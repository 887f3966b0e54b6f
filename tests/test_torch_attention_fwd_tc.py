"""The tensor-core attention forwards' arithmetic, emulated on the CPU,
against the plain versions (horovod_tpu_torch/ops/flash_attention.py and
paged_attention.py), and the rule that picks the paged kernel's variant
(the flash forward's, ``tensor_core_path``, is the backward's:
tests/test_torch_flash_tc.py).

The card's kernels (``hvd_flash_fwd_tc`` in ``csrc/flash_attention.cu``
and ``paged_attention_tc_kernel`` in ``csrc/paged_attention.cu``, both on
the tile step of ``csrc/attention_tc.cuh``) take bf16 q, k and v, form S
= Q·Kᵀ in fp32 from exact bf16 products, 64 keys at a time, and keep an
online softmax in base 2: the row max m₂ of S·(scale·log2 e) starts at a
finite floor, P = 2^(S·scale·log2 e − m₂) in fp32, the running sum l
and the fp32 output accumulator are rescaled by 2^(m₂,old − m₂,new), and
P enters O += P·V as a bf16 pair ``hi = bf16(P)``, ``lo = bf16(P −
hi)``, both halves accumulated in fp32. At the end o = O / max(l,
1e-30) is rounded once to bf16 and lse = (m₂ + log2 l)·ln 2. The
emulation below does the same in plain PyTorch and is held to the plain
versions under the card's checks (``chip_smoke.py``): the flash forward
within one bf16 ulp of the larger magnitude (the ulp floored at 2^-6)
and lse within 1e-4; paged attention within two. The same checks fail
when P is rounded once to bf16, which is why the kernels carry the pair.
The emulation lives here, not in the package: the package's plain
versions stay the one oracle.

Inputs come from a numpy seed, as bf16 values."""

import math

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import paged_attention as tpa

TILE = 64  # keys a tile step consumes (wgmma's N of S = Q·Kᵀ)
LOG2E = 1.4426950408889634

FLASH_CASES = {
    # GPT-2 medium's head_dim, causal
    "causal-d64": dict(b=1, t=512, h=2, kvh=2, d=64, causal=True),
    # GQA, 4 query heads per KV head, head_dim 128
    "gqa-d128": dict(b=1, t=512, h=4, kvh=1, d=128, causal=True),
    # a ragged length, right-padded rows (one sequence empty) and a window
    "ragged-lengths-window": dict(b=3, t=200, h=2, kvh=1, d=64,
                                  causal=True, lengths=[200, 131, 0],
                                  window=77),
}

PAGED_CASES = {
    # prefill chunks that start off a page boundary, MHA, head_dim 128
    "mha-t64": dict(b=2, t=64, h=2, kvh=2, d=128, pt=16, n_logical=24,
                    starts=[37, 250]),
    "mha-t130": dict(b=1, t=130, h=2, kvh=2, d=128, pt=16, n_logical=24,
                     starts=[101]),
    # GQA, 4 query heads per KV head: 4·t packed rows a KV head
    "gqa4-t97": dict(b=2, t=97, h=8, kvh=2, d=128, pt=16, n_logical=16,
                     starts=[3, 140]),
    # a page size that is no divisor of the 64-key tile
    "gqa4-t70-pt12": dict(b=1, t=70, h=4, kvh=1, d=128, pt=12,
                          n_logical=20, starts=[55]),
}


def _ulp_bf16(x):
    """One bf16 ulp at |x|, floored at 2^-6 (as chip_smoke.py)."""
    mag = x.abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _beyond(got, ref, ulps):
    """How many elements lie beyond ``ulps`` bf16 ulp of the larger
    magnitude, and the worst ratio of |got − ref| to that tolerance."""
    diff = (got.float() - ref.float()).abs()
    tol = ulps * _ulp_bf16(torch.maximum(got.float().abs(),
                                         ref.float().abs()))
    return int((diff > tol).sum()), float((diff / tol).max())


def _bf16(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _online_softmax(s, valid, c, v, pair):
    """The tile step over 64-key tiles: ``s`` [..., rows, keys] fp32
    scores, ``valid`` the attended pairs, ``c`` the fp32 factor taking
    a score to base-2 units, ``v`` [..., keys, d] fp32. Returns the
    unnormalized output, the row sum l and the row max m₂."""
    floor = torch.tensor(-1e30, dtype=torch.float32)
    m2 = floor.expand(*s.shape[:-1], 1).clone()
    l = torch.zeros_like(m2)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], dtype=torch.float32)
    for k0 in range(0, s.shape[-1], TILE):
        st = torch.where(valid[..., k0:k0 + TILE], s[..., k0:k0 + TILE],
                         -math.inf)
        m_new = torch.maximum(m2, st.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m2 - m_new)
        p = torch.exp2(st * c - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = v[..., k0:k0 + TILE, :]
        if pair:
            hi, lo = _split(p)
            pv = hi @ vt + lo @ vt
        else:
            pv = p.to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m2 = m_new
    return acc, l, m2


def _flash_inputs(b, t, h, kvh, d, causal, lengths=None, window=None,
                  seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = _bf16(rng, b, t, h, d), _bf16(rng, b, t, kvh, d), \
        _bf16(rng, b, t, kvh, d)
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    return q, k, v, dict(causal=causal, lengths=lens, window=window)


def _emulated_flash_fwd(q, k, v, causal, lengths, window, pair=True):
    """``hvd_flash_fwd_tc``'s arithmetic: ``(o, lse)`` as the kernel
    forms them (rows with no live key: o = 0, lse = −1e30 + log(1e−30)),
    o in fp32 before its one rounding to bf16."""
    window = tfa._check(q, k, v, causal, lengths, window)
    b, t, h, d = q.shape
    r = h // k.shape[2]
    c = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    s = q.float().transpose(1, 2) @ tfa._bhtd(k, r, torch.float32) \
        .transpose(-1, -2)
    valid = tfa._valid(t, causal, window, lengths, q.device, pad_rows=False)
    acc, l, m2 = _online_softmax(s, valid.expand_as(s), c,
                                 tfa._bhtd(v, r, torch.float32), pair)
    o = acc / l.clamp_min(1e-30)
    empty = torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-30)
    lse = torch.where(l > 0, (m2 + torch.log2(l)) * math.log(2.0), empty)
    return o.transpose(1, 2), lse.reshape(b * h, t)


def _paged_inputs(b, t, h, kvh, d, pt, n_logical, starts, seed=0):
    """bf16 pools with a scrambled page table (the sentinel past each
    slot's live pages) and queries."""
    rng = np.random.default_rng(seed)
    num_pages = b * n_logical + 3
    k_pool, v_pool = _bf16(rng, num_pages, pt, kvh, d), \
        _bf16(rng, num_pages, pt, kvh, d)
    table = np.full((b, n_logical), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, s in enumerate(starts):
        live = -(-(s + t) // pt)
        assert live <= n_logical
        table[i, :live] = perm[used:used + live]
        used += live
    q = _bf16(rng, b, t, h, d)
    return (q, k_pool, v_pool, torch.from_numpy(table),
            torch.tensor(starts, dtype=torch.int32))


def _emulated_paged(q, k_pool, v_pool, table, lengths, pair=True):
    """``paged_attention_tc_kernel``'s arithmetic, causal: each slot's
    keys in 64-key tiles from position 0, scores divided by √d after
    the product (folded into the base-2 factor). The output in fp32,
    before its one rounding to bf16."""
    b, t, h, d = q.shape
    num_pages, pt, kvh, _ = k_pool.shape
    r = h // kvh
    tbl = table.long().clamp(0, num_pages - 1)
    seq = tbl.shape[1] * pt
    k = k_pool[tbl].reshape(b, seq, kvh, d).float().repeat_interleave(r, 2)
    v = v_pool[tbl].reshape(b, seq, kvh, d).float().repeat_interleave(r, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k)
    start = lengths.long()
    key_pos = torch.arange(seq)
    q_pos = start[:, None] + torch.arange(t)
    valid = (key_pos[None, None, :] < (start + t)[:, None, None]) & (
        key_pos[None, None, :] <= q_pos[:, :, None])
    c = torch.tensor(LOG2E, dtype=torch.float32) / torch.tensor(
        math.sqrt(d), dtype=torch.float32)
    acc, l, _ = _online_softmax(s, valid[:, None].expand_as(s), c,
                                v.transpose(1, 2), pair)
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


def _pre_rounding_ulps(got, ref):
    """The worst |got − ref| of two fp32 outputs in bf16 ulp of the
    larger magnitude: how far the kernel's sum lies from the plain one
    before the one rounding that both take."""
    tol = _ulp_bf16(torch.maximum(got.abs(), ref.abs()))
    return float(((got - ref).abs() / tol).max())


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_fwd_hi_lo_passes_the_card_check(name):
    q, k, v, kw = _flash_inputs(**FLASH_CASES[name])
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, **kw)
    o32, lse = _emulated_flash_fwd(q, k, v, kw["causal"], kw["lengths"],
                                   kw["window"])
    bad, worst = _beyond(o32.to(torch.bfloat16), o_ref, 1)
    assert bad == 0, f"{bad} outputs beyond one rounding (worst " \
                     f"{worst:.2f} of the tolerance)"
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    # margin: before the rounding, a small fraction of an ulp off the
    # plain version's fp32 output
    want32, _ = tfa.flash_fwd_plain(q.float(), k.float(), v.float(), **kw)
    assert _pre_rounding_ulps(o32, want32) < 0.1


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_hi_lo_passes_the_card_check(name):
    args = _paged_inputs(**PAGED_CASES[name])
    got32 = _emulated_paged(*args)
    bad, worst = _beyond(got32.to(torch.bfloat16),
                         tpa.paged_attention_plain(*args), 2)
    assert bad == 0, f"{bad} outputs beyond two ulp (worst {worst:.2f} " \
                     "of the tolerance)"
    q, k_pool, v_pool = (x.float() for x in args[:3])
    want32 = tpa.paged_attention_plain(q, k_pool, v_pool, *args[3:])
    assert _pre_rounding_ulps(got32, want32) < 0.1


def test_flash_fwd_single_bf16_p_breaks_the_card_check():
    """Why the kernel carries P as a pair: rounded once to bf16 (2^-9
    relative a term), O = P·V falls outside one rounding of the plain
    version on thousands of outputs."""
    q, k, v, kw = _flash_inputs(**FLASH_CASES["causal-d64"], seed=1)
    o_ref, _ = tfa.flash_fwd_plain(q, k, v, **kw)
    o32, _ = _emulated_flash_fwd(q, k, v, kw["causal"], kw["lengths"],
                                 kw["window"], pair=False)
    bad, _ = _beyond(o32.to(torch.bfloat16), o_ref, 1)
    assert bad > 1000


def test_paged_single_bf16_p_breaks_the_card_check():
    args = _paged_inputs(**PAGED_CASES["gqa4-t97"], seed=1)
    got32 = _emulated_paged(*args, pair=False)
    bad, _ = _beyond(got32.to(torch.bfloat16),
                     tpa.paged_attention_plain(*args), 2)
    assert bad > 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("head_dim", [8, 24, 64, 96, 128, 256])
@pytest.mark.parametrize("rows", [1, 4, 5, 12, 64, 256])
def test_paged_dispatch_rule(dtype, head_dim, rows):
    """Three ways by the packed rows of a (slot, KV head), t·h/kvh: at
    most 4 take the decode kernel; more take the tiled kernel, on the
    tensor cores for bf16 at head_dim 64 or 128 and on the CUDA cores
    otherwise."""
    if rows <= 4:
        want = "decode"
    elif dtype == torch.bfloat16 and head_dim in (64, 128):
        want = "tensor_cores"
    else:
        want = "cuda_cores"
    assert tpa.kernel_variant(dtype, head_dim, rows) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_and_flash_share_the_tensor_core_rule(dtype):
    """Past the decode kernel's rows, the paged tiled kernel takes the
    tensor cores exactly where the flash kernels do."""
    for head_dim in range(8, 257, 8):
        paged_tc = tpa.kernel_variant(dtype, head_dim, 64) == "tensor_cores"
        assert paged_tc == tfa.tensor_core_path(dtype, head_dim), head_dim


def _counts():
    return (tfa.flash_fwd.launches, tfa.flash_fwd.tc_launches,
            tpa.paged_attention.launches, tpa.paged_attention.chunk_launches,
            tpa.paged_attention.tc_launches)


def test_cpu_wrappers_launch_nothing():
    """On the CPU both wrappers take the plain versions at shapes the
    tensor-core kernels would serve on the card, and count nothing."""
    before = _counts()
    q, k, v, kw = _flash_inputs(b=1, t=70, h=2, kvh=2, d=64, causal=True)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, **kw)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    args = _paged_inputs(b=1, t=9, h=4, kvh=1, d=64, pt=16, n_logical=4,
                         starts=[20])
    assert torch.equal(tpa.paged_attention(*args),
                       tpa.paged_attention_plain(*args))
    assert _counts() == before
