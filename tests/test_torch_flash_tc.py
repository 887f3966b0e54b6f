"""The tensor-core backward's arithmetic, emulated on the CPU, against
the plain backward (horovod_tpu_torch/ops/flash_attention.py), and the
rule that picks the backward kernels' variant.

The card's kernels (``hvd_flash_bwd_dq_tc`` and ``hvd_flash_bwd_dkv_tc``
in ``csrc/flash_attention.cu``) take bf16 q, k, v and dO, form S and dP
in fp32 from exact bf16 products, form P = 2^(S·scale·log2 e − lse·log2
e) and dS in fp32, and feed P and dS to the second products (dQ = dS·K,
dV = Pᵀ·dO, dK = dSᵀ·Q) as a bf16 pair ``hi = bf16(x)``, ``lo = bf16(x
− hi)``, accumulating both halves in fp32. The emulation below does the
same in plain PyTorch, and is held to :func:`flash_bwd_plain` under the
card's check (``chip_smoke.py``'s ``_check_one_rounding``): every output
within one bf16 ulp of the larger magnitude, the ulp floored at 2^-6.
The same check fails when P and dS are rounded to one bf16 each, which
is why the kernels carry the pair. The emulation lives here, not in the
package: the package's plain version stays the one oracle.

Inputs come from a numpy seed, as bf16 values."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

CASES = {
    # GPT-2 medium's head_dim, causal
    "causal-d64": dict(b=1, t=512, h=2, kvh=2, d=64, causal=True),
    # GQA, 4 query heads per KV head, head_dim 128
    "gqa-d128": dict(b=1, t=512, h=4, kvh=1, d=128, causal=True),
    # a ragged length, padded rows and a window
    "ragged-lengths-window": dict(b=2, t=200, h=2, kvh=1, d=64,
                                  causal=True, lengths=[200, 131],
                                  window=77),
}


def _ulp_bf16(x):
    """One bf16 ulp at |x|, floored at 2^-6 (as chip_smoke.py)."""
    mag = x.abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _within_one_rounding(got, ref):
    """How many elements break the card's check, and the worst ratio of
    |got − ref| to the tolerance."""
    diff = (got.float() - ref.float()).abs()
    tol = _ulp_bf16(torch.maximum(got.float().abs(), ref.float().abs()))
    return int((diff > tol).sum()), float((diff / tol).max())


def _inputs(b, t, h, kvh, d, causal, lengths=None, window=None, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16)

    q, k, v, do = mk(b, t, h, d), mk(b, t, kvh, d), mk(b, t, kvh, d), \
        mk(b, t, h, d)
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    return q, k, v, do, dict(causal=causal, lengths=lens, window=window)


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulated_backward(q, k, v, o, lse, do, causal, lengths, window,
                       pair=True):
    """The tensor-core kernels' arithmetic in plain PyTorch: fp32 S and
    dP from bf16 operands, P and dS in fp32, then each second product
    as the sum of its hi and lo halves (``pair``) or of one bf16 operand
    (``pair=False``), accumulated in fp32 and rounded once to bf16."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    r = h // kvh
    scale = 1.0 / d ** 0.5
    qf = q.float().transpose(1, 2)
    kf = tfa._bhtd(k, r, torch.float32)
    vf = tfa._bhtd(v, r, torch.float32)
    dof = do.float().transpose(1, 2)
    valid = tfa._valid(t, causal, window, lengths, q.device,
                       pad_rows=lengths is not None)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    p = torch.where(valid,
                    torch.exp2((qf @ kf.transpose(-1, -2)) * c
                               - lse.reshape(b, h, t, 1) * log2e), 0.0)
    delta = tfa.flash_bwd_delta_plain(o, do).reshape(b, h, t, 1)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)

    def product(a, bmat):
        if not pair:
            return a.to(torch.bfloat16).float() @ bmat
        hi, lo = _split(a)
        return hi @ bmat + lo @ bmat

    dq = scale * product(ds, kf)
    dk = scale * product(ds.transpose(-1, -2), qf)
    dv = product(p.transpose(-1, -2), dof)
    dk = dk.reshape(b, kvh, r, t, d).sum(dim=2)
    dv = dv.reshape(b, kvh, r, t, d).sum(dim=2)
    return tuple(x.transpose(1, 2).to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hi_lo_operands_pass_the_card_check(name):
    q, k, v, do, kw = _inputs(**CASES[name])
    o, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    want = tfa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    got = _emulated_backward(q, k, v, o, lse, do, kw["causal"],
                             kw["lengths"], kw["window"])
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        bad, worst = _within_one_rounding(g, w)
        assert bad == 0, f"{label}: {bad} outputs beyond one rounding " \
                         f"(worst {worst:.2f} of the tolerance)"


@pytest.mark.parametrize("name", ["causal-d64", "gqa-d128"])
def test_single_bf16_operands_break_the_card_check(name):
    """Why the kernels carry P and dS as a pair: rounded once to bf16
    (2^-9 relative per term), the second products fall outside one
    rounding of the plain version on many outputs."""
    q, k, v, do, kw = _inputs(**CASES[name], seed=1)
    o, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    want = tfa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    got = _emulated_backward(q, k, v, o, lse, do, kw["causal"],
                             kw["lengths"], kw["window"], pair=False)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        bad, _ = _within_one_rounding(g, w)
        assert bad > 100, label


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("head_dim", [8, 24, 32, 64, 96, 128, 256])
def test_dispatch_rule(dtype, head_dim):
    """bf16 at head_dim 64 or 128 takes the tensor-core kernels (the
    forward's and the backward's); every other (dtype, head_dim) the
    CUDA-core ones."""
    want = dtype == torch.bfloat16 and head_dim in (64, 128)
    assert tfa.tensor_core_path(dtype, head_dim) is want


def test_delta_plain_is_the_row_sum():
    q, _, _, do, _ = _inputs(b=2, t=9, h=3, kvh=3, d=16, causal=False)
    got = tfa.flash_bwd_delta(q, do)  # CPU: the plain version
    want = (do.float() * q.float()).sum(-1).transpose(1, 2).reshape(6, 9)
    assert got.dtype == torch.float32 and got.shape == (6, 9)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_backward_ignores_a_given_delta():
    """On the CPU the wrappers take the plain backward whatever delta
    they are handed, and launch nothing."""
    q, k, v, do, kw = _inputs(b=1, t=40, h=4, kvh=2, d=64, causal=True)
    o, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    counts = (tfa.flash_bwd_delta.launches, tfa.flash_bwd_dq.tc_launches,
              tfa.flash_bwd_dkv.tc_launches)
    delta = tfa.flash_bwd_delta(o, do)
    want = tfa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    dq = tfa.flash_bwd_dq(q, k, v, o, lse, do, delta=delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, o, lse, do, delta=delta, **kw)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert (tfa.flash_bwd_delta.launches, tfa.flash_bwd_dq.tc_launches,
            tfa.flash_bwd_dkv.tc_launches) == counts
