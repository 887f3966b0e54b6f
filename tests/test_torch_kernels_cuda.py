"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX (the card's machine has none), so it runs there on
its own, without the repository's JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs come from a numpy seed. Both versions compute in fp32 and round
once to the output type, differing only in the order of fp32 sums, so
the tolerance is fp32 reassociation for fp32 outputs and one rounding
of the output type (``rtol`` 2 eps, ``atol`` eps / 4) otherwise."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(b, t, h, kvh, d, pt, n_logical, lengths, sentinel_rows=(),
          seed=0):
    rng = np.random.default_rng(seed)
    num_pages = b * n_logical + 3
    k_pool = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    v_pool = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    table = np.full((b, n_logical), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lengths):
        if i in sentinel_rows:
            continue
        live = min(-(-(int(n) + t) // pt), n_logical)
        table[i, :live] = perm[used:used + live]
        used += live
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k_pool, v_pool, table, np.asarray(lengths, np.int32)


CASES = {
    # decode kernel (t * h / kvh <= 4 rows per KV head)
    "decode-mha": dict(b=4, t=1, h=2, kvh=2, d=64, pt=16, n_logical=32,
                       lengths=[0, 5, 300, 511]),
    "decode-gqa2": dict(b=3, t=1, h=4, kvh=2, d=128, pt=16, n_logical=8,
                        lengths=[9, 0, 127]),
    "decode-gqa4": dict(b=2, t=1, h=8, kvh=2, d=32, pt=5, n_logical=20,
                        lengths=[44, 99]),
    "decode-t2-r2": dict(b=2, t=2, h=4, kvh=2, d=16, pt=8, n_logical=12,
                         lengths=[3, 70]),
    # a warp's whole chunk past row 0's causal bound
    "decode-t4-edge": dict(b=1, t=4, h=1, kvh=1, d=64, pt=16, n_logical=4,
                           lengths=[30]),
    "decode-d256": dict(b=2, t=1, h=2, kvh=2, d=256, pt=16, n_logical=4,
                        lengths=[20, 63]),
    "decode-sentinel": dict(b=3, t=1, h=2, kvh=2, d=64, pt=16,
                            n_logical=8, lengths=[10, 0, 4],
                            sentinel_rows=(1,)),
    # tiled kernel (prefill chunks, wide GQA groups)
    "chunk-t5": dict(b=3, t=5, h=2, kvh=2, d=64, pt=16, n_logical=8,
                     lengths=[0, 3, 100]),
    "chunk-gqa": dict(b=2, t=3, h=8, kvh=2, d=128, pt=16, n_logical=8,
                      lengths=[17, 60]),
    "chunk-t40": dict(b=2, t=40, h=2, kvh=2, d=64, pt=16, n_logical=16,
                      lengths=[0, 77]),
    # more than one 64-row tile: causal tiles of unequal weight
    "chunk-t130": dict(b=1, t=130, h=4, kvh=4, d=64, pt=16, n_logical=16,
                       lengths=[100]),
    # a page size that divides no tile: a 64-key tile spans 13-14 pages
    "chunk-gqa4-pt5": dict(b=2, t=70, h=8, kvh=2, d=128, pt=5,
                           n_logical=40, lengths=[3, 61]),
}


def _tolerance(dtype):
    if dtype == torch.float32:
        return dict(atol=1e-5, rtol=1e-5)
    eps = torch.finfo(dtype).eps
    return dict(atol=eps / 4, rtol=2 * eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_card, name, dtype):
    q, k, v, table, lengths = _case(**CASES[name])
    args = [torch.from_numpy(x).to(cuda_card, dtype) for x in (q, k, v)]
    args += [torch.from_numpy(x).to(cuda_card) for x in (table, lengths)]
    before = _paged_counts()
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    b, t, h, d = q.shape
    variant = pa.kernel_variant(dtype, d, t * h // k.shape[2])
    assert _paged_counts() == (before[0] + 1,
                               before[1] + (variant != "decode"),
                               before[2] + (variant == "tensor_cores"))
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, pa.paged_attention_plain(*args),
                               **_tolerance(dtype))


# the decode kernel at its split edges: 64-key splits (4 pages of 16),
# live keys at 1, 63, 64, 65, 66, 128 and the whole 64-page table, a
# sentinel slot, at head_dim 64, 128 and 40 (an odd multiple of 8)
DECODE_EDGES = [0, 62, 63, 64, 65, 127, 64 * 16 - 1, 300]


@pytest.mark.parametrize("d", [64, 128, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_split_edges_match_plain(cuda_card, dtype, d):
    for t, h, kvh in ((1, 4, 4), (1, 8, 2), (2, 4, 2)):
        q, k, v, table, lengths = _case(
            b=len(DECODE_EDGES), t=t, h=h, kvh=kvh, d=d, pt=16,
            n_logical=64, lengths=DECODE_EDGES, sentinel_rows=(7,))
        args = [torch.from_numpy(x).to(cuda_card, dtype) for x in (q, k, v)]
        args += [torch.from_numpy(x).to(cuda_card)
                 for x in (table, lengths)]
        got = pa._launch(*args, True, "decode")
        again = pa._launch(*args, True, "decode")
        torch.cuda.synchronize()
        assert torch.equal(got, again)  # the ticket words were left zero
        torch.testing.assert_close(got, pa.paged_attention_plain(*args),
                                   **_tolerance(dtype))
    assert not pa._ticket_words[got.device].any()


def _paged_counts():
    return (pa.paged_attention.launches, pa.paged_attention.chunk_launches,
            pa.paged_attention.tc_launches)


def _ulp_bf16(x):
    """One bf16 ulp at |x|, floored at 2^-6 (as chip_smoke.py)."""
    mag = x.abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _assert_within_ulps(got, want, ulps):
    """chip_smoke.py's check: |got − want| within ``ulps`` bf16 ulp of
    the larger magnitude."""
    diff = (got.float() - want.float()).abs()
    tol = ulps * _ulp_bf16(torch.maximum(got.float().abs(),
                                         want.float().abs()))
    assert torch.isfinite(got.float()).all()
    assert not bool((diff > tol).any()), float((diff / tol).max())


# chip_smoke.py's phase-2 shapes that take the tiled kernel: the serving
# path's 256-row prefill chunk, a 512-row one, a GQA 3-token chunk
PAGED_PHASE2 = {
    "prefill256": dict(b=1, t=256, h=16, kvh=16, d=64, pt=16, n_logical=64,
                       lengths=[293]),
    "prefill512": dict(b=1, t=512, h=16, kvh=16, d=64, pt=16, n_logical=64,
                       lengths=[37]),
    "gqa": dict(b=4, t=3, h=32, kvh=8, d=128, pt=16, n_logical=64,
                lengths=[0, 17, 100, 500]),
}


@pytest.mark.parametrize("name", sorted(PAGED_PHASE2))
def test_paged_tensor_cores_match_plain_at_phase2_shapes(cuda_card, name):
    """The tensor-core tiled kernel, bf16, within 2 bf16 ulp of the plain
    version (chip_smoke.py's check), its launch counted as a tensor-core
    chunk launch."""
    q, k, v, table, lengths = _case(**PAGED_PHASE2[name])
    args = [torch.from_numpy(x).to(cuda_card, torch.bfloat16)
            for x in (q, k, v)]
    args += [torch.from_numpy(x).to(cuda_card) for x in (table, lengths)]
    before = _paged_counts()
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert _paged_counts() == tuple(c + 1 for c in before)
    _assert_within_ulps(got, pa.paged_attention_plain(*args), 2)


def test_paged_tensor_cores_not_causal(cuda_card):
    q, k, v, table, lengths = _case(**CASES["chunk-gqa4-pt5"])
    args = [torch.from_numpy(x).to(cuda_card, torch.bfloat16)
            for x in (q, k, v)]
    args += [torch.from_numpy(x).to(cuda_card) for x in (table, lengths)]
    before = pa.paged_attention.tc_launches
    got = pa.paged_attention(*args, causal=False)
    torch.cuda.synchronize()
    assert pa.paged_attention.tc_launches == before + 1
    _assert_within_ulps(got, pa.paged_attention_plain(*args, causal=False),
                        2)


# ------------------------------------------------------ flash attention

from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402

FLASH_CASES = {
    # GPT-2 medium's head_dim, a ragged last tile, causal
    "causal-t130": dict(b=2, t=130, h=4, kvh=4, d=64, causal=True),
    # BERT's bidirectional attention, an odd length
    "full-t77": dict(b=1, t=77, h=3, kvh=3, d=64, causal=False),
    # GQA, head_dim 128, lengths (one row fully padded) and a window
    "gqa-lengths-window": dict(b=3, t=100, h=8, kvh=2, d=128, causal=True,
                               lengths=[100, 37, 0], window=33),
    # head_dim 24 and 256: the narrowest tile group and the widest
    "d24": dict(b=1, t=40, h=2, kvh=1, d=24, causal=True, lengths=[29]),
    "d256": dict(b=1, t=70, h=2, kvh=2, d=256, causal=True, window=20),
    # ViT's padded bidirectional rows: the last 64-key tile partial,
    # keys past each row's length unseen, padded query rows zero
    "vit-lengths-full-t200": dict(b=2, t=200, h=4, kvh=4, d=64,
                                  causal=False, lengths=[197, 120]),
}


def _flash_inputs(device, dtype, b, t, h, kvh, d, causal, lengths=None,
                  window=None, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)
        ).to(device, dtype)

    q, k, v, do = mk(b, t, h, d), mk(b, t, kvh, d), mk(b, t, kvh, d), \
        mk(b, t, h, d)
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, do, dict(causal=causal, lengths=lens, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_card, name, dtype):
    """Forward (o, lse), dQ and dK/dV against the plain versions, each
    backward kernel on the variant the dispatch rule names (bf16 at
    head_dim 64 and 128: the tensor cores). fp32: sums over up to t
    terms in another order (atol 2e-5, rtol 1e-4); bf16 and fp16: one
    rounding of the output."""
    q, k, v, do, kw = _flash_inputs(cuda_card, dtype, **FLASH_CASES[name])
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    tc = (fa.flash_fwd.tc_launches, fa.flash_bwd_dq.tc_launches,
          fa.flash_bwd_dkv.tc_launches)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do, **kw)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, o_ref, lse_ref,
                                                do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    on_tc = int(fa.tensor_core_path(dtype, q.shape[3]))
    assert (fa.flash_fwd.tc_launches, fa.flash_bwd_dq.tc_launches,
            fa.flash_bwd_dkv.tc_launches) == tuple(c + on_tc for c in tc)
    tol = (dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32
           else _tolerance(dtype))
    torch.testing.assert_close(o, o_ref, **tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, **tol)


# chip_smoke.py's FLASH_CASES: (b, t, h, kvh, d, causal, lengths, window)
FLASH_PHASE2 = {
    "gpt2-t512": (8, 512, 16, 16, 64, True, None, None),
    "gpt2-t1024": (8, 1024, 16, 16, 64, True, None, None),
    "bert-full-t512": (8, 512, 16, 16, 64, False, None, None),
    "gqa-t1024": (4, 1024, 32, 8, 128, True, None, None),
    "lengths-t512": (8, 512, 16, 16, 64, True,
                     [512, 500, 431, 300, 257, 129, 64, 1], None),
    "window-t1024": (8, 1024, 16, 16, 64, True, None, 256),
    "ragged-t1000": (8, 1000, 16, 16, 64, True, None, None),
    "vit-b16-t200": (64, 200, 12, 12, 64, False, [197] * 64, None),
}


@pytest.mark.parametrize("name", sorted(FLASH_PHASE2))
def test_flash_fwd_tensor_cores_match_plain_at_phase2_shapes(cuda_card,
                                                              name):
    """The tensor-core forward, bf16: o within one bf16 rounding of the
    plain version and lse within 1e-4 (chip_smoke.py's checks)."""
    b, t, h, kvh, d, causal, lengths, window = FLASH_PHASE2[name]
    q, k, v, _, kw = _flash_inputs(cuda_card, torch.bfloat16, b, t, h, kvh,
                                   d, causal, lengths, window)
    before = (fa.flash_fwd.launches, fa.flash_fwd.tc_launches)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd.tc_launches) == (
        before[0] + 1, before[1] + 1)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    _assert_within_ulps(o, o_ref, 1)
    assert float((lse - lse_ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_fp32_and_fp16_launch_no_tensor_core_kernel(cuda_card, dtype):
    """fp32 and fp16 keep the CUDA-core forward and tiled kernel at the
    head_dims the tensor cores take in bf16."""
    q, k, v, _, kw = _flash_inputs(cuda_card, dtype, 1, 130, 2, 2, 64, True)
    pq, pk, pv, table, lengths = _case(**CASES["chunk-t40"])
    args = [torch.from_numpy(x).to(cuda_card, dtype) for x in (pq, pk, pv)]
    args += [torch.from_numpy(x).to(cuda_card) for x in (table, lengths)]
    before = (fa.flash_fwd.launches, fa.flash_fwd.tc_launches,
              _paged_counts())
    fa.flash_fwd(q, k, v, **kw)
    pa.paged_attention(*args)
    torch.cuda.synchronize()
    launches, chunks, tcs = before[2]
    assert (fa.flash_fwd.launches, fa.flash_fwd.tc_launches,
            _paged_counts()) == (before[0] + 1, before[1],
                                 (launches + 1, chunks + 1, tcs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_delta_matches_plain(cuda_card, dtype):
    """The delta pass on strided inputs against rowsum(dO ⊙ O) in fp32:
    sums of d products in another order."""
    b, t, h, d = 2, 77, 3, 136
    rng = np.random.default_rng(3)
    ob = torch.from_numpy(rng.normal(size=(b, t, 2, h, d)).astype(
        np.float32)).to(cuda_card, dtype)
    o = ob[:, :, 1]  # a strided slice, as the fused projection's
    do = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(
        np.float32)).to(cuda_card, dtype)
    before = fa.flash_bwd_delta.launches
    got = fa.flash_bwd_delta(o, do)
    torch.cuda.synchronize()
    assert fa.flash_bwd_delta.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b * h, t)
    torch.testing.assert_close(got, fa.flash_bwd_delta_plain(o, do),
                               atol=1e-4, rtol=1e-5)


def test_flash_given_delta_launches_no_delta_pass(cuda_card):
    """A backward kernel handed delta reads it and launches nothing
    else; one handed none computes it first."""
    q, k, v, do, kw = _flash_inputs(cuda_card, torch.bfloat16,
                                    **FLASH_CASES["causal-t130"])
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = fa.flash_bwd_delta(o, do)
    before = fa.flash_bwd_delta.launches
    given = fa.flash_bwd_dq(q, k, v, o, lse, do, delta=delta, **kw)
    assert fa.flash_bwd_delta.launches == before
    computed = fa.flash_bwd_dq(q, k, v, o, lse, do, **kw)
    assert fa.flash_bwd_delta.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(given, computed)
    with pytest.raises(ValueError, match="delta must be fp32"):
        fa.flash_bwd_dkv(q, k, v, o, lse, do, delta=delta[:1], **kw)


def test_flash_function_gradients_on_card(cuda_card):
    """The autograd Function on strided slices of one fused projection
    (the model's layout): gradients equal the plain backward's."""
    b, t, h, d = 2, 96, 4, 64
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(
        rng.normal(size=(b, t, 3, h, d)).astype(np.float32)
    ).to(cuda_card).requires_grad_()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    w = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
    w = w.to(cuda_card)
    lengths = torch.tensor([96, 50], device=cuda_card)
    (fa.flash_attention(q, k, v, causal=True, lengths=lengths) * w).sum() \
        .backward()
    got = qkv.grad.clone()
    qkv.grad = None
    o, lse = fa.flash_fwd_plain(q, k, v, True, lengths)
    valid = (torch.arange(t, device=cuda_card)[None] < lengths[:, None])
    do = torch.where(valid[:, :, None, None], w, 0.0)
    want = torch.stack(fa.flash_bwd_plain(q.detach(), k.detach(), v.detach(),
                                          o, lse, do, True, lengths), dim=2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# ----------------------------------------------------------- wire kernels

from horovod_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

WIRE_SIZES = [1, 511, 513, 100_003]


def _wire_input(device, n, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[: n // 3] *= 1e-3  # mixed magnitudes: blocks keep their own range
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("in_dtype", [torch.int8, torch.float32,
                                      torch.bfloat16])
def test_scale_cast_bitwise(cuda_card, in_dtype, out_dtype):
    """B1 against plain: one fp32 product, one rounding, same bits."""
    x = _wire_input(cuda_card, 100_003) * 50
    x = x.to(in_dtype)
    s = torch.tensor([0.0371], device=cuda_card)
    before = ck.scale_cast.launches
    got = ck.scale_cast(x, s, out_dtype)
    torch.cuda.synchronize()
    assert ck.scale_cast.launches == before + 1
    assert torch.equal(got, ck.scale_cast_plain(x, s, out_dtype))


# B2's sizes: none a multiple of 8 but 512, smaller than one block's
# slice, and splitting unevenly over the grid
B2_SIZES = WIRE_SIZES + [7, 1_000_003, 3_000_017]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", B2_SIZES)
def test_int8_quantize_bitwise(cuda_card, n, dtype):
    """B2 against plain: the same Philox bits and IEEE divisions give
    equal values and an equal scale, in any traversal order."""
    x = _wire_input(cuda_card, n, dtype)
    before = ck.int8_quantize.launches
    q, s = ck.int8_quantize(x, seed=11, stream=3)
    torch.cuda.synchronize()
    assert ck.int8_quantize.launches == before + 1
    qp, sp = ck.int8_quantize_plain(x, seed=11, stream=3)
    assert torch.equal(s, sp) and torch.equal(q, qp)


def test_int8_quantize_zero_and_clip(cuda_card):
    """An all-zero tensor's scale is 1e-30 · fp32(1/127) and its values
    0; values at ± absmax reach the clip at ±127 (and -128 never)."""
    zero = torch.zeros(1001, device=cuda_card)
    q, s = ck.int8_quantize(zero)
    qp, sp = ck.int8_quantize_plain(zero)
    assert torch.equal(s, sp) and torch.equal(q, qp)
    want = torch.tensor(1e-30, dtype=torch.float32) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32)
    assert float(s) == float(want) and not q.any()
    x = _wire_input(cuda_card, 4099) * 0.5
    x[::7] = 3.0
    x[3::7] = -3.0
    q, s = ck.int8_quantize(x, seed=5)
    qp, sp = ck.int8_quantize_plain(x, seed=5)
    assert torch.equal(s, sp) and torch.equal(q, qp)
    assert int(q.max()) == 127 and int(q.min()) == -127


def test_int8_quantize_graph_replay_matches_eager(cuda_card):
    """Captured in a CUDA graph and replayed, the kernel gives the bits
    it gives eagerly."""
    x = _wire_input(cuda_card, 1_000_003, torch.bfloat16)
    eager_q, eager_s = ck.int8_quantize(x, seed=9, stream=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.int8_quantize(x, seed=9, stream=2)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        q, s = ck.int8_quantize(x, seed=9, stream=2)
    q.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(q, eager_q) and torch.equal(s, eager_s)


# B3's block sizes: each side of every variant limit (lanes below 32,
# warp to 2048, cta to 8192, cta_reread above), the paths' 512 and 1000
B3_BLOCKS = [1, 3, 31, 32, 33, 512, 1000, ck.WARP_MAX_BLOCK,
             ck.WARP_MAX_BLOCK + 1, 4096, ck.CTA_STAGE_MAX + 1]
WIRE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _assert_block_bitwise(x, block, rows=False, seed=7, stream=0):
    before = ck.int8_block_quantize.launches
    q, s = ck.int8_block_quantize(x, block, seed=seed, stream=stream,
                                  rows=rows)
    torch.cuda.synchronize()
    assert ck.int8_block_quantize.launches == before + 1
    qp, sp = ck.int8_block_quantize_plain(x, block, seed=seed,
                                          stream=stream, rows=rows)
    assert torch.equal(s, sp) and torch.equal(q, qp)
    return q, s


@pytest.mark.parametrize("dtype", WIRE_DTYPES)
@pytest.mark.parametrize("block", B3_BLOCKS)
@pytest.mark.parametrize("n", WIRE_SIZES)
def test_int8_block_quantize_bitwise(cuda_card, n, block, dtype):
    """B3 against plain, flat: values and scales bit for bit, in every
    variant."""
    _assert_block_bitwise(_wire_input(cuda_card, n, dtype), block)


@pytest.mark.parametrize("block", [33, 512, 1000, 4096])
@pytest.mark.parametrize("dtype", WIRE_DTYPES)
@pytest.mark.parametrize("cols", [2501, 2502, 2503, 2504])
def test_int8_block_quantize_rows_bitwise(cuda_card, dtype, cols, block):
    """B3 on the fused wire's [n, chunk] rows: blocks stop at each row,
    a ragged last block per row, and rows of length 1, 2, 3 and 0 (mod
    4), so blocks start inside a 16-byte vector and share it with their
    neighbour."""
    x = _wire_input(cuda_card, 4 * cols, dtype).reshape(4, cols)
    _, s = _assert_block_bitwise(x, block, rows=True, seed=5, stream=9)
    assert s.shape == (4, -(-cols // block))


@pytest.mark.parametrize("dtype", WIRE_DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_int8_block_quantize_misaligned_view_bitwise(cuda_card, dtype,
                                                     offset):
    """A view whose base is not 16-byte aligned takes the scalar loads:
    the same bits as plain, flat and as rows, and at every variant."""
    base = _wire_input(cuda_card, 4 * 2503 + offset, dtype)
    view = base[offset:]
    assert view.data_ptr() % 16
    for block in (3, 512, 4096):
        _assert_block_bitwise(view, block)
        _assert_block_bitwise(view.view(4, 2503), block, rows=True)


@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_int8_block_quantize_graph_replay_matches_eager(cuda_card, dtype):
    """Captured in a CUDA graph and replayed, B3 gives the bits it gives
    eagerly (no host sync, no allocation beyond its outputs)."""
    x = _wire_input(cuda_card, 4 * 250_001, dtype).reshape(4, 250_001)
    eager_q, eager_s = ck.int8_block_quantize(x, 512, seed=3, stream=1,
                                              rows=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.int8_block_quantize(x, 512, seed=3, stream=1, rows=True)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        q, s = ck.int8_block_quantize(x, 512, seed=3, stream=1, rows=True)
    q.zero_()
    s.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(q, eager_q) and torch.equal(s, eager_s)
    qp, sp = ck.int8_block_quantize_plain(x, 512, seed=3, stream=1,
                                          rows=True)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 513, 1_000_003])
def test_adasum_pair_matches_plain(cuda_card, n, dtype):
    """B4: the dots within fp32 reassociation, bitwise equal on a rerun
    (no atomics); the apply within 1e-5 of the largest magnitude in fp32
    and one rounding in bf16."""
    a = _wire_input(cuda_card, n, dtype, seed=1)
    b = _wire_input(cuda_card, n, dtype, seed=2)
    before = (ck.adasum_dots.launches, ck.adasum_apply.launches)
    dots = ck.adasum_dots(a, b)
    again = ck.adasum_dots(a, b)
    out = ck.adasum_apply(a, b, dots)
    torch.cuda.synchronize()
    assert (ck.adasum_dots.launches, ck.adasum_apply.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(dots, again)
    torch.testing.assert_close(dots, ck.adasum_dots_plain(a, b),
                               rtol=1e-5, atol=1e-5)
    want = ck.adasum_apply_plain(a, b, dots)
    assert out.dtype == dtype
    scale = float(want.float().abs().max())
    tol = (dict(atol=1e-5 * scale, rtol=0) if dtype == torch.float32
           else _tolerance(dtype))
    torch.testing.assert_close(out, want, **tol)


@pytest.mark.parametrize("n", [513, 1_000_003])
def test_hier_adasum_split_dots_match_whole(cuda_card, n):
    """Hierarchical Adasum's combine on the card (``ops/adasum.py``
    ``_combine``): at L = 1, with no group, B4's dots then apply against
    ``adasum_pair_plain`` on the full vector (B4's apply tolerance,
    1e-5 of the largest magnitude); with the vector split in two halves,
    each half's dots summed (what the intra allreduce completes) and
    each half applied with them, equal to B4 on the whole vector within
    2.0e-7 of its largest magnitude."""
    from horovod_tpu_torch.ops import adasum

    a = _wire_input(cuda_card, n, torch.float32, seed=3)
    b = _wire_input(cuda_card, n, torch.float32, seed=4)
    before = (ck.adasum_dots.launches, ck.adasum_apply.launches)
    got = adasum._combine(a, b, None)
    assert (ck.adasum_dots.launches, ck.adasum_apply.launches) == (
        before[0] + 1, before[1] + 1)
    want = ck.adasum_pair_plain(a, b)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    h = n // 2
    dots = ck.adasum_dots(a[:h], b[:h]) + ck.adasum_dots(a[h:], b[h:])
    split = torch.cat([ck.adasum_apply(a[:h], b[:h], dots),
                       ck.adasum_apply(a[h:], b[h:], dots)])
    whole = ck.adasum_pair(a, b)
    torch.cuda.synchronize()
    assert float((split - whole).abs().max()) <= 2.0e-7 * scale


def test_mixed_product_on_card(cuda_card):
    """The LM head's product (``ops/fused_xent.mixed_mm``): bf16 operands
    on the tensor cores with an fp32 result, against the fp32 product of
    the same rounded operands within fp32 sums in another order; and the
    fused loss's gradients against the dense bf16 head's within one bf16
    rounding of each largest magnitude."""
    from horovod_tpu_torch.ops import fused_xent as fx

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(96, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 1000)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy((rng.normal(size=1000) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, 96))
    x, w, b, labels = (t.to(cuda_card) for t in (x, w, b, labels))
    got = fx.mixed_mm(x, w, torch.bfloat16)
    want = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    grads = []
    for fused in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        if fused:
            loss = fx.fused_linear_cross_entropy(*leaves, labels, chunk=256)
        else:
            loss = torch.nn.functional.cross_entropy(
                fx.mixed_linear(*leaves, torch.bfloat16), labels,
                reduction="none")
        loss.mean().backward()
        grads.append([t.grad for t in leaves])
    for g_dense, g_fused in zip(*grads):
        scale = float(g_dense.abs().max())
        assert float((g_fused - g_dense).abs().max()) <= 2.0 ** -8 * scale


# ------------------------------------------- the wire kernels' operators


def _op_cases(device):
    x = _wire_input(device, 100_003)
    rows = _wire_input(device, 4 * 2501, seed=1).view(4, 2501)
    q, s = ck.int8_quantize(x, seed=3, stream=1)
    b = _wire_input(device, 100_003, seed=2)
    dots = ck.adasum_dots(x, b)
    return {
        "scale_cast": ((q, s, torch.bfloat16),
                       lambda: ck.scale_cast(q, s, torch.bfloat16)),
        "int8_quantize": ((x, 3, 1), lambda: ck.int8_quantize(x, 3, 1)),
        "int8_block_quantize": ((rows, 512, 5, 2, True),
                                lambda: ck.int8_block_quantize(
                                    rows, 512, 5, 2, True)),
        "int8_block_quantize_flat": ((x, 64, 5, 2, False),
                                     lambda: ck.int8_block_quantize(
                                         x, 64, 5, 2, False)),
        "adasum_dots": ((x, b), lambda: ck.adasum_dots(x, b)),
        "adasum_apply": ((x, b, dots), lambda: ck.adasum_apply(x, b, dots)),
    }


@pytest.mark.parametrize("name", ["scale_cast", "int8_quantize",
                                  "int8_block_quantize",
                                  "int8_block_quantize_flat", "adasum_dots",
                                  "adasum_apply"])
def test_custom_op_equals_wrapper_and_fake(cuda_card, name):
    """Each wire kernel's ``torch.library`` operator (the form a compiled
    step reaches) launches the kernel: bitwise its direct wrapper's
    output, one launch of the wrapper's counter a call; its fake gives the
    real output's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args, direct = _op_cases(cuda_card)[name]
    op = getattr(ck.OPS, name.replace("_flat", ""))
    counter = {"scale_cast": ck.scale_cast, "int8_quantize": ck.int8_quantize,
               "adasum_dots": ck.adasum_dots,
               "adasum_apply": ck.adasum_apply}.get(
                   name.replace("_flat", ""), ck.int8_block_quantize)
    before = counter.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = direct()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, g in zip(fake, got):
        assert f.shape == g.shape and f.dtype == g.dtype
