"""The port's flash attention (horovod_tpu_torch/ops/flash_attention.py)
against the JAX package's (horovod_tpu/ops/flash_attention.py, Pallas in
interpret mode on the CPU, as tests/test_flash_attention.py runs it).

The same numpy inputs go through both: the plain forward's ``o`` and
``lse`` against the JAX forward's, and the autograd Function's
gradients against ``jax.vjp`` of the JAX function, for causal and
bidirectional attention, ``lengths``, GQA, ``window`` and their
composition. fp32 within 1e-5 (both sides compute in fp32 and differ in
the order of sums); bf16 inputs within one bf16 rounding of each output
(rtol 2^-7, plus 2^-10 absolute for fp32 sums near zero). The plain
backward is also held to finite differences by ``gradcheck`` in
float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5
CASES = {
    "full": dict(b=2, t=24, h=2, kvh=2, d=8, causal=False),
    "causal": dict(b=2, t=32, h=2, kvh=2, d=16, causal=True),
    "lengths": dict(b=3, t=24, h=2, kvh=2, d=8, causal=True,
                    lengths=[24, 11, 1]),
    "lengths-full": dict(b=2, t=16, h=2, kvh=2, d=8, causal=False,
                         lengths=[9, 16]),
    "gqa": dict(b=2, t=16, h=4, kvh=2, d=8, causal=True),
    "window": dict(b=1, t=32, h=2, kvh=2, d=8, causal=True, window=5),
    "gqa-lengths-window": dict(b=2, t=32, h=4, kvh=1, d=8, causal=True,
                               lengths=[32, 19], window=7),
}


def _inputs(b, t, h, kvh, d, causal, lengths=None, window=None, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, t, h, d), (b, t, kvh, d), (b, t, kvh, d),
                      (b, t, h, d))]
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    return arrs, dict(causal=causal, window=window), lens


def _jax_out_and_grads(q, k, v, w, kw, lens, dtype=jnp.float32):
    """JAX flash output and the vjp of ``sum(o * w)``, as fp32 numpy."""
    def f(q, k, v):
        return jfa.flash_attention(
            q, k, v, lengths=None if lens is None else jnp.asarray(lens),
            **kw,
        )

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(w, dtype))
    return [np.asarray(x, np.float32) for x in (o, *grads)]


def _torch_out_and_grads(q, k, v, w, kw, lens, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(
        *args, lengths=None if lens is None else torch.from_numpy(lens), **kw
    )
    (o.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy() for x in (o, *(a.grad for a in args))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_lse_match_jax(name):
    (q, k, v, _), kw, lens = _inputs(**CASES[name])
    b, t, h, d = q.shape
    r = h // k.shape[2]

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, t, d)

    block = jfa._pick_block(t)
    lens_bh = None
    if lens is not None:
        lens_bh = jnp.repeat(jnp.asarray(lens), h)[:, None]
    window = kw["window"] if kw["window"] and kw["window"] < t else None
    o_j, lse_j = jfa._flash_fwd(bhtd(q), bhtd(k), bhtd(v), kw["causal"],
                                block, block, lens=lens_bh, h_per_kv=r,
                                window=window)
    o_t, lse_t = tfa.flash_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), kw["causal"],
        None if lens is None else torch.from_numpy(lens), kw["window"],
    )
    o_j = np.asarray(o_j).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j)[..., 0].reshape(b, h, t)
    o_t, lse_t = o_t.numpy(), lse_t.numpy().reshape(b, h, t)
    # the raw forward at padded query rows is the wrapper's to zero (a
    # padded row whose window holds no live key differs: the reference
    # averages the masked scores there, the port gives 0); compare the
    # rows the contract keeps
    live = np.ones((b, t), bool)
    if lens is not None:
        live = np.arange(t)[None, :] < lens[:, None]
    np.testing.assert_allclose(o_t[live], o_j[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.transpose(0, 2, 1)[live],
                               lse_j.transpose(0, 2, 1)[live],
                               atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    (q, k, v, w), kw, lens = _inputs(**CASES[name], seed=1)
    want = _jax_out_and_grads(q, k, v, w, kw, lens)
    got = _torch_out_and_grads(q, k, v, w, kw, lens)
    for label, g, j in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, j, atol=ATOL, rtol=0, err_msg=label)
    if lens is not None:  # padded query rows: zero output, zero dq
        t = q.shape[1]
        pad = np.arange(t)[None, :] >= lens[:, None]
        assert not got[0][pad].any() and not got[1][pad].any()


@pytest.mark.parametrize("name", ["causal", "gqa-lengths-window"])
def test_bf16_within_one_rounding(name):
    (q, k, v, w), kw, lens = _inputs(**CASES[name], seed=2)
    q, k, v, w = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                  for x in (q, k, v, w))  # bf16-representable inputs
    want = _jax_out_and_grads(q, k, v, w, kw, lens, jnp.bfloat16)
    got = _torch_out_and_grads(q, k, v, w, kw, lens, torch.bfloat16)
    for label, g, j in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, j, atol=2.0 ** -10, rtol=2.0 ** -7,
                                   err_msg=label)


@pytest.fixture
def one_thread():
    """Tiny float64 ops gain nothing from torch's intra-op threads, and
    beside other test processes the threads only contend for the cores:
    run on one, then restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["causal", "gqa-lengths-window",
                                  "lengths-full"])
def test_plain_backward_gradcheck(name):
    """The Function (plain forward and backward on the CPU) against
    finite differences in float64."""
    cfg = dict(CASES[name], t=9, b=2)
    if cfg.get("lengths"):
        cfg["lengths"] = [9, 4]
    if cfg.get("window"):
        cfg["window"] = 3
    (q, k, v, _), kw, lens = _inputs(**cfg, seed=3)
    args = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    lens_t = None if lens is None else torch.from_numpy(lens)

    def f(q, k, v):
        return tfa.flash_attention(q, k, v, lengths=lens_t, **kw)

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-6)


def test_validation_matches_reference():
    q = torch.zeros(1, 8, 4, 8)
    with pytest.raises(ValueError, match="window= requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="window must be >= 1"):
        tfa.flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="kv heads"):
        tfa.flash_attention(q, q[:, :, :3], q[:, :, :3], causal=True)
    with pytest.raises(ValueError, match="lengths"):
        tfa.flash_attention(q, q, q, lengths=torch.tensor([1, 2]))
    assert tfa.unsupported_reason(64) is None
    assert "multiple of 8" in tfa.unsupported_reason(20)
    assert "outside" in tfa.unsupported_reason(512)


def test_cpu_wrappers_count_no_launch():
    """CPU tensors take the plain version: the kernel counters stay."""
    (q, k, v, do), kw, _ = _inputs(**CASES["gqa"])
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    counters = (tfa.flash_fwd, tfa.flash_bwd_delta, tfa.flash_bwd_dq,
                tfa.flash_bwd_dkv)
    before = [c.launches for c in counters] + [
        tfa.flash_bwd_dq.tc_launches, tfa.flash_bwd_dkv.tc_launches]
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    tfa.flash_bwd_delta(o, do)
    tfa.flash_bwd_dq(q, k, v, o, lse, do, **kw)
    tfa.flash_bwd_dkv(q, k, v, o, lse, do, **kw)
    assert [c.launches for c in counters] + [
        tfa.flash_bwd_dq.tc_launches, tfa.flash_bwd_dkv.tc_launches] == before
