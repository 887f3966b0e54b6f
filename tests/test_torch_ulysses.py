"""The port's Ulysses sequence parallelism
(``horovod_tpu_torch/parallel/ulysses.py``) against the JAX package's on
the CPU: the same seeded inputs through ``ulysses_attention`` on the
conftest's 8-device mesh and on a gloo world of 8 CPU processes (one
world for the module), the dense inner attention and the flash one
(the JAX kernels in interpret mode, the port's plain versions),
causal and not, grouped-query on an sp of 2; the gradients against
autodiff of dense attention; the head-poor errors. Values within 1e-5
(fp32), gradients within the JAX test's 5e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLD = 8
B, T, H, D = 2, 64, 8, 16
CASES = [(inner, causal) for inner in ("dense", "flash")
         for causal in (False, True)]


def _qkv(seed, kv_heads=H):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    return q, k[:, :, :kv_heads], v[:, :, :kv_heads], w


def _ulysses_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel import MeshSpec, ulysses_attention
    from horovod_tpu_torch.parallel.mesh import world_axis

    hvd.init(device="cpu", store=file_store(outdir, n))
    inner = {"dense": None,
             "flash": lambda q, k, v, c: flash_attention(q, k, v, c)}
    out = {}
    tl = T // n
    sl = slice(rank * tl, (rank + 1) * tl)
    for name, causal in CASES:
        q, k, v, w = (torch.from_numpy(a) for a in _qkv(3))
        ql, kl, vl = (a[:, sl].clone().requires_grad_() for a in (q, k, v))
        o = ulysses_attention(ql, kl, vl, axis=world_axis(), causal=causal,
                              attn_fn=inner[name])
        (o.float() ** 2).sum().backward()
        out[(name, causal)] = [o.detach(), ql.grad, kl.grad, vl.grad]
    # grouped-query over an sp of 2 (ranks 0 and 1)
    m2 = MeshSpec(sp=2).build([0, 1])
    if m2.member:
        t2 = T // 2
        s2 = slice(rank * t2, (rank + 1) * t2)
        for name, causal in CASES:
            q, k, v, _ = (torch.from_numpy(a) for a in _qkv(4, kv_heads=4))
            o = ulysses_attention(q[:, s2], k[:, s2], v[:, s2],
                                  axis=m2.axis("sp"), causal=causal,
                                  attn_fn=inner[name])
            out[("gqa", name, causal)] = o
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("ulysses"), WORLD, Path(__file__),
                "_ulysses_worker", 180, None)


def _jax_ulysses(q, k, v, causal, inner, n, axis="sp"):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops.flash_attention import flash_attention
    from horovod_tpu.parallel.ulysses import ulysses_attention

    fn = flash_attention if inner == "flash" else None
    mesh = Mesh(np.asarray(jax.devices()[:n]), (axis,))
    f = jax.jit(jax.shard_map(
        lambda q, k, v: ulysses_attention(q, k, v, axis_name=axis,
                                          causal=causal, attn_fn=fn),
        mesh=mesh, in_specs=(P(None, axis),) * 3, out_specs=P(None, axis),
        check_vma=False))
    return np.asarray(f(q, k, v))


@pytest.mark.parametrize("inner,causal", CASES)
def test_values_match_jax(hvd, world, inner, causal):
    q, k, v, _ = _qkv(3)
    want = _jax_ulysses(q, k, v, causal, inner, WORLD)
    tl = T // WORLD
    for r, out in enumerate(world):
        np.testing.assert_allclose(
            np.asarray(out[(inner, causal)][0]),
            want[:, r * tl:(r + 1) * tl], rtol=1e-5, atol=1e-5,
            err_msg=f"rank {r}")


@pytest.mark.parametrize("inner,causal", CASES)
def test_gradients_match_dense_autodiff(hvd, world, inner, causal):
    """Every rank's dq/dk/dv of its share of sum(out²) against
    jax.grad of the dense full-sequence loss (the JAX test's oracle)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel.ulysses import _dense_attention

    q, k, v, _ = _qkv(3)

    def loss(q, k, v):
        return jnp.sum(_dense_attention(q, k, v, causal).astype(
            jnp.float32) ** 2)

    want = [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    tl = T // WORLD
    for r, out in enumerate(world):
        for label, got, g in zip("qkv", out[(inner, causal)][1:], want):
            np.testing.assert_allclose(
                np.asarray(got), g[:, r * tl:(r + 1) * tl], rtol=5e-4,
                atol=5e-4, err_msg=f"rank {r} d{label}")


@pytest.mark.parametrize("inner,causal", CASES)
def test_gqa_matches_jax(hvd, world, inner, causal):
    q, k, v, _ = _qkv(4, kv_heads=4)
    want = _jax_ulysses(q, k, v, causal, inner, 2)
    t2 = T // 2
    for r in range(2):
        np.testing.assert_allclose(
            np.asarray(world[r][("gqa", inner, causal)]),
            want[:, r * t2:(r + 1) * t2], rtol=1e-5, atol=1e-5)


def _axis(size):
    from horovod_tpu_torch.parallel.mesh import Axis

    ranks = tuple(range(size))
    return Axis("sp", None, ranks, 0, size, (ranks,))


def test_head_poor_model_rejected():
    from horovod_tpu_torch.parallel import ulysses_attention

    x = torch.zeros((1, 8, 4, 8))  # 4 heads < sp = 8
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(x, x, x, axis=_axis(8))
    # head-poor grouped-query: 8 q heads but 4 kv heads over sp = 8
    q = torch.zeros((1, 8, 8, 8))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, x, x, axis=_axis(8))


def test_dense_inner_matches_independent_oracle():
    """The inner dense attention against the conftest's oracle."""
    import jax.numpy as jnp

    from conftest import dense_attention_oracle
    from horovod_tpu_torch.parallel.ulysses import _dense_attention

    q, k, v, _ = _qkv(5)
    for causal in (False, True):
        want = np.asarray(dense_attention_oracle(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
        got = _dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
