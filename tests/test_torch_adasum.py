"""The port's Adasum (``horovod_tpu_torch/ops/adasum.py``) against the
JAX package's, in gloo worlds of 1, 2, 3, 4, 5, 6 and 8 processes.

Every rank of a world runs the same program (``_adasum_worker``) on
inputs made from one numpy seed, rank r taking row r: VHDD Adasum over
the world in fp32 (13 elements, so every halving stage pads) and bf16,
identical inputs on every rank, and process-set Adasum over the ranks
{0, 2, 3, ...} (allgather over the set plus the tree). The tests hold
each rank's result against the port's numpy host oracle and the JAX
package's, within 1e-5 relative (fp32 dots in another order than the
oracle's fp64), and against JAX ``adasum_allreduce`` on as many
devices of the 8-device CPU mesh of tests/conftest.py, with the same
per-rank inputs. On the CPU the port runs B4's plain versions."""

from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import adasum as port_adasum

from test_torch_collectives import _run, file_store

# the ranks load this file too: the JAX side is imported by the tests
# alone, inside them


def _jax_adasum():
    from horovod_tpu.ops import adasum

    return adasum

WORLDS = [1, 2, 3, 4, 5, 6, 8]
WIDTH = 13


def _stack(n, seed=0):
    rng = np.random.default_rng(100 + seed)
    return rng.normal(size=(n, WIDTH)).astype(np.float32)


def _set_ranks(n):
    return [r for r in range(n) if r != 1] if n > 2 else [0]


def _adasum_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    x = torch.from_numpy(_stack(n)[rank])
    out["vhdd"] = hvd.adasum_allreduce(x)
    out["eager"] = hvd.allreduce(x, op=hvd.Adasum)
    out["matrix"] = hvd.adasum_allreduce(
        torch.from_numpy(np.tile(_stack(n, 1)[rank], 2).reshape(2, WIDTH)))
    out["bf16"] = hvd.adasum_allreduce(x.to(torch.bfloat16))
    base = torch.linspace(-1.0, 1.0, 16)
    out["identical"] = hvd.adasum_allreduce(base.clone())
    ps = hvd.add_process_set(_set_ranks(n))
    out["set"] = port_adasum.adasum_allreduce(x, process_set=ps)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    n = request.param
    return n, _run(tmp_path_factory.mktemp(f"adasum{n}"), n, Path(__file__),
                   "_adasum_worker", 120, None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-5, atol=1e-6)


def test_vhdd_matches_host_oracles(world):
    n, outs = world
    stack = _stack(n).astype(np.float64)
    jax_adasum = _jax_adasum()
    want = port_adasum.adasum_vhdd_host(stack)
    np.testing.assert_allclose(want, jax_adasum.adasum_vhdd_host(stack),
                               rtol=1e-12)
    mat = np.stack([np.tile(r, 2) for r in _stack(n, 1)]).astype(np.float64)
    want_mat = jax_adasum.adasum_vhdd_host(mat).reshape(2, WIDTH)
    for o in outs:
        _close(o["vhdd"].numpy(), want)
        _close(o["eager"].numpy(), want)
        _close(o["matrix"].numpy(), want_mat)
    # every rank holds the same bits
    for o in outs[1:]:
        assert torch.equal(o["vhdd"], outs[0]["vhdd"])


def test_identical_inputs_are_the_identity(world):
    _, outs = world
    base = np.linspace(-1.0, 1.0, 16)
    for o in outs:
        _close(o["identical"].numpy(), base)


def test_bf16_keeps_dtype(world):
    n, outs = world
    want = port_adasum.adasum_vhdd_host(
        _stack(n).astype(np.float64))
    for o in outs:
        assert o["bf16"].dtype == torch.bfloat16
        # bf16 inputs and one bf16 rounding of the fp32 result
        np.testing.assert_allclose(o["bf16"].float().numpy(), want,
                                   rtol=2e-2, atol=2e-2)


def test_process_set_matches_tree_oracle(world):
    n, outs = world
    ranks = _set_ranks(n)
    stack = _stack(n)
    jax_adasum = _jax_adasum()
    want = port_adasum.adasum_tree_host(stack[ranks].astype(np.float64))
    np.testing.assert_allclose(
        want, jax_adasum.adasum_tree_host(stack[ranks].astype(np.float64)),
        rtol=1e-12)
    for r, o in enumerate(outs):
        if r in ranks:
            _close(o["set"].numpy(), want)
        else:  # non-members keep their input
            assert np.array_equal(o["set"].numpy(), stack[r])


def test_vhdd_matches_jax_mesh(world):
    """The same per-rank inputs through JAX ``adasum_allreduce`` on as
    many devices of the CPU mesh as the world has ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    n, outs = world
    jax_adasum = _jax_adasum()
    stack = _stack(n)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("world",))
    fn = jax.shard_map(
        lambda x: jax_adasum.adasum_allreduce(x[0], axis_name="world")[None],
        mesh=mesh, in_specs=P("world"), out_specs=P("world"),
        check_vma=False,
    )
    want = np.asarray(jax.jit(fn)(jnp.asarray(stack)))
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["vhdd"].numpy(), want[r], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("n", range(1, 17))
def test_vhdd_wire_bytes_match_jax(n):
    jax_adasum = _jax_adasum()
    for payload in (1 << 20, 12345):
        assert port_adasum.vhdd_wire_bytes(n, payload) == \
            jax_adasum.vhdd_wire_bytes(n, payload)


def test_hierarchical_raises():
    """Hierarchical Adasum composes with the whole two-level world only:
    a process set raises, as in the reference, and so does an unknown
    inter wire (its two-level worlds run in
    tests/test_torch_hier_route.py)."""
    from horovod_tpu_torch.common.process_sets import ProcessSet

    with pytest.raises(NotImplementedError, match="process set"):
        port_adasum.adasum_allreduce(torch.ones(3), hierarchical=True,
                                     process_set=ProcessSet([0]))
    with pytest.raises(ValueError, match="inter_wire"):
        port_adasum.adasum_allreduce(torch.ones(3), hierarchical=True,
                                     inter_wire="fp16")


def test_tree_combine_matches_jax_tree():
    """The tree on one process: the port's pairwise order and odd carry
    against JAX ``_tree_combine`` on the same five vectors."""
    import jax.numpy as jnp

    jax_adasum = _jax_adasum()
    stack = np.random.default_rng(5).normal(size=(5, 33)).astype(np.float32)
    got = port_adasum._tree_combine(list(torch.from_numpy(stack)))
    want = jax_adasum._tree_combine([jnp.asarray(s) for s in stack])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    a, b = (torch.from_numpy(s) for s in stack[:2].astype(np.float16))
    np.testing.assert_allclose(
        port_adasum._pair_f32(a, b).numpy(),
        np.asarray(jax_adasum._pair_f32(jnp.asarray(stack[0].astype(
            np.float16)).astype(jnp.float32), jnp.asarray(stack[1].astype(
                np.float16)).astype(jnp.float32))),
        rtol=1e-5, atol=1e-6)
