"""The port's remaining eager collectives (``horovod_tpu_torch/ops/
eager.py``): alltoall, reducescatter, the grouped allgather and
reducescatter, ``flush`` and join, and the basics the package exports
beside them, in gloo worlds of 2, 4 and 6 processes on the CPU (the flat
route; tests/test_torch_hier_route.py runs the two-level one).

Every rank runs ``_rest_worker`` on inputs made from one numpy seed,
rank r taking row r. The oracle is the JAX package: its traced
``alltoall``, ``reducescatter``, ``allgather`` and ``allreduce`` with the
join mask on as many devices of the 8-device CPU mesh of
tests/conftest.py, and, for the uneven cases the traced functions do
not take, the closed forms of tests/test_ops_eager.py:186-320 and
tests/test_op_matrix.py:88-170, whose split rule (the earlier ranks one
extra row) the JAX eager API is checked to follow on its own mesh.

Tolerances: integer-valued inputs, so every result is compared bitwise;
the int8 wire under a join mask within 3 quanta (``max|mean| / 127``)
of the masked mean, every rank equal; Adasum under a join mask 1e-5
relative of the fp64 host oracle over the active ranks.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLDS = [2, 4, 6]


def _ints(n, shape, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n,) + tuple(shape)).astype(np.float32)


def _rs_rows(total, n, r):
    """Rank r's rows of a dim 0 of ``total`` rows scattered over n ranks,
    the earlier ranks one extra."""
    base, rem = divmod(total, n)
    off = r * base + min(r, rem)
    return slice(off, off + base + (r < rem))


def _rest_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu", store=file_store(outdir, n))
    fusion = basics.state().fusion
    out = {}
    # alltoall: equal slices, every dtype, and splits
    for dtype in (torch.float32, torch.int32):
        out[f"a2a_{dtype}"] = hvd.alltoall(
            (torch.arange(2 * n) % n + 100 * rank).to(dtype))
    rows = torch.full((sum(j + 1 for j in range(n)), 2), float(rank))
    out["a2a_v"] = hvd.alltoall(rows, splits=[j + 1 for j in range(n)])
    h = hvd.alltoall_async(torch.from_numpy(_ints(n, (3 * n, 2), 1)[rank]))
    out["a2a_async"] = h.wait()
    ps = hvd.add_process_set([0, n - 1])
    if rank in (0, n - 1):
        out["a2a_set"] = hvd.alltoall(torch.full((6, 2), float(rank)),
                                      splits=[2, 4], process_set=ps)
        out["rs_set"] = hvd.reducescatter(
            torch.from_numpy(_ints(n, (4, 3), 2)[rank]), op=hvd.Sum,
            process_set=ps)
    # reducescatter: even, uneven, Average, scale factors, dtypes
    x = torch.from_numpy(_ints(n, (2 * n, 3), 3)[rank])
    out["rs"] = hvd.reducescatter(x, op=hvd.Sum)
    out["rs_avg"] = hvd.reducescatter(x)
    out["rs_scaled"] = hvd.reducescatter(x, op=hvd.Sum, prescale_factor=0.5,
                                         postscale_factor=4.0)
    out["rs_uneven"] = hvd.reducescatter(
        torch.from_numpy(_ints(n, (n + 3,), 4)[rank]), op=hvd.Sum)
    out["rs_short"] = hvd.reducescatter(
        torch.from_numpy(_ints(n, (n - 1, 2), 5)[rank]), op=hvd.Sum)
    for dtype in (torch.int32, torch.uint8, torch.bfloat16):
        out[f"rs_{dtype}"] = hvd.reducescatter(
            torch.full((2 * n, 3), rank, dtype=dtype), op=hvd.Sum)
    # grouped
    d0 = fusion.dispatched_batches
    out["grs"] = hvd.grouped_reducescatter(
        [x, torch.from_numpy(_ints(n, (n + 1, 2), 6)[rank])], op=hvd.Sum)
    out["grs_batches"] = fusion.dispatched_batches - d0
    out["gag"] = hvd.grouped_allgather(
        [torch.full((rank + 1, 3), float(rank + i)) for i in range(3)])
    # flush: a pending batch goes out now
    h = hvd.allreduce_async(torch.full((4,), float(rank)), op=hvd.Sum)
    d0 = fusion.dispatched_batches
    hvd.flush()
    out["flushed"] = fusion.dispatched_batches - d0
    out["flush_result"] = h.wait()
    # join
    out["mask_outside"] = hvd.current_join_mask()
    y = torch.from_numpy(_ints(n, (24,), 7)[rank])
    with hvd.join_ranks([n - 1]):
        out["mask_inside"] = hvd.current_join_mask().tolist()
        out["join_avg"] = hvd.allreduce(y)
        out["join_sum"] = hvd.allreduce(y, op=hvd.Sum)
        out["join_min"] = hvd.allreduce(y, op=hvd.Min)
        out["join_int"] = hvd.allreduce(y.to(torch.int32), op=hvd.Sum)
        out["join_int8"] = hvd.allreduce(
            torch.from_numpy(np.random.default_rng(8).normal(
                size=(n, 300)).astype(np.float32)[rank]),
            compression=hvd.Compression.int8)
        out["join_adasum"] = hvd.allreduce(
            torch.from_numpy(np.random.default_rng(9).normal(
                size=(n, 13)).astype(np.float32)[rank]), op=hvd.Adasum)
    with hvd.join_ranks([0]):
        out["join_first"] = hvd.allreduce(y, op=hvd.Sum)
    out["join_last"] = hvd.join([0, n - 1])
    out["join_none"] = hvd.join()
    # the exported basics
    out["basics"] = {
        "ids": hvd.get_process_set_ids(),
        "set_ranks": hvd.get_process_set(ps.process_set_id).ranks,
        "homogeneous": hvd.is_homogeneous(),
        "topology": (hvd.topology().size, hvd.topology().local_size),
        "config_threshold": hvd.get_config().fusion_threshold_bytes,
        "built": [f() for f in (hvd.nccl_built, hvd.gloo_built,
                                hvd.cuda_built, hvd.gloo_enabled,
                                hvd.mpi_built, hvd.mpi_enabled,
                                hvd.ddl_built, hvd.ccl_built,
                                hvd.rocm_built, hvd.xla_built)],
        "interrupt": issubclass(hvd.HostsUpdatedInterrupt, Exception),
    }
    # the pair exchange composed from all_to_all_single on a gloo group:
    # ranks 0 and 1 swap, the rest take part idle
    from horovod_tpu_torch.ops import _collectives

    out["backend"] = _collectives._backend(None, torch.device("cpu"))
    mine = torch.arange(5, dtype=torch.float32) + 10 * rank
    if rank < 2:
        got = torch.empty_like(mine)
        _collectives.exchange(mine, got, rank ^ 1)
        out["exchanged"] = got
    else:
        _collectives.exchange(None, None, None, like=mine)
    # misuse raises at the call, and leaves the world usable
    errors = []
    for call in (lambda: hvd.reducescatter(x, op=hvd.Min),
                 lambda: hvd.reducescatter(torch.tensor(1.0)),
                 lambda: hvd.alltoall(torch.ones(2 * n + 1)),
                 lambda: hvd.alltoall(torch.ones(n), splits=[n] + [1] * (
                     n - 1)),
                 lambda: hvd.alltoall(torch.ones(n), splits=[1])):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    out["after_errors"] = hvd.allreduce(torch.ones(2), op=hvd.Sum)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    n = request.param
    return n, _run(tmp_path_factory.mktemp(f"rest{n}"), n, Path(__file__),
                   "_rest_worker", 150, None)


def _sm(fn, n):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("hvd"),
                                 out_specs=P("hvd"), check_vma=False))


def test_alltoall_matches_jax(world):
    from horovod_tpu.ops import traced

    n, outs = world
    sent = np.stack([np.arange(2 * n) % n + 100 * r for r in range(n)])
    want = np.asarray(_sm(lambda v: traced.alltoall(v[0])[None], n)(
        sent.astype(np.float32)))
    per = _ints(n, (3 * n, 2), 1)
    want_async = np.asarray(_sm(lambda v: traced.alltoall(v[0])[None], n)(
        per))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["a2a_torch.float32"].numpy(),
                                      want[r])
        assert o["a2a_torch.int32"].dtype == torch.int32
        np.testing.assert_array_equal(o["a2a_torch.int32"].numpy(),
                                      want[r].astype(np.int32))
        np.testing.assert_array_equal(o["a2a_async"].numpy(), want_async[r])


def test_alltoall_with_splits(world):
    """Rank r sends j+1 rows to rank j (``tests/test_ops_eager.py``'s
    uneven case): rank j receives j+1 rows from each rank, in rank
    order, and the received splits say so."""
    n, outs = world
    for j, o in enumerate(outs):
        got, splits = o["a2a_v"]
        assert splits.tolist() == [j + 1] * n
        want = np.concatenate([np.full((j + 1, 2), float(r))
                               for r in range(n)])
        np.testing.assert_array_equal(got.numpy(), want)
    # a process set of the first and last rank: positions 0 and 1
    for pos, r in enumerate((0, n - 1)):
        got, splits = outs[r]["a2a_set"]
        rows = [2, 4][pos]
        assert splits.tolist() == [rows, rows]
        np.testing.assert_array_equal(
            got[:, 0].numpy(), [0.0] * rows + [float(n - 1)] * rows)


def test_reducescatter_matches_jax(world):
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, outs = world
    x = _ints(n, (2 * n, 3), 3)
    want = np.asarray(_sm(lambda v: traced.reducescatter(
        v[0], op=Sum)[None], n)(x))
    want_avg = np.asarray(_sm(lambda v: traced.reducescatter(
        v[0], op=Average)[None], n)(x))
    want_scaled = np.asarray(_sm(lambda v: traced.reducescatter(
        v[0], op=Sum, prescale_factor=0.5, postscale_factor=4.0)[None],
        n)(x))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["rs"].numpy(), want[r])
        np.testing.assert_array_equal(o["rs_avg"].numpy(), want_avg[r])
        np.testing.assert_array_equal(o["rs_scaled"].numpy(), want_scaled[r])
        np.testing.assert_array_equal(o["grs"][0].numpy(), want[r])
        for dtype in (torch.int32, torch.uint8, torch.bfloat16):
            got = o[f"rs_{dtype}"]
            assert got.dtype == dtype and got.shape == (2, 3)
            assert torch.equal(got.float(), torch.full(
                (2, 3), float(sum(range(n)))))


def test_reducescatter_uneven_closed_form(world):
    n, outs = world
    uneven = _ints(n, (n + 3,), 4).sum(0)
    short = _ints(n, (n - 1, 2), 5).sum(0)
    grouped = _ints(n, (n + 1, 2), 6).sum(0)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["rs_uneven"].numpy(),
                                      uneven[_rs_rows(n + 3, n, r)])
        got = o["rs_short"].numpy()
        assert got.shape == ((1, 2) if r < n - 1 else (0, 2))
        np.testing.assert_array_equal(got, short[_rs_rows(n - 1, n, r)])
        np.testing.assert_array_equal(o["grs"][1].numpy(),
                                      grouped[_rs_rows(n + 1, n, r)])
        assert o["grs_batches"] == 1  # the group is one collective
    members = [0, n - 1]
    total = _ints(n, (4, 3), 2)[members].sum(0)
    for pos, r in enumerate(members):
        np.testing.assert_array_equal(outs[r]["rs_set"].numpy(),
                                      total[2 * pos:2 * pos + 2])


def test_uneven_split_rule_is_the_jax_eager_one(hvd):
    """The closed form above follows the JAX eager API's rule on its own
    8-rank mesh (``tests/test_ops_eager.py:test_reducescatter_uneven``)."""
    import horovod_tpu as jhvd

    x = jhvd.shard_from_rank_fn(lambda r: np.arange(11.0) + r, hvd.mesh())
    got = hvd.reducescatter(x, op=hvd.Sum)
    total = 8 * np.arange(11.0) + 28.0
    for r in range(8):
        np.testing.assert_array_equal(np.asarray(got[r]),
                                      total[_rs_rows(11, 8, r)])


def test_grouped_allgather_and_flush(world):
    n, outs = world
    for o in outs:
        for i, got in enumerate(o["gag"]):
            want = np.concatenate([np.full((r + 1, 3), float(r + i))
                                   for r in range(n)])
            np.testing.assert_array_equal(got.numpy(), want)
        assert o["flushed"] == 1
        np.testing.assert_array_equal(o["flush_result"].numpy(),
                                      np.full(4, float(sum(range(n)))))


def test_join_mask_matches_jax(world):
    """Joined ranks contribute nothing and Average divides by the active
    count, against JAX ``traced.allreduce(mask=)`` on the same rows;
    Min skips the joined rank; integers and the int8 wire take the mask
    too; ``join`` returns the last joined rank, or -1."""
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Average, Sum
    from horovod_tpu_torch.ops import adasum as padasum

    n, outs = world
    y = _ints(n, (24,), 7)
    mask = np.array([True] * (n - 1) + [False])
    want_avg = np.asarray(_sm(lambda v: traced.allreduce(
        v, op=Average, mask=mask), n)(y))
    want_sum = np.asarray(_sm(lambda v: traced.allreduce(
        v, op=Sum, mask=mask), n)(y))
    rows = np.random.default_rng(8).normal(size=(n, 300)).astype(
        np.float32)
    mean = rows[:n - 1].mean(0)
    ada = np.random.default_rng(9).normal(size=(n, 13))
    want_ada = padasum.adasum_vhdd_host(
        np.concatenate([ada[:n - 1], np.zeros((1, 13))]))
    for r, o in enumerate(outs):
        assert o["mask_outside"] is None
        assert o["mask_inside"] == mask.tolist()
        np.testing.assert_array_equal(o["join_avg"].numpy(), want_avg[r])
        np.testing.assert_array_equal(o["join_sum"].numpy(), want_sum[r])
        np.testing.assert_array_equal(o["join_min"].numpy(),
                                      y[:n - 1].min(0))
        np.testing.assert_array_equal(o["join_int"].numpy(),
                                      y[:n - 1].sum(0).astype(np.int32))
        np.testing.assert_array_equal(o["join_first"].numpy(),
                                      y[1:].sum(0))
        assert np.abs(o["join_int8"].numpy() - mean).max() < 3.0 * (
            np.abs(mean).max() / 127.0)
        assert torch.equal(o["join_int8"], outs[0]["join_int8"])
        np.testing.assert_allclose(o["join_adasum"].numpy(), want_ada,
                                   rtol=1e-5, atol=1e-6)
        assert (o["join_last"], o["join_none"]) == (n - 1, -1)


def test_join_return_values_are_the_jax_eager_ones(hvd):
    assert hvd.join([2, 5]) == 5 and hvd.join() == -1


def test_pair_exchange_composed_on_gloo(world):
    """gloo takes no point-to-point call on CUDA tensors, so on a gloo
    group ``_collectives.exchange`` is an ``all_to_all_single`` that
    every rank joins: ranks 0 and 1 swap their tensors while the others
    send and receive nothing."""
    n, outs = world
    for r, o in enumerate(outs):
        assert o["backend"] == "gloo"
        if r < 2:
            assert torch.equal(o["exchanged"], torch.arange(
                5, dtype=torch.float32) + 10 * (r ^ 1))
        else:
            assert "exchanged" not in o


def test_exported_basics_and_misuse(world):
    n, outs = world
    for o in outs:
        b = o["basics"]
        assert b["ids"] == [0, 1] if n > 2 else b["ids"] == [0]
        assert b["set_ranks"] == [0, n - 1]
        assert b["homogeneous"] and b["topology"] == (n, n)
        assert b["config_threshold"] == 64 * 1024 * 1024
        assert b["built"] == [True, True, True, True] + [False] * 6
        assert b["interrupt"]
        assert len(o["errors"]) == 5
        assert "Sum and Average" in o["errors"][0]
        assert all("alltoall" in e for e in o["errors"][2:])
        assert torch.equal(o["after_errors"], torch.full((2,), float(n)))
