"""The port's two-level route (``horovod_tpu_torch/ops/fusion.py``'s
``_allreduce_hier``, reducescatter and allgather, hierarchical Adasum,
``Compression.hier_int8`` and ``DistributedOptimizer``'s error feedback
on it) in gloo worlds on the CPU, against the JAX package.

Worlds: 4 ranks with ``HOROVOD_INTRA_SIZE=2`` (2 nodes of 2), 6 ranks
with ``HOROVOD_INTRA_SIZE=4``, which degrades to gcd 2 (3 nodes of 2),
and 2 ranks with no intra size, where the hierarchy degenerates and
every batch stays flat. Every rank runs ``_hier_worker`` with
``HOROVOD_HIERARCHICAL=on`` on inputs made from one numpy seed, rank r
taking row r, then again after ``init`` with ``HOROVOD_HIERARCHICAL=off``
for the flat route. The oracle is the JAX package on as many devices of
the 8-device CPU mesh of tests/conftest.py: ``hierarchy_stages``,
``traced.hierarchical_allreduce_groups``, ``hierarchical_reducescatter``
and ``hierarchical_allgather`` over the same groups,
``traced.allreduce`` with the join mask, the JAX optimizer's
``_allreduce_grads`` under ``Compression.hier_int8``, and hierarchical
``adasum_allreduce`` on a two-axis mesh.

Tolerances (ROADMAP's rules):
- integer-valued fp32 (and small integers on the bf16 wire, whose sums
  stay exact in bf16): bitwise, against JAX and against the port's own
  flat route;
- random fp32 on the exact route: 8 ulp of the largest sum (a few
  roundings of reassociation, the JAX test's bound);
- the int8 inter hop (stochastic rounding: the port's Philox and
  ``jax.random`` differ): within 3 quanta (``max|sum| / 127``) of the
  exact sum, as the JAX test holds JAX itself, and within 6 of JAX's
  result; two chained error-feedback steps within 4 quanta of twice the
  sum; every rank bitwise equal;
- hierarchical Adasum in fp32: 1e-5 relative of the fp64 host oracle
  over the per-node sums (and of JAX); int8 within 6 quanta, every rank
  bitwise equal.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

# (world, HOROVOD_INTRA_SIZE or None, the L the split resolves to)
WORLDS = [(4, "2", 2), (6, "4", 2), (2, None, None)]
SIZES = [37, 8, 1000]


def _ints(n, shape, seed, lo=-100, hi=100):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n,) + tuple(shape)).astype(np.float32)


def _normal(n, size, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size)).astype(np.float32)


def _run_ops(hvd, rank, n, out, tag):
    """The collectives both routes run, keyed by ``tag``."""
    for i, size in enumerate(SIZES):
        x = torch.from_numpy(_ints(n, (size,), i)[rank])
        out[f"{tag}_sum{i}"] = hvd.allreduce(x, op=hvd.Sum)
        out[f"{tag}_avg{i}"] = hvd.allreduce(x, op=hvd.Average)
    x = torch.from_numpy(_ints(n, (16,), 5)[rank])
    out[f"{tag}_scaled"] = hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5,
                                         postscale_factor=2.0)
    small = torch.from_numpy(_ints(n, (40,), 6, -3, 4)[rank])
    out[f"{tag}_bf16"] = hvd.allreduce(small, op=hvd.Sum,
                                       compression=hvd.Compression.bf16)
    out[f"{tag}_normal"] = hvd.allreduce(
        torch.from_numpy(_normal(n, 513, 1)[rank]), op=hvd.Sum)
    panes = torch.from_numpy(_ints(n, (2 * n, 5), 7)[rank])
    out[f"{tag}_rs"] = hvd.reducescatter(panes, op=hvd.Sum)
    out[f"{tag}_rs_avg"] = hvd.reducescatter(panes, op=hvd.Average)
    uneven = torch.from_numpy(_ints(n, (n + 1, 3), 8)[rank])
    out[f"{tag}_rs_uneven"] = hvd.reducescatter(uneven, op=hvd.Sum)
    out[f"{tag}_gather"] = hvd.allgather(
        torch.from_numpy(_ints(n, (5,), 9)[rank]))
    out[f"{tag}_gather_v"] = hvd.allgather(
        torch.full((rank + 1, 2), float(rank)))
    with hvd.join_ranks([n - 1]):
        out[f"{tag}_join"] = hvd.allreduce(
            torch.from_numpy(_ints(n, (48,), 10)[rank]))


def _hier_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import eager

    os.environ["HOROVOD_HIERARCHICAL"] = "on"
    hvd.init(device="cpu", store=file_store(outdir, n))
    fusion = basics.state().fusion
    out = {"local_size": hvd.local_size()}
    h0 = fusion.hier_dispatches
    _run_ops(hvd, rank, n, out, "hier")
    out["route_dispatches"] = fusion.hier_dispatches - h0

    # a process set keeps the batch flat
    ps = hvd.add_process_set(list(range(max(n // 2, 1))))
    h0 = fusion.hier_dispatches
    if ps.included(rank):
        out["set_sum"] = hvd.allreduce(
            torch.from_numpy(_ints(n, (32,), 11)[rank]), op=hvd.Sum,
            process_set=ps)
    out["set_hier"] = fusion.hier_dispatches - h0

    # the int8 inter hop: within quanta, every rank equal, by-hop bytes
    hier_int8 = hvd.Compression.hier_int8.with_block_size(64)
    x = torch.from_numpy(_normal(n, 300, 3)[rank])
    counters = ("wire_bytes_intra", "wire_bytes_inter", "hier_dispatches",
                "handed_bytes_intra", "handed_bytes_inter")
    before = [getattr(fusion, c) for c in counters]
    out["q"] = hvd.allreduce(x, op=hvd.Sum, compression=hier_int8)
    out["q_bytes"] = [getattr(fusion, c) - b
                      for c, b in zip(counters, before)]
    out["q_formats"] = (fusion.last_wire_format_intra,
                        fusion.last_wire_format_inter)
    out["q_avg"] = hvd.allreduce(x, op=hvd.Average,
                                 compression=hvd.Compression.hier_int8)
    with hvd.join_ranks([0]):
        out["q_join"] = hvd.allreduce(x, op=hvd.Average,
                                      compression=hier_int8)

    # error feedback on the two-level route (the optimizer's entry):
    # two chained steps, and the residual shard's bytes on the intra hop
    x = torch.from_numpy(_normal(n, 128, 4)[rank])
    carry = torch.zeros_like(x)
    outs, residuals = [], []
    for step in range(2):
        before = fusion.handed_bytes_intra
        o, carry = eager._submit(*eager._allreduce_entry(
            x + carry, f"ef.{step}", hvd.Sum, 1.0, 1.0, None, hier_int8,
            return_residual=True, two_level=True)).wait()
        outs.append(o)
        residuals.append(carry)
    out["ef"], out["ef_res"] = outs, residuals
    out["ef_handed_intra"] = fusion.handed_bytes_intra - before
    # the eager rule: a residual asked for from the API rides flat int8
    h0 = fusion.hier_dispatches
    out["eager_res"] = hvd.allreduce(x, op=hvd.Sum, compression=hier_int8,
                                     return_residual=True)
    out["eager_res_hier"] = fusion.hier_dispatches - h0
    out["eager_res_format"] = fusion.last_wire_format

    # hierarchical Adasum
    per = _normal(n, 97, 16)[rank]
    out["adasum"] = hvd.adasum_allreduce(torch.from_numpy(per),
                                         hierarchical=True)
    out["adasum_scaled"] = hvd.adasum_allreduce(
        torch.from_numpy(per * 1000.0), hierarchical=True)
    out["adasum_int8"] = hvd.adasum_allreduce(
        torch.from_numpy(per), hierarchical=True, inter_wire="int8", seed=5)
    out["adasum_bf16"] = hvd.adasum_allreduce(
        torch.from_numpy(per), hierarchical=True, inter_wire="bf16")
    try:
        hvd.adasum_allreduce(torch.ones(4), hierarchical=True,
                             process_set=hvd.global_process_set())
        out["adasum_set"] = None
    except NotImplementedError as e:
        out["adasum_set"] = str(e)

    # the optimizer: hier_int8 with error feedback, gradients set by hand
    w = torch.nn.Parameter(torch.zeros(600))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   compression=hvd.Compression.hier_int8,
                                   error_feedback=True)
    h0 = fusion.hier_dispatches
    w.grad = torch.from_numpy(_normal(n, 600, 14)[rank])
    opt.step()
    out["opt_step1"] = -w.detach().clone()
    out["opt_hier"] = fusion.hier_dispatches - h0
    out["opt_residual_norm"] = opt.residual_norm()

    # int8_block with error feedback stays on the flat int8 wire, as the
    # JAX optimizer routes every quantized compressor but hier_int8
    w = torch.nn.Parameter(torch.zeros(600))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   compression=hvd.Compression.int8_block,
                                   error_feedback=True)
    h0 = fusion.hier_dispatches
    w.grad = torch.from_numpy(_normal(n, 600, 15)[rank])
    opt.step()
    out["blk_step1"] = -w.detach().clone()
    out["blk_hier"] = fusion.hier_dispatches - h0
    out["blk_format"] = fusion.last_wire_format
    out["blk_residual"] = opt.state_dict()["ef_residuals"][0]
    out["inflight_after_step"] = len(fusion._inflight)

    # a dispatched entry lets its payload go (the batch packed a copy),
    # keeping its shape; a waited batch leaves the in-flight list
    payload = torch.from_numpy(_normal(n, 64, 17)[rank]).view(8, 8)
    entry, post = eager._allreduce_entry(payload, "payload", hvd.Sum, 1.0,
                                         1.0, None, hier_int8)
    handle = eager._submit(entry, post)
    hvd.flush()
    out["payload_kept"] = (entry.tensor.untyped_storage().data_ptr()
                           == payload.untyped_storage().data_ptr())
    out["payload_shape"] = tuple(entry.tensor.shape)
    out["payload_out"] = handle.wait()
    out["inflight_after_wait"] = len(fusion._inflight)
    hvd.shutdown()

    os.environ["HOROVOD_HIERARCHICAL"] = "off"
    hvd.init(device="cpu", store=file_store(Path(outdir) / "flat", n))
    fusion = basics.state().fusion
    h0 = fusion.hier_dispatches
    _run_ops(hvd, rank, n, out, "flat")
    out["flat_dispatches"] = fusion.hier_dispatches - h0
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=WORLDS,
                ids=[f"world{n}-intra{i}" for n, i, _ in WORLDS])
def world(request, tmp_path_factory):
    n, intra, L = request.param
    env = {"HOROVOD_INTRA_SIZE": intra or ""}
    path = tmp_path_factory.mktemp(f"hier{n}")
    (path / "flat").mkdir()
    return n, L, _run(path, n, Path(__file__), "_hier_worker", 150, env)


def _sm(fn, n, mesh=None, ins=None, outs=None):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = mesh or Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("hvd") if ins is None else ins,
        out_specs=P("hvd") if outs is None else outs, check_vma=False))


def _stages(n, L):
    from horovod_tpu.common import topology as jtopo

    return jtopo.hierarchical_stage_groups(n, L)


def test_stages_resolve_as_the_jax_package(world, monkeypatch):
    """The tri-state, the legacy flag and the gcd degrade, port against
    JAX, on the same environment (``tests/test_hier_wire.py:56-104``)."""
    from horovod_tpu.common import topology as jtopo
    from horovod_tpu_torch.common import topology as ptopo

    n, L, outs = world
    for o in outs:
        assert o["local_size"] == (L or n)
    for key in ("HOROVOD_HIERARCHICAL", "HOROVOD_HIERARCHICAL_ALLREDUCE",
                "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_INTRA_SIZE",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_SIZE"):
        monkeypatch.delenv(key, raising=False)
    cases = [({"HOROVOD_INTRA_SIZE": "4", "HOROVOD_HIERARCHICAL": m}, None)
             for m in ("off", "on", "auto")]
    cases += [({"HOROVOD_HIERARCHICAL": "auto"}, None),
              ({"HOROVOD_HIERARCHICAL": "on"}, None),
              ({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                "HOROVOD_INTRA_SIZE": "2"}, None),
              ({"HOROVOD_HIERARCHICAL_ALLGATHER": "1",
                "HOROVOD_INTRA_SIZE": "2"}, None),
              ({"HOROVOD_HIERARCHICAL": "off",
                "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                "HOROVOD_INTRA_SIZE": "2"}, None),
              ({}, ("on", 4)), ({}, ("on", 5)), ({}, ("on", 1))]
    for env, explicit in cases:
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for w in (n, 8):
            if explicit is None:
                got, want = (ptopo.hierarchy_stages(world=w),
                             jtopo.hierarchy_stages(world=w))
            else:
                mode, intra = explicit
                got = ptopo.hierarchy_stages(world=w, mode=mode, intra=intra)
                want = jtopo.hierarchy_stages(world=w, mode=mode,
                                              intra=intra)
            assert got == (None if want is None else tuple(want)), (env, w)
        for key in env:
            monkeypatch.delenv(key)
    assert ptopo.hierarchy_stages(world=6, mode="on", intra=4) == (
        [[0, 1], [2, 3], [4, 5]], [[0, 2, 4], [1, 3, 5]])
    # a launcher that names more than one node and more than one rank a
    # node is positive evidence for auto
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "2")
    monkeypatch.setenv("HOROVOD_CROSS_SIZE", "4")
    assert ptopo.hierarchy_stages(world=8) == tuple(_stages(8, 2))


def test_routes_taken(world):
    n, L, outs = world
    per_world_batches = 2 * len(SIZES) + 3  # sums, averages, scaled, bf16,
    # and the random one; the masked batch stays flat
    for o in outs:
        assert o["flat_dispatches"] == 0
        assert o["set_hier"] == 0
        if L is None:
            assert o["route_dispatches"] == 0
            assert o["q_bytes"][2] == 0 and o["opt_hier"] == 0
        else:
            assert o["route_dispatches"] == per_world_batches
            assert o["q_bytes"][2] == 1
            assert o["opt_hier"] == 1
            assert o["q_formats"] == ("bf16", "int8")
        assert o["blk_hier"] == 0 and o["blk_format"] == "int8"
        assert o["eager_res_hier"] == 0
        assert o["eager_res_format"] == "int8"


def test_dispatch_lets_payloads_and_waited_batches_go(world):
    """The fusion layer's memory: an allreduce entry's payload is not
    held past dispatch, and neither the optimizer's step nor a wait
    leaves a batch on the in-flight list, whose outputs would otherwise
    live until the next dispatch."""
    n, L, outs = world
    want = _normal(n, 64, 17).sum(0).reshape(8, 8)
    q = _quantum(want)
    for o in outs:
        assert not o["payload_kept"] and o["payload_shape"] == (8, 8)
        assert np.abs(o["payload_out"].numpy() - want).max() < 3.0 * q
        assert o["inflight_after_step"] == 0
        assert o["inflight_after_wait"] == 0


def test_exact_route_bitwise_equal_to_flat_and_jax(world):
    """Integer-valued fp32: the two-level route gives the flat route's
    bits, and JAX's flat psum and two-level recipe's on the same groups
    (``tests/test_hier_wire.py:121-160``)."""
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, L, outs = world
    for i, size in enumerate(SIZES):
        per = _ints(n, (size,), i)
        for key, op in (("sum", Sum), ("avg", Average)):
            flat = np.asarray(_sm(lambda v, op=op: traced.allreduce(
                v, op=op), n)(per))
            if L is not None:
                hier = np.asarray(_sm(
                    lambda v, op=op: traced.hierarchical_allreduce_groups(
                        v[0], op=op, stages=_stages(n, L))[None], n)(per))
                np.testing.assert_array_equal(hier, flat)
            for r, o in enumerate(outs):
                got = o[f"hier_{key}{i}"].numpy()
                np.testing.assert_array_equal(got, o[f"flat_{key}{i}"])
                np.testing.assert_array_equal(got, flat[r])
    per = _ints(n, (16,), 5)
    small = _ints(n, (40,), 6, -3, 4)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["hier_scaled"].numpy(), per.sum(0))
        np.testing.assert_array_equal(o["hier_bf16"].numpy(), small.sum(0))
        np.testing.assert_array_equal(o["hier_bf16"], o["flat_bf16"])


def test_exact_route_ulp_bound_on_random_data(world):
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Sum

    n, L, outs = world
    x = _normal(n, 513, 1)
    want = x.astype(np.float64).sum(0)
    tol = 8 * np.finfo(np.float32).eps * np.abs(want).max()
    if L is not None:
        jax_hier = np.asarray(_sm(lambda v: traced.hierarchical_allreduce_groups(
            v[0], op=Sum, stages=_stages(n, L))[None], n)(x))
        assert np.abs(jax_hier[0] - want).max() <= tol
    for o in outs:
        assert np.abs(o["hier_normal"].numpy() - want).max() <= tol
        assert torch.equal(o["hier_normal"], outs[0]["hier_normal"])


def test_reducescatter_and_allgather_two_level(world):
    """Reducescatter and allgather on the two-level recipes, bitwise on
    integers against JAX's flat scatter and gather and its two-level
    recipes (``tests/test_hier_wire.py:212-258``), even and uneven."""
    import jax
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, L, outs = world
    panes = _ints(n, (2 * n, 5), 7)
    for key, op in (("rs", Sum), ("rs_avg", Average)):
        flat = np.asarray(_sm(lambda v, op=op: traced.reducescatter(
            v[0], op=op)[None], n)(panes))
        if L is not None:
            hier = np.asarray(_sm(
                lambda v, op=op: traced.hierarchical_reducescatter(
                    v[0].reshape(n, -1), op=op, stages=_stages(n, L)
                ).reshape(2, 5)[None], n)(panes))
            np.testing.assert_array_equal(hier, flat)
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[f"hier_{key}"].numpy(), flat[r])
            np.testing.assert_array_equal(o[f"hier_{key}"], o[f"flat_{key}"])
    uneven = _ints(n, (n + 1, 3), 8).sum(0)
    for r, o in enumerate(outs):
        rows = uneven[:2] if r == 0 else uneven[r + 1:r + 2]
        np.testing.assert_array_equal(o["hier_rs_uneven"].numpy(), rows)
    shards = _ints(n, (5,), 9)
    flat = np.asarray(_sm(lambda v: jax.lax.all_gather(v[0], "hvd")[None],
                          n)(shards))
    if L is not None:
        hier = np.asarray(_sm(lambda v: traced.hierarchical_allgather(
            v[0], stages=_stages(n, L))[None], n)(shards))
        np.testing.assert_array_equal(hier, flat)
    want_v = np.concatenate([np.full((r + 1, 2), float(r))
                             for r in range(n)])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["hier_gather"].numpy(),
                                      flat[r].reshape(-1))
        np.testing.assert_array_equal(o["hier_gather_v"].numpy(), want_v)


def test_masked_and_process_set_batches_stay_flat(world):
    """A join-masked batch and a process-set batch under forced
    hierarchy give the flat masked results (``tests/test_hier_wire.py:
    260-350``): JAX ``traced.allreduce`` with the same mask, bitwise."""
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Average

    n, L, outs = world
    per = _ints(n, (48,), 10)
    mask = np.array([True] * (n - 1) + [False])
    want = np.asarray(_sm(lambda v: traced.allreduce(
        v, op=Average, mask=mask), n)(per))
    members = list(range(max(n // 2, 1)))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["hier_join"].numpy(), want[r])
        np.testing.assert_array_equal(o["hier_join"], o["flat_join"])
        if r in members:
            np.testing.assert_array_equal(
                o["set_sum"].numpy(), _ints(n, (32,), 11)[members].sum(0))


def _quantum(want):
    return np.abs(want).max() / 127.0


def test_hier_int8_within_quanta_and_consistent(world):
    """The int8 inter hop against the exact sum and JAX's two-level
    recipe on the same groups (``tests/test_hier_wire.py:166-210``)."""
    from horovod_tpu.ops import traced
    from horovod_tpu.ops.reduction_ops import Sum

    n, L, outs = world
    x = _normal(n, 300, 3)
    want = x.sum(0)
    q = _quantum(want)
    if L is not None:
        jax_out = np.asarray(_sm(lambda v: traced.hierarchical_allreduce_groups(
            v[0], op=Sum, stages=_stages(n, L), inter_wire="int8",
            intra_wire="bf16", block_size=64, seed=7)[None], n)(x))
        assert np.abs(jax_out[0] - want).max() < 3.0 * q
    for o in outs:
        got = o["q"].numpy()
        assert np.abs(got - want).max() < 3.0 * q
        if L is not None:
            assert np.abs(got - jax_out[0]).max() < 6.0 * q
        assert torch.equal(o["q"], outs[0]["q"])
        assert np.abs(o["q_avg"].numpy() - want / n).max() < 3.0 * q / n
        masked = x[1:].sum(0) / (n - 1)
        assert np.abs(o["q_join"].numpy() - masked).max() < 3.0 * q
        assert torch.equal(o["q_avg"], outs[0]["q_avg"])


def test_hier_int8_bytes_by_hop(world):
    """The per-hop byte model (``fusion.py:1404-1460``): bf16 on the
    whole buffer intra, int8 with both stages' scales on the 1/L shard
    inter, as the JAX ``_hop_bytes``; and the bytes the batch handed
    each hop's collectives, counted at the calls, against the shapes."""
    from horovod_tpu.ops.fusion import FusionManager
    from horovod_tpu_torch.ops.fusion import hop_bytes

    n, L, outs = world
    if L is None:  # the hierarchy degenerates: the flat wire, no hops
        assert all(o["q_bytes"][:2] == [0, 0] for o in outs)
        assert all(o["q_bytes"][3:] == [0, 0] for o in outs)
        assert all(o["ef_handed_intra"] == 0 for o in outs)
        return
    intra = FusionManager._hop_bytes(300, "bf16", 4, L, 64)[0]
    inter = FusionManager._hop_bytes(-(-300 // L), "int8", 4, n // L, 64)[0]
    assert (intra, inter) == (hop_bytes(300, "bf16", 4, L, 64)[0],
                              hop_bytes(-(-300 // L), "int8", 4, n // L,
                                        64)[0])
    for o in outs:
        assert o["q_bytes"][:2] == [intra, inter]
    # what the batch handed each hop's collectives, from the shapes: the
    # intra reduce-scatter takes the bf16 buffer and the allgather its
    # 1/L shard; the inter hop both stages' int8 chunks and fp32 scales
    H = n // L
    shard = 300 // L
    chunk = -(-shard // H)
    blocks = -(-chunk // 64)
    handed = [2 * 300 + 2 * shard, (H + 1) * (chunk + 4 * blocks)]
    assert handed == [intra + intra // L, inter + chunk]
    ef_intra = 2 * 128 + 2 * 128 // L + 4 * 128 // L  # + the residual
    for o in outs:
        assert o["q_bytes"][3:] == handed
        assert o["ef_handed_intra"] == ef_intra


def test_hier_int8_residual_chains_over_two_steps(world):
    """Two chained error-feedback steps land within 4 quanta of twice
    the sum, and the carry changed what the second step sent; the
    residual is one value a node (``traced.py:1139-1214``)."""
    n, L, outs = world
    x = _normal(n, 128, 4)
    want = x.sum(0)
    q = _quantum(want)
    for o in outs:
        cum = o["ef"][0].numpy() + o["ef"][1].numpy() - 2 * want
        assert np.abs(cum).max() < 4.0 * q
        assert not torch.equal(o["ef"][0], o["ef"][1])
        assert torch.equal(o["ef"][1], outs[0]["ef"][1])
    if L is not None:
        for r, o in enumerate(outs):
            node = outs[r - r % L]
            assert torch.equal(o["ef_res"][1], node["ef_res"][1])
    for o in outs:  # the eager rule's flat int8 result
        assert np.abs(o["eager_res"][0].numpy() - want).max() < 3.0 * q


def test_optimizer_hier_int8_matches_jax_optimizer(world, monkeypatch):
    """``DistributedOptimizer(compression=Compression.hier_int8,
    error_feedback=True)`` against the JAX optimizer's two-level path
    (``tests/test_hier_wire.py:676-730``) on the same gradients, within
    the shared quantum budget."""
    import jax.numpy as jnp
    from horovod_tpu.ops.compression import Compression
    from horovod_tpu.ops.reduction_ops import Average
    from horovod_tpu.optimizer import _allreduce_grads

    n, L, outs = world
    if L is not None:
        monkeypatch.setenv("HOROVOD_INTRA_SIZE", str(L))
    g = _normal(n, 600, 14)
    want = g.mean(0)
    scale = np.abs(g.sum(0)).max() / 127.0 / n
    jax_out = np.asarray(_sm(lambda t: _allreduce_grads(
        {"g": t[0]}, Average, Compression.hier_int8, 1.0, 1.0, None, "hvd",
        seed=3)["g"][None], n)(jnp.asarray(g)))
    assert np.abs(jax_out[0] - want).max() < 4.0 * scale
    for o in outs:
        got = o["opt_step1"].numpy()
        assert np.abs(got - want).max() < 4.0 * scale
        assert np.abs(got - jax_out[0]).max() < 6.0 * scale
        assert torch.equal(o["opt_step1"], outs[0]["opt_step1"])
        assert o["opt_residual_norm"] > 0.0


def test_optimizer_int8_block_error_feedback_stays_flat(world):
    """``Compression.int8_block`` with error feedback under forced
    hierarchy rides the flat int8 wire (``horovod_tpu/optimizer.py:
    80-90``): no two-level batch, within the quantum budget of the JAX
    optimizer's flat ``quantized_allreduce`` on the same gradients, and
    a residual that holds the whole error: n · out + Σ residuals gives
    the exact sum within fp32 rounding (the two-level residual misses
    the bf16 intra hops' error, some hundred times more)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops.compression import Compression
    from horovod_tpu.ops.reduction_ops import Average
    from horovod_tpu.optimizer import _allreduce_grads

    n, L, outs = world
    g = _normal(n, 600, 15)
    want = g.mean(0)
    scale = np.abs(g.sum(0)).max() / 127.0 / n
    specs = (P("hvd"), P("hvd"))
    jax_out, _ = _sm(lambda t, r: tuple(v["g"][None] for v in (
        _allreduce_grads({"g": t[0]}, Average, Compression.int8_block, 1.0,
                         1.0, None, "hvd", seed=3,
                         residuals={"g": r[0]}))), n,
        ins=specs, outs=specs)(jnp.asarray(g), jnp.zeros_like(g))
    jax_out = np.asarray(jax_out)
    assert np.abs(jax_out[0] - want).max() < 4.0 * scale
    carried = sum(o["blk_residual"].double().numpy() for o in outs)
    exact = g.astype(np.float64).sum(0)
    for o in outs:
        got = o["blk_step1"].numpy()
        assert np.abs(got - want).max() < 4.0 * scale
        assert np.abs(got - jax_out[0]).max() < 6.0 * scale
        assert torch.equal(o["blk_step1"], outs[0]["blk_step1"])
        held = n * got.astype(np.float64) + carried - exact
        assert np.abs(held).max() <= 1e-5 * np.abs(exact).max()


def test_hier_adasum_matches_host_oracle_and_jax(world):
    """Intra Sum, then Adasum across nodes, against the fp64 host oracle
    over the per-node sums and JAX's hierarchical Adasum on a two-axis
    mesh (``tests/test_hier_wire.py:765-847``); scale invariance; every
    rank equal."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.common import topology as jtopo
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu_torch.ops import adasum as padasum

    n, L, outs = world
    L = L or n
    H = n // L
    per = _normal(n, 97, 16)
    want = padasum.adasum_vhdd_host(
        [per[e * L:(e + 1) * L].astype(np.float64).sum(0) for e in range(H)])
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(H, L),
                (jtopo.INTER_AXIS, jtopo.INTRA_AXIS))
    spec = P((jtopo.INTER_AXIS, jtopo.INTRA_AXIS))
    jax_out = np.asarray(_sm(lambda x: jadasum.adasum_allreduce(
        x[0], hierarchical=True)[None], n, mesh=mesh, ins=spec,
        outs=spec)(per))
    for o in outs:
        np.testing.assert_allclose(o["adasum"].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["adasum"].numpy(), jax_out[0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["adasum_scaled"].numpy() / 1000.0,
                                   o["adasum"].numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(o["adasum"], outs[0]["adasum"])
        assert "process set" in o["adasum_set"]


def test_hier_adasum_int8_and_bf16_inter_wires(world):
    """The quantized inter wire: every rank bitwise equal (an owner
    consumes its own dequantized piece) and within 6 quanta of the exact
    composition; bf16 within its rounding."""
    from horovod_tpu_torch.ops import adasum as padasum

    n, L, outs = world
    L = L or n
    H = n // L
    per = _normal(n, 97, 16)
    want = padasum.adasum_vhdd_host(
        [per[e * L:(e + 1) * L].astype(np.float64).sum(0) for e in range(H)])
    q = _quantum(want)
    for o in outs:
        assert torch.equal(o["adasum_int8"], outs[0]["adasum_int8"])
        assert np.abs(o["adasum_int8"].numpy() - want).max() < 6.0 * q
        assert torch.equal(o["adasum_bf16"], outs[0]["adasum_bf16"])
        np.testing.assert_allclose(o["adasum_bf16"].numpy(), want,
                                   rtol=3e-2, atol=3e-2 * np.abs(want).max())
