"""The port's in-step quantized wires and two-level recipes
(``horovod_tpu_torch/ops/traced.py`` on the recipe of
``ops/int8_wire.py``) in gloo worlds of 2 and 4 processes on the CPU
(the world of 4 as 2 nodes of 2, ``HOROVOD_INTRA_SIZE=2``), against the
JAX package's ``ops/traced.py`` on as many devices of the 8-device CPU
mesh, and a compiled exchange equal to eager.

Stochastic rounding cannot match across frameworks (the port's Philox
against ``jax.random``), so the quantized wires are held to ROADMAP's
stochastic contract against the JAX functions:

- the stage-1 scales are deterministic, a row's or block's absmax /
  127: bit for bit the kernels' product with fp32(1/127) (the Pallas
  wrappers' arithmetic), within one ulp of the JAX traced functions'
  plain division; each value is ``floor`` or ``floor + 1`` of ``x /
  scale``;
- every output lies within the two-stage quantum budget of the exact
  sum (``(Σ_r max|x_r| + max|Σ x|) / 127`` each stage a quantum), as
  JAX's own does;
- the residual contract, seed for seed: the output, scaled back to input
  units (× n under Average, ÷ the prescale), plus every rank's residual
  is the exact sum to fp32 rounding (both stages' errors are in the
  carry, the second on the owned chunk only); a prescale of 0 gives a
  zero carry;
- the mean over 48 seeds of the per-row wire's output is within a
  tenth of a quantum of the exact sum (unbiased rounding);
- the exact two-level recipes equal the flat route bit for bit on
  integer-valued fp32, and JAX's.

The compiled case: ``torch.compile(fullgraph=True)`` of a function that
calls ``quantized_allreduce`` (the per-row wire and block 64) and
``bucketed_allreduce(compression=int8_block, residuals=)`` in the world
of 2 gives the eager bits under the same seed, and its graph holds the
B2 and B3 custom operators. It compiles through AOTAutograd
(``backend="aot_eager"``): Inductor's CPU code generator in torch
2.13.0+cpu miscompiles these graphs, reading memory it never wrote;
``chip_smoke.py``'s phase 14 (c) runs Inductor on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

ULP = np.finfo(np.float32).eps
SEEDS = 48
M = 300  # a length no world size divides, so chunks are padded


def _normal(n, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + tuple(shape)).astype(np.float32)


def _ints(n, shape, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n,) + tuple(shape)).astype(np.float32)


def _compiled_exchange(hvd, traced, x, tree, zeros):
    """The function the compiled case captures."""
    blocks = hvd.Compression.int8_block.with_block_size(64)
    rows = traced.quantized_allreduce(x, op=hvd.Sum, seed=11)
    blk, res = traced.quantized_allreduce(x, seed=11, block_size=64,
                                          return_residual=True)
    red, new_r = hvd.bucketed_allreduce(tree, op=hvd.Sum, n_buckets=2,
                                        compression=blocks, residuals=zeros,
                                        seed=4, min_bucket_bytes=0,
                                        hier_stages=None)
    return rows, blk, res, red, new_r


def _quant_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.ops import traced

    hvd.init(device="cpu", store=file_store(outdir, n))
    t = lambda a: torch.from_numpy(a[rank].copy())  # noqa: E731
    x = t(_normal(n, (M,), 1))
    out = {}
    for key, kw in (("rows_sum", dict(op=hvd.Sum)),
                    ("rows_avg", dict(op=hvd.Average)),
                    ("blk_sum", dict(op=hvd.Sum, block_size=64)),
                    ("blk_avg_pre", dict(op=hvd.Average, block_size=64,
                                         prescale_factor=0.25)),
                    ("rows_pre", dict(op=hvd.Sum, prescale_factor=3.0)),
                    ("pre0", dict(op=hvd.Sum, block_size=64,
                                  prescale_factor=0.0))):
        out[key] = traced.quantized_allreduce(x, seed=5, return_residual=True,
                                              **kw)
    out["seeds"] = torch.stack([
        traced.quantized_allreduce(x, op=hvd.Sum, seed=s)
        for s in range(SEEDS)])
    # stage 1 alone: the row and block quantizers on this rank's chunks
    chunks = torch.nn.functional.pad(x, (0, (-M) % n)).view(n, -1)
    out["stage1_rows"] = traced._stochastic_round_rows(chunks, seed=3)
    out["stage1_blocks"] = traced._stochastic_round_blocks(chunks, 64,
                                                           seed=3)
    pairs = [[2 * i, 2 * i + 1] for i in range(n // 2)]
    out["groups"] = traced.quantized_allreduce(
        x, op=hvd.Sum, seed=6, block_size=64, groups=pairs,
        return_residual=True, prescale_factor=2.0)
    panes = t(_normal(n, (n, 70), 2))
    out["qrs"] = traced.quantized_reducescatter(panes, op=hvd.Sum, seed=7,
                                                block_size=32,
                                                return_residual=True)
    out["qrs_avg"] = traced.quantized_reducescatter(panes, op=hvd.Average,
                                                    seed=7)
    out["qag"] = traced.quantized_allgather(panes[0], seed=8, block_size=32,
                                            return_residual=True)
    if n == 4:
        stages = topology.hierarchy_stages(mode="on")
        xi = t(_ints(n, (M,), 3))
        out["stages"] = stages
        for op in ("Sum", "Average"):
            out[f"h_fp32_{op}"] = traced.hierarchical_allreduce_groups(
                xi, op=getattr(hvd, op), stages=stages)
            out[f"flat_{op}"] = traced.allreduce(xi, op=getattr(hvd, op))
        out["h_bf16"] = traced.hierarchical_allreduce_groups(
            t(_ints(n, (M,), 4, -3, 4)), op=hvd.Sum, stages=stages,
            intra_wire="bf16", inter_wire="bf16")
        out["h_int8"] = traced.hierarchical_allreduce_groups(
            x, op=hvd.Sum, stages=stages, inter_wire="int8", seed=9,
            block_size=32, return_residual=True, prescale_factor=0.5)
        out["h_int8_bf16"] = traced.hierarchical_allreduce_groups(
            x, op=hvd.Average, stages=stages, intra_wire="bf16",
            inter_wire="int8", seed=9)
        hp = t(_ints(n, (n, 9), 5))
        out["h_rs"] = traced.hierarchical_reducescatter(hp, op=hvd.Sum,
                                                        stages=stages)
        out["h_rs_int8"] = traced.hierarchical_reducescatter(
            panes, op=hvd.Sum, stages=stages, inter_wire="int8", seed=2)
        out["h_ag"] = traced.hierarchical_allgather(hp[0], stages=stages)
        out["h_ag_int8"] = traced.hierarchical_allgather(
            panes[0], stages=stages, inter_wire="int8", seed=2)
        mesh = traced.hierarchical_mesh()
        out["mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names)
        out["h_mesh"] = traced.hierarchical_allreduce(xi, op=hvd.Sum,
                                                      mesh=mesh)
        out["h_mesh_avg"] = traced.hierarchical_allreduce(
            xi, op=hvd.Average, mesh=mesh, prescale_factor=2.0)
        out["hq_mesh"] = traced.hierarchical_quantized_allreduce(
            x, op=hvd.Sum, mesh=mesh, seed=3, return_residual=True)
    if n == 2:
        tree = {"a": t(_normal(n, (40, 3), 9)), "b": t(_normal(n, (77,), 10))}
        zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
        eager = _compiled_exchange(hvd, traced, x, tree, zeros)
        targets = []

        def backend(gm, example_inputs):
            targets.extend(str(node.target) for node in gm.graph.nodes)
            return torch._dynamo.lookup_backend("aot_eager")(gm,
                                                             example_inputs)

        fn = torch.compile(
            lambda a, b, c: _compiled_exchange(hvd, traced, a, b, c),
            fullgraph=True, backend=backend)
        out["compiled"] = (eager, fn(x, tree, zeros))
        out["compiled_targets"] = targets
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def _spawn(tmp_path_factory, n):
    path = tmp_path_factory.mktemp(f"tq{n}")
    env = {"HOROVOD_INTRA_SIZE": "2"} if n == 4 else None
    return n, _run(path, n, Path(__file__), "_quant_worker", 150, env)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4)


@pytest.fixture(params=["world2", "world4"])
def world(request):
    return request.getfixturevalue(request.param)


def _sm(fn, n, *arrays):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    run = jax.jit(jax.shard_map(
        lambda *a: jax.tree_util.tree_map(
            lambda v: v[None], fn(*[v[0] for v in a])),
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, run(*arrays))


def _budget(x, scale=1.0):
    """Two stages of under a quantum each: every rank's stage-1 quantum,
    and the reduced shard's."""
    return 1.01 * scale * (np.abs(x).max(axis=1).sum()
                           + np.abs(x.sum(0)).max()) / 127


# ------------------------------------------------------------ the flat wire


QCASES = {"rows_sum": ("Sum", None, 1.0), "rows_avg": ("Average", None, 1.0),
          "blk_sum": ("Sum", 64, 1.0), "blk_avg_pre": ("Average", 64, 0.25),
          "rows_pre": ("Sum", None, 3.0)}


@pytest.mark.parametrize("case", sorted(QCASES))
def test_quantized_allreduce_contract(world, case):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops import reduction_ops as jops

    n, outs = world
    opname, block, pre = QCASES[case]
    x = _normal(n, (M,), 1)
    div = n if opname == "Average" else 1
    want = x.astype(np.float64).sum(0) * pre / div
    budget = _budget(x, pre) / div
    jax_out = _sm(lambda a: jt.quantized_allreduce(
        a, op=getattr(jops, opname), seed=5, block_size=block,
        prescale_factor=pre), n, x)
    for r, o in enumerate(outs):
        got, _ = o[case]
        assert np.abs(got.numpy() - want).max() <= budget
        assert np.abs(jax_out[r] - want).max() <= budget
        assert torch.equal(got, outs[0][case][0])  # every rank equal
    # the residual contract: scaled back to input units, out + Σ carry
    got = outs[0][case][0].double() * div / pre
    carry = sum(o[case][1].double() for o in outs)
    exact = torch.from_numpy(x.astype(np.float64).sum(0))
    tol = 16 * ULP * float(np.abs(x).max(axis=1).sum()) * max(1.0, 1 / pre)
    assert (got + carry - exact).abs().max() <= tol


def test_zero_prescale_carries_nothing(world):
    _, outs = world
    for o in outs:
        got, res = o["pre0"]
        assert torch.equal(got, torch.zeros_like(got))
        assert torch.equal(res, torch.zeros_like(res))


def test_stage_one_scales_against_jax(world):
    """Stage 1's scales are the row's or block's absmax / 127 in the
    kernels' arithmetic, the product with fp32(1/127) that XLA makes of
    the Pallas wrappers' division (``cuda_kernels._scale_plain``), bit for
    bit; the JAX traced functions divide in plain jnp, which this XLA
    keeps as a division, so theirs are within one ulp. Each value is
    ``floor`` or ``floor + 1`` of ``x / scale`` on both sides."""
    import jax
    from horovod_tpu.ops import traced as jt

    n, outs = world
    x = _normal(n, (M,), 1)
    inv = np.float32(1.0 / 127.0)
    for r, o in enumerate(outs):
        chunks = np.pad(x[r], (0, (-M) % n)).reshape(n, -1)
        cols = chunks.shape[1]
        blocks = np.pad(chunks, ((0, 0), (0, (-cols) % 64))).reshape(
            n, -1, 64)
        key = jax.random.PRNGKey(0)
        for name, absmax, (jq, js) in (
                ("stage1_rows", np.abs(chunks).max(1, keepdims=True),
                 jt._stochastic_round_rows(chunks, key)),
                ("stage1_blocks", np.abs(blocks).max(2),
                 jt._stochastic_round_blocks(chunks, 64, key))):
            q, s = o[name]
            want = np.maximum(absmax, np.float32(1e-30)) * inv
            np.testing.assert_array_equal(s.numpy(), want)
            js = np.asarray(js).reshape(want.shape)
            assert np.all(np.abs(s.numpy() - js) <= np.spacing(js)), name
            per = (np.repeat(want, 64, axis=1)[:, :cols]
                   if name == "stage1_blocks" else want)
            floor = np.floor(chunks / per)
            qv = q.numpy().astype(np.float64)
            assert np.all((qv == floor) | (qv == floor + 1)), name
            assert np.abs(np.asarray(jq).reshape(n, -1)[:, :cols]
                          - floor).max() <= 1


def test_mean_over_seeds_is_unbiased(world):
    n, outs = world
    x = _normal(n, (M,), 1)
    quantum = _budget(x) / 2
    mean = outs[0]["seeds"].double().mean(0).numpy()
    assert np.abs(mean - x.astype(np.float64).sum(0)).max() <= (
        0.1 * quantum * 2 + 4 * quantum / np.sqrt(SEEDS))
    # different seeds round differently
    assert not torch.equal(outs[0]["seeds"][0], outs[0]["seeds"][1])


def test_groups_reduce_within_pairs(world):
    n, outs = world
    x = _normal(n, (M,), 1)
    for r, o in enumerate(outs):
        pair = x[r - r % 2:r - r % 2 + 2]
        got, _ = o["groups"]
        want = pair.astype(np.float64).sum(0) * 2.0
        assert np.abs(got.numpy() - want).max() <= _budget(pair, 2.0)
        carry = o["groups"][1].double() + outs[r ^ 1]["groups"][1].double()
        exact = torch.from_numpy(pair.astype(np.float64).sum(0))
        assert (got.double() / 2.0 + carry - exact).abs().max() <= (
            16 * ULP * float(np.abs(pair).max(axis=1).sum()))


def test_quantized_reducescatter_and_allgather(world):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Sum

    n, outs = world
    panes = _normal(n, (n, 70), 2)
    jax_rs = _sm(lambda a: jt.quantized_reducescatter(a, op=Sum, seed=7,
                                                      block_size=32), n, panes)
    one = 1.01 * np.abs(panes).max(axis=(1, 2)).sum() / 127
    for r, o in enumerate(outs):
        shard, res = o["qrs"]
        want = panes[:, r].astype(np.float64).sum(0)
        assert np.abs(shard.numpy() - want).max() <= one
        assert np.abs(jax_rs[r] - want).max() <= one
        np.testing.assert_allclose(o["qrs_avg"].numpy(), want / n,
                                   atol=one / n * 1.01 + 1e-6)
        carry = sum(oo["qrs"][1][r].double() for oo in outs)
        assert (shard.double() + carry - torch.from_numpy(want)).abs().max() \
            <= 16 * ULP * float(np.abs(panes).max())
        gathered, gres = o["qag"]
        assert tuple(gathered.shape) == (n, 70)
        for s in range(n):
            assert (gathered[s].double() + outs[s]["qag"][1].double()
                    - torch.from_numpy(panes[s, 0].astype(np.float64))
                    ).abs().max() <= 4 * ULP * float(np.abs(panes[s]).max())
        assert torch.equal(gathered, outs[0]["qag"][0])


# -------------------------------------------------------- the two levels


def test_two_level_exact_equals_flat_and_jax(world4):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, outs = world4
    stages = outs[0]["stages"]
    assert stages == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
    xi = _ints(n, (M,), 3)
    for name, op in (("Sum", Sum), ("Average", Average)):
        want = _sm(lambda a, op=op: jt.hierarchical_allreduce_groups(
            a, op=op, stages=stages), n, xi)
        for r, o in enumerate(outs):
            assert torch.equal(o[f"h_fp32_{name}"], o[f"flat_{name}"])
            np.testing.assert_array_equal(o[f"h_fp32_{name}"].numpy(),
                                          want[r])
    small = _ints(n, (M,), 4, -3, 4)
    hp = _ints(n, (n, 9), 5)
    want_rs = _sm(lambda a: jt.hierarchical_reducescatter(
        a, op=Sum, stages=stages), n, hp)
    want_ag = _sm(lambda a: jt.hierarchical_allgather(a[0], stages=stages),
                  n, hp)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["h_bf16"].numpy(), small.sum(0))
        np.testing.assert_array_equal(o["h_rs"].numpy(), want_rs[r])
        np.testing.assert_array_equal(o["h_ag"].numpy(), want_ag[r])
        assert o["mesh"] == ([[0, 1], [2, 3]], ("inter", "intra"))
        np.testing.assert_array_equal(o["h_mesh"].numpy(), xi.sum(0))
        np.testing.assert_array_equal(o["h_mesh_avg"].numpy(),
                                      xi.sum(0) * 2.0 / n)


def test_two_level_int8_contract(world4):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Sum

    n, outs = world4
    stages = outs[0]["stages"]
    x = _normal(n, (M,), 1)
    nodes = np.stack([x[0] + x[1], x[2] + x[3]])
    exact = x.astype(np.float64).sum(0)
    # int8 across nodes on the node sums: the budget of a flat world of 2
    budget = _budget(nodes)
    jax_out = _sm(lambda a: jt.hierarchical_allreduce_groups(
        a, op=Sum, stages=stages, inter_wire="int8", seed=9, block_size=32,
        prescale_factor=0.5), n, x)
    for r, o in enumerate(outs):
        got, res = o["h_int8"]
        assert np.abs(got.numpy() - 0.5 * exact).max() <= 0.5 * budget
        assert np.abs(jax_out[r] - 0.5 * exact).max() <= 0.5 * budget
        assert torch.equal(got, outs[0]["h_int8"][0])
        avg = o["h_int8_bf16"].numpy()
        assert np.abs(avg - exact / n).max() <= (budget / n
                                                 + 2 ** -8 * np.abs(
                                                     nodes).max())
        got_q, res_q = o["hq_mesh"]
        assert np.abs(got_q.numpy() - exact).max() <= budget
    # input-unit carry, divided by L and held by each node's ranks
    carry = sum(o["h_int8"][1].double() for o in outs)
    got = outs[0]["h_int8"][0].double() / 0.5
    assert (got + carry - torch.from_numpy(exact)).abs().max() <= (
        32 * ULP * float(np.abs(nodes).max(axis=1).sum()))
    carry = sum(o["hq_mesh"][1].double() for o in outs)
    assert (outs[0]["hq_mesh"][0].double() + carry
            - torch.from_numpy(exact)).abs().max() <= (
        32 * ULP * float(np.abs(nodes).max(axis=1).sum()))
    panes = _normal(n, (n, 70), 2)
    for r, o in enumerate(outs):
        want = panes[:, r].astype(np.float64).sum(0)
        one = 1.01 * np.abs(panes.reshape(2, 2, n, 70).sum(1)).max(
            axis=(1, 2)).sum() / 127
        assert np.abs(o["h_rs_int8"].numpy() - want).max() <= one
        gathered = o["h_ag_int8"].numpy()
        assert np.abs(gathered - panes[:, 0]).max() <= (
            1.01 * np.abs(panes[:, 0]).max() / 127)
        assert torch.equal(o["h_ag_int8"], outs[0]["h_ag_int8"])


# ---------------------------------------------------------------- compiled


def test_compiled_exchange_equals_eager(world2):
    n, outs = world2
    for o in outs:
        eager, compiled = o["compiled"]
        flat_e = [eager[0], eager[1], eager[2], *eager[3].values(),
                  *eager[4].values()]
        flat_c = [compiled[0], compiled[1], compiled[2],
                  *compiled[3].values(), *compiled[4].values()]
        for a, b in zip(flat_e, flat_c):
            assert torch.equal(a, b)
        targets = " ".join(o["compiled_targets"])
        assert "hvd_torch.int8_quantize" in targets  # B2: the per-row wire
        assert "hvd_torch.int8_block_quantize" in targets  # B3


def test_custom_ops_fake_and_plain():
    """Each operator's CPU implementation is the plain version, and its
    fake gives the real output's shapes and dtypes (``opcheck`` also
    runs the schema, autograd-registration and fake-tensor checks)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from horovod_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 1000)).astype(np.float32))
    q, s = ck.int8_quantize_plain(x, 1, 2)
    cases = {
        "scale_cast": ((q, s, torch.bfloat16),
                       ck.scale_cast_plain(q, s, torch.bfloat16)),
        "int8_quantize": ((x, 1, 2), (q, s)),
        "int8_block_quantize": ((x, 64, 1, 2, True),
                                ck.int8_block_quantize_plain(x, 64, 1, 2,
                                                             True)),
        "adasum_dots": ((x, x * 2), ck.adasum_dots_plain(x, x * 2)),
        "adasum_apply": ((x, x * 2, ck.adasum_dots_plain(x, x * 2)),
                         ck.adasum_pair_plain(x, x * 2)),
    }
    for name, (args, want) in cases.items():
        op = getattr(ck.OPS, name)
        got = op(*args)
        for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (got, want))):
            assert torch.equal(g, w), name
        torch.library.opcheck(op, args)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) if torch.is_tensor(a) else a
                        for a in args])
        for f, g in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (fake, got))):
            assert f.shape == g.shape and f.dtype == g.dtype, name
    flat = ck.OPS.int8_block_quantize(x.reshape(-1), 512, 0, 0, False)
    assert flat[1].shape == (-(-3000 // 512),)
