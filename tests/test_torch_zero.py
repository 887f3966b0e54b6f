"""ZeRO in the port (``horovod_tpu_torch/sharded_optimizer.py`` and the
sharded legs of ``ops/overlap.py``) against the JAX package's
``ShardedDistributedOptimizer`` and legs, in one gloo world of 4
processes on the CPU with ``HOROVOD_INTRA_SIZE=2`` (2 nodes of 2; the
``_zero_worker`` world runs once per module), on inputs made from numpy
seeds, rank r taking row r. The JAX side runs as ``tests/test_zero.py``
runs it, ``shard_map`` over 4 devices of the conftest's CPU mesh.

- The legs: ``bucketed_reduce_scatter``/``_shard_all_gather`` on
  integer-valued fp32 are JAX's bit for bit, on the flat route, the
  two-level route and within ``groups=``; bf16 carries these integers
  exactly; the int8 legs hold the stochastic contract (within one
  quantum a rank of the exact sum, every rank the same gathered bits,
  the residual the exact remainder; Philox cannot match ``jax.random``'s
  bits, ROADMAP's rule); the pair shares one cached schedule.
- The int8 wire's padding (``test_zero.py:451-530``): the block scales
  of a padded buffer equal the unpadded buffer's and JAX's, bit for bit;
  each value within one quantum; a zero residual and a zero shard in the
  padding, and in the optimizer's ``ag`` residuals.
- The optimizer: stages 1–3 with SGD momentum and with Adam, 3 steps, op
  Sum, against JAX's with ``optax.sgd(lr, momentum)``/``optax.adam``.
  The gradients come from torch's and XLA's matmuls, which round
  differently, so the parameters are held within 8 ulp of their largest
  magnitude for SGD and within 2e-6 absolute for Adam (torch adds eps to
  ``sqrt(v̂)``, optax to ``sqrt(v̂ + eps_root)`` with its own order of the
  bias corrections; a step of 1e-2 moves a parameter by ≈ 1e-2 and
  three of them sit within a few ulp of 1e-2 of each other). Stages 2
  and 3 are stage 1 bit for bit in the port (the same schedule, the same
  collectives, the same inner steps; the JAX package's own stage 3 sits
  1 ulp off through an FMA its XLA contracts, which the port does not
  have). The two-level route trains within 1e-6 of the flat one.
- The int8 wire with error feedback (stage 2) and without (stage 3)
  trains: the loss falls every step and stays within 0.5 % of the fp32
  wire's; the guard's skip on a NaN
  in one rank's batch leaves parameters, inner state and residuals
  bitwise; a parameter used on step 0 only is not stepped again at any
  stage (ROADMAP C2's scenario for the sharded optimizer).
- State: the world's ``state_dict``s re-split for 3 ranks and for 1
  carry the moments and ``ag`` residuals bit for bit, the ``rs``
  residuals' total, the seed and the guard counters; training resumes
  in a world of one from the re-split state. The JAX package's elastic
  8 → 6 carry (``test_zero.py:616``): the JAX state after 4 steps at
  world 8, taken into the port's layout, re-splits to the JAX re-split
  bit for bit. Stage 3's parameter shards re-split 4 → 3 → 4 and back
  to the same full tensors.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

N = 4
ULP = np.finfo(np.float32).eps
LR = 1e-2
D_IN, D_OUT = 12, 7
LEG_SHAPES = {"a": (33, 7), "b": (129,), "c": (5, 5, 5), "d": (3,),
              "s": ()}


def _problem(seed, n=N, d_in=D_IN, d_out=D_OUT):
    """Weights, a 0-d offset, and each rank's batch of a linear
    regression whose sizes pad on 4 ranks (7 and 84 elements)."""
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(d_in, d_out)).astype(np.float32)
    params = {"b": np.zeros(d_out, np.float32),
              "s": np.asarray(0.1, np.float32),
              "w": rng.normal(size=(d_in, d_out)).astype(np.float32)}
    x = rng.normal(size=(n, 16, d_in)).astype(np.float32)
    y = np.einsum("wbi,io->wbo", x, true).astype(np.float32)
    return params, x, y


def _leg_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(-50, 51, size=(n,) + s).astype(np.float32)
            for k, s in LEG_SHAPES.items()}


class _Lin(torch.nn.Module):
    def __init__(self, params, late=False):
        super().__init__()
        for k in ("w", "b", "s"):  # the JAX tree's leaves, w first
            setattr(self, k, torch.nn.Parameter(
                torch.from_numpy(params[k].copy())))
        self.late = torch.nn.Parameter(torch.ones(5)) if late else None
        self.calls = 0

    def forward(self, x):
        out = x @ self.w + self.b + self.s
        if self.late is not None and self.calls == 0:
            out = out * self.late.sum() / 5
        self.calls += 1
        return out


def _mse(model, x, y):
    return ((model(x) - y) ** 2).mean()


INNER = {
    "sgd": lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9),
    "adam": lambda ps: torch.optim.Adam(ps, lr=LR),
    "sgd_wd": lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9,
                                         weight_decay=0.1),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=LR),
}


def _train(hvd, rank, stage, inner, steps=3, seed=0, late=False,
           nan_step=None, **kw):
    """``steps`` steps of the port's optimizer on rank ``rank``'s batch;
    the full parameters after each step (by name), the losses, and the
    state_dict before the last step and after it."""
    params, x, y = _problem(seed)
    model = _Lin(params, late)
    kw.setdefault("hierarchical", False)
    kw.setdefault("overlap_buckets", 2)
    opt = hvd.ShardedDistributedOptimizer(
        INNER[inner](model.parameters()),
        named_parameters=model.named_parameters(),
        op=kw.pop("op", hvd.Sum), zero_stage=stage, overlap_min_bytes=0,
        **kw)
    xb, yb = torch.from_numpy(x[rank]), torch.from_numpy(y[rank])
    seen, losses, states = [], [], []
    for step in range(steps):
        xs = xb
        if step == nan_step and rank == 0:
            xs = xb.clone()
            xs[0, 0] = float("nan")
        states.append(opt.state_dict())
        opt.zero_grad()
        loss, _ = opt.value_and_grad(lambda: _mse(model, xs, yb), model)()
        opt.step()
        losses.append(float(loss))
        seen.append({k: v.detach().clone()
                     for k, v in opt.gather_params(model).items()})
    out = {"params": seen, "losses": losses, "state_before": states[-1],
           "state": opt.state_dict()}
    if stage == 3:
        out["shards"] = opt.param_shards()
    opt.remove_hooks()
    return out


def _zero_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.ops import overlap, traced

    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    tree = {k: torch.from_numpy(np.array(v[rank]))
            for k, v in _leg_tree(n, 1).items()}
    leg = dict(n_buckets=2, min_bucket_bytes=0)
    overlap.reset_schedule_cache()
    overlap.reset_leg_stats()
    out["rs_sum"] = hvd.bucketed_reduce_scatter(tree, op=hvd.Sum,
                                                hier_stages=None, **leg)
    out["ag"] = hvd.bucketed_shard_all_gather(out["rs_sum"], tree,
                                              hier_stages=None, **leg)
    out["pair_cache"] = overlap.schedule_cache_stats()
    out["legs"] = overlap.leg_stats()
    out["rs_avg"] = hvd.bucketed_reduce_scatter(tree, hier_stages=None,
                                                **leg)
    stages = topology.hierarchy_stages(world=n, mode="on")
    out["stages"] = stages
    out["rs_hier"] = hvd.bucketed_reduce_scatter(tree, op=hvd.Sum,
                                                 hier_stages=stages, **leg)
    out["ag_hier"] = hvd.bucketed_shard_all_gather(
        out["rs_hier"], tree, hier_stages=stages, **leg)
    out["rs_auto"] = hvd.bucketed_reduce_scatter(tree, op=hvd.Sum, **leg)
    groups = [[0, 1], [2, 3]]
    out["rs_groups"] = hvd.bucketed_reduce_scatter(
        tree, op=hvd.Average, groups=groups, **leg)
    out["ag_groups"] = hvd.bucketed_shard_all_gather(
        out["rs_groups"], tree, groups=groups, **leg)
    out["rs_bf16"] = hvd.bucketed_reduce_scatter(
        tree, op=hvd.Sum, wire="bf16", hier_stages=None, **leg)
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    out["rs_q"], out["rs_q_res"] = hvd.bucketed_reduce_scatter(
        tree, op=hvd.Sum, wire="int8", wire_block=32, seed=3,
        residuals=zeros, **leg)
    shard_zeros = {k: torch.zeros_like(v) for k, v in out["rs_sum"].items()}
    out["ag_q"], out["ag_q_res"] = hvd.bucketed_shard_all_gather(
        out["rs_sum"], tree, wire="int8", wire_block=16, seed=5,
        residuals=shard_zeros, **leg)
    # wire="auto": these buckets sit under the tuner's int8 floor, so
    # fp32 (the bits of the default wire); a big bucket's prior is int8
    out["rs_wire_auto"] = hvd.bucketed_reduce_scatter(
        tree, op=hvd.Sum, wire="auto", **leg)
    out["auto_big"] = overlap.resolve_wire("auto", 1 << 20)

    # the int8 wire's padding (test_zero.py:451-530): a [4, 96] pane
    # buffer whose last 26 columns are padding, and a 24-element shard
    # whose last 7 are
    rng = np.random.default_rng(6)
    base = rng.normal(size=(n, n, 70)).astype(np.float32) * 5
    panes = torch.zeros(n, 96)
    panes[:, :70] = torch.from_numpy(base[rank])
    out["pad_rs"] = traced.quantized_reducescatter(
        panes, op=hvd.Sum, seed=3, block_size=32, return_residual=True)
    shard = torch.zeros(24)
    shard[:17] = torch.from_numpy(rng.normal(size=(n, 17)).astype(
        np.float32)[rank] * 3)
    out["pad_ag"] = traced.quantized_allgather(shard, seed=5, block_size=16,
                                               return_residual=True)

    # the optimizer
    for inner in ("sgd", "adam"):
        for stage in (1, 2, 3):
            out[f"{inner}_z{stage}"] = _train(hvd, rank, stage, inner)
    out["sgd_z2_hier"] = _train(hvd, rank, 2, "sgd", hierarchical=None)
    out["sgd_z1_per_tensor"] = _train(hvd, rank, 1, "sgd",
                                      overlap_buckets=0)
    out["adam_z2_6"] = _train(hvd, rank, 2, "adam", steps=6)
    out["int8_ef"] = _train(hvd, rank, 2, "adam", steps=6, wire="int8",
                            wire_block=32, error_feedback=True)
    out["int8_z3"] = _train(hvd, rank, 3, "adam", steps=6, wire="int8",
                            wire_block=32)
    out["bf16_z2"] = _train(hvd, rank, 2, "sgd", wire="bf16")
    out["guard"] = _train(hvd, rank, 2, "adam", steps=4, nan_step=3,
                          wire="int8", wire_block=32, error_feedback=True,
                          grad_guard=True)
    for inner in ("sgd_wd", "adamw"):
        for stage in (1, 2, 3):
            out[f"late_{inner}_z{stage}"] = _train(hvd, rank, stage, inner,
                                                   late=True)
    out["final_legs"] = overlap.leg_stats()
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = tmp_path_factory.mktemp("zero")
    return _run(path, N, Path(__file__), "_zero_worker", 240,
                {"HOROVOD_INTRA_SIZE": "2"})


# ------------------------------------------------------------ JAX side


def _sm(fn, n=N, ins=None, outs=None):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("hvd") if ins is None else ins,
        out_specs=P("hvd") if outs is None else outs, check_vma=False))


def _per_rank(fn):
    """``fn`` on rank-major leaves (row r to rank r), its outputs stacked
    rank-major."""
    import jax

    lift = lambda t: jax.tree_util.tree_map(lambda v: v[None], t)  # noqa
    drop = lambda t: jax.tree_util.tree_map(lambda v: v[0], t)  # noqa
    return _sm(lambda t: lift(fn(drop(t))))


def _np(t):
    return {k: np.asarray(v) for k, v in t.items()}


def test_legs_bitwise_equal_jax(world):
    from horovod_tpu.common import topology as jtopo
    from horovod_tpu.ops import overlap as jov
    from horovod_tpu.ops.reduction_ops import Average, Sum

    tree = _leg_tree(N, 1)
    kw = dict(n_buckets=2, min_bucket_bytes=0)
    stages = jtopo.hierarchical_stage_groups(N, 2)
    groups = [[0, 1], [2, 3]]
    want = {
        "rs_sum": _per_rank(lambda t: jov.bucketed_reduce_scatter(
            t, op=Sum, hier_stages=None, **kw))(tree),
        "rs_avg": _per_rank(lambda t: jov.bucketed_reduce_scatter(
            t, op=Average, hier_stages=None, **kw))(tree),
        "rs_hier": _per_rank(lambda t: jov.bucketed_reduce_scatter(
            t, op=Sum, hier_stages=stages, **kw))(tree),
        "rs_groups": _per_rank(lambda t: jov.bucketed_reduce_scatter(
            t, op=Average, groups=groups, **kw))(tree),
    }
    want["ag"] = _per_rank(lambda t: jov.bucketed_shard_all_gather(
        jov.bucketed_reduce_scatter(t, op=Sum, hier_stages=None, **kw), t,
        hier_stages=None, **kw))(tree)
    want["ag_hier"] = _per_rank(lambda t: jov.bucketed_shard_all_gather(
        jov.bucketed_reduce_scatter(t, op=Sum, hier_stages=stages, **kw),
        t, hier_stages=stages, **kw))(tree)
    want["ag_groups"] = _per_rank(lambda t: jov.bucketed_shard_all_gather(
        jov.bucketed_reduce_scatter(t, op=Average, groups=groups, **kw), t,
        groups=groups, **kw))(tree)
    for r, o in enumerate(world):
        assert [list(map(list, s)) for s in o["stages"]] == [
            list(map(list, s)) for s in stages]
        for key, w in want.items():
            for k in LEG_SHAPES:
                np.testing.assert_array_equal(
                    o[key][k].numpy(), np.asarray(w[k])[r], err_msg=key + k)
        for k, v in tree.items():  # the gather gives back the full sums
            np.testing.assert_array_equal(o["ag"][k].numpy(), v.sum(0))
            np.testing.assert_array_equal(o["ag_hier"][k].numpy(),
                                          v.sum(0))
            # auto resolves the two-level split; bf16 carries these
            # integers exactly
            np.testing.assert_array_equal(o["rs_auto"][k].numpy(),
                                          o["rs_hier"][k].numpy())
            np.testing.assert_array_equal(o["rs_bf16"][k].numpy(),
                                          o["rs_sum"][k].numpy())
        assert o["rs_sum"]["a"].shape == (-(-33 * 7 // N),)
        assert o["rs_sum"]["s"].shape == ()
        for k in LEG_SHAPES:
            np.testing.assert_array_equal(o["rs_wire_auto"][k].numpy(),
                                          o["rs_auto"][k].numpy())
        assert o["auto_big"] == "int8"


def test_pair_shares_one_schedule_and_counts_legs(world):
    o = world[0]
    # the reduce-scatter misses once; the all-gather on the same tree hits
    assert o["pair_cache"]["misses"] == 1 and o["pair_cache"]["hits"] == 1
    assert o["legs"] == {"reduce_scatter": 2, "all_gather": 2}


def test_int8_legs_hold_the_contract(world):
    tree = _leg_tree(N, 1)
    for k, v in tree.items():
        if v.ndim == 1:  # 0-d: allreduced whole, exactly
            continue
        flat = v.reshape(N, -1)
        cols = -(-flat.shape[1] // N)
        exact = np.zeros(N * cols, np.float32)
        exact[:flat.shape[1]] = flat.sum(0)
        # within one quantum (≤ max|x| / 127 a rank) of the exact sum
        budget = 1.01 * np.abs(flat).max(axis=1).sum() / 127
        for r, o in enumerate(world):
            got = o["rs_q"][k].numpy()
            assert np.abs(got - exact[r * cols:(r + 1) * cols]).max() <= (
                budget)
        # the carries are what the wire did not deliver: the output plus
        # every rank's residual is the exact sum
        carry = sum(o["rs_q_res"][k].double().numpy() for o in world)
        got = np.concatenate([o["rs_q"][k].numpy() for o in world])
        np.testing.assert_allclose(
            got[:flat.shape[1]].reshape(v.shape[1:])
            + carry, v.sum(0), atol=1e-4)
        for o in world:  # every rank gathers the same bits
            np.testing.assert_array_equal(o["ag_q"][k].numpy(),
                                          world[0]["ag_q"][k].numpy())
            assert o["rs_q_res"][k].shape == v.shape[1:]
        # a gathered value within one quantum of its block, whose members
        # are any tensor's shards: the largest shard value / 127
        q = 1.01 * max(np.abs(o["rs_sum"][j].numpy()).max()
                       for o in world for j in tree) / 127
        assert np.abs(world[0]["ag_q"][k].numpy() - v.sum(0)).max() <= q


def test_int8_padding_scales_quantum_and_residuals(world):
    """Padding zeros set no block scale and carry no residual
    (``test_zero.py:451-530``); the scales equal JAX's bit for bit."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.ops import traced as jtraced
    from horovod_tpu_torch.ops import traced

    for o in world:
        shard, res = o["pad_rs"]
        assert (res[:, 70:] == 0).all()
        assert (shard[70:] == 0).all() and shard.shape == (96,)
        full, res = o["pad_ag"]
        assert (res[17:] == 0).all() and (full[:, 17:] == 0).all()
    rng = np.random.default_rng(6)
    base = rng.normal(size=(N, 70)).astype(np.float32) * 5
    padded = np.concatenate([base, np.zeros((N, 26), np.float32)], axis=1)
    q_pad, s_pad = traced._stochastic_round_blocks(torch.from_numpy(padded),
                                                   32, 0, 1)
    q_un, s_un = traced._stochastic_round_blocks(torch.from_numpy(base), 32,
                                                 0, 1)
    # jitted, as the JAX wire runs it: XLA makes the division by 127 a
    # product with its fp32 reciprocal, as the port's quantizers do
    _, s_jax = jax.jit(lambda v: jtraced._stochastic_round_blocks(
        v, 32, jax.random.PRNGKey(0)))(jnp.asarray(padded))
    torch.testing.assert_close(s_pad, s_un, rtol=0, atol=0)
    np.testing.assert_array_equal(s_pad.numpy(), np.asarray(s_jax))
    assert (q_pad[:, 70:] == 0).all()
    deq = (q_pad.float().view(N, 3, 32) * s_pad.view(N, 3, 1)).view(N, 96)
    quantum = s_pad.repeat_interleave(32, dim=1)
    assert ((deq - torch.from_numpy(padded)).abs() <= quantum).all()
    # through the optimizer: b (7 elements over 4 ranks, cols 2) pads one
    # slot, which holds a zero ag residual after int8 steps
    for r, o in enumerate(world):
        ag = o["int8_ef"]["state"]["wire"]["ag"]
        if r == N - 1:
            assert float(ag[1][1]) == 0.0  # rank 3's second slot is pad
        assert float(o["int8_ef"]["state"]["wire"]["rs"][0].abs().max()) > 0
    carried = np.concatenate([o["int8_ef"]["state"]["wire"]["ag"][1].numpy()
                              for o in world])
    assert np.abs(carried[:7]).max() > 0


def _jax_step(opt, mesh, stage):
    """The canonical steps of ``tests/test_zero.py`` (full gradients into
    ``update`` at stage 1, the in-backprop scatter at 2, shard rows at
    3) on this file's loss."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd

    ax = jhvd.WORLD_AXIS

    def loss_fn(p, xb, yb):
        return jnp.mean((xb @ p["w"] + p["b"] + p["s"] - yb) ** 2)

    spec = opt.state_spec()
    pspec = spec if stage == 3 else P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(pspec, spec, P(ax), P(ax)),
             out_specs=(pspec, spec, P()), check_vma=False)
    def step(p, st, xb, yb):
        local = opt.local_shards(p) if stage == 3 else p
        if stage == 1:
            loss, g = jax.value_and_grad(loss_fn)(local, xb[0], yb[0])
        else:
            loss, g = opt.value_and_grad(loss_fn)(local, xb[0], yb[0])
        u, st = opt.update(g, st, local)
        new = optax.apply_updates(local, u)
        return (opt.as_rows(new) if stage == 3 else new), st, (
            jax.lax.pmean(loss, ax))

    return jax.jit(step)


def _jax_train(stage, inner, steps=3, seed=0):
    import jax
    import optax
    from jax.sharding import Mesh

    import horovod_tpu as jhvd

    params, x, y = _problem(seed)
    make = {"sgd": lambda: optax.sgd(LR, momentum=0.9),
            "adam": lambda: optax.adam(LR)}[inner]
    opt = jhvd.ShardedDistributedOptimizer(
        make(), op=jhvd.Sum, zero_stage=stage, overlap_buckets=2,
        overlap_min_bytes=0, world=N, hierarchical=False)
    mesh = Mesh(np.asarray(jax.devices()[:N]), (jhvd.WORLD_AXIS,))
    st = opt.init(params)
    seen = []
    step = _jax_step(opt, mesh, stage)
    p = opt.init_params(params) if stage == 3 else params
    for _ in range(steps):
        p, st, _ = step(p, st, x, y)
        seen.append(_np(opt.unshard_params(jax.device_get(p))
                        if stage == 3 else p))
    return seen


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_stages_match_jax(hvd, world, inner):
    """Each stage of the port against the same stage of the JAX package
    (module docstring's bounds), every rank the same bits."""
    for stage in (1, 2, 3):
        want = _jax_train(stage, inner)
        for o in world:
            got = o[f"{inner}_z{stage}"]["params"]
            for step in range(3):
                for k in ("w", "b", "s"):
                    a, b = got[step][k].numpy(), want[step][k]
                    if inner == "sgd":
                        tol = 8 * ULP * max(np.abs(b).max(), 1.0)
                    else:
                        tol = 2e-6
                    assert np.abs(a - b).max() <= tol, (stage, step, k)
                    np.testing.assert_array_equal(
                        a, world[0][f"{inner}_z{stage}"]["params"][step][
                            k].numpy())


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_stages_2_and_3_bitwise_stage_1(world, inner):
    for o in world:
        one = o[f"{inner}_z1"]
        for stage in (2, 3):
            other = o[f"{inner}_z{stage}"]
            assert one["losses"] == other["losses"]
            for a, b in zip(one["params"], other["params"]):
                for k in a:
                    assert torch.equal(a[k], b[k]), (stage, k)
            sa, sb = one["state"]["state"], other["state"]["state"]
            for idx in sa["state"]:
                for key, v in sa["state"][idx].items():
                    assert torch.equal(v, sb["state"][idx][key])


def test_per_tensor_and_two_level_routes(world):
    """``overlap_buckets=0`` (a collective a tensor) and the two-level
    route train to the bucketed flat route's parameters within 1e-6."""
    for o in world:
        want = o["sgd_z1"]["params"][-1]
        for key in ("sgd_z1_per_tensor", "sgd_z2_hier"):
            got = o[key]["params"][-1]
            for k in want:
                assert (got[k] - want[k]).abs().max() <= 1e-6, (key, k)


def test_quantized_wires_train(world):
    exact = [np.mean([o["adam_z2_6"]["losses"][s] for o in world])
             for s in range(6)]
    for key in ("int8_ef", "int8_z3"):
        losses = [np.mean([o[key]["losses"][s] for o in world])
                  for s in range(6)]
        # Adam at lr 1e-2 moves each parameter ≈ 1e-2 a step: the loss
        # falls every step, and the int8 wire's stays within 0.5 % of
        # the fp32 wire's
        assert all(b < a for a, b in zip(losses, losses[1:])), losses
        assert np.abs(np.asarray(losses) / exact - 1).max() < 5e-3, (
            key, losses, exact)
        for o in world:  # the replicas stay bitwise equal
            for k, v in o[key]["params"][-1].items():
                assert torch.equal(v, world[0][key]["params"][-1][k])
    assert all(o["int8_ef"]["state"]["wire"]["step"] == 6 for o in world)
    for o in world:
        for k, v in o["bf16_z2"]["params"][-1].items():
            assert (v - o["sgd_z2"]["params"][-1][k]).abs().max() < 2e-2


def test_guard_skip_keeps_everything(world):
    """A NaN in rank 0's batch at step 3: every rank skips (one scalar
    all-reduce agrees it), the parameters, the inner state and both
    residuals stay bitwise, and the skip is counted."""
    for o in world:
        g = o["guard"]
        for k in g["params"][2]:
            assert torch.equal(g["params"][3][k], g["params"][2][k])
        before, after = g["state_before"], g["state"]
        for idx, entry in before["state"]["state"].items():
            for key, v in entry.items():
                assert torch.equal(v, after["state"]["state"][idx][key])
        for kind in ("rs", "ag"):
            for i, v in before["wire"][kind].items():
                assert torch.equal(v, after["wire"][kind][i])
        assert after["guard"] == {"skips": 1, "streak": 1, "step": 4}
        assert after["wire"]["step"] == 4  # the seed advances on a skip


def test_parameter_without_gradient_is_not_stepped(world):
    """ROADMAP C2's scenario at every stage: ``late`` has a gradient on
    step 0 only; SGD with momentum and weight decay, and AdamW, leave it
    where step 0 put it."""
    for o in world:
        for inner in ("sgd_wd", "adamw"):
            for stage in (1, 2, 3):
                p = o[f"late_{inner}_z{stage}"]["params"]
                assert not torch.equal(p[0]["late"], torch.ones(5))
                for later in p[1:]:
                    assert torch.equal(later["late"], p[0]["late"]), (
                        inner, stage)
                assert torch.equal(p[-1]["w"], world[0][
                    f"late_{inner}_z{stage}"]["params"][-1]["w"])


def _port_opt(hvd, stage=2, **kw):
    params, _, _ = _problem(0)
    model = _Lin(params)
    return model, hvd.ShardedDistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=LR), zero_stage=stage,
        op=hvd.Sum, overlap_buckets=2, overlap_min_bytes=0,
        hierarchical=False, **kw)


@pytest.fixture
def one(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_INTRA_SIZE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_reshard_state_carries_and_resumes(world, one):
    hvd = one
    model, opt = _port_opt(hvd, wire="int8", wire_block=32,
                           error_feedback=True, grad_guard=True)
    states = [o["guard"]["state"] for o in world]
    sizes = {0: 84, 1: 7, 2: 1}
    for m in (3, 1):
        new = opt.reshard_state(states, m)
        assert len(new) == m and all(s["world"] == m for s in new)
        for idx, entry in states[0]["state"]["state"].items():
            for key, v in entry.items():
                if v.dim() == 0:
                    assert all(torch.equal(s["state"]["state"][idx][key], v)
                               for s in new)
                    continue
                old = torch.cat([s["state"]["state"][idx][key]
                                 for s in states])[:sizes[idx]]
                got = torch.cat([s["state"]["state"][idx][key]
                                 for s in new])[:sizes[idx]]
                assert torch.equal(old, got)
        for i in (0, 1):
            old = torch.cat([s["wire"]["ag"][i] for s in states])[:sizes[i]]
            got = torch.cat([s["wire"]["ag"][i] for s in new])[:sizes[i]]
            assert torch.equal(old, got)
            total = states[0]["wire"]["rs"][i].clone()
            for s in states[1:]:
                total += s["wire"]["rs"][i]
            assert torch.equal(new[0]["wire"]["rs"][i], total)
            assert all(not s["wire"]["rs"][i].any() for s in new[1:])
        assert all(s["guard"] == states[0]["guard"] for s in new)
        assert all(s["wire"]["step"] == 4 for s in new)
    # resume in a world of one from the re-split state
    opt.load_state_dict(opt.reshard_state(states, 1)[0])
    model.load_state_dict({k: v for k, v in world[0]["guard"]["params"][
        -1].items()})
    _, x, y = _problem(0)
    xb = torch.from_numpy(x.reshape(-1, D_IN))
    yb = torch.from_numpy(y.reshape(-1, D_OUT))
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = _mse(model, xb, yb)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert opt.state_dict()["guard"]["step"] == 7
    with pytest.raises(ValueError, match="reshard_state"):
        opt.load_state_dict(states[0])
    plain = _port_opt(hvd)[1]
    with pytest.raises(ValueError, match="reshard_state"):
        plain.load_state_dict(opt.state_dict())
    # the migration: the wire and guard rows follow the new optimizer
    down = plain.reshard_state(states, 2)
    assert "wire" not in down[0] and "guard" not in down[0]
    up = opt.reshard_state([plain.state_dict()], 2)
    assert up[0]["wire"]["rs"][0].shape == (D_IN, D_OUT)
    assert up[1]["wire"]["ag"][1].shape == (4,)


def test_reshard_params_stage3(world, one):
    _, opt = _port_opt(one, stage=3)
    shards = [o["adam_z3"]["shards"] for o in world]
    full = world[0]["adam_z3"]["params"][-1]
    for m in (3, 1):
        new = opt.reshard_params(shards, m)
        back = opt.reshard_params(new, N)
        for i, k in enumerate(("w", "b", "s")):
            assert all(torch.equal(a[i], b[i]) for a, b in zip(back, shards))
            if k == "s":
                assert torch.equal(new[0][i], full[k])
                continue
            got = torch.cat([s[i] for s in new])[:full[k].numel()]
            assert torch.equal(got.view(full[k].shape), full[k])
    opt.load_param_shards(opt.reshard_params(shards, 1)[0])
    for k, v in opt.gather_params().items():
        name = {"param.0": "w", "param.1": "b", "param.2": "s"}[k]
        assert torch.equal(v, full[name])
    with pytest.raises(ValueError, match="reshard_params"):
        opt.load_param_shards(shards[0])


def test_elastic_8_to_6_equals_jax(hvd, one):
    """``test_zero.py:616``'s shape: the JAX optimizer at world 8 (int8,
    error feedback, guard) after 4 steps, its state taken into the
    port's layout rank by rank, re-split to 6 by the port and by the JAX
    package: the same moments, residuals, seed and counters, bit for
    bit."""
    import jax
    import optax
    from jax.sharding import Mesh

    import horovod_tpu as jhvd

    params, x, y = _problem(12, n=8, d_in=24, d_out=9)
    jopt = jhvd.ShardedDistributedOptimizer(
        optax.adam(LR), op=jhvd.Sum, zero_stage=2, overlap_buckets=2,
        overlap_min_bytes=0, wire="int8", wire_block=32,
        error_feedback=True, grad_guard=True, world=8, hierarchical=False)
    st = jopt.init(params)
    step = _jax_step(jopt, Mesh(np.asarray(jax.devices()[:8]),
                                (jhvd.WORLD_AXIS,)), 1)
    p = params
    for _ in range(4):
        p, st, _ = step(p, st, x, y)
    st = jax.device_get(st)
    want = jopt.reshard_state(st, params, 6)

    model = _Lin(params)
    opt = one.ShardedDistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=LR), zero_stage=2,
        wire="int8", wire_block=32, error_feedback=True, grad_guard=True)
    order = ("w", "b", "s")  # the port's parameter order
    adam = st["state"][0]

    def port_state(r, s, adam, n):
        t = lambda a: torch.from_numpy(np.array(a[r]))  # noqa: E731
        return {
            "state": {"state": {i: {"step": t(adam.count).float(),
                                    "exp_avg": t(adam.mu[k]),
                                    "exp_avg_sq": t(adam.nu[k])}
                                for i, k in enumerate(order)},
                      "param_groups": opt._inner.state_dict()[
                          "param_groups"]},
            "world": n, "rank": r,
            "guard": {k: int(np.asarray(v)[r])
                      for k, v in s["guard"].items()},
            "wire": {"step": int(np.asarray(s["wire"]["step"])[r]),
                     "rs": {i: t(s["wire"]["rs"][k])
                            for i, k in enumerate(order)},
                     "ag": {i: t(s["wire"]["ag"][k])
                            for i, k in enumerate(order)}}}

    got = opt.reshard_state([port_state(r, st, adam, 8) for r in range(8)],
                            6)
    expect = [port_state(r, want, want["state"][0], 6) for r in range(6)]
    for g, e in zip(got, expect):
        for idx in range(3):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(g["state"]["state"][idx][key],
                                   e["state"]["state"][idx][key]), (idx, key)
            for kind in ("rs", "ag"):
                assert torch.equal(g["wire"][kind][idx],
                                   e["wire"][kind][idx]), (kind, idx)
        assert g["wire"]["step"] == e["wire"]["step"] == 4
        assert g["guard"] == e["guard"]
