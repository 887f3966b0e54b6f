"""Local SGD in the port (``horovod_tpu_torch/local_sgd.py``, the grouped
Adasum of ``ops/adasum.py``, ``DistributedOptimizer(local_sgd_steps=)``
and the fusion manager's local phase) against the JAX package's
(``tests/test_local_sgd.py``'s cases on the 8-device CPU mesh of
tests/conftest.py), in gloo worlds on the CPU.

Worlds (``_ls_worker``, once per module each): 8 ranks in slices of 4
and of 2 (``local_sgd_intra``/``stages``; ``hvd.init`` makes no split of
its own, so the local split's groups are new), and 6 ranks in slices of
2 (3 slices: VHDD's excess pre-reduction). Inputs come from numpy
seeds, rank r taking row r or its slice's row. Tolerances:

- the grouped Adasum on the fp32 wire: within rtol 1e-5, atol 1e-6 of
  the JAX function and of the fp64 host oracle (``adasum_vhdd_host``),
  every rank the same bits; scale invariance against the oracle within
  rtol 1e-4, atol 1e-5 (the JAX test's);
- the int8 wire (the port's Philox cannot match ``jax.random``'s bits):
  the error-feedback pre-quantization's scales bitwise JAX's
  ``_stochastic_round_blocks`` on the same input and each value within
  one quantum; the merge within 0.05 of the oracle's largest magnitude
  (the JAX test's bound); every rank the same bits;
- error feedback: the new residual is bitwise the fp32 remainder
  ``x_eff − dequant(quant(x_eff))`` of what the wire sent, chained over
  two rounds, and ``quantized + residual'`` is ``x_eff`` within that
  subtraction's rounding (exactly, on all but the elements under half
  a quantum that rounded away from zero);
- the optimizer: K = 1 bitwise the plain optimizer; after local steps
  the slices' replicas equal and the slices apart; after ``opt.sync()``
  every rank equal, within rtol 1e-5, atol 1e-5 of JAX's ``sync`` and of
  the oracle over the deltas. JAX's "zero inter groups in the lowered
  program" is a recorder of the groups handed to ``torch.distributed``
  during each local step: every one lies inside this rank's slice.

Ranks run as separate interpreters with a deadline
(``test_torch_collectives._run``)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

from horovod_tpu_torch.ops import adasum as port_adasum
from horovod_tpu_torch.ops import cuda_kernels as ck

WORLDS = [(8, 4), (8, 2), (6, 2)]
LR = 0.1


def _slice_vals(h, m, seed):
    return np.random.default_rng(seed).normal(size=(h, m)).astype(np.float32)


def _opt_params():
    """``tests/test_local_sgd.py``'s ``_params(rng)``."""
    rng = np.random.default_rng(42)
    return {"w": rng.normal(size=(24, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}


def _opt_grads(n, seed=7):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 24, 8)).astype(np.float32),
            "b": rng.normal(size=(n, 8)).astype(np.float32)}


def _ef_shards(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 300)).astype(np.float32)


# ------------------------------------------------------------- the worker


def _opt(hvd, params, **kw):
    """SGD over fresh parameters ``w``, ``b`` through the port's
    DistributedOptimizer."""
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in ("w", "b")]
    return ps, hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=LR),
                                        op=hvd.Average, **kw)


def _step(ps, opt, grads, rank, recorder=None):
    for p, k in zip(ps, ("w", "b")):
        p.grad = torch.from_numpy(grads[k][rank].copy())
    if recorder is None:
        opt.step()
        return []
    with recorder() as calls:
        opt.step()
    return [tuple(c) for c in calls]


def _snap(ps):
    return [p.detach().clone() for p in ps]


def _ls_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import local_sgd
    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.common.retry import RetryPolicy
    from horovod_tpu_torch.testing import chaos
    from horovod_tpu_torch.testing.recorder import record_collectives

    L = int(os.environ["LS_INTRA"])
    H = n // L
    hvd.init(device="cpu", store=file_store(outdir, n))
    stages = topology.hierarchical_stage_groups(n, L)
    h = rank // L
    out = {}

    # the grouped Adasum: fp32, scaled, int8
    vals = _slice_vals(H, 97, 1)
    out["fp32"] = port_adasum.adasum_allreduce_groups(
        torch.from_numpy(vals[h]), stages, "fp32")
    scaled = vals[h] * (7.5 if h == 0 else 1.0)
    out["scaled"] = port_adasum.adasum_allreduce_groups(
        torch.from_numpy(scaled), stages, "fp32")
    v512 = _slice_vals(H, 512, 2)
    out["int8"] = port_adasum.adasum_allreduce_groups(
        torch.from_numpy(v512[h]), stages, "int8", seed=3)

    # error feedback on the shard form, chained over two rounds
    s1, s2 = _ef_shards(n, 10)[rank], _ef_shards(n, 11)[rank]
    m1, r1 = port_adasum.adasum_sync_shard(
        torch.from_numpy(s1), stages, "int8", seed=5, return_residual=True)
    m2, r2 = port_adasum.adasum_sync_shard(
        torch.from_numpy(s2), stages, "int8", seed=6, residual=r1,
        return_residual=True)
    m2_cold = port_adasum.adasum_sync_shard(
        torch.from_numpy(s2), stages, "int8", seed=6)
    out["ef"] = {"r1": r1, "r2": r2, "m2": m2, "m2_cold": m2_cold}

    # the optimizer on each inter wire: 2 local steps, then the round
    params, grads = _opt_params(), _opt_grads(n)
    for wire in ("fp32", "int8"):
        ps, opt = _opt(hvd, params, local_sgd_steps=2, local_sgd_intra=L,
                       local_sgd_inter_wire=wire)
        rec = {"steps": [], "calls": []}
        for _ in range(2):
            rec["calls"].append(_step(ps, opt, grads, rank,
                                      record_collectives))
            rec["steps"].append(_snap(ps))
        if wire == "int8":
            anchor = [a.clone() for a in opt._anchor]
        with record_collectives() as calls:
            opt.sync()
        rec["sync_calls"] = [tuple(c) for c in calls]
        rec["synced"] = _snap(ps)
        rec["anchor"] = [a.clone() for a in opt._anchor]
        if wire == "int8":
            rec["residual"] = [r.clone() for r in opt._local_res]
            # the carry joins the next round's signal: the same round
            # body from the same parameters with and without it
            for _ in range(2):
                _step(ps, opt, grads, rank)
            with torch.no_grad():
                rec["with_carry"] = local_sgd.sync_tree(
                    ps, opt._anchor, opt._local_res, stages=stages,
                    seed=9, return_residual=True)[0]
                rec["no_carry"] = local_sgd.sync_tree(
                    ps, opt._anchor,
                    [torch.zeros_like(r) for r in opt._local_res],
                    stages=stages, seed=9, return_residual=True)[0]
            rec["first_anchor"] = anchor
        opt.remove_hooks()
        out[f"opt_{wire}"] = rec

    if (n, L) == (8, 4):
        out.update(_driver_checks(hvd, rank, n, L, params, grads, registry,
                                  RetryPolicy, chaos, local_sgd,
                                  record_collectives))
        out["eager"] = _eager_checks(hvd, rank, n, stages, local_sgd,
                                     record_collectives)
        out["env"] = _env_checks(hvd, rank, n, L, params, outdir)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def _driver_checks(hvd, rank, n, L, params, grads, registry, RetryPolicy,
                   chaos, local_sgd, record_collectives):
    out = {}
    # K = 1 is the plain optimizer, bit for bit
    runs = []
    for kw in ({}, {"local_sgd_steps": 1}):
        ps, opt = _opt(hvd, params, **kw)
        for _ in range(3):
            _step(ps, opt, grads, rank)
        runs.append(_snap(ps))
        opt.remove_hooks()
    out["k1"] = runs

    # the guard, agreed within the slice: a NaN on rank 0
    ps, opt = _opt(hvd, params, local_sgd_steps=2, local_sgd_intra=L,
                   grad_guard=True)
    bad = {k: v.copy() for k, v in grads.items()}
    bad["w"][0, 0, 0] = np.nan
    _step(ps, opt, bad, rank)
    out["guard"] = _snap(ps)
    opt.remove_hooks()

    # chaos on rank 0 only: two resets beat 2 attempts, so the round
    # defers on every rank, and the next one completes
    policy = RetryPolicy.from_env("local_sgd.sync", attempts=2,
                                  backoff_ms=1.0, circuit_threshold=0)
    ps, opt = _opt(hvd, params, local_sgd_steps=2, local_sgd_intra=L)
    base = registry.snapshot()
    if rank == 0:
        chaos.configure("seed=7;local_sgd.sync@1:reset;local_sgd.sync@2:reset")
    hist, around = [], []
    try:
        for i in range(4):
            _step(ps, opt, grads, rank)
            before = _snap(ps)
            _, synced = local_sgd.maybe_sync(
                opt.sync, step=i, k=opt.local_sgd_steps, policy=policy,
                payload_bytes=opt.local_payload_bytes,
                stages=opt.local_stages)
            hist.append(synced)
            around.append((before, _snap(ps)))
    finally:
        chaos.reset()
    snap = registry.snapshot()
    out["defer"] = {
        "hist": hist, "around": around, "final": _snap(ps),
        "counts": {k: snap.get(k, 0) - base.get(k, 0) for k in (
            "local_sgd.rounds_deferred", "local_sgd.sync_rounds",
            "local_sgd.local_steps", "local_sgd.inter_bytes",
            "faults_injected", "retry.local_sgd.sync.attempts")},
        "payload": opt.local_payload_bytes}
    opt.remove_hooks()

    # one fault on rank 3 only: the round retries whole, applies once
    twins = []
    for faulted in (False, True):
        ps, opt = _opt(hvd, params, local_sgd_steps=2, local_sgd_intra=L)
        for _ in range(2):
            _step(ps, opt, grads, rank)
        base = registry.snapshot()
        if faulted and rank == 3:
            chaos.configure("seed=7;local_sgd.sync@1:timeout")
        try:
            _, synced = local_sgd.run_round(
                opt.sync, policy=RetryPolicy.from_env(
                    "local_sgd.sync", attempts=3, backoff_ms=1.0,
                    circuit_threshold=0))
        finally:
            chaos.reset()
        snap = registry.snapshot()
        twins.append({"synced": synced, "params": _snap(ps),
                      "deferred": snap.get("local_sgd.rounds_deferred", 0)
                      - base.get("local_sgd.rounds_deferred", 0)})
        opt.remove_hooks()
    out["retry"] = twins

    # rejoin: slice 0 restored at the anchor, slice 1 trained on
    ps, opt = _opt(hvd, params, local_sgd_steps=4, local_sgd_intra=L,
                   local_sgd_inter_wire="fp32")
    for _ in range(3):
        _step(ps, opt, grads, rank)
    trained = _snap(ps)
    if rank < L:
        with torch.no_grad():
            for p, a in zip(ps, opt._anchor):
                p.copy_(a)
    anchor = [a.clone() for a in opt._anchor]
    _, synced = local_sgd.rejoin_sync(opt.sync)
    out["rejoin"] = {"synced": synced, "trained": trained,
                     "anchor": anchor, "after": _snap(ps)}
    # the state carries the anchor; a plain optimizer refuses it
    sd = opt.state_dict()
    out["state_keys"] = sorted(sd["local_sgd"])
    plain_ps, plain = _opt(hvd, params)
    try:
        plain.load_state_dict(sd)
        out["plain_loads_local"] = "loaded"
    except ValueError as e:
        out["plain_loads_local"] = str(e)
    plain.remove_hooks()
    opt.remove_hooks()

    opt.remove_hooks()
    return out


def _eager_checks(hvd, rank, n, stages, local_sgd, record_collectives):
    """The fusion manager's local phase (``test_local_sgd.py``'s
    ``TestEagerLocalPhase``)."""
    from horovod_tpu_torch.common import basics

    fusion = basics.state().fusion
    out = {}
    x = torch.full((8,), float(rank))
    before = fusion.local_dispatches
    with local_sgd.local_phase(stages):
        with record_collectives() as calls:
            out["sum"] = hvd.allreduce(x, op=hvd.Sum)
        out["calls"] = [tuple(c) for c in calls]
        out["dispatches"] = fusion.local_dispatches - before
        base = torch.linspace(0.0, 1.0, 4096)
        out["int8"] = hvd.allreduce(base + rank, op=hvd.Average,
                                    compression=hvd.Compression.int8)
        out["int8_format"] = fusion.last_wire_format
        ints = torch.arange(32, dtype=torch.float32) + 4 * rank
        out["hier"] = hvd.allreduce(ints, op=hvd.Sum,
                                    compression=hvd.Compression.hier_int8)
        out["hier_format"] = fusion.last_wire_format
        # a batch cut across a phase switch keeps each side's route
        inside = hvd.allreduce_async(x, op=hvd.Sum, name="inside")
    outside = hvd.allreduce_async(x, op=hvd.Sum, name="outside")
    out["inside"], out["outside"] = inside.wait(), outside.wait()
    out["flat"] = hvd.allreduce(x, op=hvd.Sum)
    local_sgd.set_local_phase(stages)
    out["active"] = local_sgd.active_intra_groups()
    local_sgd.reset()
    out["reset"] = local_sgd.active_intra_groups()
    return out


def _env_checks(hvd, rank, n, L, params, outdir):
    """``HOROVOD_LOCAL_SGD_STEPS`` engages local SGD, with one warning
    for the process."""
    import warnings

    import torch.distributed as dist

    from horovod_tpu_torch import local_sgd

    hvd.shutdown()
    os.environ["HOROVOD_LOCAL_SGD_STEPS"] = "2"
    hvd.init(device="cpu",
             store=dist.FileStore(str(Path(outdir) / "store_env"), n))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        opts = [_opt(hvd, params, local_sgd_intra=L)[1] for _ in range(2)]
    out = {"default": local_sgd.default_steps(),
           "steps": [o.local_sgd_steps for o in opts],
           "warnings": sum("HOROVOD_LOCAL_SGD_STEPS=2" in str(w.message)
                           for w in seen)}
    for o in opts:
        o.remove_hooks()
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def world(request, tmp_path_factory):
    n, L = request.param
    outs = _run(tmp_path_factory.mktemp(f"local{n}_{L}"), n, Path(__file__),
                "_ls_worker", 150, {"LS_INTRA": str(L)})
    return n, L, outs


@pytest.fixture(scope="module")
def w84(tmp_path_factory):
    """The world of 8 in slices of 4 (run once, shared)."""
    return _run(tmp_path_factory.mktemp("local8_4x"), 8, Path(__file__),
                "_ls_worker", 150, {"LS_INTRA": "4"})


# ------------------------------------------------------------ JAX side


def _jax_groups(vals, L, wire="fp32", seed=0):
    """JAX ``adasum_allreduce_groups`` on as many devices as ranks, each
    rank holding its slice's row."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.common.topology import hierarchical_stage_groups
    from horovod_tpu.ops.adasum import adasum_allreduce_groups

    n = len(vals) * L
    stages = hierarchical_stage_groups(n, L)
    rows = np.stack([vals[r // L] for r in range(n)]).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("hvd"),),
             out_specs=P("hvd"), check_vma=False)
    def run(x):
        return adasum_allreduce_groups(
            x[0], axis_name="hvd", stages=stages, inter_wire=wire,
            seed=seed)[None]

    return np.asarray(jax.jit(run)(jnp.asarray(rows)))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=atol)


def _same_bits(tensors):
    return all(torch.equal(t, tensors[0]) for t in tensors[1:])


# ------------------------------------------------------ the grouped Adasum


def test_grouped_adasum_matches_jax_and_oracle(world):
    n, L, outs = world
    vals = _slice_vals(n // L, 97, 1)
    want = port_adasum.adasum_vhdd_host(vals.astype(np.float64))
    jax_out = _jax_groups(vals, L)
    for r, o in enumerate(outs):
        _close(o["fp32"].numpy(), want)
        _close(o["fp32"].numpy(), jax_out[r])
    assert _same_bits([o["fp32"] for o in outs])


def test_grouped_adasum_scale_invariance(world):
    """Adasum does not care how far a slice went: scaling slice 0's
    delta moves the merge as the oracle says, not as an average."""
    n, L, outs = world
    vals = _slice_vals(n // L, 97, 1)
    scaled = vals.copy()
    scaled[0] *= 7.5
    want = port_adasum.adasum_vhdd_host(scaled.astype(np.float64))
    _close(outs[0]["scaled"].numpy(), want, rtol=1e-4, atol=1e-5)
    assert not np.allclose(outs[0]["scaled"].numpy(),
                           outs[0]["fp32"].numpy())


def test_grouped_adasum_int8_wire(world):
    n, L, outs = world
    vals = _slice_vals(n // L, 512, 2)
    want = port_adasum.adasum_vhdd_host(vals.astype(np.float64))
    scale = np.abs(want).max()
    for o in outs:
        assert np.abs(o["int8"].numpy() - want).max() < 0.05 * scale
    assert _same_bits([o["int8"] for o in outs])
    jax_out = _jax_groups(vals, L, wire="int8", seed=3)
    assert np.abs(jax_out[0] - want).max() < 0.05 * scale


def _prequant(x_eff, seed, rank):
    """The port's pre-quantization of ``x_eff`` as ``adasum_sync_shard``
    keys it (the plain B3 on the CPU): values, scales, dequantized."""
    block = min(512, x_eff.size)
    q, s = ck.int8_block_quantize_plain(
        torch.from_numpy(x_eff), block, seed=seed,
        stream=(port_adasum._PREQUANT << 20) | rank)
    return q, s, ck.int8_block_dequantize(q, s, block).numpy()


def test_ef_prequantization_contract_and_chaining(world):
    """Two chained rounds on the shard form: each carry is bitwise the
    fp32 remainder of what the wire sent, the quantized value plus the
    carry is the signal within that subtraction's rounding, the scales
    are JAX's bit for bit and the values within one quantum of JAX's,
    and the carry changes the next round."""
    import jax

    from horovod_tpu.ops.traced import (_block_dequant,
                                        _stochastic_round_blocks)

    n, L, outs = world
    s1, s2 = _ef_shards(n, 10), _ef_shards(n, 11)
    exact = total = 0
    for r, o in enumerate(outs):
        ef = o["ef"]
        carry = np.zeros(300, np.float32)
        for sig, seed, res in ((s1[r], 5, ef["r1"]), (s2[r], 6, ef["r2"])):
            x_eff = (sig + carry).astype(np.float32)
            q, scales, q_x = _prequant(x_eff, seed, r)
            np.testing.assert_array_equal(res.numpy(), x_eff - q_x)
            back = q_x + res.numpy()
            bound = (np.spacing(np.abs(res.numpy()))
                     + np.spacing(np.abs(x_eff))) / 2
            assert np.all(np.abs(back - x_eff) <= bound)
            exact += int((back == x_eff).sum())
            total += x_eff.size
            # jitted, as the JAX round runs it (XLA takes the division
            # by 127 as a product with its reciprocal, as B3 does)
            jq, js = jax.jit(lambda v, k: _stochastic_round_blocks(
                v, 300, k))(x_eff[None], jax.random.PRNGKey(seed))
            np.testing.assert_array_equal(scales.numpy(),
                                          np.asarray(js).reshape(-1))
            steps = np.abs(q.numpy().astype(np.int32)
                           - np.asarray(jq).reshape(-1)[:300])
            assert steps.max() <= 1  # within one quantum
            jq_x = np.asarray(_block_dequant(jq, js))[0][:300]
            assert np.all((q_x == jq_x) == (steps == 0))
            carry = res.numpy()
        assert np.any(ef["r1"].numpy() != 0)
        assert not torch.equal(ef["m2"], ef["m2_cold"])
    assert exact / total > 0.99


# ------------------------------------------------------------ the optimizer


def test_local_steps_stay_in_the_slice_then_sync_reconciles(world):
    """Local steps: each slice's ranks bitwise equal, the slices apart,
    and every collective a step hands to torch.distributed inside this
    rank's slice; after the round every rank bitwise equal, and the
    anchor is the new parameters."""
    n, L, outs = world
    for wire in ("fp32", "int8"):
        for s in range(2):
            steps = [o[f"opt_{wire}"]["steps"][s] for o in outs]
            for h in range(n // L):
                for k in range(2):
                    assert _same_bits([steps[h * L + i][k]
                                       for i in range(L)])
            assert not torch.allclose(steps[0][0], steps[L][0])
        for r, o in enumerate(outs):
            mine = set(range(r // L * L, r // L * L + L))
            calls = [c for step in o[f"opt_{wire}"]["calls"] for c in step]
            assert calls and all(set(c[1]) <= mine for c in calls), calls
            assert any(not set(c[1]) <= mine
                       for c in o[f"opt_{wire}"]["sync_calls"])
        synced = [o[f"opt_{wire}"]["synced"] for o in outs]
        for k in range(2):
            assert _same_bits([s[k] for s in synced])
            assert torch.equal(outs[0][f"opt_{wire}"]["anchor"][k],
                               synced[0][k])


def test_sync_matches_jax_and_the_oracle_of_the_deltas(world, hvd):
    """The fp32 round against JAX's ``sync`` on the same parameters and
    gradients (``test_sync_matches_host_adasum_of_deltas``), and against
    the host oracle over the slices' deltas."""
    n, L, outs = world
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    params, grads = _opt_params(), _opt_grads(n)
    opt = hvd.DistributedOptimizer(
        optax.sgd(LR), op=hvd.Average, local_sgd_steps=2,
        local_sgd_intra=L, local_sgd_inter_wire="fp32")
    mesh = Mesh(np.asarray(jax.devices()[:n]), (hvd.WORLD_AXIS,))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    step = _make_opt_step(hvd, opt, mesh)
    pm, sm = _rank_major(jp, n), _rank_major(opt.init(jp), n)
    for s in range(2):
        pm, sm = step(pm, sm, jg)
        for r, o in enumerate(outs):
            got = o["opt_fp32"]["steps"][s]
            _close(got[0].numpy(), np.asarray(pm["w"])[r], 1e-6, 1e-6)
    pm2, _ = _make_sync_step(hvd, opt, mesh)(pm, sm)
    deltas = [np.concatenate([
        (outs[h * L]["opt_fp32"]["steps"][1][0].numpy() - params["w"]
         ).reshape(-1),
        outs[h * L]["opt_fp32"]["steps"][1][1].numpy() - params["b"]])
        for h in range(n // L)]
    merged = port_adasum.adasum_vhdd_host(np.stack(deltas).astype(
        np.float64))
    for r, o in enumerate(outs):
        got = o["opt_fp32"]["synced"]
        _close(got[0].numpy(), np.asarray(pm2["w"])[r], 1e-5, 1e-5)
        _close(got[1].numpy(), np.asarray(pm2["b"])[r], 1e-5, 1e-5)
        _close(got[0].numpy().reshape(-1), params["w"].reshape(-1)
               + merged[:192], 1e-5, 1e-5)


def test_ef_residual_chains_across_rounds(world):
    """The int8 round leaves a carry, the same on a slice's ranks, and
    the carry joins the next round's signal."""
    n, L, outs = world
    res = [o["opt_int8"]["residual"] for o in outs]
    assert any(torch.any(r[0] != 0) for r in res)
    for h in range(n // L):
        for k in range(2):
            assert _same_bits([res[h * L + i][k] for i in range(L)])
    for o in outs:
        assert not torch.equal(o["opt_int8"]["with_carry"][0],
                               o["opt_int8"]["no_carry"][0])
    assert _same_bits([o["opt_int8"]["with_carry"][0] for o in outs])


def test_k1_is_the_plain_optimizer_bitwise(w84):
    for o in w84:
        plain, k1 = o["k1"]
        for a, b in zip(plain, k1):
            assert torch.equal(a, b)


def test_guard_skips_only_the_slice_that_saw_the_nan(w84):
    params = _opt_params()
    for r, o in enumerate(w84):
        w = o["guard"][0].numpy()
        if r < 4:
            np.testing.assert_array_equal(w, params["w"])
        else:
            assert not np.allclose(w, params["w"])
            assert np.all(np.isfinite(w))


# ------------------------------------------------------- the round driver


def test_due_and_round_inter_bytes_match_jax():
    from horovod_tpu import local_sgd as jax_ls
    from horovod_tpu.common.topology import hierarchical_stage_groups

    from horovod_tpu_torch import local_sgd
    from horovod_tpu_torch.common import topology

    for k in (1, 2, 4):
        assert [local_sgd.due(i, k) for i in range(12)] == [
            jax_ls.due(i, k) for i in range(12)]
    assert [local_sgd.due(i, 4) for i in range(8)] == [
        False, False, False, True, False, False, False, True]
    for world, L in ((8, 4), (8, 2), (6, 2), (4, 2)):
        ours = topology.hierarchical_stage_groups(world, L)
        theirs = hierarchical_stage_groups(world, L)
        assert [list(g) for g in ours[0]] == theirs[0]
        assert [list(g) for g in ours[1]] == theirs[1]
        for wire in ("int8", "bf16", "fp32"):
            for payload in (1 << 20, 12345, 4 * 406336593):
                assert local_sgd.round_inter_bytes(payload, ours, wire) == \
                    jax_ls.round_inter_bytes(payload, theirs, wire)
    stages = topology.hierarchical_stage_groups(4, 2)
    assert local_sgd.round_inter_bytes(4 * 406336593, stages) == 203168296
    assert local_sgd.round_inter_bytes(4 * 406336593, stages,
                                       "fp32") == 812673188


def test_chaos_fault_on_one_rank_defers_the_round_on_every_rank(w84):
    """Two resets on rank 0 alone beat 2 attempts: the agreement step
    fails every rank's attempts with it, so the round at step 1 defers
    everywhere (the parameters untouched), training goes on, and the
    round at step 3 reconciles every rank bit for bit."""
    from horovod_tpu_torch import local_sgd
    from horovod_tpu_torch.common import topology

    stages = topology.hierarchical_stage_groups(8, 4)
    for r, o in enumerate(w84):
        d = o["defer"]
        assert d["hist"] == [False, False, False, True]
        c = d["counts"]
        assert c["local_sgd.rounds_deferred"] == 1
        assert c["local_sgd.sync_rounds"] == 1
        assert c["local_sgd.local_steps"] == 4
        assert c["local_sgd.inter_bytes"] == local_sgd.round_inter_bytes(
            d["payload"], stages)
        assert c["faults_injected"] == (2 if r == 0 else 0)
        assert c["retry.local_sgd.sync.attempts"] == 3
        before, after = d["around"][1]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    for k in range(2):
        assert not torch.equal(w84[0]["defer"]["around"][1][1][k],
                               w84[4]["defer"]["around"][1][1][k])
        assert _same_bits([o["defer"]["final"][k] for o in w84])


def test_single_fault_retries_the_round_whole_and_applies_it_once(w84):
    """One timeout on rank 3 with 3 attempts: the round retries and
    completes with no deferral, and every rank lands bitwise where the
    same round lands without the fault."""
    for o in w84:
        clean, faulted = o["retry"]
        assert clean["synced"] and faulted["synced"]
        assert faulted["deferred"] == 0
        for a, b in zip(clean["params"], faulted["params"]):
            assert torch.equal(a, b)
    assert _same_bits([o["retry"][1]["params"][0] for o in w84])


def test_rejoin_syncs_from_consensus_not_root(w84):
    """Slice 0 restored at the anchor (a zero delta, Adasum's identity)
    and slice 1 trained on: the rejoin round lands every rank on the
    anchor plus slice 1's progress, not on rank 0's stale values."""
    rj = [o["rejoin"] for o in w84]
    assert all(x["synced"] for x in rj)
    anchor = np.concatenate([a.numpy().reshape(-1)
                             for a in rj[0]["anchor"]])
    d1 = np.concatenate([t.numpy().reshape(-1)
                         for t in rj[4]["trained"]]) - anchor
    merged = port_adasum.adasum_vhdd_host(
        np.stack([np.zeros_like(d1), d1]).astype(np.float64))
    after = np.concatenate([t.numpy().reshape(-1)
                            for t in rj[0]["after"]])
    _close(after, anchor + merged)
    assert not np.allclose(after, anchor)
    assert _same_bits([torch.cat([t.reshape(-1) for t in x["after"]])
                       for x in rj])


def test_state_dict_carries_the_anchor(w84):
    o = w84[0]
    assert o["state_keys"] == ["anchor"]  # the fp32 wire has no residual
    assert "local_sgd" in o["plain_loads_local"]


def test_env_default_engages_with_one_warning(w84):
    for o in w84:
        assert o["env"] == {"default": 2, "steps": [2, 2], "warnings": 1}


# ------------------------------------------------ the eager local phase


def test_fused_allreduce_routes_within_the_slice(w84):
    for r, o in enumerate(x["eager"] for x in w84):
        want = 6.0 if r < 4 else 22.0
        assert torch.equal(o["sum"], torch.full((8,), want))
        assert o["dispatches"] >= 1
        mine = set(range(r // 4 * 4, r // 4 * 4 + 4))
        assert o["calls"] and all(set(c[1]) <= mine for c in o["calls"])
        assert torch.equal(o["inside"], torch.full((8,), want))
        assert torch.equal(o["outside"], torch.full((8,), 28.0))
        assert torch.equal(o["flat"], torch.full((8,), 28.0))


def test_int8_and_hier_int8_in_the_local_phase(w84):
    """int8 within the slice stays within two quanta of the slice's mean
    (the JAX test's 0.11); ``hier_int8``'s int8 was for the inter hop,
    so within the slice it rides bf16, exact on these integers."""
    base = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    for r, o in enumerate(x["eager"] for x in w84):
        h = r // 4
        want = base + np.mean(range(h * 4, h * 4 + 4))
        assert np.abs(o["int8"].numpy() - want).max() < 0.11
        assert o["int8_format"] == "int8"
        ints = sum(np.arange(32) + 4 * j for j in range(h * 4, h * 4 + 4))
        np.testing.assert_array_equal(o["hier"].numpy(), ints)
        assert o["hier_format"] == "bf16"


def test_phase_reset(w84):
    for o in (x["eager"] for x in w84):
        assert o["active"] == ((0, 1, 2, 3), (4, 5, 6, 7))
        assert o["reset"] is None


# ------------------------------------------------ one process, no world


@pytest.fixture
def port():
    import horovod_tpu_torch as phvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    phvd.init(device="cpu")
    yield phvd
    phvd.shutdown()


def test_rejects_bad_configs(port):
    ps = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="Sum/Average"):
        port.DistributedOptimizer(torch.optim.SGD(ps, lr=LR),
                                  op=port.Adasum, local_sgd_steps=4)
    with pytest.raises(ValueError, match="inter_wire"):
        port.DistributedOptimizer(torch.optim.SGD(ps, lr=LR),
                                  local_sgd_steps=4,
                                  local_sgd_inter_wire="fp8")
    with pytest.raises(NotImplementedError, match="process sets"):
        port.DistributedOptimizer(
            torch.optim.SGD(ps, lr=LR), local_sgd_steps=4,
            process_set=port.ProcessSet([0]))
    opt = port.DistributedOptimizer(torch.optim.SGD(ps, lr=LR))
    with pytest.raises(ValueError, match="local_sgd_steps > 1"):
        opt.sync()
    opt.remove_hooks()


def test_unresolvable_split_raises(port):
    """One rank, no intra size: there is no second slice to merge with."""
    ps = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="two-level topology"):
        port.DistributedOptimizer(torch.optim.SGD(ps, lr=LR),
                                  local_sgd_steps=4)
    with pytest.raises(ValueError, match="two-level topology"):
        port.local_sgd.resolve_stages(1)


def test_round_driver_in_a_world_of_one(port):
    """The driver alone: the cadence counts every call, an exhausted
    ladder defers (counted), and a fatal error is not retried."""
    from horovod_tpu_torch import local_sgd
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.common.retry import RetryPolicy
    from horovod_tpu_torch.testing import chaos

    ran = []
    base = registry.snapshot()
    policy = RetryPolicy.from_env("local_sgd.sync", attempts=2,
                                  backoff_ms=0.0, circuit_threshold=0)
    chaos.configure("local_sgd.sync@1:reset;local_sgd.sync@2:reset")
    try:
        got = [local_sgd.maybe_sync(lambda: ran.append(1) or "done", step=i,
                                    k=2, policy=policy) for i in range(4)]
    finally:
        chaos.reset()
    assert got == [(None, False), (None, False), (None, False),
                   ("done", True)]
    assert ran == [1]
    snap = registry.snapshot()
    assert snap["local_sgd.rounds_deferred"] - base.get(
        "local_sgd.rounds_deferred", 0) == 1
    assert snap["local_sgd.local_steps"] - base.get(
        "local_sgd.local_steps", 0) == 4

    def fatal():
        raise PermissionError("not retryable")

    with pytest.raises(PermissionError):
        local_sgd.run_round(fatal, policy=policy)


# ------------------------------------------------ JAX helpers (its test's)


def _rank_major(tree, world=8):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                   (world,) + tuple(np.shape(x))), tree)


def _strip(tree):
    import jax

    return jax.tree_util.tree_map(lambda x: x[0], tree)


def _lift(tree):
    import jax

    return jax.tree_util.tree_map(lambda x: x[None], tree)


def _make_opt_step(hvd, opt, mesh):
    from functools import partial

    import jax
    import optax
    from jax.sharding import PartitionSpec as P

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(hvd.WORLD_AXIS),) * 3,
             out_specs=(P(hvd.WORLD_AXIS), P(hvd.WORLD_AXIS)),
             check_vma=False)
    def step(pm, sm, gm):
        p, s, g = _strip(pm), _strip(sm), _strip(gm)
        u, s = opt.update(g, s, p)
        return _lift(optax.apply_updates(p, u)), _lift(s)

    return jax.jit(step)


def _make_sync_step(hvd, opt, mesh):
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(hvd.WORLD_AXIS),) * 2,
             out_specs=(P(hvd.WORLD_AXIS), P(hvd.WORLD_AXIS)),
             check_vma=False)
    def sync_step(pm, sm):
        p, s = opt.sync(_strip(pm), _strip(sm))
        return _lift(p), _lift(s)

    return jax.jit(sync_step)
