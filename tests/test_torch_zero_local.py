"""ZeRO in local-SGD mode (``ShardedDistributedOptimizer(zero_stage=1|2,
local_sgd_steps=K)``) against the JAX package's
(``tests/test_local_sgd.py``'s ``TestShardedLocalSGD`` on the 8-device CPU
mesh of tests/conftest.py), in one gloo world of 8 processes on the CPU
in slices of 4 (``_zl_worker``, once per module), inputs from numpy
seeds, rank r taking row r.

- Stage 2 with SGD, 2 local steps then ``sync_round()`` on the fp32
  wire: within rtol 1e-5, atol 1e-6 of JAX after each step and after the
  round (torch's and XLA's matmuls round differently); each slice's
  ranks bitwise equal and the slices apart after the local steps, every
  rank bitwise equal after the round; every collective of a local step
  inside this rank's slice (the recorder of ``horovod_tpu_torch.testing``
  in place of JAX's lowered-program audit); stage 1 bitwise stage 2.
- A 0-d parameter enters the round once (at intra position 0): the
  round lands within 1e-5 of the fp64 host oracle over the slices'
  deltas. The int8 inter wire: every rank bitwise equal, a carry left.
- The guard agrees within the slice: a NaN on rank 0 skips slice 0's
  step only.
- State: the ``"local"`` family's 8 → 6 re-split (width gcd(4, 6) = 2)
  carries the anchor bit for bit and the round, the moments re-cut from
  slice 0; a plain optimizer's re-split drops the family; the layout
  mismatches raise. Stage 3 refuses local SGD.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

from horovod_tpu_torch.ops import adasum as port_adasum

N, L = 8, 4
LR = 0.1


def _params(with_scalar=False):
    """``tests/test_local_sgd.py``'s ``_sharded_params(rng)``."""
    rng = np.random.default_rng(42)
    p = {"w": rng.normal(size=(12, 6)).astype(np.float32),
         "b": rng.normal(size=(6,)).astype(np.float32)}
    if with_scalar:
        p["s"] = np.asarray(0.5, np.float32)
    return p


def _xs():
    return np.random.default_rng(3).normal(size=(N, 4, 12)).astype(
        np.float32)


class _Net(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        out = (torch.tanh(x @ self.w) * self.b).sum()
        return out * self.s if hasattr(self, "s") else out


def _zl_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.testing.recorder import record_collectives

    hvd.init(device="cpu", store=file_store(outdir, n))
    x = torch.from_numpy(_xs()[rank])

    def make(params, stage, inner="sgd", **kw):
        net = _Net(params)
        ps = list(net.parameters())
        inner_opt = (torch.optim.SGD(ps, lr=LR) if inner == "sgd"
                     else torch.optim.AdamW(ps, lr=1e-2))
        kw.setdefault("local_sgd_steps", 2)
        kw.setdefault("local_sgd_intra", L)
        return net, hvd.ShardedDistributedOptimizer(
            inner_opt, named_parameters=net.named_parameters(), op=hvd.Sum,
            zero_stage=stage, overlap_buckets=2, overlap_min_bytes=0, **kw)

    def snap(net):
        return [p.detach().clone() for p in net.parameters()]

    def train(net, opt, steps=2, xb=x, record=False):
        seen, calls = [], []
        for _ in range(steps):
            opt.zero_grad()
            with record_collectives() as got:
                (net(xb)).backward()
                opt.step()
            calls.append([tuple(c) for c in got])
            seen.append(snap(net))
        return seen, calls

    out = {}
    for stage in (1, 2):
        net, opt = make(_params(), stage, local_sgd_inter_wire="fp32")
        seen, calls = train(net, opt, record=True)
        opt.sync_round()
        out[f"z{stage}"] = {"steps": seen, "calls": calls,
                            "synced": snap(net),
                            "round": opt.state_dict()["local"]["round"]}
        opt.remove_hooks()

    net, opt = make(_params(True), 1, local_sgd_inter_wire="fp32")
    anchor = snap(net)
    seen, _ = train(net, opt)
    opt.sync_round()
    out["scalar"] = {"anchor": anchor, "trained": seen[-1],
                     "synced": snap(net)}
    opt.remove_hooks()

    net, opt = make(_params(True), 2)  # the int8 inter wire
    train(net, opt)
    opt.sync_round()
    out["int8"] = {"synced": snap(net), "residual": [
        r.clone() for r in opt.state_dict()["local"]["residual"].values()]}
    opt.remove_hooks()

    # the guard: a NaN on rank 0 skips slice 0's step only
    net, opt = make(_params(), 1, grad_guard=True)
    xb = x.clone()
    if rank == 0:
        xb[0, 0] = float("nan")
    train(net, opt, steps=1, xb=xb)
    out["guard"] = {"params": snap(net),
                    "skips": opt.state_dict()["guard"]["skips"]}
    opt.remove_hooks()

    # state: the world's states re-split for 6 ranks, and the mismatches
    net, opt = make(_params(), 2, inner="adamw")
    train(net, opt)
    opt.sync_round()
    states = hvd.allgather_object(opt.state_dict())
    flat_net, flat = make(_params(), 2, inner="adamw", local_sgd_steps=1,
                          local_sgd_intra=None)
    train(flat_net, flat, steps=1)
    errors = {}
    for name, target, sd in (("local_loads_flat", opt, flat.state_dict()),
                             ("flat_loads_local", flat, states[rank])):
        try:
            target.load_state_dict(sd)
            errors[name] = "loaded"
        except ValueError as e:
            errors[name] = str(e)
    wide = dict(states[rank], local=dict(states[rank]["local"], intra=2))
    try:
        opt.load_state_dict(wide)
        errors["width"] = "loaded"
    except ValueError as e:
        errors["width"] = str(e)
    out["errors"] = errors
    if rank == 0:
        out["states"] = states
        out["re6"] = opt.reshard_state(states, 6)
        out["re6_flat"] = flat.reshard_state(states, 6)
    opt.remove_hooks()
    flat.remove_hooks()
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("zero_local"), N, Path(__file__),
                "_zl_worker", 150, None)


def _same_bits(tensors):
    return all(torch.equal(t, tensors[0]) for t in tensors[1:])


def _jax_sharded(hvd, steps=2):
    """JAX's stage-2 local SGD on the same parameters and batches
    (``tests/test_local_sgd.py``'s ``_make_sharded_steps``), SGD in place
    of Adam; the rank-major parameters after each step and the round."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    opt = hvd.ShardedDistributedOptimizer(
        optax.sgd(LR), op=hvd.Sum, zero_stage=2, overlap_buckets=2,
        overlap_min_bytes=0, local_sgd_steps=2, local_sgd_intra=L,
        local_sgd_inter_wire="fp32")
    mesh = hvd.mesh()
    ax = hvd.WORLD_AXIS

    def loss(p, xb):
        return jnp.sum(jnp.tanh(xb @ p["w"]) * p["b"])

    def strip(t):
        return jax.tree_util.tree_map(lambda v: v[0], t)

    def lift(t):
        return jax.tree_util.tree_map(lambda v: v[None], t)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(ax), opt.state_spec(), P(ax)),
             out_specs=(P(ax), opt.state_spec()), check_vma=False)
    def step(pm, s, xb):
        p = strip(pm)
        _, g_sh = opt.value_and_grad(loss)(p, xb[0])
        u, s = opt.update(g_sh, s, p)
        return lift(optax.apply_updates(p, u)), s

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(ax), opt.state_spec()),
             out_specs=(P(ax), opt.state_spec()), check_vma=False)
    def sync(pm, s):
        p, s = opt.sync_round(strip(pm), s)
        return lift(p), s

    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = opt.init(params)
    pm = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v[None], (N,) + v.shape), params)
    seen = []
    for _ in range(steps):
        pm, state = jax.jit(step)(pm, state, jnp.asarray(_xs()))
        seen.append({k: np.asarray(v) for k, v in pm.items()})
    pm, state = jax.jit(sync)(pm, state)
    seen.append({k: np.asarray(v) for k, v in pm.items()})
    return seen


def test_stage2_local_phase_and_sync_match_jax(world, hvd):
    jax_seen = _jax_sharded(hvd)
    for r, o in enumerate(world):
        z = o["z2"]
        for s in range(2):
            for k, name in enumerate(("w", "b")):
                np.testing.assert_allclose(z["steps"][s][k].numpy(),
                                           jax_seen[s][name][r],
                                           rtol=1e-5, atol=1e-6)
        for k, name in enumerate(("w", "b")):
            np.testing.assert_allclose(z["synced"][k].numpy(),
                                       jax_seen[2][name][r],
                                       rtol=1e-5, atol=1e-6)
        assert z["round"] == 1


def test_local_steps_stay_in_the_slice(world):
    for stage in (1, 2):
        key = f"z{stage}"
        for s in range(2):
            w = [o[key]["steps"][s][0] for o in world]
            assert _same_bits(w[:L]) and _same_bits(w[L:])
            assert not torch.allclose(w[0], w[L])
        for r, o in enumerate(world):
            mine = set(range(r // L * L, r // L * L + L))
            calls = [c for step in o[key]["calls"] for c in step]
            assert calls and all(set(c[1]) <= mine for c in calls), calls
        for k in range(2):
            assert _same_bits([o[key]["synced"][k] for o in world])


def test_stage1_is_stage2_bitwise(world):
    for o in world:
        for a, b in zip(o["z1"]["synced"], o["z2"]["synced"]):
            assert torch.equal(a, b)


def test_scalar_parameter_enters_the_round_once(world):
    def flat(ts):
        return np.concatenate([t.numpy().reshape(-1) for t in ts])

    anchor = flat(world[0]["scalar"]["anchor"])
    deltas = np.stack([flat(world[h * L]["scalar"]["trained"]) - anchor
                       for h in range(N // L)]).astype(np.float64)
    want = anchor + port_adasum.adasum_vhdd_host(deltas)
    for o in world:
        np.testing.assert_allclose(flat(o["scalar"]["synced"]), want,
                                   rtol=1e-5, atol=1e-6)
    assert _same_bits([torch.from_numpy(flat(o["scalar"]["synced"]))
                       for o in world])


def test_int8_inter_wire_replicas_and_carry(world):
    for k in range(3):
        assert _same_bits([o["int8"]["synced"][k] for o in world])
    assert any(torch.any(r != 0) for r in world[0]["int8"]["residual"])


def test_guard_agreement_is_intra_only(world):
    w0 = _params()["w"]
    for r, o in enumerate(world):
        w = o["guard"]["params"][0].numpy()
        if r < L:
            np.testing.assert_array_equal(w, w0)
            assert o["guard"]["skips"] == 1
        else:
            assert not np.allclose(w, w0) and np.all(np.isfinite(w))
            assert o["guard"]["skips"] == 0


def test_reshard_local_family_8_to_6(world):
    o = world[0]
    states, re6 = o["states"], o["re6"]
    assert len(re6) == 6
    size = {0: 72, 1: 6}  # w (12 x 6), b (6,)
    for i, n_el in size.items():
        old = torch.cat([states[r]["local"]["anchor"][i]
                         for r in range(L)])[:n_el]
        for h in range(3):  # every new slice holds the whole anchor
            new = torch.cat([re6[h * 2 + j]["local"]["anchor"][i]
                             for j in range(2)])[:n_el]
            assert torch.equal(old, new)
        m_old = torch.cat([states[r]["state"]["state"][i]["exp_avg"]
                           for r in range(L)])[:n_el]
        m_new = torch.cat([re6[j]["state"]["state"][i]["exp_avg"]
                           for j in range(2)])[:n_el]
        assert torch.equal(m_old, m_new)
        flat_m = torch.cat([re6_r["state"]["state"][i]["exp_avg"]
                            for re6_r in o["re6_flat"]])[:n_el]
        assert torch.equal(m_old, flat_m)
    for sd in re6:
        assert sd["local"]["intra"] == 2 and sd["local"]["round"] == 1
        assert sd["world"] == 6
    assert all("local" not in sd for sd in o["re6_flat"])


def test_layout_mismatch_errors(world):
    for o in world:
        e = o["errors"]
        assert 'no "local" layout' in e["local_loads_flat"]
        assert "local_sgd_steps <= 1" in e["flat_loads_local"]
        assert "reshard_state" in e["width"]


def test_stage3_rejected():
    import os

    import horovod_tpu_torch as phvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    phvd.init(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="zero_stage<=2"):
            phvd.ShardedDistributedOptimizer(
                torch.optim.Adam([torch.nn.Parameter(torch.zeros(4))]),
                zero_stage=3, local_sgd_steps=4)
        with pytest.raises(ValueError, match="inter_wire"):
            phvd.ShardedDistributedOptimizer(
                torch.optim.Adam([torch.nn.Parameter(torch.zeros(4))]),
                local_sgd_steps=4, local_sgd_inter_wire="fp8")
    finally:
        phvd.shutdown()
