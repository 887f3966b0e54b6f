"""The port's sharded serving engine against the JAX package's on the CPU.

``InferenceEngine(mesh=)`` shards the KV pool and the attention heads
over ``tp`` and the MoE expert banks over ``ep``; every rank builds the
engine, the leader drives and the followers mirror its operations
(``horovod_tpu_torch/serving/engine.py``). The oracle is the JAX engine
on a device mesh of the conftest's 8 CPU devices
(``tests/test_serving.py::test_tp_sharded_cache_matches_unsharded``,
``tests/test_moe_wire.py::TestServeMoE``), fed the same weights: the JAX
``init`` carried across by ``convert.params_from_flax`` and cut by
``convert.shard_state_dict``.

The port runs in one gloo world of 4 CPU processes (``_mesh_worker``,
once for the module), every mesh built up front in one order on every
rank: tp 2 on ranks 0-1 (the toy model, 2 heads) beside tp 2 on ranks
2-3 (GQA, 4 heads over 2 KV heads), then ep 2 × tp 2 on all four (the
MoE model), then ``serve(mesh=)`` over HTTP on ranks 0-1, the error
cases, and a follower whose forward raises on ranks 2-3. The world's
process group has a timeout, so a fault ends in an error, not a hang.

Tolerances: greedy tokens identical (fp32); the leader's logits of one
prefill chunk within 1e-5 of the unsharded port engine's (a tp sum adds
in another order); the MoE block outputs and router outputs bitwise
equal on every rank (each all-reduce hands every rank the same bits).
Nothing is compared bit for bit with a JAX output.
"""

import concurrent.futures
import hashlib
import json
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run

WORLD = 4
WORLD_TIMEOUT_S = 240
PG_TIMEOUT_S = 30  # the world's collectives: a lost peer errors by then
PROMPT = [7, 8, 9]
N_TOKENS = 5
LOGIT_TOL = 1e-5
# the rolling admissions of TestServeMoE: prompt sizes, max_new_tokens
MOE_ROLLS = (((5, 9, 3), 6), ((7, 2), 4))
MOE_STEPS = 40


def _toy_kw(**kw):
    """``tests/test_serving.py``'s ``_cfg()`` fields."""
    base = dict(vocab_size=61, num_layers=1, d_model=16, num_heads=2,
                d_ff=32, max_len=64, causal=True)
    base.update(kw)
    return base


GQA = dict(num_heads=4, num_kv_heads=2)
MOE_KW = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
              d_ff=64, max_len=64, causal=True, flash_attention=False,
              moe_experts=4)


def _port_cfg(kw):
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(dtype=torch.float32, **kw)


# ------------------------------------------------------------ the port side


def _generate(eng, prompt, n, cow=False):
    """The JAX tests' ``_generate``: a prefill then ``n - 1`` decode
    steps on one slot. ``cow``: first move the slot's first page by
    copy-on-write, so the decode steps read the copy (a sharded
    leader's followers must copy it too)."""
    slot = eng.manager.alloc()
    out = [eng.prefill(slot, prompt)]
    if cow:
        assert eng.manager._cow(slot, 0)
    for _ in range(n - 1):
        toks = np.zeros(eng.slots, np.int32)
        toks[slot] = out[-1]
        nxt = eng.decode_step(toks)
        eng.manager.advance(slot)
        out.append(int(nxt[slot]))
    return out


def _logit_hook(model, sink):
    return model.lm_head.register_forward_hook(
        lambda m, i, o: sink.append(o.detach().clone()))


def _sharded_engine(kw, state, mesh, **eng_kw):
    from horovod_tpu_torch.models.convert import shard_state_dict
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving import InferenceEngine

    cfg = _port_cfg(kw)
    model = Transformer(cfg, device="cpu", mesh=mesh)
    eng_kw.setdefault("slots", 4)
    return InferenceEngine(model, shard_state_dict(state, cfg, mesh),
                           max_len=64, device="cpu", mesh=mesh, **eng_kw)


def _whole_engine(kw, state):
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving import InferenceEngine

    return InferenceEngine(Transformer(_port_cfg(kw), device="cpu"), state,
                           slots=4, max_len=64, device="cpu")


def _pool_heads(eng):
    return sorted({leaf.shape[2] for layer in eng.manager.full_cache
                   for leaf in layer.values()})


def _tp_pair(kw, state, mesh):
    """tp 2: the leader's greedy tokens and first chunk's logits against
    the unsharded port engine's; a follower mirrors until "stop"."""
    eng = _sharded_engine(kw, state, mesh)
    out = {"heads": _pool_heads(eng), "leader": eng.leader,
           "sharding": tuple(eng.manager.sharding)}
    if not eng.leader:
        out["ops"] = eng.follow()
        out["stats"] = eng.stats()
        return out
    sharded, whole = [], []
    hook = _logit_hook(eng.model, sharded)
    out["tokens"] = _generate(eng, PROMPT, N_TOKENS, cow=True)
    hook.remove()
    eng.close()
    out["stats"] = eng.stats()
    ref = _whole_engine(kw, state)
    hook = _logit_hook(ref.model, whole)
    out["whole_tokens"] = _generate(ref, PROMPT, N_TOKENS)
    hook.remove()
    # the unsharded engine's prefill tiers apply the LM head to the
    # last real position only: compare that row
    out["chunk_err"] = float((sharded[0][0, -1] - whole[0].reshape(
        -1, whole[0].shape[-1])[-1]).abs().max())
    return out


def _moe_requests(bat):
    """TestServeMoE's rolling admissions: the tokens of each request."""
    rng = np.random.default_rng(0)
    reqs = []
    for sizes, max_new in MOE_ROLLS:
        reqs += [bat.submit(rng.integers(0, 64, size=n).tolist(),
                            max_new_tokens=max_new) for n in sizes]
        for _ in range(MOE_STEPS):
            bat.step()
    return [r.status for r in reqs], [list(r.out_tokens) for r in reqs]


def _digests(model):
    """sha256 chains of every block's output (the post-reduce hidden
    state) and every router's output, over the forwards to come."""
    chains = {"blocks": hashlib.sha256(), "router": hashlib.sha256()}

    def hook(name):
        return lambda m, i, o: chains[name].update(
            o.detach().contiguous().numpy().tobytes())

    for block in model.blocks:
        block.register_forward_hook(hook("blocks"))
        block.moe.router.register_forward_hook(hook("router"))
    return chains


def _moe_world(state, mesh):
    from horovod_tpu_torch.serving import ContinuousBatcher

    eng = _sharded_engine(MOE_KW, state, mesh)
    chains = _digests(eng.model)
    out = {"heads": _pool_heads(eng), "leader": eng.leader,
           "experts": [b.moe.w1.shape[0] for b in eng.model.blocks]}
    if eng.leader:
        out["status"], out["tokens"] = _moe_requests(ContinuousBatcher(eng))
        eng.close()
        out["stats"] = eng.stats()
        out["whole_status"], out["whole_tokens"] = _moe_requests(
            ContinuousBatcher(_whole_engine(MOE_KW, state)))
    else:
        out["ops"] = eng.follow()
        out["stats"] = eng.stats()
    out["digests"] = {k: h.hexdigest() for k, h in chains.items()}
    return out


def _serve_pair(kw, state, mesh):
    """``serve(mesh=)``: HTTP on the leader, no port on the follower,
    whose handle ends with the leader's ``stop()``."""
    from horovod_tpu_torch.models.convert import shard_state_dict
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving import serve

    cfg = _port_cfg(kw)
    handle = serve(Transformer(cfg, device="cpu", mesh=mesh),
                   shard_state_dict(state, cfg, mesh), port=0, slots=2,
                   max_len=64, device="cpu", handle_sigterm=False,
                   addr="127.0.0.1", mesh=mesh, policy="static")
    if handle.port is None:
        ended = handle.wait(timeout=PG_TIMEOUT_S + 30)
        return {"port": None, "ended": ended, "ops": handle.ops,
                "error": repr(handle.error)}
    req = urllib.request.Request(
        f"http://127.0.0.1:{handle.port}/generate",
        data=json.dumps({"tokens": PROMPT,
                         "max_tokens": N_TOKENS}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.load(resp)
    handle.stop()
    return {"port": handle.port, "body": body,
            "policy": handle.batcher.policy}


def _errors(rank, meshes, states):
    """Each refusal's message, or None where it did not raise."""
    from horovod_tpu_torch.models.transformer import (
        Transformer, init_cache, shard_moe_params)
    from horovod_tpu_torch.serving import InferenceEngine, create_kv_manager

    toy = _port_cfg(_toy_kw())
    cases = {
        "kv_tp4": lambda: create_kv_manager(
            lambda b, s: init_cache(toy, b, s), 4, 64, mesh=meshes["tp4"]),
        "model_tp4": lambda: Transformer(toy, device="cpu",
                                         mesh=meshes["tp4"]),
    }
    if rank < 3:
        cases["ep3"] = lambda: shard_moe_params(states["moe"],
                                                meshes["ep3"], "ep")
    if rank < 2:
        cases["dp2"] = lambda: InferenceEngine(
            Transformer(toy, device="cpu"), None, slots=2, max_len=64,
            device="cpu", mesh=meshes["dp2"])
        cases["role_decode"] = lambda: _sharded_engine(
            _toy_kw(), states["toy"], meshes["tp_a"], role="decode")
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _failing_pair(kw, state, mesh, outdir, rank, out):
    """A follower whose forward raises: the leader's request ends
    ``error`` and nothing hangs. The follower saves and leaves at once,
    closing its sockets under the leader's collective."""
    import os

    from horovod_tpu_torch.serving import ContinuousBatcher

    eng = _sharded_engine(kw, state, mesh)
    if not eng.leader:
        def boom(*args, **kwargs):
            raise RuntimeError("injected follower fault")

        eng.model.forward = boom
        try:
            eng.follow()
            out["fail"] = {"raised": None}
        except RuntimeError as e:
            out["fail"] = {"raised": str(e)}
        torch.save(out, Path(outdir) / f"rank{rank}.pt")
        os._exit(0)
    bat = ContinuousBatcher(eng, default_max_new_tokens=4)
    bat.start()
    t0 = time.monotonic()
    req = bat.submit(PROMPT)
    ended = req.wait(timeout=PG_TIMEOUT_S + 30)
    out["fail"] = {"ended": ended, "status": req.status,
                   "s": time.monotonic() - t0,
                   "engine_failed": eng._failed is not None}
    bat.stop()
    eng.close()  # a no-op after a failure: nothing left to stop


def _mesh_worker(rank, n, outdir):
    import datetime

    import torch.distributed as dist

    from horovod_tpu_torch.parallel import MeshSpec

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(outdir) / "store"), n),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    states = {k: torch.load(Path(outdir) / f"{k}.pt")
              for k in ("toy", "gqa", "moe")}
    # every mesh on every rank, in one order (new_group is collective)
    meshes = {
        "tp_a": MeshSpec(tp=2).build([0, 1]),
        "tp_b": MeshSpec(tp=2).build([2, 3]),
        "moe": MeshSpec(ep=2, tp=2).build(),
        "tp4": MeshSpec(tp=4).build(),
        "ep3": MeshSpec(ep=3).build([0, 1, 2]),
        "dp2": MeshSpec(dp=2).build([0, 1]),
    }
    out = {}
    if rank < 2:
        out["toy"] = _tp_pair(_toy_kw(), states["toy"], meshes["tp_a"])
    else:
        out["gqa"] = _tp_pair(_toy_kw(**GQA), states["gqa"],
                              meshes["tp_b"])
    out["moe"] = _moe_world(states["moe"], meshes["moe"])
    out["errors"] = _errors(rank, meshes, states)
    if rank < 2:
        out["serve"] = _serve_pair(_toy_kw(), states["toy"], meshes["tp_a"])
    else:
        _failing_pair(_toy_kw(**GQA), states["gqa"], meshes["tp_b"],
                      outdir, rank, out)
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


# ------------------------------------------------------------- the JAX side


def _jax_models():
    """(model, params) of the toy, the GQA and the MoE models, from the
    JAX ``init`` as their tests make them (jitted: both sides take these
    weights, whatever bits the init rounds to)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import Transformer, TransformerConfig

    out = {}
    key = jax.random.PRNGKey(0)
    for name, kw in (("toy", _toy_kw()), ("gqa", _toy_kw(**GQA))):
        model = Transformer(TransformerConfig(dtype=jnp.float32, **kw))
        init = jax.jit(lambda k, x, m=model: m.init(k, x, train=False))
        out[name] = (model, init(key, jnp.ones((1, 4), jnp.int32)))
    model = Transformer(TransformerConfig(dtype=jnp.float32, **MOE_KW))
    out["moe"] = (model, jax.jit(model.init)(
        key, np.zeros((1, 4), np.int32))["params"])
    return out


def _jax_oracles(models):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from horovod_tpu.serving.batcher import ContinuousBatcher
    from horovod_tpu.serving.engine import InferenceEngine

    devs = np.asarray(jax.devices())
    out = {}
    for name in ("toy", "gqa"):
        model, params = models[name]
        eng = InferenceEngine(model, params, slots=4, max_len=64,
                              min_bucket=4,
                              mesh=Mesh(devs[:2], ("tp",)))
        out[name] = _generate(eng, PROMPT, N_TOKENS)
    # the uncached argmax loop (test_serving.py's _greedy_ref) at one
    # padded width: a causal position's logits ignore the padding after it
    model, params = models["toy"]
    fwd = jax.jit(lambda p, t: model.apply(p, t, train=False))
    seq = list(PROMPT)
    for _ in range(N_TOKENS):
        toks = np.zeros((1, len(PROMPT) + N_TOKENS), np.int32)
        toks[0, :len(seq)] = seq
        lg = np.asarray(fwd(params, jnp.asarray(toks)))
        seq.append(int(lg[0, len(seq) - 1].argmax()))
    out["greedy_ref"] = seq[len(PROMPT):]
    model, params = models["moe"]
    eng = InferenceEngine(model, params, slots=4, max_len=64,
                          mesh=Mesh(devs[:4].reshape(2, 2), ("ep", "tp")))
    out["moe_status"], out["moe"] = _moe_requests(ContinuousBatcher(eng))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world and the JAX oracles, computed side by side."""
    from horovod_tpu_torch.models.convert import params_from_flax

    tmp = tmp_path_factory.mktemp("serving_mesh")
    models = _jax_models()
    for name, kw in (("toy", _toy_kw()), ("gqa", _toy_kw(**GQA)),
                     ("moe", MOE_KW)):
        torch.save(params_from_flax(models[name][1], _port_cfg(kw)),
                   tmp / f"{name}.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        world = ex.submit(_run, tmp, WORLD, Path(__file__), "_mesh_worker",
                          WORLD_TIMEOUT_S, None)
        oracles = _jax_oracles(models)
        return world.result(), oracles


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("name,ranks", [("toy", (0, 1)), ("gqa", (2, 3))])
def test_tp2_greedy_tokens_match_jax_and_unsharded(runs, name, ranks):
    world, jax_out = runs
    lead, follow = (world[r][name] for r in ranks)
    assert lead["leader"] and not follow["leader"]
    assert lead["tokens"] == jax_out[name] == lead["whole_tokens"]
    if name == "toy":
        assert lead["tokens"] == jax_out["greedy_ref"]
    assert lead["chunk_err"] <= LOGIT_TOL
    # kv_heads / tp heads a rank: 1 of the toy's 2, 1 of GQA's 2
    assert lead["heads"] == follow["heads"] == [1]
    assert [world[r][name]["sharding"][1:] for r in ranks] == [(2, 0),
                                                               (2, 1)]
    # the follower mirrored the prefill, the copy-on-write copy (the
    # decode steps read the copied page) and every decode step, then
    # stopped; the eager sharded step captured nothing
    assert follow["stats"]["chunks_followed"] == 1
    assert follow["stats"]["decode_steps"] == N_TOKENS - 1
    assert follow["ops"] == N_TOKENS + 1
    assert lead["stats"]["decode_compiles"] == 0
    assert lead["stats"]["decode_graphed"] == 0
    assert lead["stats"]["control_ops"] == N_TOKENS + 2  # and the stop


def test_moe_ep2_tp2_rolling_admissions(runs):
    world, jax_out = runs
    lead = world[0]["moe"]
    assert lead["leader"] and not any(world[r]["moe"]["leader"]
                                      for r in (1, 2, 3))
    assert lead["status"] == jax_out["moe_status"] == ["done"] * 5
    assert lead["tokens"] == jax_out["moe"] == lead["whole_tokens"]
    for r in range(WORLD):
        assert world[r]["moe"]["experts"] == [2, 2]  # 4 experts / ep 2
        assert world[r]["moe"]["heads"] == [2]  # 4 kv heads / tp 2
    # the router and the post-reduce hidden state agree bit for bit
    for key in ("blocks", "router"):
        assert len({world[r]["moe"]["digests"][key]
                    for r in range(WORLD)}) == 1
    steps = lead["stats"]["decode_steps"]
    assert all(world[r]["moe"]["stats"]["decode_steps"] == steps
               for r in (1, 2, 3))


def test_serve_on_a_mesh_answers_on_the_leader_only(runs):
    world, jax_out = runs
    lead, follow = world[0]["serve"], world[1]["serve"]
    assert lead["body"]["status"] == "done"
    assert lead["body"]["tokens"] == jax_out["toy"]
    assert lead["policy"] == "static"
    assert follow["port"] is None and follow["ended"]
    assert follow["error"] == "None" and follow["ops"] == N_TOKENS


@pytest.mark.parametrize("case,ranks,match", [
    ("kv_tp4", (0, 1, 2, 3), "must divide the kv head count"),
    ("model_tp4", (0, 1, 2, 3), "divide"),
    ("ep3", (0, 1, 2), "must divide"),
    ("dp2", (0, 1), "A15"),
    ("role_decode", (0, 1), "A15"),
])
def test_mesh_refusals(runs, case, ranks, match):
    world, _ = runs
    for r in ranks:
        assert world[r]["errors"][case] is not None, (case, r)
        assert match in world[r]["errors"][case]


def test_a_failing_follower_ends_the_leaders_requests(runs):
    world, _ = runs
    lead, follow = world[2]["fail"], world[3]["fail"]
    assert follow["raised"] == "injected follower fault"
    assert lead["ended"] and lead["status"] == "error"
    assert lead["engine_failed"]
    assert lead["s"] < PG_TIMEOUT_S + 30


def test_static_policy_is_a_batch_barrier():
    """``tests/test_serving.py::test_static_policy_is_a_batch_barrier``
    on the port: while the first batch is in flight the next request
    stays queued."""
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving import ContinuousBatcher, InferenceEngine

    torch.manual_seed(0)
    eng = InferenceEngine(Transformer(_port_cfg(_toy_kw()), device="cpu"),
                          None, slots=2, max_len=64, device="cpu")
    b = ContinuousBatcher(eng, max_admit_per_step=2, policy="static",
                          default_max_new_tokens=4)
    r1 = b.submit([1, 2])
    b.step()
    assert b.active() == 1
    r2 = b.submit([3, 4])
    while not r1.finished():
        assert r2.status == "queued"
        b.step()
    while not r2.finished():
        b.step()
    assert r1.status == r2.status == "done"
    with pytest.raises(ValueError, match="unknown policy"):
        ContinuousBatcher(eng, policy="fifo")
