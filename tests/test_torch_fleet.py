"""The serving fleet's control plane of the port
(horovod_tpu_torch/serving/frontend.py's Router and result dedupe, the
batcher's ``serve.worker_kill`` site, the elastic driver's per-role
serve gauges, the fleet's three knobs and the sliding window on the
cached path) against the JAX package's.

The Router: the port's and the JAX package's read the same
``KVStore`` announcements, heartbeats and dead-host set, and must pick
the same ranks in the same order (least loaded with local debits,
stragglers avoided, stale and draining workers skipped, page headroom
over slot headroom with legacy blobs read, roleless blobs routable,
decode workers excluded and prefill workers preferred, the driver's
dead hosts evicted). Over HTTP, against ``serve()`` workers of the port
on the CPU: failover past a dark worker is a replay that tombstones it,
a 4xx surfaces, a stalled primary is hedged, and a repeated
``request_id`` is answered from the dedupe cache; every routed token
list equals the JAX model's greedy full-forward loop. The windowed toy
serves the JAX engine's tokens on the slab and on the paged plane. The
port runs with ``device="cpu"``, where each kernel wrapper takes its
plain version; tokens are compared exactly, gauges and knobs for
equality."""

import dataclasses
import json
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.common import config as jconfig
from horovod_tpu.common.metrics import registry as jmetrics
from horovod_tpu.elastic.driver import ElasticDriver as JaxDriver
from horovod_tpu.models import transformer as jt
from horovod_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu.serving.frontend import Router as JaxRouter
from horovod_tpu_torch import preemption
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.common.metrics import registry as metrics
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.runner.rendezvous import (
    KVStore,
    put_dead_hosts,
    put_heartbeat,
)
from horovod_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceEngine,
    Rejected,
    Router,
    ServeFrontend,
    serve,
)
from horovod_tpu_torch.testing import chaos

BASE = dict(vocab_size=61, num_layers=1, d_model=16, num_heads=2, d_ff=32,
            max_len=64, causal=True)
PROMPT = [4, 5, 6]


def _models(**kw):
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32,
                                                 **BASE, **kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                         train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **BASE, **kw)
    tmodel = tt.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def toy():
    """(JAX model, its params, the port's model) and the JAX greedy
    full-forward tokens of PROMPT, 3 of them."""
    jm, jp, tm = _models()
    seq = list(PROMPT)
    for _ in range(3):
        logits = jm.apply(jp, jnp.asarray([seq]), train=False)
        seq.append(int(np.asarray(logits)[0, -1].argmax()))
    return jm, jp, tm, seq[len(PROMPT):]


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    yield
    chaos.reset()
    for fn in preemption.drain_hooks():
        preemption.unregister_drain(fn)


def _put(store, rank, port=None, **fields):
    blob = {"rank": rank, "addr": "127.0.0.1",
            "port": 9000 + rank if port is None else port,
            "queue_depth": 0, "draining": False, "ts": time.time()}
    blob.update(fields)
    store.put("serve", str(rank), json.dumps(blob).encode())


def _heartbeats(store, p50s):
    class _Client:
        def put(self, scope, key, value):
            store.put(scope, key, value)

    for rank, p50 in p50s.items():
        put_heartbeat(_Client(), rank, {"step": 100, "step_ms_p50": p50,
                                        "last_step_ts": time.time()})


def _least_loaded(store):
    _put(store, 0, free_slots=1, queue_depth=5)
    _put(store, 1, free_slots=7)
    return 8, False


def _stragglers(store):
    _put(store, 0, free_slots=8)
    _put(store, 1, free_slots=2)
    _put(store, 2, free_slots=2)
    _heartbeats(store, {0: 500.0, 1: 50.0, 2: 55.0})
    return 4, True


def _stale_and_draining(store):
    _put(store, 0, free_slots=8, ts=time.time() - 60)
    _put(store, 1, free_slots=1, draining=True)
    _put(store, 2, free_slots=1)
    return 2, True


def _page_headroom(store):
    _put(store, 0, free_slots=8, free_pages=1, pages_total=16)
    _put(store, 1, free_slots=2, free_pages=9, pages_total=16)
    _put(store, 3, free_slots=4)  # a legacy blob: slots only
    return 6, False


def _roles(store):
    _put(store, 0, role="decode", free_slots=4, free_pages=500)
    _put(store, 1, free_slots=4, free_pages=50)  # no role: unified
    _put(store, 2, role="prefill", free_slots=1, free_pages=1)
    _put(store, 3, role="unified", free_slots=9, free_pages=90)
    return 4, True


def _roleless(store):
    _put(store, 0, free_slots=4, free_pages=50)
    _put(store, 1, free_slots=4, free_pages=50)
    return 3, False


def _decode_only(store):
    _put(store, 0, role="decode", free_slots=4, free_pages=500)
    return 2, False


def _dead_hosts(store):
    _put(store, 0, free_slots=8)
    _put(store, 1, free_slots=2)
    _put(store, 2, free_slots=3, host="gone-host", addr="10.0.0.9")
    put_dead_hosts(store, ["gone-host"], ranks=[0])
    return 3, True


FLEETS = {f.__name__[1:]: f for f in (
    _least_loaded, _stragglers, _stale_and_draining, _page_headroom,
    _roles, _roleless, _decode_only, _dead_hosts)}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_picks_equal_jax(fleet):
    """Both routers over one store pick the same ranks in the same order,
    with and without a credit after each pick, and keep the same live
    set and straggler ledger."""
    store = KVStore()
    n, credit = FLEETS[fleet](store)
    ours, theirs = Router(store), JaxRouter(store)
    assert sorted(ours.snapshot()) == sorted(theirs.snapshot())
    assert ours.straggler_ranks() == theirs.straggler_ranks()
    picks = []
    for router in (ours, theirs):
        got = []
        for _ in range(n):
            ann = router.pick()
            got.append(None if ann is None else ann["rank"])
            if ann is not None and credit:
                router.credit(ann["rank"])
        picks.append(got)
    assert picks[0] == picks[1], picks
    assert any(p is not None for p in picks[0]) == (fleet != "decode_only")


def _post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _serve(model, **kw):
    return serve(model, None, port=0, slots=2, max_len=64, max_new_tokens=3,
                 addr="127.0.0.1", handle_sigterm=False, device="cpu", **kw)


def test_replay_on_dark_worker_tombstones_it(toy):
    """The freest worker is dark (nothing listens): the request replays
    on the live one (``serve.replays`` +1) with the JAX greedy tokens,
    the dark worker's unchanged blob leaves the live set until it
    announces again, and a request that can never fit raises (a 4xx is
    the request's fault, not failed over)."""
    _, _, tm, want = toy
    handle = _serve(tm)
    try:
        store = KVStore()
        _put(store, 0, port=1, free_slots=9)
        _put(store, 1, port=handle.port, free_slots=2)
        router = Router(store)
        before = metrics.snapshot().get("serve.replays", 0)
        out = router.route(PROMPT, attempts=3, request_id="rep-1")
        assert out["status"] == "done" and out["tokens"] == want
        assert metrics.snapshot().get("serve.replays", 0) == before + 1
        assert set(router.snapshot()) == {1}
        _put(store, 0, port=1, free_slots=9)
        assert set(router.snapshot()) == {0, 1}
        with pytest.raises(RuntimeError, match="rejected"):
            router.route(list(range(1, 65)), attempts=3)
    finally:
        handle.stop()


def test_hedge_fires_on_a_stalled_primary(toy):
    """The primary (the freest) accepts the POST but its scheduler never
    runs; after 50 ms a backup goes to the second worker, whose answer,
    the JAX greedy tokens, wins (``serve.hedges`` +1)."""
    _, _, tm, want = toy
    stalled = ContinuousBatcher(
        InferenceEngine(tm, None, slots=2, max_len=64, device="cpu"),
        default_max_new_tokens=3)
    sfe = ServeFrontend(stalled, port=0, addr="127.0.0.1")
    sfe.start()
    handle = _serve(tm)
    try:
        store = KVStore()
        _put(store, 0, port=sfe.port, free_slots=9)
        _put(store, 1, port=handle.port, free_slots=2)
        before = metrics.snapshot().get("serve.hedges", 0)
        out = Router(store).route(PROMPT, hedge_ms=50.0, timeout=30.0)
        assert out["status"] == "done" and out["tokens"] == want
        assert metrics.snapshot().get("serve.hedges", 0) == before + 1
    finally:
        sfe.stop()
        handle.stop()


def test_generate_dedupe_answers_a_repeated_request_id(toy):
    """A second POST with the same ``request_id`` gets the cached result
    (``serve.replay_dedupe_hits`` +1, no second decode), even while the
    worker drains; another id is fresh work."""
    _, _, tm, want = toy
    handle = _serve(tm)
    try:
        before = metrics.snapshot().get("serve.replay_dedupe_hits", 0)
        payload = {"tokens": PROMPT, "request_id": "client-abc"}
        s1, out1 = _post(handle.port, payload)
        steps = handle.engine.stats()["decode_steps"]
        s2, out2 = _post(handle.port, payload)
        assert s1 == s2 == 200 and out1 == out2 and out1["tokens"] == want
        assert handle.engine.stats()["decode_steps"] == steps
        assert metrics.snapshot().get(
            "serve.replay_dedupe_hits", 0) == before + 1
        s3, out3 = _post(handle.port, {"tokens": PROMPT,
                                       "request_id": "client-def"})
        assert s3 == 200 and out3["tokens"] == want
        handle.frontend.drain(timeout=5.0)
        assert _post(handle.port, payload) == (200, out1)
        assert metrics.snapshot().get(
            "serve.replay_dedupe_hits", 0) == before + 2
    finally:
        handle.stop()


def test_worker_kill_fault_crashes_the_scheduler():
    """``serve.worker_kill@1:reset`` lands at the top of the first round:
    the request accepted before it ends ``error`` (its waiter is
    released) and the worker refuses new work, as the JAX batcher's."""
    cfg = tt.TransformerConfig(vocab_size=31, num_layers=1, d_model=8,
                               num_heads=2, d_ff=16, max_len=32,
                               dtype=torch.float32)
    eng = InferenceEngine(tt.Transformer(cfg, device="cpu"), None, slots=2,
                          max_len=32, device="cpu")
    bat = ContinuousBatcher(eng, default_max_new_tokens=4)
    chaos.configure("seed=3;serve.worker_kill@1:reset")
    before = metrics.snapshot().get("chaos.serve.worker_kill.reset", 0)
    req = bat.submit([1, 2, 3])
    bat.start()
    try:
        assert req.wait(timeout=30) and req.status == "error"
        with pytest.raises(Rejected):
            bat.submit([4, 5])
    finally:
        bat.stop()
    assert metrics.snapshot().get(
        "chaos.serve.worker_kill.reset", 0) == before + 1


def test_driver_per_role_gauges_equal_jax():
    """The driver's ``driver.serve.{role}.*`` gauges over one store equal
    the JAX driver's; a roleless blob counts as unified and a draining
    worker adds no headroom."""
    store = KVStore()
    _put(store, 0, role="prefill", free_slots=4, free_pages=50)
    _put(store, 1, role="decode", free_slots=2, free_pages=7)
    _put(store, 2, free_slots=4, free_pages=50)
    _put(store, 3, role="decode", free_slots=3, free_pages=9,
         draining=True)
    ours = types.SimpleNamespace(_server=types.SimpleNamespace(store=store),
                                 _serve_cap_seen={}, _clock=time.monotonic,
                                 _maybe_scale_up=lambda per_role: None)
    theirs = types.SimpleNamespace(
        _server=types.SimpleNamespace(store=store), _serve_cap_seen={},
        _maybe_scale_up=lambda per_role: None)
    ElasticDriver._poll_serve_capacity(ours)
    JaxDriver._poll_serve_capacity(theirs)
    keys = [f"driver.serve.{role}.{k}" for role in ("prefill", "decode",
                                                    "unified")
            for k in ("workers", "free_slots", "free_pages")]
    got = {k: metrics.snapshot().get(k) for k in keys}
    assert got == {k: jmetrics.snapshot().get(k) for k in keys}
    assert got["driver.serve.decode.workers"] == 2.0
    assert got["driver.serve.decode.free_pages"] == 7.0


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_SERVE_HEDGE_MS": "25", "HOROVOD_SERVE_DRAIN_DEADLINE_S": "1.5",
     "HOROVOD_SERVE_DEDUPE_TTL_S": "0"},
    {"HOROVOD_SERVE_HEDGE_MS": " ", "HOROVOD_SERVE_DEDUPE_TTL_S": "7e1"},
], ids=["defaults", "set", "blank"])
def test_fleet_knobs_equal_jax(env, monkeypatch):
    for name in ("HOROVOD_SERVE_HEDGE_MS", "HOROVOD_SERVE_DRAIN_DEADLINE_S",
                 "HOROVOD_SERVE_DEDUPE_TTL_S"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, theirs = tconfig.live_config(), jconfig.Config.from_env()
    for field in ("serve_hedge_ms", "serve_drain_deadline_s",
                  "serve_dedupe_ttl_s"):
        assert getattr(ours, field) == getattr(theirs, field), field
    monkeypatch.setenv("HOROVOD_SERVE_HEDGE_MS", "soon")
    with pytest.raises(ValueError, match="HOROVOD_SERVE_HEDGE_MS"):
        tconfig.live_config()
    with pytest.raises(ValueError, match="HOROVOD_SERVE_HEDGE_MS"):
        jconfig.Config.from_env()


WINDOW = 8
WINDOWED = [(list(range(1, 13)), 6), ([7, 3, 9, 1] * 4, 5)]


def _tokens(batcher, jobs):
    out = []
    for prompt, n in jobs:
        req = batcher.submit(prompt, max_new_tokens=n)
        while not req.finished():
            batcher.step()
        assert req.status == "done"
        out.append(req.result()["tokens"])
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_windowed_cached_path_equals_jax(paged):
    """A windowed toy (window 8, prompts of 12 and 16 tokens) serves the
    JAX engine's greedy tokens exactly on the slab and on the paged
    plane's gather read, and the window bites (the same weights without
    it give other tokens)."""
    jm, jp, tm = _models(sliding_window=WINDOW)
    kw = dict(slots=2, max_len=64, paged=paged)
    want = _tokens(JaxBatcher(JaxEngine(jm, jp, min_bucket=4, **kw)),
                   WINDOWED)
    eng = InferenceEngine(tm, None, device="cpu", paged_attn="off", **kw)
    assert _tokens(ContinuousBatcher(eng), WINDOWED) == want
    plain = tt.Transformer(dataclasses.replace(tm.cfg, sliding_window=None),
                           device="cpu")
    plain.load_state_dict(tm.state_dict())
    unwindowed = _tokens(ContinuousBatcher(InferenceEngine(
        plain, None, device="cpu", paged_attn="off", **kw)), WINDOWED)
    assert unwindowed != want


def test_windowed_paged_kernel_raises_where_jax_falls_back():
    """``paged_attn='on'`` with a window: the port raises with the reason
    and the remedy, where the JAX engine counts a fallback to its gather
    read (``serve.paged_attn_fallbacks``) and serves."""
    jm, jp, tm = _models(sliding_window=WINDOW)
    with pytest.raises(RuntimeError, match="sliding_window.*paged_attn='off'"):
        InferenceEngine(tm, None, slots=2, max_len=64, device="cpu",
                        paged_attn="on")
    before = jmetrics.snapshot().get("serve.paged_attn_fallbacks", 0)
    jeng = JaxEngine(jm, jp, slots=2, max_len=64, min_bucket=4,
                     paged_attn="on")
    _tokens(JaxBatcher(jeng), WINDOWED[:1])
    assert jmetrics.snapshot().get("serve.paged_attn_fallbacks", 0) > before
