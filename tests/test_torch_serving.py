"""The port's serving plane (horovod_tpu_torch/serving/) against the
JAX package's: the same Flax weights in both engines, the same requests,
the same greedy tokens (staggered admissions, prefix-cache skips, a
chunked long prompt, pause on pool exhaustion); the page bookkeeping of
the two PagedKVCacheManagers under one scripted sequence; and
``serve(device="cpu")`` over HTTP. The CPU is used only because the
tests ask for it: ``serve()`` with its default device, and
chip_smoke.py, refuse to run without a CUDA card."""

import json
import os
import shutil
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu.serving.paged_kv import PagedKVCacheManager as JaxManager
from horovod_tpu_torch import preemption
from horovod_tpu_torch.common.metrics import registry as metrics
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceEngine,
    PagedKVCacheManager,
    serve,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4, d_ff=64,
            max_len=64)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port model with the same weights)."""
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **BASE))
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), train=False
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **BASE)
    tmodel = tt.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.fixture(autouse=True)
def _clean_drain_hooks():
    yield
    for fn in preemption.drain_hooks():
        preemption.unregister_drain(fn)


def _greedy_ref(tmodel, prompt, n):
    """The port's uncached full-forward argmax loop."""
    seq = list(map(int, prompt))
    with torch.no_grad():
        for _ in range(n):
            seq.append(int(tmodel(torch.tensor([seq]))[0, -1].argmax()))
    return seq[len(prompt):]


def _prompts():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 61, 16).tolist()  # two full 8-token pages
    return [
        rng.integers(0, 61, 5).tolist(),
        shared + rng.integers(0, 61, 3).tolist(),
        rng.integers(0, 61, 37).tolist(),  # > ceiling 16: three chunks
        shared + rng.integers(0, 61, 6).tolist(),
        rng.integers(0, 61, 11).tolist(),
    ]


def _run(batcher, prompts, max_tokens):
    reqs = [batcher.submit(p, max_new_tokens=max_tokens) for p in prompts]
    for _ in range(500):
        if all(r.finished() for r in reqs):
            break
        batcher.step()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [list(r.out_tokens) for r in reqs]


ENGINE_KW = dict(slots=3, max_len=64, prefill_ceiling=16, page_tokens=8,
                 paged_attn="on")


@pytest.mark.parametrize("pages", [0, 9])
def test_batcher_tokens_match_jax_engine(models, pages):
    """Staggered requests (more than slots, so admissions happen mid
    decode) through both planes. pages=9 with no reserve watermark
    undersubscribes the pool: decode runs it dry, the batcher pauses
    the youngest request and reclaims paused pages (resumed by
    re-prefill)."""
    jmodel, params, tmodel = models
    kw = dict(ENGINE_KW, pages=pages, page_watermark=0 if pages else -1)
    jeng = JaxEngine(jmodel, params, min_bucket=4, **kw)
    teng = InferenceEngine(tmodel, None, device="cpu", **kw)
    assert jeng.paged_attn and teng.paged_attn
    prompts, max_tokens = _prompts(), 9
    paused = metrics.snapshot().get("serve.paused", 0.0)
    want = _run(JaxBatcher(jeng, max_admit_per_step=2), prompts, max_tokens)
    got = _run(ContinuousBatcher(teng, max_admit_per_step=2), prompts,
               max_tokens)
    assert got == want
    assert got[2] == _greedy_ref(tmodel, prompts[2], max_tokens)
    stats = teng.stats()
    assert stats["chunked_prefill_chunks"] >= 2
    assert stats["prefill_chunks_skipped"] >= 2  # the shared 2 pages
    assert stats["paged_attn_calls"] > 0 and stats["paged_attn_fallbacks"] == 0
    for key in ("prefill_chunks_skipped", "chunked_prefill_chunks",
                "prefills"):
        assert stats[key] == jeng.stats()[key], key
    if pages:
        after = metrics.snapshot()
        assert after["serve.paused"] > paused
        assert after["serve.paused_pages_reclaimed"] > 0


def test_slab_engine_matches_paged(models):
    _, _, tmodel = models
    prompts = _prompts()
    slab = InferenceEngine(tmodel, None, device="cpu", slots=3, max_len=64,
                           prefill_ceiling=16, paged=False)
    paged = InferenceEngine(tmodel, None, device="cpu", **ENGINE_KW)
    assert not slab.paged_attn
    assert _run(ContinuousBatcher(slab), prompts, 6) == _run(
        ContinuousBatcher(paged), prompts, 6
    )


@pytest.mark.parametrize("requested", ["auto", "on"])
def test_kernel_that_cannot_run_raises(models, monkeypatch, requested):
    """On a CUDA device with no built kernel the engine refuses to
    resolve paged_attn instead of serving on the plain read; only an
    explicit 'off' takes the plain read there."""
    from horovod_tpu_torch.ops import _build

    _, _, tmodel = models
    eng = InferenceEngine(tmodel, None, device="cpu", **ENGINE_KW)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    monkeypatch.setattr(_build, "available", lambda name: False)
    with pytest.raises(RuntimeError, match="not built"):
        eng._resolve_paged_attn(requested, tmodel.cfg)
    assert eng._resolve_paged_attn("off", tmodel.cfg) is False
    assert eng.stats()["paged_attn_fallbacks"] == 0


def test_kernel_unsupported_geometry_raises():
    """paged_attn='on' with a head_dim the kernel does not take raises
    at construction, on the CPU too."""
    cfg = tt.TransformerConfig(dtype=torch.float32,
                               **dict(BASE, d_model=16))  # head_dim 4
    model = tt.Transformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="head_dim 4"):
        InferenceEngine(model, None, device="cpu", **ENGINE_KW)
    eng = InferenceEngine(model, None, device="cpu",
                          **dict(ENGINE_KW, paged_attn="off"))
    assert not eng.paged_attn


def test_sampled_decode_is_reproducible(models):
    _, _, tmodel = models

    def once(seed):
        eng = InferenceEngine(tmodel, None, device="cpu", **ENGINE_KW)
        b = ContinuousBatcher(eng)
        reqs = [b.submit([1, 2, 3], max_new_tokens=8, temperature=1.5,
                         seed=seed),
                b.submit([1, 2, 3], max_new_tokens=8, top_k=1,
                         temperature=1.0, seed=seed)]
        while not all(r.finished() for r in reqs):
            b.step()
        return [r.out_tokens for r in reqs]

    first = once(7)
    assert once(7) == first
    # top_k 1 keeps only the argmax: the greedy sequence
    assert first[1] == _greedy_ref(tmodel, [1, 2, 3], 8)


def test_eos_and_deadlines_end_requests(models):
    _, _, tmodel = models
    prompt = [4, 8, 15, 16]
    greedy = _greedy_ref(tmodel, prompt, 6)
    eng = InferenceEngine(tmodel, None, device="cpu", **ENGINE_KW)
    # eos: the request stops at the first occurrence of the eos token
    b = ContinuousBatcher(eng, eos_id=greedy[2])
    assert _run(b, [prompt], 6) == [greedy[:greedy.index(greedy[2]) + 1]]
    # deadlines: a queued request expires before any prefill is spent
    b = ContinuousBatcher(eng, max_admit_per_step=1)
    first = b.submit(prompt, max_new_tokens=3)
    late = b.submit(prompt, max_new_tokens=3, deadline_ms=1e-3)
    prefills = eng.stats()["prefills"]
    while not (first.finished() and late.finished()):
        b.step()
    assert first.status == "done" and late.status == "deadline"
    assert late.out_tokens == [] and eng.stats()["prefills"] == prefills + 1


def _script(mgr):
    """One scripted allocator sequence; the bookkeeping after each step."""
    from horovod_tpu_torch.serving.paged_kv import page_hashes

    prompt = np.arange(20, dtype=np.int32)
    hashes = page_hashes(prompt, mgr.page_tokens)
    snaps = []

    def snap(note):
        snaps.append((note, mgr._tables.tolist(), mgr._ref.tolist(),
                      list(mgr._free), mgr.stats()))

    a = mgr.alloc("a")
    assert mgr.ensure_pages(a, 20)
    mgr.set_length(a, 20)
    mgr.publish_prefix(a, hashes)
    snap("prefill a")
    b = mgr.alloc("b")
    hits = mgr.lookup_prefix(hashes)
    mgr.attach_prefix(b, hits[:2])
    assert mgr.ensure_pages(b, 21, write_from=16)
    mgr.set_length(b, 21)
    snap("b attaches the prefix")
    assert mgr.ensure_pages(b, 21, write_from=8)  # copy-on-write
    snap("b writes into a shared page")
    mgr.free(a)
    snap("a retires")
    kept, length = mgr.detach_keep(b)
    snap("b pauses")
    c = mgr.alloc("c")
    mgr.reattach(c, kept, length)
    mgr.set_length(c, 23)
    snaps.append(("decode sweep", mgr.ensure_decode_pages()))
    snap("c resumed")
    d = mgr.alloc("d")
    # more than the pool holds: index-only pages are evicted, then False
    snaps.append(("d asks for a whole slot", mgr.ensure_pages(d, 64)))
    snap("d holds what the pool had")
    kept, _ = mgr.detach_keep(c)
    mgr.release_kept(kept)
    mgr.free(d)
    snap("all free")
    return snaps


def test_page_manager_matches_jax():
    def jax_cache(batch, seq):
        return jt.init_cache(jt.TransformerConfig(dtype=jnp.float32, **BASE),
                             batch, seq)

    def torch_cache(batch, seq):
        return tt.init_cache(tt.TransformerConfig(dtype=torch.float32, **BASE),
                             batch, seq)

    kw = dict(page_tokens=8, num_pages=12, watermark=-1)
    want = _script(JaxManager(jax_cache, 3, 64, **kw))
    got = _script(PagedKVCacheManager(torch_cache, 3, 64, **kw))
    assert got == want


# ------------------------------------------------------------------ HTTP


def _post(port, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body, method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as resp:
        return resp.read().decode()


def test_serve_http_roundtrip(models):
    _, _, tmodel = models
    handle = serve(tmodel, None, port=0, slots=2, max_new_tokens=5,
                   addr="127.0.0.1", handle_sigterm=False, device="cpu",
                   page_tokens=8, prefill_ceiling=16)
    try:
        prompt = [9, 10, 11, 12]
        status, out = _post(handle.port, json.dumps({"tokens": prompt})
                            .encode())
        assert status == 200 and out["status"] == "done"
        assert out["tokens"] == _greedy_ref(tmodel, prompt, 5)
        assert out["ttft_ms"] > 0
        # a prompt that fills the slot can never fit: 429
        status, err = _post(handle.port, json.dumps(
            {"tokens": list(range(64))}).encode())
        assert status == 429 and "no room" in err["error"]
        for body in (b"not json", b"[1,2,3]", b'{"tokens": "abc"}',
                     b'{"tokens": [1, 2], "max_tokens": "x"}'):
            assert _post(handle.port, body)[0] == 400, body
        health = json.loads(_get(handle.port, "/healthz"))
        assert health["ok"] and health["slots_total"] == 2
        assert health["free_pages"] == health["pages_total"] == 16
        text = _get(handle.port, "/metrics")
        assert 'serve_ttft_ms{quantile="0.5"}' in text
        assert "hvd_serve_slots_total" in text
        stats = json.loads(_get(handle.port, "/stats"))
        assert stats["prefills"] == 1 and stats["slo"]["ttft_ms"]["count"] == 1
    finally:
        handle.stop()


def test_drain_finishes_accepted_then_refuses(models):
    _, _, tmodel = models
    handle = serve(tmodel, None, port=0, slots=2, max_new_tokens=4,
                   addr="127.0.0.1", handle_sigterm=False, device="cpu",
                   page_tokens=8)
    try:
        assert handle._drain_hook in preemption.drain_hooks()
        req = handle.batcher.submit([3, 4, 5])
        preemption.GracefulShutdown().drain()  # what SIGTERM runs
        assert req.status == "done" and len(req.out_tokens) == 4
        status, err = _post(handle.port, b'{"tokens": [1]}')
        assert status == 503 and err["error"] == "draining"
        assert json.loads(_get(handle.port, "/healthz"))["ok"] is False
    finally:
        handle.stop()
    assert handle._drain_hook not in preemption.drain_hooks()


def test_scheduler_failure_errors_requests(models, monkeypatch):
    _, _, tmodel = models
    handle = serve(tmodel, None, port=0, slots=2, max_new_tokens=4,
                   addr="127.0.0.1", handle_sigterm=False, device="cpu",
                   page_tokens=8)
    try:
        def boom(tokens):
            raise RuntimeError("device fault")

        monkeypatch.setattr(handle.engine, "decode_step", boom)
        status, out = _post(handle.port, b'{"tokens": [1, 2]}')
        assert status == 500 and out["status"] == "error"
        assert handle.frontend.draining
    finally:
        handle.stop()


def test_default_device_needs_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, _, tmodel = models
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(tmodel, None, port=0, handle_sigterm=False)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA card, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr
