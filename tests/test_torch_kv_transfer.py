"""The port's disaggregated fleet (horovod_tpu_torch/serving/kv_transfer.py)
against the JAX package's (horovod_tpu/serving/kv_transfer.py).

The wire: fp32 and bf16 frames byte for byte the JAX codec's for the
same pages; the int8 codec held to its contract against the JAX one
(the same meta and layout, block scales bitwise, each value within one
quantum, pad rows exact zeros, unbiased over seeds); ``wire_block_size``
equal. The fleet: a prefill worker and a decode worker of the port on
localhost, over a real ``KVTransferServer``, give on the fp32 wire the
JAX package's unified tokens bit for bit (the toy MHA, the RoPE-GQA
model, staggered multi-slot admissions), and on the int8 wire a greedy
match of at least 0.9; the role gates, reservation denial and
failover, a retried mid-transfer reset, the fallback to local decode on
exhaustion and the local path without capacity (both with no 5xx), the
capacity blob's keys and roleless announcements. Live migration (the
``migrate`` frame): a sequence exported mid-decode resumes on a decode
worker with the JAX unified tokens bit for bit (fp32 wire), a sampled
one with the tokens of the port's own unmigrated run (torch's Philox is
not ``jax.random``), the drain deadline migrates, a ``serve.migrate``
reset admits once, no capacity decodes locally, and a quantizer that
fails while packing ends the request ``error`` with no fallback. The
JAX unified tokens are computed once for the module. The port runs with
``device="cpu"``, where each kernel wrapper takes its plain version."""

import json
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu.serving import kv_transfer as jkv
from horovod_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu.serving.frontend import ServeFrontend as JaxFrontend
from horovod_tpu_torch import preemption
from horovod_tpu_torch.common.metrics import registry as metrics
from horovod_tpu_torch.common.retry import RetryPolicy, _reset_breakers
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving import kv_transfer as tkv
from horovod_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceEngine,
    Rejected,
    ServeFrontend,
    read_announcements,
    serve,
)
from horovod_tpu_torch.testing import chaos

BASE = dict(vocab_size=61, num_layers=1, d_model=16, num_heads=2, d_ff=32,
            max_len=64, causal=True)
ENGINE_KW = dict(slots=4, max_len=64, paged=True)
MHA = dict(prompt=list(range(1, 11)), n=8)
GQA = dict(prompt=list(range(2, 14)), n=6)
STAGGERED = [list(range(1, 8)), list(range(3, 15)), [7, 5, 3, 2, 9]]
INT8 = [list(range(1, 10)), list(range(5, 17)), [9, 1, 4, 4, 8]]
FALLBACK = list(range(1, 9))
# live migration: (prompt, tokens), exported after 4 rounds mid-decode
MIGRATE = [(list(range(1, 9)), 10), (list(range(2, 10)), 10),
           (list(range(1, 8)), 9), (list(range(4, 12)), 8)]
SAMPLED = dict(temperature=0.7, top_k=7, seed=42)


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


def _jax_unified(jmodel, params, jobs):
    """The JAX package's unified tokens, one request at a time through
    one engine (its executables compile once)."""
    bat = JaxBatcher(JaxEngine(jmodel, params, min_bucket=4, **ENGINE_KW))
    out = []
    for prompt, n in jobs:
        req = bat.submit(prompt, max_new_tokens=n)
        while not req.finished():
            bat.step()
        assert req.status == "done"
        out.append(req.result()["tokens"])
    return out


@pytest.fixture(scope="module")
def oracle():
    """(port toy MHA model, port RoPE-GQA model, the JAX unified tokens
    of every job below)."""
    jm, jp, tm = _models()
    jobs = ([(MHA["prompt"], MHA["n"])] + [(p, 6) for p in STAGGERED]
            + [(p, 8) for p in INT8] + [(FALLBACK, 5)] + MIGRATE)
    toks = _jax_unified(jm, jp, jobs)
    jg, jgp, tg = _models(rope=True, num_kv_heads=1)
    (gqa,) = _jax_unified(jg, jgp, [(GQA["prompt"], GQA["n"])])
    return {
        "mha": tm, "gqa": tg, "mha_tokens": toks[0],
        "staggered": toks[1:4], "int8": toks[4:7], "fallback": toks[7],
        "migrate": toks[8:],
        "gqa_tokens": gqa, "jax": (jm, jp),
    }


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    _reset_breakers()
    yield
    chaos.reset()
    _reset_breakers()
    for fn in preemption.drain_hooks():
        preemption.unregister_drain(fn)


class _Announcements:
    """The serve-scope announcements over a dict: what a coordinator
    reads instead of a live rendezvous KV."""

    def __init__(self, anns):
        self.anns = dict(anns)

    def keys(self, scope):
        return [str(r) for r in self.anns] if scope == "serve" else []

    def get(self, scope, key):
        return json.dumps(self.anns[int(key)]).encode()


def _decode_ann(rank, transfer_port, free_pages=100, **extra):
    ann = {"port": 1, "addr": "127.0.0.1", "role": "decode",
           "transfer_port": transfer_port, "free_pages": free_pages,
           "free_slots": 4, "ts": time.time()}
    ann.update(extra)
    return ann


def _engine(model, role="unified", **kw):
    return InferenceEngine(model, None, device="cpu", role=role,
                           **dict(ENGINE_KW, **kw))


class _Fleet:
    """A prefill and a decode worker of the port wired through a real
    KVTransferServer on localhost."""

    def __init__(self, model, wire="fp32", retry=None):
        self.deng = _engine(model, "decode")
        self.dbat = ContinuousBatcher(self.deng, role="decode")
        self.server = tkv.KVTransferServer(self.dbat, port=0,
                                           addr="127.0.0.1")
        self.server.start()
        self.peng = _engine(model, "prefill")
        self.pbat = ContinuousBatcher(self.peng, role="prefill")
        self.coord = tkv.TransferCoordinator(
            self.peng, wire=wire, retry=retry,
            client=_Announcements({0: _decode_ann(0, self.server.port)}),
        )
        self.pbat.transfer = self.coord
        self.dbat.start()

    def run(self, jobs, stagger=0, timeout=60.0):
        reqs = []
        for prompt, n in jobs:
            reqs.append(self.pbat.submit(prompt, max_new_tokens=n))
            for _ in range(stagger):  # admissions land mid-decode
                self.pbat.step()
                time.sleep(0.002)
        deadline = time.monotonic() + timeout
        while (not all(r.finished() for r in reqs)
               and time.monotonic() < deadline):
            self.pbat.step()
            time.sleep(0.005)
        assert all(r.finished() for r in reqs), "transfer never completed"
        return reqs

    def close(self):
        self.dbat.stop()
        self.server.stop()


# ---------------------------------------------------------------- codec


def _pages(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("pool,wire", [("float32", "fp32"),
                                       ("float32", "bf16"),
                                       ("bfloat16", "fp32"),
                                       ("bfloat16", "bf16")])
def test_frames_byte_equal_jax(pool, wire):
    """The same pages framed by both codecs: the same bytes, and each
    side unpacks the other's frame to the same values."""
    np_dtype = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[pool]
    raw = _pages((3, 8, 2, 4), 0, np_dtype)
    want = jkv.frame(*jkv.pack_raw_pages(raw, [0, 1, 2], length=20,
                                         page_tokens=8, wire=wire))
    mine = [torch.from_numpy(a.astype(np.float32)).to(
        tkv.NAME_DTYPES[pool]) for a in raw]
    got = tkv.frame(*tkv.pack_raw_pages(mine, [0, 1, 2], length=20,
                                        page_tokens=8, wire=wire))
    assert got == want
    meta, blob = tkv.unframe(got)
    for a, b in zip(jkv.unpack_pages(*jkv.unframe(want)),
                    tkv.unpack_pages(meta, blob)):
        assert str(b.dtype).endswith(pool)
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.float().numpy())


def _int8_parts(meta, blob):
    """(values, scales) per segment of an int8 blob."""
    off, out = 0, []
    for seg in meta["segments"]:
        n = int(np.prod(seg["shape"]))
        vals = np.frombuffer(blob, np.int8, count=n, offset=off)
        off += n
        scales = np.frombuffer(blob, np.float32, count=seg["nscales"],
                               offset=off)
        off += 4 * seg["nscales"]
        out.append((vals, scales))
    return out


def test_int8_codec_contract_against_jax():
    """Meta and layout equal; scales bitwise; each value within one
    quantum of the JAX codec's (the two draw their stochastic rounding
    from different generators); pad rows exact zeros; the JAX unpack of
    the port's frame equals the port's own; unbiased over seeds."""
    rng = np.random.default_rng(1)
    page = rng.standard_normal((4, 8, 2, 32)).astype(np.float32)
    page[-1, 3:] = 0.0  # the tail page's pad rows
    page[0, 0, 0, 0] = 50.0  # a block whose scale a pad would not set
    jmeta, jblob = jkv.pack_raw_pages([page], [0, 1, 2, 3], length=27,
                                      page_tokens=8, wire="int8", seed=3)
    meta, blob = tkv.pack_raw_pages([torch.from_numpy(page)], [0, 1, 2, 3],
                                    length=27, page_tokens=8, wire="int8",
                                    seed=3)
    assert meta == jmeta and len(blob) == len(jblob)
    assert meta["segments"][0]["block"] == 512  # a page is 512 elements
    ((jv, js),), ((v, s),) = _int8_parts(jmeta, jblob), _int8_parts(meta,
                                                                     blob)
    np.testing.assert_array_equal(s, js)
    assert np.abs(v.astype(np.int32) - jv.astype(np.int32)).max() <= 1
    (out,) = tkv.unpack_pages(meta, blob)
    np.testing.assert_array_equal(out[-1, 3:].numpy(), 0.0)
    (jout,) = jkv.unpack_pages(meta, blob)
    np.testing.assert_array_equal(out.numpy(), jout)
    flat_in, flat_out = page.reshape(4, -1), out.numpy().reshape(4, -1)
    for p in range(4):
        bound = 2.0 * np.abs(flat_in[p]).max() / 127.0 + 1e-6
        assert np.abs(flat_in[p] - flat_out[p]).max() <= bound
    # unbiased: the mean over seeds of a value's dequantization tends to
    # the value (256 draws: a standard deviation of s/32 at most, where
    # a biased rounding such as the floor is off by up to s)
    small = torch.from_numpy(page[1:2])
    mean = torch.stack([
        tkv.unpack_pages(*tkv.pack_raw_pages(
            [small], [0], length=8, page_tokens=8, wire="int8",
            seed=k))[0]
        for k in range(256)]).mean(0)
    step = float(np.abs(page[1]).max()) / 127.0
    assert float((mean - small).abs().max()) <= step / 4


def test_wire_block_size_matches_jax():
    for elems in (1, 64, 500, 512, 513, 1024, 4096, 16384, 12345):
        assert tkv.wire_block_size(elems) == jkv.wire_block_size(elems)
    assert tkv.wire_block_size(16 * 16 * 64) == 512  # GPT-2 medium's page


# ------------------------------------------------------------ bit parity


def test_fp32_fleet_equals_jax_unified_mha(oracle):
    fleet = _Fleet(oracle["mha"], wire="fp32")
    try:
        (req,) = fleet.run([(MHA["prompt"], MHA["n"])])
        assert req.status == "done"
        assert req.result()["tokens"] == oracle["mha_tokens"]
        assert fleet.deng.stats()["transfer_ingests"] == 1
    finally:
        fleet.close()


def test_fp32_fleet_equals_jax_unified_rope_gqa(oracle):
    fleet = _Fleet(oracle["gqa"], wire="fp32")
    try:
        (req,) = fleet.run([(GQA["prompt"], GQA["n"])])
        assert req.result()["tokens"] == oracle["gqa_tokens"]
    finally:
        fleet.close()


def test_fp32_fleet_equals_jax_unified_staggered(oracle):
    """Three prompts streamed at staggered times share the decode
    worker's slots; each matches its JAX unified tokens bit for bit.
    Neither worker captures a decode graph on the CPU."""
    fleet = _Fleet(oracle["mha"], wire="fp32")
    try:
        reqs = fleet.run([(p, 6) for p in STAGGERED], stagger=3)
        for req, want in zip(reqs, oracle["staggered"]):
            assert req.status == "done"
            assert req.result()["tokens"] == want
        assert fleet.deng.stats()["transfer_ingests"] == 3
        assert fleet.deng.stats()["decode_compiles"] == 0
        assert fleet.peng.stats()["decode_compiles"] == 0
        assert fleet.peng.stats()["decode_steps"] == 0
    finally:
        fleet.close()


def test_int8_fleet_greedy_match(oracle):
    fleet = _Fleet(oracle["mha"], wire="int8")
    try:
        reqs = fleet.run([(p, 8) for p in INT8])
        total = matched = 0
        for req, want in zip(reqs, oracle["int8"]):
            got = req.result()["tokens"]
            assert req.status == "done" and len(got) == len(want)
            total += len(want)
            matched += sum(g == w for g, w in zip(got, want))
        assert matched / total >= 0.9, (matched, total)
    finally:
        fleet.close()


def test_pack_failure_raises_and_never_falls_back(oracle, monkeypatch):
    """A failure of the int8 codec's quantizer while packing is a
    kernel's fault, not the wire's: the request ends ``error``, the
    handoff thread raises it, its pages go back to the pool, and no
    local decode (``serve.transfer_fallbacks``) hides it."""
    def broken(*args, **kw):
        raise RuntimeError("block quantizer failed to launch")

    raised = []
    monkeypatch.setattr(tkv, "int8_block_quantize", broken)
    monkeypatch.setattr(
        "threading.excepthook", lambda hook: raised.append(hook.exc_value))
    before = metrics.snapshot()
    fleet = _Fleet(oracle["mha"], wire="int8")
    try:
        (req,) = fleet.run([(FALLBACK, 5)])
        assert req.status == "error"
        deadline = time.monotonic() + 10
        while not raised and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [str(e) for e in raised] == [
            "block quantizer failed to launch"]
        after = metrics.snapshot()
        for key, grew in (("serve.transfer_fallbacks", 0),
                          ("serve.errored", 1), ("serve.transfers", 0)):
            assert after.get(key, 0) - before.get(key, 0) == grew, key
        assert fleet.peng.stats()["decode_steps"] == 0
        assert fleet.deng.stats()["transfer_ingests"] == 0
        assert fleet.pbat._handoffs == 0
        assert fleet.peng.manager.stats()["pages_active"] == 0
    finally:
        fleet.close()


# ------------------------------------------------------------ role gates


def test_role_gates(oracle):
    model = oracle["mha"]
    eng = _engine(model, "decode")
    bat = ContinuousBatcher(eng, role="decode")
    with pytest.raises(Rejected):
        bat.submit([1, 2, 3])
    with pytest.raises(RuntimeError, match="decode-role"):
        eng.prefill(eng.manager.alloc(), [1, 2, 3])
    with pytest.raises(ValueError, match="role"):
        _engine(model, "router")
    for role, kw, what in (("router", {}, "role"),
                           ("unified", {"kv_wire": "fp16"}, "wire")):
        with pytest.raises(ValueError, match=what):
            serve(model, None, port=0, device="cpu", handle_sigterm=False,
                  addr="127.0.0.1", role=role, **kw)


def test_roles_require_paged_plane(oracle):
    eng = _engine(oracle["mha"], paged=False)
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="paged"):
            ContinuousBatcher(eng, role=role)


# ------------------------------------------------- reservations, failover


def _reserve(port, pages):
    body = json.dumps({"pages": pages}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/kv/reserve",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_reserve_denied_when_draining_or_over_headroom(oracle):
    deng = _engine(oracle["mha"], "decode")
    dbat = ContinuousBatcher(deng, role="decode")
    server = tkv.KVTransferServer(dbat, port=0, addr="127.0.0.1")
    server.start()
    try:
        headroom = deng.manager.admission_headroom()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _reserve(server.port, headroom + 1)
        assert ei.value.code == 503
        code, out = _reserve(server.port, 3)
        assert code == 200 and out["pages"] == 3
        assert {"recv_ts", "send_ts", "peer"} <= set(out)
        assert server.reserved_pages() == 3
        dbat.drain(timeout=1.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _reserve(server.port, 1)
        assert ei.value.code == 503
    finally:
        server.stop()


def test_reservation_failover_to_second_decode_worker(oracle):
    """A better-looking first target where nothing listens is skipped
    within the call; the reservation lands on the next one."""
    deng = _engine(oracle["mha"], "decode")
    server = tkv.KVTransferServer(ContinuousBatcher(deng, role="decode"),
                                  port=0, addr="127.0.0.1")
    server.start()
    coord = tkv.TransferCoordinator(
        _engine(oracle["mha"], "prefill"), wire="fp32",
        reserve_timeout_s=0.3,
        client=_Announcements({
            5: _decode_ann(5, 1, free_pages=500),
            0: _decode_ann(0, server.port, free_pages=10),
        }),
    )
    try:
        assert [a["rank"] for a in coord.decode_targets()] == [5, 0]
        res = coord.reserve(2)
        assert res is not None and res["rank"] == 0
    finally:
        server.stop()


# ------------------------------------------------------ chaos, fallback


def test_mid_transfer_reset_is_retried(oracle):
    chaos.configure("serve.kv_transfer@1:reset")
    before = metrics.snapshot().get("serve.transfer_fallbacks", 0)
    retry = RetryPolicy("serve.kv_transfer", attempts=3, backoff_ms=1.0,
                        attempt_timeout_s=10.0)
    fleet = _Fleet(oracle["mha"], wire="fp32", retry=retry)
    try:
        (req,) = fleet.run([(FALLBACK, 5)])
        assert req.status == "done"
        assert req.result()["tokens"] == oracle["fallback"]
        snap = metrics.snapshot()
        assert snap.get("chaos.serve.kv_transfer.reset", 0) >= 1
        assert snap.get("serve.transfer_fallbacks", 0) == before
        assert fleet.deng.stats()["transfer_ingests"] == 1
    finally:
        fleet.close()


def _generate(port, prompt, n):
    body = json.dumps({"tokens": prompt, "max_tokens": n}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.mark.parametrize("case", ["exhausted", "no_capacity"])
def test_fallback_and_local_path_answer_200(oracle, case):
    """Every stream attempt reset past the retry budget after the
    reservation and the prefill: the request comes home and decodes
    locally (``serve.transfer_fallbacks``). With no decode worker
    announced, it takes the local path at once (``serve.transfer_local``).
    Either way the client sees 200 and the JAX unified tokens."""
    model = oracle["mha"]
    fleet = None
    if case == "exhausted":
        chaos.configure("serve.kv_transfer:p=1:reset")
        fleet = _Fleet(model, wire="fp32", retry=RetryPolicy(
            "serve.kv_transfer", attempts=2, backoff_ms=1.0, deadline_s=5.0,
            attempt_timeout_s=0.5))
        pbat, peng = fleet.pbat, fleet.peng
        counter = "serve.transfer_fallbacks"
    else:
        peng = _engine(model, "prefill")
        pbat = ContinuousBatcher(peng, role="prefill")
        pbat.transfer = tkv.TransferCoordinator(
            peng, client=_Announcements({}), wire="fp32")
        counter = "serve.transfer_local"
    fe = ServeFrontend(pbat, port=0, addr="127.0.0.1")
    before = metrics.snapshot()
    pbat.start()
    fe.start()
    try:
        code, out = _generate(fe.port, FALLBACK, 5)
        assert code == 200 and out["status"] == "done"
        assert out["tokens"] == oracle["fallback"]
        after = metrics.snapshot()
        assert after.get(counter, 0) == before.get(counter, 0) + 1
        assert after.get("serve.http_5xx", 0) == before.get(
            "serve.http_5xx", 0)
        assert peng.stats()["decode_steps"] > 0
        if fleet is not None:
            assert fleet.deng.stats()["transfer_ingests"] == 0
    finally:
        fe.stop()
        pbat.stop()
        if fleet is not None:
            fleet.close()


# ------------------------------------------------------- announcements


def test_capacity_blob_keys_equal_jax(oracle):
    """A decode worker's capacity blob has the JAX frontend's keys, its
    role and transfer port; a reservation debits its free pages."""
    jm, jp = oracle["jax"]
    jeng = JaxEngine(jm, jp, role="decode", **ENGINE_KW)
    jbat = JaxBatcher(jeng, role="decode")
    jserver = jkv.KVTransferServer(jbat, port=0, addr="127.0.0.1")
    jfe = JaxFrontend(jbat, port=0, addr="127.0.0.1",
                      transfer_server=jserver)
    deng = _engine(oracle["mha"], "decode")
    dbat = ContinuousBatcher(deng, role="decode")
    server = tkv.KVTransferServer(dbat, port=0, addr="127.0.0.1")
    server.start()
    fe = ServeFrontend(dbat, port=0, addr="127.0.0.1", transfer_server=server)
    try:
        cap = fe.capacity()
        assert set(cap) == set(jfe.capacity())
        assert cap["role"] == "decode" and cap["transfer_port"] == server.port
        _reserve(server.port, 3)
        assert fe.capacity()["free_pages"] == cap["free_pages"] - 3
    finally:
        fe.stop()
        jfe._httpd.server_close()
        jserver._httpd.server_close()
        server.stop()


def test_roleless_announcements_read_as_unified():
    """Blobs of workers that announce no role parse as unified: they are
    read, and never taken for decode targets."""
    anns = _Announcements({
        0: {"port": 9000, "addr": "127.0.0.1", "free_pages": 50,
            "transfer_port": 7000},
        1: _decode_ann(1, 7001),
        2: {"port": 9002, "role": "router"},
        3: {"no": "port"},
    })
    read = read_announcements(anns)
    assert sorted(read) == [0, 1, 2]
    assert [tkv.worker_role(read[r]) for r in (0, 1, 2)] == [
        "unified", "decode", "unified"]
    assert [jkv.worker_role(read[r]) for r in (0, 1, 2)] == [
        "unified", "decode", "unified"]
    coord = tkv.TransferCoordinator(object(), client=anns, wire="int8")
    assert [a["rank"] for a in coord.decode_targets()] == [1]
    assert [a["rank"] for a in coord.decode_targets(
        roles=("decode", "unified"))] == [1, 0]  # the most free first


# ----------------------------------------------- the engine's primitives


def test_extract_pages_and_pack_pages(oracle):
    """A prefilled slot's pages come out whole, the tail page's rows at
    and past the length zeroed; ``pack_pages`` frames exactly them."""
    eng = _engine(oracle["mha"], page_tokens=8)
    slot = eng.manager.alloc(0)
    eng.prefill(slot, list(range(1, 20)))  # 19 tokens: 3 pages
    kept, length = eng.manager.detach_keep(slot)
    assert length == 19 and [lp for lp, _ in kept] == [0, 1, 2]
    idx = torch.tensor([p for _, p in kept])
    leaves = [layer[name] for layer in eng.manager.cache
              for name in ("k", "v")]
    for leaf in leaves:
        leaf[idx[-1], 3:] = 7.0  # stale rows past the length
    pages = eng.extract_pages(kept, length)
    assert len(pages) == len(leaves)
    for got, leaf in zip(pages, leaves):
        want = leaf[idx].clone()
        want[-1, 3:] = 0
        assert torch.equal(got, want)
        assert torch.all(leaf[idx[-1], 3:] == 7.0)  # the pool untouched
    meta, blob = tkv.pack_pages(eng, kept, length, wire="fp32")
    want_meta, want_blob = tkv.pack_raw_pages(
        pages, [0, 1, 2], length, page_tokens=8, wire="fp32")
    assert (meta, blob) == (want_meta, want_blob)


def test_export_import_sampling_continues_the_stream(oracle):
    """A slot's armed sampling state moved to another engine draws what
    the first would have drawn next."""
    a, b = _engine(oracle["mha"]), _engine(oracle["mha"])
    a.set_sampling(1, temperature=0.8, top_k=5, seed=11)
    logits = torch.randn(4, 61, generator=torch.Generator().manual_seed(3))
    temps, topks = a._sample_temps, a._sample_topks
    first = a._generators[1]
    from horovod_tpu_torch.serving.engine import _sample_next

    _sample_next(logits, temps, topks, a._generators)  # one draw in
    b.import_sampling(1, a.export_sampling(1))
    assert b._sample_temps[1] == np.float32(0.8) and b._sample_topks[1] == 5
    want = _sample_next(logits, temps, topks, a._generators)[1]
    got = _sample_next(logits, b._sample_temps, b._sample_topks,
                       b._generators)[1]
    assert int(got) == int(want) and first is a._generators[1]


# ------------------------------------------------------- live migration


def _receiver(model):
    """A decode worker behind a real KVTransferServer, its scheduler
    running: where migrated sequences land."""
    deng = _engine(model, "decode")
    dbat = ContinuousBatcher(deng, role="decode")
    server = tkv.KVTransferServer(dbat, port=0, addr="127.0.0.1")
    server.start()
    dbat.start()
    return dbat, server


def _mid_decode(model, prompt, n, client, wire="fp32", retry=None,
                submit_kw=None):
    """A unified worker of the port stepped 4 rounds: (batcher, its
    coordinator, the request, mid-decode)."""
    seng = _engine(model)
    sbat = ContinuousBatcher(seng, default_max_new_tokens=8)
    coord = tkv.TransferCoordinator(seng, client=client, wire=wire,
                                    retry=retry)
    req = sbat.submit(prompt, max_new_tokens=n, **(submit_kw or {}))
    for _ in range(4):
        sbat.step()
    assert req.status == "running" and 2 <= len(req.out_tokens) < n
    return sbat, coord, req


def _port_unified(model, prompt, n, **kw):
    bat = ContinuousBatcher(_engine(model))
    req = bat.submit(prompt, max_new_tokens=n, **kw)
    while not req.finished():
        bat.step()
    return req.result()["tokens"]


def test_migration_mid_decode_equals_jax_unified(oracle):
    """A sequence exported mid-decode resumes on the decode worker with
    its whole token history and no prefill: on the fp32 wire its tokens
    are the JAX unified tokens, bit for bit."""
    (prompt, n), want = MIGRATE[0], oracle["migrate"][0]
    dbat, server = _receiver(oracle["mha"])
    before = metrics.snapshot()
    try:
        sbat, coord, req = _mid_decode(
            oracle["mha"], prompt, n,
            _Announcements({0: _decode_ann(0, server.port)}))
        records = sbat.export_inflight()
        assert len(records) == 1 and sbat._handoffs == 1
        assert coord.migrate(sbat, records[0])
        assert req.wait(timeout=30) and req.status == "done"
        assert req.result()["tokens"] == want
        after = metrics.snapshot()
        for key in ("serve.migrations", "serve.migrations_in"):
            assert after.get(key, 0) == before.get(key, 0) + 1, key
        assert dbat.engine.stats()["prefills"] == 0
        assert dbat.engine.stats()["transfer_ingests"] == 1
        assert sbat._handoffs == 0
        assert sbat.engine.manager.stats()["pages_active"] == 0
    finally:
        dbat.stop()
        server.stop()


def test_migration_continues_the_sampling_stream(oracle):
    """A sampled sequence migrated mid-decode draws what the same request
    unmigrated on one worker of the port draws: the generator's raw
    state travels, not the seed (re-seeding would fork the stream)."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    want = _port_unified(oracle["mha"], prompt, 10, **SAMPLED)
    dbat, server = _receiver(oracle["mha"])
    try:
        sbat, coord, req = _mid_decode(
            oracle["mha"], prompt, 10,
            _Announcements({0: _decode_ann(0, server.port)}),
            submit_kw=SAMPLED)
        (rec,) = sbat.export_inflight()
        assert rec["sample"]["temperature"] == np.float32(0.7)
        assert coord.migrate(sbat, rec)
        assert req.wait(timeout=30) and req.status == "done"
        assert req.result()["tokens"] == want
    finally:
        dbat.stop()
        server.stop()


def test_drain_deadline_migrates_inflight(oracle):
    """``ServeFrontend.drain(migrate_after=0)`` exports the in-flight
    slot and streams it out; the drain returns True and the request
    completes remotely with the JAX unified tokens."""
    (prompt, n), want = MIGRATE[1], oracle["migrate"][1]
    dbat, server = _receiver(oracle["mha"])
    try:
        sbat, coord, req = _mid_decode(
            oracle["mha"], prompt, n,
            _Announcements({0: _decode_ann(0, server.port)}))
        sbat.transfer = coord
        before = metrics.snapshot().get("serve.migrations", 0)
        fe = ServeFrontend(sbat, port=0, addr="127.0.0.1")
        try:
            assert fe.drain(timeout=30.0, migrate_after=0.0)
        finally:
            fe.stop()
        assert req.finished() and req.status == "done"
        assert req.result()["tokens"] == want
        assert metrics.snapshot().get("serve.migrations", 0) == before + 1
    finally:
        dbat.stop()
        server.stop()


def test_migration_reset_admits_exactly_once(oracle):
    """``serve.migrate@1:reset``: the retry re-POSTs the same frame and
    the receiver's ledger admits it once; the tokens stay the JAX
    unified tokens."""
    (prompt, n), want = MIGRATE[2], oracle["migrate"][2]
    chaos.configure("seed=7;serve.migrate@1:reset")
    retry = RetryPolicy("serve.kv_transfer", attempts=3, backoff_ms=1.0,
                        attempt_timeout_s=10.0)
    dbat, server = _receiver(oracle["mha"])
    before = metrics.snapshot()
    try:
        sbat, coord, req = _mid_decode(
            oracle["mha"], prompt, n,
            _Announcements({0: _decode_ann(0, server.port)}), retry=retry)
        (rec,) = sbat.export_inflight()
        assert coord.migrate(sbat, rec)
        assert req.wait(timeout=30) and req.status == "done"
        assert req.result()["tokens"] == want
        snap = metrics.snapshot()
        assert snap.get("chaos.serve.migrate.reset", 0) >= 1
        assert snap.get("serve.migrations_in", 0) == before.get(
            "serve.migrations_in", 0) + 1
        assert dbat.engine.stats()["transfer_ingests"] == 1
    finally:
        dbat.stop()
        server.stop()


def test_migration_without_capacity_decodes_locally(oracle):
    """No peer announced: the exported record comes home paused on its
    own pages and the same drain finishes it, counted in
    ``serve.transfer_fallbacks``, with the JAX unified tokens."""
    (prompt, n), want = MIGRATE[3], oracle["migrate"][3]
    sbat, coord, req = _mid_decode(oracle["mha"], prompt, n,
                                   _Announcements({}))
    before = metrics.snapshot().get("serve.transfer_fallbacks", 0)

    def on_deadline(records):
        for rec in records:
            assert not coord.migrate(sbat, rec)

    assert sbat.drain(timeout=30.0, migrate_after=0.0,
                      on_deadline=on_deadline)
    assert req.status == "done" and req.result()["tokens"] == want
    assert metrics.snapshot().get("serve.transfer_fallbacks", 0) == before + 1


def test_migration_pack_failure_raises_and_never_falls_back(oracle,
                                                            monkeypatch):
    """The int8 quantizer failing while a migration packs is a kernel's
    fault: the request ends ``error``, the migrate thread raises it, the
    pages go back, and no local decode (``serve.transfer_fallbacks``)
    hides it. Packing runs before the wire's retry and fallback."""
    def broken(*args, **kw):
        raise RuntimeError("block quantizer failed to launch")

    raised = []
    monkeypatch.setattr(tkv, "int8_block_quantize", broken)
    monkeypatch.setattr(
        "threading.excepthook", lambda hook: raised.append(hook.exc_value))
    dbat, server = _receiver(oracle["mha"])
    before = metrics.snapshot()
    try:
        sbat, coord, req = _mid_decode(
            oracle["mha"], MIGRATE[0][0], MIGRATE[0][1],
            _Announcements({0: _decode_ann(0, server.port)}), wire="int8")
        (rec,) = sbat.export_inflight()
        assert coord.migrate(sbat, rec)
        assert req.wait(timeout=30) and req.status == "error"
        deadline = time.monotonic() + 10
        while not raised and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [str(e) for e in raised] == [
            "block quantizer failed to launch"]
        after = metrics.snapshot()
        for key, grew in (("serve.transfer_fallbacks", 0),
                          ("serve.errored", 1), ("serve.migrations", 0),
                          ("serve.migrations_in", 0)):
            assert after.get(key, 0) - before.get(key, 0) == grew, key
        assert sbat._handoffs == 0
        assert sbat.engine.manager.stats()["pages_active"] == 0
        assert dbat.engine.stats()["transfer_ingests"] == 0
    finally:
        dbat.stop()
        server.stop()
