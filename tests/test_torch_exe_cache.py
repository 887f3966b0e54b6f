"""The port's compiled-artifact store (``horovod_tpu_torch/common/
exe_cache.py``, ``HOROVOD_EXE_CACHE``) against the reference's contract
(oracle ``tests/test_exe_cache.py``, whose classes these mirror): the
same key strings as the JAX package for the same world, intra size and
key fields; a store/load round trip with no tmp leftovers; a flipped
byte, a torn write or a bad magic counted corrupt; the chaos bit flip
degrading to a cold compile and the chaos delay still loading; an entry
of other software rejected and never loaded; scan and preload; the
overlap schedule's sidecar replayed verbatim, equal to the JAX
package's partition; the restart stamp; and one Inductor round trip of
a tiny graph across two processes, whose second process loads the entry
and computes the first's bits.

The reference's two bitwise cases fail on this JAX (ROADMAP, caveats),
so the port is held to its own cold compile, bitwise, not to JAX's
outputs. The payloads are real Inductor artifacts: the first process of
the round trip makes them (a matrix product, which Inductor hands to an
extern kernel, so that no C++ is compiled here)."""

import glob
import json
import os
import struct
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.common import exe_cache as jexe
from horovod_tpu_torch.common import exe_cache
from horovod_tpu_torch.common.metrics import registry
from horovod_tpu_torch.testing import chaos

REPO = Path(__file__).resolve().parent.parent

# one compiled graph, in a fresh process: x @ w and its gradients
_SCRIPT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch._dynamo.utils import counters
from horovod_tpu_torch.common import exe_cache
from horovod_tpu_torch.common.metrics import registry

g = torch.Generator().manual_seed(0)
x = torch.randn(8, 16, generator=g, requires_grad=True)
w = torch.randn(16, 4, generator=g, requires_grad=True)
t0 = time.monotonic()
f = torch.compile(lambda x, w: torch.mm(x, w), fullgraph=True,
                  backend=exe_cache.backend())
y = f(x, w)
y.backward(torch.ones_like(y))
assert exe_cache.flush(30)
print("RESULT " + json.dumps({
    "s": time.monotonic() - t0,
    "bits": [t.detach().numpy().tobytes().hex() for t in (y, x.grad, w.grad)],
    "cache": {k: v for k, v in registry.snapshot().items()
              if k.startswith("exe_cache.")},
    "inner": {k: dict(counters[k]) for k in ("inductor", "aot_autograd")},
}))
"""


def _compile_in_process(cache, inductor_dir):
    env = dict(os.environ, HOROVOD_EXE_CACHE=str(cache),
               TORCHINDUCTOR_CACHE_DIR=str(inductor_dir))
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """A cold process that compiles and stores, then a fresh process,
    with Inductor's own caches empty, that loads the entry."""
    root = tmp_path_factory.mktemp("exe-round-trip")
    cold = _compile_in_process(root / "cache", root / "inductor-cold")
    warm = _compile_in_process(root / "cache", root / "inductor-warm")
    return cold, warm, root / "cache"


@pytest.fixture(scope="module")
def payload(round_trip):
    """The artifact bytes of the round trip's one entry."""
    (path,) = glob.glob(str(round_trip[2] / "*.hvdexe"))
    with open(path, "rb") as f:
        _, body = exe_cache._read_header(f.read())
    return body


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture()
def cache_base(tmp_path, monkeypatch):
    base = str(tmp_path / "exe-cache")
    monkeypatch.setenv("HOROVOD_EXE_CACHE", base)
    # the loads write into Inductor's caches: keep them in the test's dir
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
    return base


def _delta(name, before):
    return registry.snapshot().get(name, 0.0) - before.get(name, 0.0)


def _rewrite_header(path, **patch):
    """Tamper with pinned header fields in place (payload untouched)."""
    with open(path, "rb") as f:
        blob = f.read()
    off = len(exe_cache.MAGIC)
    (hlen,) = struct.unpack(">I", blob[off:off + 4])
    header = json.loads(blob[off + 4:off + 4 + hlen].decode())
    header.update(patch)
    hdr = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(exe_cache.MAGIC + struct.pack(">I", len(hdr)) + hdr
                + blob[off + 4 + hlen:])


def _gm():
    """A tiny FX graph and its inputs, as Dynamo hands a backend."""
    gm = torch.fx.symbolic_trace(lambda x, w: torch.mm(x, w) * 2.0)
    return gm, [torch.ones(4, 8), torch.ones(8, 2)]


# ------------------------------------------------------------------ keys


class TestKeys:
    @pytest.mark.parametrize("nums", [None, (), (0, 1), (3,), [2, 5, 7]])
    def test_donation_signature(self, nums):
        assert exe_cache.donation_signature(nums) == \
            jexe.donation_signature(nums)

    def test_entry_path_off_without_env(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_EXE_CACHE", raising=False)
        assert exe_cache.cache_dir() is None
        assert exe_cache.entry_path("f", "abc") is None

    @pytest.mark.parametrize("fields", [
        ("serve/prefill", "h1", "int8", "d1", "w8-l8-cpu"),
        ("serve/prefill", "h1", "int8", "d1", "w6-l6-cpu"),
        ("serve/prefill", "h1", "fp32", "d1", "w8-l8-cpu"),
        ("inductor", "h2", "none", "none", "w4-l2-cuda"),
    ])
    def test_entry_path_equals_the_reference(self, cache_base, fields):
        family, fp, wire, donation, topo = fields
        got = exe_cache.entry_path(family, fp, wire=wire, donation=donation,
                                   fingerprint=topo)
        want = jexe.entry_path(family, fp, wire=wire, donation=donation,
                               fingerprint=topo)
        assert got == want
        name = os.path.basename(got)
        assert name.startswith(f"{family.replace('/', '_')}-{topo}-")
        assert name.endswith(".hvdexe")

    def test_every_key_field_is_its_own_file(self, cache_base):
        base = dict(wire="int8", donation="d1", fingerprint="w8-l8-cpu")
        paths = {exe_cache.entry_path("serve/prefill", "h1", **base)}
        for patch in ({"fingerprint": "w6-l6-cpu"}, {"wire": "fp32"},
                      {"donation": "none"}):
            paths.add(exe_cache.entry_path("serve/prefill", "h1",
                                           **dict(base, **patch)))
        paths.add(exe_cache.entry_path("serve/prefill", "h2", **base))
        assert len(paths) == 5

    def test_topology_fingerprint_equals_the_reference(self, monkeypatch):
        """The same world and intra size give the same string: the JAX
        package's before init (its 8 CPU devices), the port's from the
        environment and from a topology."""
        monkeypatch.setenv("HOROVOD_SIZE", "8")
        monkeypatch.setenv("HOROVOD_INTRA_SIZE", "4")
        want = jexe.topology_fingerprint()
        assert want == "w8-l4-cpu"
        assert exe_cache.topology_fingerprint() == want
        topo = types.SimpleNamespace(size=8, local_size=4)
        assert exe_cache.topology_fingerprint(topo, "cpu") == want
        assert exe_cache.topology_fingerprint(topo, "cuda") == "w8-l4-cuda"

    def test_graph_fingerprint_keys_code_and_inputs(self):
        gm, inputs = _gm()
        fp = exe_cache.graph_fingerprint(gm, inputs)
        assert fp == exe_cache.graph_fingerprint(*_gm())
        assert fp != exe_cache.graph_fingerprint(
            gm, [torch.ones(4, 8, dtype=torch.float64), inputs[1]])
        assert fp != exe_cache.graph_fingerprint(
            gm, [torch.ones(8, 4).t(), inputs[1]])  # strides
        other = torch.fx.symbolic_trace(lambda x, w: torch.mm(x, w))
        assert fp != exe_cache.graph_fingerprint(other, inputs)
        # a nested graph's code (a custom autograd Function's bodies, as
        # Dynamo nests them) is part of the key
        fps = set()
        for k in (1, 2):
            outer, _ = _gm()
            outer.add_submodule("body", torch.fx.symbolic_trace(
                lambda x, k=k: x + k))
            fps.add(exe_cache.graph_fingerprint(outer, inputs))
        assert len(fps | {fp}) == 3


# ------------------------------------------------------- store / load


class TestRoundTrip:
    def test_store_load_counts_a_hit(self, cache_base, payload):
        before = registry.snapshot()
        path = exe_cache.store(payload, "test.rt", "g1", meta={"n": 1})
        assert exe_cache.flush(10)
        assert _delta("exe_cache.stores", before) == 1
        assert os.path.basename(path).startswith("test.rt-")
        info = exe_cache.load("test.rt", "g1")
        assert info is not None and info.artifacts
        assert _delta("exe_cache.hits", before) == 1
        assert _delta("exe_cache.bytes", before) == os.path.getsize(path)
        assert _delta("exe_cache.deserialize_ms", before) >= 0

    def test_absent_entry_counts_miss(self, cache_base):
        before = registry.snapshot()
        assert exe_cache.load("test.absent", "deadbeef") is None
        assert _delta("exe_cache.misses", before) == 1

    def test_no_tmp_leftovers(self, cache_base, payload):
        exe_cache.store(payload, "test.tmp", "g1")
        exe_cache.store(payload, "test.tmp", "g2", sync=True)
        assert exe_cache.flush(10)
        assert len(glob.glob(os.path.join(cache_base, "*.hvdexe"))) == 2
        assert not glob.glob(os.path.join(cache_base, ".tmp-*"))

    def test_disk_tier_off_compiles_and_counts_nothing(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_EXE_CACHE", raising=False)
        gm, inputs = _gm()
        before = registry.snapshot()
        fn, hit = exe_cache.get_or_compile(
            gm, inputs, inner=lambda g, i: g.forward)
        assert hit is False and torch.equal(fn(*inputs), gm(*inputs))
        assert not any(_delta(k, before) for k in
                       ("exe_cache.misses", "exe_cache.stores"))



@pytest.mark.parametrize("failure", ["raise", "none"])
def test_failed_save_counts_and_returns_the_compiled_graph(
        cache_base, monkeypatch, failure):
    """A save that raises or returns None never fails the compile: it
    counts ``exe_cache.serialize_errors`` once and the compiled graph
    computes the eager result (the reference's ``store`` contract)."""
    def broken():
        if failure == "raise":
            raise RuntimeError("injected save failure")
        return None

    monkeypatch.setattr(torch.compiler, "save_cache_artifacts", broken)
    torch._dynamo.reset()
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    before = registry.snapshot()
    fn = torch.compile(lambda x: torch.mm(x, x.t()) + 1.0,
                       backend=exe_cache.backend(inner="aot_eager"))
    assert torch.equal(fn(x), torch.mm(x, x.t()) + 1.0)
    assert _delta("exe_cache.serialize_errors", before) == 1
    assert _delta("exe_cache.stores", before) == 0
    torch._dynamo.reset()


# ------------------------------------------- corruption / invalidation


class TestDegradation:
    def _seed(self, payload, family="test.corrupt", fp="g1"):
        path = exe_cache.store(payload, family, fp, sync=True)
        assert path and os.path.exists(path)
        return path

    def test_flipped_payload_byte_is_counted_corrupt(self, cache_base,
                                                     payload):
        path = self._seed(payload)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
        before = registry.snapshot()
        assert exe_cache.load("test.corrupt", "g1") is None
        assert _delta("exe_cache.corrupt", before) == 1

    def test_truncated_and_bad_magic_are_corrupt(self, cache_base, payload):
        path = self._seed(payload)
        before = registry.snapshot()
        for blob in (b"HV", b"NOTMAGIC" + b"\0" * 64,
                     exe_cache.MAGIC + struct.pack(">I", 10 ** 6) + b"{"):
            with open(path, "wb") as f:
                f.write(blob)
            assert exe_cache.load("test.corrupt", "g1") is None
        assert _delta("exe_cache.corrupt", before) == 3

    def test_refused_payload_is_corrupt(self, cache_base):
        """A well-formed entry whose bytes Inductor cannot load."""
        self._seed(b"not inductor artifacts")
        before = registry.snapshot()
        assert exe_cache.load("test.corrupt", "g1") is None
        assert _delta("exe_cache.corrupt", before) == 1

    def test_chaos_bitflip_degrades_to_cold_compile(self, cache_base,
                                                    payload):
        """The ``exe_cache.load`` fault site: a bit-flipped read is a
        counted cold compile, never a failed one; the fault is one-shot
        and the entry on disk stays good."""
        gm, inputs = _gm()
        self._seed(payload, "test.chaos", exe_cache.graph_fingerprint(
            gm, inputs))
        calls = []

        def inner(g, i):
            calls.append(1)
            return g.forward

        chaos.configure("exe_cache.load@1:bitflip")
        before = registry.snapshot()
        fn, hit = exe_cache.get_or_compile(gm, inputs, family="test.chaos",
                                           inner=inner)
        assert hit is False and calls == [1]
        assert torch.equal(fn(*inputs), gm(*inputs))
        assert _delta("exe_cache.corrupt", before) == 1
        assert _delta("exe_cache.hits", before) == 0
        fn, hit = exe_cache.get_or_compile(gm, inputs, family="test.chaos",
                                           inner=inner)
        assert hit is True and calls == [1, 1]
        assert _delta("exe_cache.hits", before) == 1

    def test_chaos_delay_still_loads(self, cache_base, payload):
        self._seed(payload, "test.delay")
        chaos.configure("exe_cache.load@1:delay:ms=10")
        before = registry.snapshot()
        assert exe_cache.load("test.delay", "g1") is not None
        assert _delta("exe_cache.deserialize_ms", before) >= 0
        assert registry.snapshot().get("chaos.exe_cache.load.delay", 0) > 0

    @pytest.mark.parametrize("patch", [
        {"torch": "0.0.1"}, {"cuda": "0.0"}, {"capability": "1.0"},
        {"triton": "0.0.1"}, {"platform": "tpu"},
        {"format": exe_cache.FORMAT_VERSION + 1},
    ], ids=lambda p: next(iter(p)))
    def test_mismatched_entries_rejected_never_loaded(self, cache_base,
                                                      payload, monkeypatch,
                                                      patch):
        """An entry pinning other software (torch, CUDA, capability,
        Triton, platform, format) is rejected BEFORE its payload reaches
        Inductor; another world size or donation is another key, so the
        reader misses on an absent file."""
        path = self._seed(payload, "test.rej")

        def boom(*a, **kw):  # proves the payload is never loaded
            raise AssertionError("loaded a mismatched entry")

        monkeypatch.setattr(torch.compiler, "load_cache_artifacts", boom)
        _rewrite_header(path, **patch)
        before = registry.snapshot()
        assert exe_cache.load("test.rej", "g1") is None
        assert _delta("exe_cache.rejected", before) == 1
        assert exe_cache.load("test.rej", "g1",
                              fingerprint="w6-l6-cpu") is None
        assert exe_cache.load("test.rej", "g1", donation="d1") is None
        assert _delta("exe_cache.misses", before) == 2
        assert _delta("exe_cache.rejected", before) == 1


# ------------------------------------------------------ scan / preload


class TestScanPreload:
    def test_scan_filters_family_and_topology(self, cache_base, payload):
        exe_cache.store(payload, "fam.a", "g1", meta={"width": 8}, sync=True)
        exe_cache.store(payload, "fam.b", "g1", sync=True)
        headers = exe_cache.scan("fam.a")
        assert len(headers) == 1
        h = headers[0]
        assert h["family"] == "fam.a" and h["meta"] == {"width": 8}
        assert h["graph"] == "g1" and os.path.exists(h["path"])
        assert len(exe_cache.scan()) == 2
        assert exe_cache.scan("fam.a", fingerprint="w999-l1-cpu") == []

    def test_preload_loads_everything(self, cache_base, payload):
        exe_cache.store(payload, "fam.pre", "g1", sync=True)
        loaded, nbytes = exe_cache.preload("fam.pre")
        assert loaded == 1 and nbytes == len(payload)
        # corrupt entries are skipped, not raised (a standby's staging
        # must survive a torn cache)
        path = exe_cache.scan("fam.pre")[0]["path"]
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            f.write(b"\0")
        before = registry.snapshot()
        assert exe_cache.preload("fam.pre") == (0, 0)
        assert _delta("exe_cache.corrupt", before) == 1


# ----------------------------------------------------------- sidecars


class TestSidecars:
    def test_merge_on_persist(self, cache_base):
        exe_cache.persist_json("sc", {"a": 1})
        exe_cache.persist_json("sc", {"b": 2})
        assert exe_cache.load_json("sc") == {"a": 1, "b": 2}
        assert exe_cache.load_json("absent") == {}

    def test_corrupt_sidecar_reads_empty(self, cache_base):
        path = exe_cache.persist_json("sc2", {"a": 1})
        with open(path, "w") as f:
            f.write("{not json")
        before = registry.snapshot()
        assert exe_cache.load_json("sc2") == {}
        assert _delta("exe_cache.corrupt", before) == 1

    @pytest.mark.parametrize("shapes,n,floor", [
        ([(64, 8), (16,), (3, 5)], 2, 1),
        ([(128,), (32, 32), (7,), (7,), (1000,)], 3, 0),
        ([(10,)] * 9, 4, 200),
    ])
    def test_overlap_schedule_persists_replays_and_equals_jax(
            self, cache_base, shapes, n, floor):
        """The partition the port persists equals the JAX package's for
        the same leaves; a fresh in-memory cache (a restarted worker)
        replays the recorded one verbatim, even one the balancing rule
        would not make."""
        import jax.numpy as jnp
        from torch.utils import _pytree as pytree

        from horovod_tpu.ops import overlap as joverlap
        from horovod_tpu_torch.ops import overlap

        tree = {f"l{i}": torch.ones(s) for i, s in enumerate(shapes)}
        leaves, spec = pytree.tree_flatten(tree)
        overlap.reset_schedule_cache()
        s1 = overlap.schedule_for(leaves, spec, n, floor)
        want = joverlap.build_bucket_schedule(
            [jnp.ones(s) for s in shapes], n, floor)
        assert tuple(s1) == tuple(want)
        sidecar = exe_cache.load_json("overlap_schedule")
        assert len(sidecar) == 1
        overlap.reset_schedule_cache()
        assert overlap.schedule_for(leaves, spec, n, floor) == s1
        assert overlap.schedule_cache_stats()["disk_hits"] == 1
        # replayed verbatim: a recorded partition wins over a rebuild
        (key, rec), = sidecar.items()
        order = [i for b in rec["buckets"] for i in b]
        forced = dict(rec, buckets=[order], bucket_bytes=[rec["total_bytes"]])
        exe_cache.persist_json("overlap_schedule", {key: forced})
        overlap.reset_schedule_cache()
        got = overlap.schedule_for(leaves, spec, n, floor)
        assert got.buckets == (tuple(order),)
        overlap.reset_schedule_cache()


# ----------------------------------------------------- restart clock


class TestRestartStamp:
    def test_stamp_round_trip_equals_the_reference(self):
        from horovod_tpu.runner import rendezvous as jrdv
        from horovod_tpu_torch.runner import rendezvous as rdv

        stores = rdv.KVStore(), jrdv.KVStore()
        assert rdv.read_restart_stamp(stores[0]) is None
        rdv.put_restart_stamp(stores[0], epoch=3, reason="host a failed",
                              warm=True, kind="scaleup")
        jrdv.put_restart_stamp(stores[1], epoch=3, reason="host a failed",
                               warm=True, kind="scaleup")
        got = rdv.read_restart_stamp(stores[0])
        want = jrdv.read_restart_stamp(stores[1])
        assert got.pop("ts") > 0 and want.pop("ts") > 0
        assert got == want == {"epoch": 3, "reason": "host a failed",
                               "warm": True, "kind": "scaleup"}

    @pytest.mark.parametrize("warm,kind", [(True, "scaleup"),
                                           (False, "restart")])
    def test_worker_publishes_restart_ms(self, warm, kind):
        from horovod_tpu_torch.elastic.worker import WorkerNotificationManager
        from horovod_tpu_torch.runner.rendezvous import (KVStore,
                                                         put_restart_stamp)

        store = KVStore()
        put_restart_stamp(store, epoch=2, reason="quarantine", warm=warm,
                          kind=kind)
        mgr = WorkerNotificationManager.__new__(WorkerNotificationManager)
        registry.gauge("elastic.restart_ms", -1.0)
        registry.gauge("serve.scaleup_ms", -1.0)
        mgr._publish_restart_ms(store, "1")  # a stale epoch: nothing
        assert registry.snapshot()["elastic.restart_ms"] == -1.0
        mgr._publish_restart_ms(store, "2")
        snap = registry.snapshot()
        assert snap["elastic.restart_ms"] >= 0.0
        assert snap["elastic.restart_warm"] == (1.0 if warm else 0.0)
        assert (snap["serve.scaleup_ms"] == snap["elastic.restart_ms"]) \
            == (kind == "scaleup")


# ------------------------------------------- the Inductor round trip


class TestInductorRoundTrip:
    def test_second_process_loads_the_entry_bitwise(self, round_trip):
        cold, warm, cache = round_trip
        assert cold["cache"].get("exe_cache.misses") == 1
        assert cold["cache"].get("exe_cache.stores") == 1
        assert cold["inner"]["aot_autograd"].get("autograd_cache_saved") == 1
        assert warm["cache"].get("exe_cache.hits") == 1
        assert not warm["cache"].get("exe_cache.misses")
        assert not warm["cache"].get("exe_cache.corrupt")
        assert warm["cache"].get("exe_cache.bytes", 0) > 0
        # the entry carried the forward's and the backward's graphs: with
        # its own caches empty, the second process's inner caches hit
        assert warm["inner"]["aot_autograd"].get("autograd_cache_hit") == 1
        assert warm["inner"]["inductor"].get("fxgraph_cache_hit") == 2
        assert not warm["inner"]["inductor"].get("fxgraph_cache_miss")
        assert warm["bits"] == cold["bits"]
        want = np.frombuffer(bytes.fromhex(cold["bits"][0]), np.float32)
        assert np.isfinite(want).all() and want.size == 32
        assert len(glob.glob(str(cache / "inductor-w1-l1-cpu-*.hvdexe"))) == 1
