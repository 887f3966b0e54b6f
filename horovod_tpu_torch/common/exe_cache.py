"""Persistent compiled-artifact store (``HOROVOD_EXE_CACHE``).

The counterpart of ``horovod_tpu/common/exe_cache.py``. A gang restart,
a serve scale-up or a standby's swap-in pays every compile again; this
module gives what a torch process compiles a disk tier with the
reference's contract: best effort, tmp+rename writes, and a torn,
truncated, bit-flipped or foreign entry read as a counted cold start,
never an error.

**What the port persists, and what it cannot.** The JAX package
serializes whole XLA executables. A torch process has two kinds of
compiled program, and only one of them survives the process:

* **CUDA graphs cannot be persisted.** A captured graph holds the
  capturing process's device addresses. So the serving engine's decode
  graph is captured again in each process when the engine is built
  (``InferenceEngine._capture_ms``, in its ``stats()`` as
  ``capture_ms``), and so is each of its prefill graphs, at bucket and
  exact widths, when a tier first needs it
  (``InferenceEngine.prefill_graphs()``). The JAX engine's disk tier
  under them (``_warm_start``, ``_disk_prefill_exact``) has no
  counterpart here, and its ``prefill_disk_hits``/``decode_disk_hits``
  stay 0.
  The fused eager dispatch compiles nothing; the JAX fusion's disk tier
  waits for the port's executor tiers (ROADMAP A3), which are CUDA
  graphs, and the same argument holds for them.
* **Inductor's output can be.** An entry's payload is the bytes of
  Inductor's portable cache artifacts for ONE compiled graph
  (``torch.compiler.save_cache_artifacts()`` taken right after that
  graph's compile, inside a fresh artifact recording, so an entry never
  carries another graph's artifacts): the FX graph cache's entry (the
  generated code, with the Triton kernels bundled where the card
  compiles them), AOTAutograd's entry for the forward and backward
  (the backward is lowered inside the compile, not at the first
  backward, so that its artifacts belong to the entry) and the
  autotuner's choices. A hit hands the payload to
  ``torch.compiler.load_cache_artifacts()``, which writes it into this
  process's Inductor caches, and then calls the inner compiler, whose
  own caches then hit. Loading the payload is this module's
  "deserialize" (``exe_cache.deserialize_ms``).

:func:`backend` is the entry point, the counterpart of
:func:`get_or_compile`: ``torch.compile(fn, backend=exe_cache.backend())``.
Dynamo hands it each captured FX ``GraphModule`` and its example
inputs; the graph's fingerprint (:func:`graph_fingerprint`, the
counterpart of ``hlo_fingerprint``, the semantic key) is the sha256 of
``gm.code`` (with its nested graphs' code) and each input's shape,
stride, dtype and device. A hit
loads the entry and compiles through the inner compiler (``inductor``
by default); a miss compiles and stores.

Entry key anatomy, as in the reference:

* **topology fingerprint** ``w<world>-l<intra>-<platform>``, the
  platform ``cuda`` or ``cpu`` (shared with
  :func:`..common.autotune.topology_fingerprint`);
* **graph fingerprint** (above);
* **wire format**, ``none`` for graphs that carry no fused wire;
* **donation signature**, ``d<argnums>``; torch donates no buffers, so
  every port entry has ``none``, kept for the key's layout.

On top of the key, the header pins the torch version, the CUDA runtime
(``none`` on a CPU build), the card's compute capability (``none``
without a card), Triton's version where it is installed and the
platform: an entry is only ever loaded into the exact software that
wrote it. A header that fails these rules counts
``exe_cache.rejected`` and its payload is never loaded; a torn or
bit-flipped entry (chaos site ``exe_cache.load``), or a payload
Inductor refuses, counts ``exe_cache.corrupt``. Either compiles cold.
A kernel of the package that fails to build or launch still raises:
only the cache's own tier degrades.

File format, one entry per file::

    HVDEXE1\\n | u32 header_len | header JSON | Inductor artifact bytes

Writes ride a background writer thread, flushed by the preemption
drain hooks and at exit. Telemetry:
``exe_cache.{hits,misses,corrupt,rejected,stores,bytes,deserialize_ms,
serialize_errors}``
in the metrics registry (``common/metrics.py``).

The schedule sidecars (:func:`persist_json`/:func:`load_json`) keep the
bucketed overlap's partition beside the entries (``ops/overlap.py``).
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import json
import os
import queue
import struct
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .logging import get_logger
from .metrics import registry as _metrics

# torch is imported where it is used: the standby warmer's driver side
# and the tests read keys without it
_log = get_logger("exe_cache")

FORMAT_VERSION = 1
MAGIC = b"HVDEXE1\n"
_SUFFIX = ".hvdexe"

# --------------------------------------------------------------------- keys


def cache_dir(base: Optional[str] = None) -> Optional[str]:
    """The resolved cache directory, or None when the disk tier is off
    (no ``HOROVOD_EXE_CACHE`` and no explicit base)."""
    if base:
        return base
    return os.environ.get("HOROVOD_EXE_CACHE") or None


def topology_fingerprint(topology=None, device=None) -> str:
    """``w<world>-l<intra>-<platform>``: the tuner cache's namespace."""
    from .autotune import topology_fingerprint as _fp

    return _fp(topology, device)


def graph_fingerprint(gm, example_inputs) -> str:
    """sha256 of an FX graph's code (and its nested graphs', such as a
    custom autograd Function's forward and backward bodies) and its
    inputs' shapes, strides, dtypes and devices: what Dynamo hands a
    backend for one graph."""
    h = hashlib.sha256()
    for name, mod in sorted(gm.named_modules(), key=lambda kv: kv[0]):
        code = getattr(mod, "code", None)
        if isinstance(code, str):
            h.update(f"{name}\n{code}".encode())
    for x in example_inputs:
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            meta = (tuple(x.shape), tuple(x.stride()), str(x.dtype),
                    str(x.device))
        else:  # a SymInt or a plain constant
            meta = (type(x).__name__, str(x))
        h.update(repr(meta).encode())
    return h.hexdigest()


def donation_signature(donate_argnums) -> str:
    """``d<i>.<j>`` for donated argument indices; ``none`` without."""
    nums = tuple(int(i) for i in (donate_argnums or ()))
    return "d" + ".".join(str(i) for i in nums) if nums else "none"


def _entry_hash(graph_fp: str, wire: str, donation: str) -> str:
    return hashlib.sha256(
        f"{graph_fp}|{wire}|{donation}".encode()).hexdigest()[:24]


def entry_path(
    family: str,
    graph_fp: str,
    wire: str = "none",
    donation: str = "none",
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
) -> Optional[str]:
    """The entry file for one key, or None when the disk tier is off."""
    root = cache_dir(base)
    if not root:
        return None
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    name = (f"{family.replace('/', '_')}-{fingerprint}"
            f"-{_entry_hash(graph_fp, wire, donation)}{_SUFFIX}")
    return os.path.join(root, name)


def _software() -> Dict[str, str]:
    """The fields an entry pins: it loads only into this software."""
    import torch

    cuda = torch.cuda.is_available()
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "none"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "capability": ("%d.%d" % torch.cuda.get_device_capability()
                       if cuda else "none"),
        "triton": triton_version,
        "platform": "cuda" if cuda else "cpu",
    }


# ----------------------------------------------------------- write side


class _Writer:
    """Background entry writer: the payload is made on the caller; this
    thread owns only the tmp+rename file I/O. ``flush`` drains it (a
    preemption drain hook and at exit)."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="exe-cache-writer")
                self._thread.start()

    def _run(self) -> None:
        while True:
            path, blob = self._q.get()
            try:
                _write_atomic(path, blob)
            except OSError as e:  # best effort by contract
                _metrics.counter("exe_cache.store_errors")
                _log.warning("exe cache write failed for %s: %s", path, e)
            finally:
                self._q.task_done()

    def submit(self, path: str, blob: bytes) -> None:
        self._ensure_thread()
        self._q.put((path, blob))

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Drain queued writes; True when the queue emptied in time."""
        if self._thread is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True


_writer = _Writer()
_drain_registered = False
_drain_lock = threading.Lock()


def flush(timeout: Optional[float] = None) -> bool:
    """Drain pending entry writes (drain hooks, tests)."""
    return _writer.flush(timeout)


def _register_drain() -> None:
    """Once a process: writes survive a SIGTERM drain and a normal exit."""
    global _drain_registered
    with _drain_lock:
        if _drain_registered:
            return
        _drain_registered = True
    atexit.register(flush, 5.0)
    from .. import preemption

    preemption.register_drain(lambda: flush(5.0))


def _write_atomic(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-",
                               suffix=_SUFFIX)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def store(
    payload: bytes,
    family: str,
    graph_fp: str,
    wire: str = "none",
    donation: str = "none",
    meta: Optional[Dict[str, Any]] = None,
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
    sync: bool = False,
) -> Optional[str]:
    """Persist one compiled graph's artifact bytes under its key.
    Returns the entry path, or None when the disk tier is off or the
    write failed; never raises."""
    path = entry_path(family, graph_fp, wire, donation, fingerprint, base)
    if path is None:
        return None
    header = dict(_software())
    header.update(
        format=FORMAT_VERSION,
        family=family,
        topology=fingerprint or topology_fingerprint(),
        graph=graph_fp,
        wire=wire,
        donation=donation,
        meta=dict(meta or {}),
        payload_sha256=hashlib.sha256(payload).hexdigest(),
        payload_bytes=len(payload),
    )
    hdr = json.dumps(header, sort_keys=True).encode()
    blob = MAGIC + struct.pack(">I", len(hdr)) + hdr + payload
    _metrics.counter("exe_cache.stores")
    _register_drain()
    if not sync:
        _writer.submit(path, blob)
        return path
    try:
        _write_atomic(path, blob)
    except OSError as e:
        _metrics.counter("exe_cache.store_errors")
        _log.warning("exe cache write failed for %s: %s", path, e)
        return None
    return path


# ------------------------------------------------------------ read side


def _read_header(blob: bytes) -> Tuple[Dict[str, Any], bytes]:
    if not blob.startswith(MAGIC):
        raise ValueError("bad magic")
    off = len(MAGIC)
    (hlen,) = struct.unpack(">I", blob[off:off + 4])
    off += 4
    header = json.loads(blob[off:off + hlen].decode())
    if not isinstance(header, dict):
        raise ValueError("header is not an object")
    return header, blob[off + hlen:]


def _header_mismatch(header: Dict[str, Any], graph_fp: str, wire: str,
                     donation: str, fingerprint: str) -> Optional[str]:
    """The invalidation rules: every pinned field must match the reader
    exactly. Returns the first offending field, or None."""
    want = dict(_software())
    want.update(format=FORMAT_VERSION, topology=fingerprint, graph=graph_fp,
                wire=wire, donation=donation)
    for field, expect in want.items():
        if header.get(field) != expect:
            return field
    return None


def _hot_load(payload: bytes) -> Any:
    """Write an entry's artifacts into this process's Inductor caches."""
    import torch

    info = torch.compiler.load_cache_artifacts(payload)
    if info is None:
        raise ValueError("no artifacts in the payload")
    return info


def load(
    family: str,
    graph_fp: str,
    wire: str = "none",
    donation: str = "none",
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
):
    """Load one entry by key into this process's Inductor caches; returns
    what Inductor loaded, or None on any miss. A miss is always safe: an
    absent file (``exe_cache.misses``), a torn or bit-flipped entry or a
    payload Inductor refuses (``exe_cache.corrupt``), or a header that
    fails the invalidation rules (``exe_cache.rejected``: the payload is
    never loaded). A hit counts its bytes and the load's wall-ms."""
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    path = entry_path(family, graph_fp, wire, donation, fingerprint, base)
    if path is None:
        return None
    from ..testing import chaos as _chaos

    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        _metrics.counter("exe_cache.misses")
        return None
    # the chaos site: ``bitflip`` corrupts the bytes just read (the site
    # owns the corruption), ``delay`` stalls inside inject()
    if _chaos.inject("exe_cache.load") == "bitflip" and blob:
        blob = blob[:-1] + bytes([blob[-1] ^ 0x40])
    t0 = time.monotonic()
    try:
        header, body = _read_header(blob)
    except (ValueError, struct.error, UnicodeDecodeError):
        _metrics.counter("exe_cache.corrupt")
        _log.warning("exe cache entry %s is corrupt (header)", path)
        return None
    bad = _header_mismatch(header, graph_fp, wire, donation, fingerprint)
    if bad is not None:
        _metrics.counter("exe_cache.rejected")
        _log.warning("exe cache entry %s rejected: %s mismatch (%r != "
                     "reader)", path, bad, header.get(bad))
        return None
    if (hashlib.sha256(body).hexdigest() != header.get("payload_sha256")
            or len(body) != header.get("payload_bytes")):
        _metrics.counter("exe_cache.corrupt")
        _log.warning("exe cache entry %s is corrupt (payload)", path)
        return None
    try:
        info = _hot_load(body)
    except Exception as e:  # noqa: BLE001 - a refused payload is a miss
        _metrics.counter("exe_cache.corrupt")
        _log.warning("exe cache entry %s failed to load: %s", path, e)
        return None
    _metrics.counter("exe_cache.hits")
    _metrics.counter("exe_cache.bytes", len(blob))
    _metrics.counter("exe_cache.deserialize_ms",
                     max((time.monotonic() - t0) * 1e3, 0.0))
    return info


def _inner_compiler(inner) -> Callable:
    if callable(inner):
        return inner
    import torch._dynamo

    return torch._dynamo.lookup_backend(inner)


@contextlib.contextmanager
def _lowering():
    """The backward lowered inside the compile (AOTAutograd otherwise
    lowers it at the first backward, after the entry was taken). The
    setting is part of AOTAutograd's own cache key, so a hit compiles
    under it too."""
    import torch._functorch.config as functorch_config

    with functorch_config.patch(force_non_lazy_backward_lowering=True):
        yield


@contextlib.contextmanager
def _recording():
    """A fresh artifact recording around one graph's compile; yields
    the function that returns what it recorded."""
    import torch
    from torch.compiler._cache import CacheArtifactManager

    with CacheArtifactManager.with_fresh_cache():
        yield torch.compiler.save_cache_artifacts


def get_or_compile(
    gm,
    example_inputs,
    family: str = "inductor",
    inner="inductor",
    wire: str = "none",
    donation: str = "none",
    meta: Optional[Dict[str, Any]] = None,
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
):
    """The one-call disk tier for one FX graph: load its entry into the
    inner compiler's caches and compile, or compile and persist.
    Returns ``(compiled, hit)``. With the disk tier off it compiles and
    counts nothing."""
    compile_fn = _inner_compiler(inner)
    if cache_dir(base) is None:
        return compile_fn(gm, example_inputs), False
    fp = graph_fingerprint(gm, example_inputs)
    if load(family, fp, wire, donation, fingerprint, base) is not None:
        with _lowering():
            return compile_fn(gm, example_inputs), True
    with _lowering(), _recording() as save:
        compiled = compile_fn(gm, example_inputs)
        try:
            artifacts = save()
            if artifacts is None:
                raise ValueError("save_cache_artifacts returned None")
            store(artifacts[0], family, fp, wire, donation, meta,
                  fingerprint, base)
        except Exception as e:  # noqa: BLE001 - persistence never fails a compile
            _metrics.counter("exe_cache.serialize_errors")
            _log.warning("exe cache serialize failed (%s): %s", family, e)
    return compiled, False


def backend(inner="inductor", family: str = "inductor",
            base: Optional[str] = None, fingerprint: Optional[str] = None):
    """A ``torch.compile`` backend that compiles each graph through
    :func:`get_or_compile` over ``inner`` (a backend name or a compiler
    callable): ``torch.compile(fn, backend=exe_cache.backend())``."""

    def compile_fn(gm, example_inputs):
        return get_or_compile(gm, example_inputs, family=family, inner=inner,
                              fingerprint=fingerprint, base=base)[0]

    compile_fn.__name__ = f"hvd_exe_cache_{getattr(inner, '__name__', inner)}"
    return compile_fn


def scan(
    family: Optional[str] = None,
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Headers (never payloads) of every readable entry for this
    topology, each with its ``path``. Unreadable files are skipped."""
    root = cache_dir(base)
    if not root or not os.path.isdir(root):
        return []
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    out = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(_SUFFIX) or name.startswith(".tmp-"):
            continue
        if fingerprint not in name:
            continue
        if family is not None and not name.startswith(
                family.replace("/", "_") + "-"):
            continue
        path = os.path.join(root, name)
        try:
            with open(path, "rb") as f:
                head = f.read(len(MAGIC) + 4)
                if not head.startswith(MAGIC):
                    continue
                (hlen,) = struct.unpack(">I", head[len(MAGIC):])
                header = json.loads(f.read(hlen).decode())
        except (OSError, ValueError, struct.error, UnicodeDecodeError):
            continue
        if not isinstance(header, dict) or \
                header.get("topology") != fingerprint:
            continue
        if family is not None and header.get("family") != family:
            continue
        header["path"] = path
        out.append(header)
    return out


def preload(
    family: Optional[str] = None,
    fingerprint: Optional[str] = None,
    base: Optional[str] = None,
    limit: Optional[int] = None,
) -> Tuple[int, int]:
    """Load every readable entry for this topology into this process's
    Inductor caches: the warm standby's staging, which pays the reads
    and the loads before the host is swapped into a gang. Returns
    ``(loaded, bytes)``; corrupt or mismatched entries count through
    :func:`load`'s counters and are skipped."""
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    loaded = total = 0
    for header in scan(family, fingerprint, base):
        if limit is not None and loaded >= limit:
            break
        if load(header.get("family", ""), header.get("graph", ""),
                header.get("wire", "none"), header.get("donation", "none"),
                fingerprint, base) is not None:
            loaded += 1
            total += int(header.get("payload_bytes", 0))
    return loaded, total


# ------------------------------------------- schedule-decision sidecars
#
# The bucketed overlap persists its partition decisions beside the
# entries: a restarted worker replays the recorded partition verbatim,
# so a change of the balancing rule does not move a persisted schedule.


def sidecar_path(name: str, fingerprint: Optional[str] = None,
                 base: Optional[str] = None) -> Optional[str]:
    root = cache_dir(base)
    if not root:
        return None
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    return os.path.join(root, f"{name}-{fingerprint}.json")


def load_json(name: str, fingerprint: Optional[str] = None,
              base: Optional[str] = None) -> Dict[str, Any]:
    """Best-effort sidecar read: {} when off, absent or corrupt."""
    path = sidecar_path(name, fingerprint, base)
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        _metrics.counter("exe_cache.corrupt")
        return {}
    return obj if isinstance(obj, dict) else {}


def persist_json(name: str, entries: Dict[str, Any],
                 fingerprint: Optional[str] = None,
                 base: Optional[str] = None) -> Optional[str]:
    """Merge-and-write a sidecar (this writer's keys win, the disk's
    other keys survive), tmp+rename."""
    path = sidecar_path(name, fingerprint, base)
    if not path:
        return None
    merged = dict(load_json(name, fingerprint, base))
    merged.update(entries)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-",
                                   suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        _metrics.counter("exe_cache.store_errors")
        _log.warning("exe cache sidecar write failed for %s: %s", path, e)
        return None
    return path
