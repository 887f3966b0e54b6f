"""Cross-rank parameter audit: prove the replicas agree.

The counterpart of ``horovod_tpu/audit.py``. Data-parallel replicas
stay bit-identical after every allreduce; a replica that diverges (a
memory fault, a non-deterministic kernel, a checkpoint restored on one
host and not another) trains on quietly wrong. This module checks it:

* :func:`tree_digest`: a SHA-256 over a state dict (nested dicts, lists
  and tuples of tensors, arrays and scalars): each leaf's typed key path
  (:func:`flatten`, which ``checkpoint.py`` keys its files by too),
  dtype, shape and bytes, the keys in sorted order, after a copy to the
  host.
* :func:`audit`: digest the tree, count ``audit.digests`` and set
  ``audit.last_digest_step``, and under the launcher publish ``{step,
  digest}`` to the rendezvous KV (``runner/rendezvous.py`` ``put_audit``),
  where the elastic driver compares the gang's digests, and beside it
  the rank's collective-schedule fingerprint
  (``analysis/sched_audit.py``, ``put_sched``).
* :func:`maybe_audit`: the same every ``HOROVOD_AUDIT_STEPS`` steps
  (0: never), so a loop can call it every step.
* :func:`find_divergent`: the driver's comparison, a copy of the JAX
  package's: at the newest step that two ranks report, the majority
  digest wins (a tie goes to the lowest rank, as ``sync()`` broadcasts
  from the root) and the other ranks are divergent.

The digest is not comparable with the JAX package's, which hashes a
pytree's treedef; the verdicts of :func:`find_divergent` are.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

from .common.logging import get_logger

# torch and numpy are imported where they are used: the package binds
# audit() at its own import, which imports no torch
_log = get_logger("audit")

_lock = threading.Lock()
_kv_client = None  # cached RendezvousClient (None until first publish)
_kv_unavailable = False


# an empty container is a leaf of its own (DCP drops an empty dict), as
# one of these strings
EMPTY = {"\x00hvd.empty.dict": dict, "\x00hvd.empty.list": list,
          "\x00hvd.empty.tuple": tuple}
EMPTY_OF = {v: k for k, v in EMPTY.items()}


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(typed path, leaf)`` pairs of a state dict, dict keys in sorted
    order: ``/name`` a str key, ``/#3`` an int key, ``/[0]`` a list
    index, ``/(0)`` a tuple's. An empty container is a leaf of its own,
    so that :func:`unflatten` gives it back."""
    if isinstance(tree, (dict, list, tuple)) and not tree:
        return [(prefix or "/", EMPTY_OF[type(tree) if type(tree) in
                                          EMPTY_OF else dict])]
    if isinstance(tree, dict) and tree:
        out = []
        for k in sorted(tree, key=lambda k: (isinstance(k, int), str(k))):
            if isinstance(k, bool) or not isinstance(k, (str, int)):
                raise TypeError(f"checkpoint keys are str or int, got {k!r}")
            seg = f"#{k}" if isinstance(k, int) else str(k)
            out += flatten(tree[k], f"{prefix}/{seg}")
        return out
    if isinstance(tree, (list, tuple)) and tree:
        o, c = ("[", "]") if isinstance(tree, list) else ("(", ")")
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}/{o}{i}{c}")
        return out
    return [(prefix or "/", tree)]


def _segments(path: str) -> List[str]:
    return [] if path == "/" else path[1:].split("/")


def unflatten(pairs) -> Any:
    """The tree :func:`flatten` was taken of."""
    pairs = [(p, EMPTY[v]() if isinstance(v, str) and v in EMPTY else v)
             for p, v in pairs]
    if len(pairs) == 1 and pairs[0][0] == "/":
        return pairs[0][1]
    root: dict = {}
    for path, leaf in pairs:
        node, segs = root, _segments(path)
        for seg in segs[:-1]:
            node = node.setdefault(seg, {})
        node[segs[-1]] = leaf

    def build(node):
        if not isinstance(node, dict) or not node or type(node) is not dict:
            return node
        keys = list(node)
        if not all(isinstance(k, str) for k in keys):
            return node
        if all(k[:1] == "[" for k in keys):
            return [build(node[k]) for k in sorted(keys, key=lambda k:
                                                   int(k[1:-1]))]
        if all(k[:1] == "(" for k in keys):
            return tuple(build(node[k]) for k in sorted(
                keys, key=lambda k: int(k[1:-1])))
        return {(int(k[1:]) if k[:1] == "#" else k): build(v)
                for k, v in node.items()}

    return build(root)


def to_host(leaf: Any) -> Any:
    """A leaf as the digest reads it: a tensor detached, contiguous and
    on the host (a copy, so a later in-place step cannot change it), an
    array as it is, any other leaf unchanged."""
    import torch

    if torch.is_tensor(leaf):
        return leaf.detach().contiguous().cpu().clone()
    return leaf


def _leaf_meta(leaf: Any) -> Tuple[str, Tuple[int, ...]]:
    import numpy as np
    import torch

    if torch.is_tensor(leaf):
        return str(leaf.dtype), tuple(leaf.shape)
    if isinstance(leaf, np.ndarray):
        return str(leaf.dtype), tuple(leaf.shape)
    return type(leaf).__name__, ()


def _leaf_bytes(leaf: Any) -> bytes:
    import numpy as np
    import torch

    if torch.is_tensor(leaf):
        return leaf.reshape(-1).view(torch.uint8).numpy().tobytes()
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf).tobytes()
    return repr(leaf).encode()


def digest_host_leaves(pairs: List[Tuple[str, Any]]) -> str:
    """The hashing core of :func:`tree_digest` over ``(path, host
    leaf)`` pairs; the checkpoint manager copies to the host at once and
    hashes on a background thread."""
    h = hashlib.sha256()
    for path, leaf in pairs:
        dt, shape = _leaf_meta(leaf)
        h.update(path.encode())
        h.update(dt.encode())
        h.update(str(shape).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


def tree_digest(tree: Any) -> str:
    """SHA-256 of a state dict: each leaf's key path, dtype, shape and
    bytes, in sorted key order. A tree and its restored twin digest the
    same exactly when they are bit-identical."""
    return digest_host_leaves([(p, to_host(v)) for p, v in flatten(tree)])


def tree_meta_digest(tree: Any) -> str:
    """SHA-256 of the key paths, dtypes and shapes alone, with no copy
    to the host: two trees :func:`tree_digest` can compare share it."""
    h = hashlib.sha256()
    for path, leaf in flatten(tree):
        dt, shape = _leaf_meta(leaf)
        h.update(path.encode())
        h.update(dt.encode())
        h.update(str(shape).encode())
    return h.hexdigest()


def _cached_kv_client():
    """The process's rendezvous client for the audit; None without a
    launcher's KV (a world of one, the tests)."""
    global _kv_client, _kv_unavailable
    from .common.config import TrainConfig
    from .runner.rendezvous import _client_from_cfg

    with _lock:
        if _kv_unavailable:
            return None
        if _kv_client is None:
            cfg = TrainConfig.from_env()
            if not (cfg.rendezvous_addr and cfg.rendezvous_port):
                _kv_unavailable = True
                return None
            _kv_client = _client_from_cfg(cfg)
        return _kv_client


def _publish(rank: int, step: int, digest: str) -> bool:
    """Best-effort KV publication; False when there is no KV."""
    from .runner.rendezvous import put_audit

    client = _cached_kv_client()
    if client is None:
        return False
    try:
        put_audit(client, rank, step, digest)
        return True
    except Exception:  # noqa: BLE001 - the audit never stops training
        _log.debug("audit publish failed", exc_info=True)
        return False


def _reset_client() -> None:
    """Drop the cached client, so the next publish re-reads the (new
    gang's) rendezvous variables (the elastic worker's re-init)."""
    global _kv_client, _kv_unavailable
    with _lock:
        _kv_client = None
        _kv_unavailable = False


def audit(tree: Any, step: int = 0, rank: Optional[int] = None) -> str:
    """``hvd.audit(model.state_dict(), step=...)``: digest ``tree``,
    record the ``audit.*`` metrics and publish to the gang's KV when
    there is one. Returns the hex digest."""
    from .common import basics
    from .common.metrics import registry as _metrics

    digest = tree_digest(tree)
    step = int(step)
    if rank is None:
        rank = basics.rank() if basics.is_initialized() else 0
    _metrics.counter("audit.digests")
    _metrics.gauge("audit.last_digest_step", step)
    _publish(int(rank), step, digest)
    # the collective-schedule fingerprint rides the same cadence and KV
    # (analysis/sched_audit.py): the two halves of one audit plane
    from .analysis import sched_audit

    sched_audit.publish(step, rank=rank)
    _log.debug("audit step %d: %s", step, digest[:16])
    return digest


def default_audit_steps() -> int:
    from .common import basics

    return int(basics.live_config().audit_steps)


def maybe_audit(tree: Any, step: int, every: Optional[int] = None,
                rank: Optional[int] = None) -> Optional[str]:
    """:func:`audit` when ``step`` lands on the ``HOROVOD_AUDIT_STEPS``
    cadence (``every`` overrides; 0: never); call it every step."""
    every = default_audit_steps() if every is None else int(every)
    if every <= 0 or int(step) % every != 0:
        return None
    return audit(tree, step=step, rank=rank)


def find_divergent(
    digests: Dict[int, dict],
) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """The driver's comparison over ``{rank: {"step", "digest"}}`` (what
    ``read_audit_digests`` returns), a copy of the JAX package's: at the
    newest step at least two ranks report, if the digests disagree,
    ``(step, divergent_ranks)``, the majority winning and a tie going to
    the lowest rank's digest; None with no quorum or full agreement."""
    by_step: Dict[int, Dict[int, str]] = {}
    for rank, payload in digests.items():
        try:
            step = int(payload["step"])
            digest = str(payload["digest"])
        except (KeyError, TypeError, ValueError):
            continue
        by_step.setdefault(step, {})[int(rank)] = digest
    for step in sorted(by_step, reverse=True):
        ranks = by_step[step]
        if len(ranks) < 2:
            continue
        counts: Dict[str, list] = {}
        for r, d in sorted(ranks.items()):
            counts.setdefault(d, []).append(r)
        if len(counts) == 1:
            return None  # the newest quorum step agrees
        majority = max(
            counts.items(), key=lambda kv: (len(kv[1]), -min(kv[1]))
        )[0]
        divergent = tuple(
            sorted(r for d, rs in counts.items() if d != majority for r in rs)
        )
        return step, divergent
    return None
