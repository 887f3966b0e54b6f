"""Warm-standby host warmer (``HOROVOD_WARM_STANDBY``).

The counterpart of ``horovod_tpu/elastic/standby.py``. A standby host is
capacity the elastic driver holds out of the gang, so that a failure, a
quarantine or a saturated serve role swaps it in without a cold start.
The warmer is a small process the driver launches on each reserved
local host; its lifecycle is a series of announcements in the rendezvous
KV's ``standby`` scope (``runner/rendezvous.py`` ``put_standby``):

``announce``
    Registered: the host is reachable and the warmer alive.
``staging``
    Paying a torch process's cold-start costs ahead of time, the ones a
    rank of the port pays at its start: importing torch and
    ``torch._dynamo`` (which the first ``torch.optim`` constructor
    imports), opening the CUDA context on the local rank's card, loading
    every kernel library through ``ops/_build.py`` (each built at first
    use into the checkout's ``_build/``, where the swapped-in worker
    finds it), loading every compiled-artifact entry for the gang's
    topology into this host's Inductor caches (``exe_cache.preload``),
    and, with a checkpoint directory, restoring the latest good
    checkpoint (``CheckpointManager.restore_latest_good``).
``armed``
    Ready. The announcement carries what was staged and what each part
    took (``exes``, ``exe_bytes``, ``ckpt_step``, ``kernels``,
    ``import_s``, ``context_s``, ``kernels_s``, ``exe_s``, ``ckpt_s``,
    ``stage_s``), and the warmer refreshes it every ``KEEPALIVE_S``.

The driver releases a standby by writing ``release.<host>`` in the same
scope (or by SIGTERM); the warmer announces ``released`` and exits 0, and
the host is plain capacity again for the next gang. The loading of the
entries and the checkpoint are best effort: staging speeds the swap-in
and never gates it. A kernel library that fails to build raises.

Runs as ``python -m horovod_tpu_torch.elastic.standby`` with a worker's
rendezvous variables (``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``,
``HOROVOD_SECRET_KEY``), ``HOROVOD_STANDBY_HOSTNAME``, the gang's
``HOROVOD_SIZE``/``HOROVOD_LOCAL_SIZE`` (the topology the preload
targets), ``HOROVOD_EXE_CACHE`` and ``HOROVOD_CHECKPOINT_DIR``. The
module imports no torch until it stages.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

from ..common.logging import get_logger

_log = get_logger("standby")

# the armed announcement's refresh period (the driver ages out a warmer
# whose ts stops advancing, as for heartbeats)
KEEPALIVE_S = 5.0


def _load_kernel_libraries() -> int:
    """Build (where not built) and load every kernel library of the
    package; returns how many."""
    from ..ops import _build, cuda_kernels, flash_attention, paged_attention

    mods = (cuda_kernels, flash_attention, paged_attention)
    _build.build(m.LIBRARY for m in mods)  # one nvcc a source, together
    for m in mods:
        _build.load(m.LIBRARY, m._declare)
    return len(mods)


class StandbyWarmer:
    """One standby host's announce, stage, armed lifecycle. ``device``
    is the card staging opens (None: the local rank's); pass ``"cpu"``
    to stage without one (no context, no kernel libraries)."""

    def __init__(self, client, hostname: str,
                 exe_cache_base: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 fingerprint: Optional[str] = None,
                 device=None) -> None:
        self._client = client
        self.hostname = str(hostname)
        self._exe_base = exe_cache_base
        self._ckpt_dir = checkpoint_dir
        self._fingerprint = fingerprint
        self._device = device
        self._stop = threading.Event()
        self.staged: dict = {}

    def _announce(self, state: str, detail: Optional[dict] = None) -> None:
        from ..runner.rendezvous import put_standby

        try:
            put_standby(self._client, self.hostname, state, detail)
        except Exception:  # noqa: BLE001 - the driver may be tearing down
            _log.debug("standby announce %s failed", state, exc_info=True)

    def stage(self) -> dict:
        """Pay the cold-start costs (module docstring); returns what was
        staged and the seconds each part took."""
        self._announce("staging")
        detail: dict = {"exes": 0, "exe_bytes": 0, "ckpt_step": None,
                        "kernels": 0}
        t_start = t0 = time.monotonic()
        import torch
        import torch._dynamo  # noqa: F401 - the first optimizer's import

        detail["import_s"] = time.monotonic() - t0
        from ..common.config import resolve_device

        t0 = time.monotonic()
        dev = resolve_device(self._device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.empty(1, device=dev)  # the context
        detail["device"] = str(dev)
        detail["context_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        if dev.type == "cuda":
            detail["kernels"] = _load_kernel_libraries()
        detail["kernels_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        if self._exe_base:
            try:
                from ..common import exe_cache

                detail["exes"], detail["exe_bytes"] = exe_cache.preload(
                    fingerprint=self._fingerprint, base=self._exe_base)
            except Exception:  # noqa: BLE001 - best effort by contract
                _log.warning("standby exe preload failed", exc_info=True)
        detail["exe_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        if self._ckpt_dir and os.path.isdir(self._ckpt_dir):
            try:
                from ..checkpoint import CheckpointManager

                # a reader, never rank 0 (which clears the partial saves
                # of other tokens) and with a token (no collective)
                mgr = CheckpointManager(self._ckpt_dir, rank=1, world=2,
                                        token="standby")
                step, _, _ = mgr.restore_latest_good(own=False)
                detail["ckpt_step"] = int(step)
            except FileNotFoundError:
                pass  # no checkpoint yet
            except Exception:  # noqa: BLE001 - best effort by contract
                _log.warning("standby checkpoint stage failed",
                             exc_info=True)
        detail["ckpt_s"] = time.monotonic() - t0
        detail["stage_s"] = time.monotonic() - t_start
        self.staged = detail
        return detail

    def _released(self) -> bool:
        """Has the driver released this standby? (A lost driver counts.)"""
        from ..runner.rendezvous import STANDBY_SCOPE

        try:
            raw = self._client.get(STANDBY_SCOPE, f"release.{self.hostname}")
        except OSError:
            return True  # the driver is gone: stop holding the host
        return raw is not None

    def run(self) -> int:
        """announce, stage, armed, keepalive until released."""
        self._announce("announce")
        detail = self.stage()
        self._announce("armed", detail)
        _log.info("standby %s armed in %.2f s: %d entries (%d bytes), "
                  "%d kernel libraries, checkpoint step %s", self.hostname,
                  detail["stage_s"], detail["exes"], detail["exe_bytes"],
                  detail["kernels"], detail["ckpt_step"])
        while not self._stop.is_set():
            if self._released():
                break
            self._announce("armed", detail)
            self._stop.wait(KEEPALIVE_S)
        self._announce("released", detail)
        _log.info("standby %s released", self.hostname)
        return 0

    def stop(self) -> None:
        self._stop.set()


def main() -> int:
    """``python -m horovod_tpu_torch.elastic.standby``."""
    from ..common.config import TrainConfig
    from ..runner.rendezvous import _client_from_cfg

    cfg = TrainConfig.from_env()
    if not (cfg.rendezvous_addr and cfg.rendezvous_port):
        _log.error("the standby warmer needs the rendezvous variables")
        return 2
    warmer = StandbyWarmer(
        _client_from_cfg(cfg),
        os.environ.get("HOROVOD_STANDBY_HOSTNAME", os.uname().nodename),
        exe_cache_base=cfg.exe_cache,
        checkpoint_dir=os.environ.get("HOROVOD_CHECKPOINT_DIR") or None,
        fingerprint=os.environ.get("HOROVOD_STANDBY_FINGERPRINT") or None,
    )
    signal.signal(signal.SIGTERM, lambda signum, frame: warmer.stop())
    return warmer.run()


if __name__ == "__main__":
    raise SystemExit(main())
