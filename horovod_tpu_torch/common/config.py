"""The ``HOROVOD_SERVE_*`` environment contract of the serving plane.

The serving part of ``horovod_tpu/common/config.py`` (its defaults and
``serve_*`` fields), with the same variable names, defaults and parsing,
so a launch script configures either package the same way. Knobs of
planes not ported yet (KV transfer, fleet router, migration) come with
those planes. The JAX
package snapshots its ``Config`` at ``hvd.init()``; the port has no init
step, so :func:`live_config` reads the environment when a serving
object is built.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

# Serving plane: decode-slot count (concurrent sequences), admissions per
# decode step, default per-request token budget/deadline, and the
# frontend port (0 = ephemeral).
DEFAULT_SERVE_PORT = 0
DEFAULT_SERVE_KV_SLOTS = 8
DEFAULT_SERVE_MAX_BATCH = 4
DEFAULT_SERVE_MAX_TOKENS = 64
DEFAULT_SERVE_DEADLINE_MS = 0.0  # 0 = no deadline
# Memory plane (serving/paged_kv.py): tokens per KV page, pool size in
# pages (0 = full backing, slots × max_len ÷ page_tokens), prefix-cache
# toggle, and the admission reserve watermark (-1 = auto: 0 at full
# backing, one page per slot otherwise).
DEFAULT_SERVE_PAGE_TOKENS = 16
DEFAULT_SERVE_PAGES = 0
DEFAULT_SERVE_PREFIX_CACHE = True
DEFAULT_SERVE_PAGE_WATERMARK = -1
# Fleet role: only "unified" is served by the port so far.
DEFAULT_SERVE_ROLE = "unified"
# Paged-attention read (ops/paged_attention.py): auto = the hand-written
# kernel on CUDA devices and the plain read elsewhere; on = the kernel
# path anywhere (its plain PyTorch version for CPU tensors); off = always
# the plain read. A kernel asked for that cannot run raises.
DEFAULT_SERVE_PAGED_ATTN = "auto"


def _env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {val!r}")


def _env_choice(name: str, default: str, choices) -> str:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    val = val.strip().lower()
    if val not in choices:
        raise ValueError(
            f"{name} must be one of {'/'.join(choices)}, got {val!r}"
        )
    return val


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        raise ValueError(f"{name} must be a float, got {val!r}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Snapshot of the serving knobs (field names as in the JAX Config)."""

    serve_port: int = DEFAULT_SERVE_PORT
    serve_kv_slots: int = DEFAULT_SERVE_KV_SLOTS
    serve_max_batch: int = DEFAULT_SERVE_MAX_BATCH
    serve_max_tokens: int = DEFAULT_SERVE_MAX_TOKENS
    serve_deadline_ms: float = DEFAULT_SERVE_DEADLINE_MS
    serve_page_tokens: int = DEFAULT_SERVE_PAGE_TOKENS
    serve_pages: int = DEFAULT_SERVE_PAGES
    serve_prefix_cache: bool = DEFAULT_SERVE_PREFIX_CACHE
    serve_page_watermark: int = DEFAULT_SERVE_PAGE_WATERMARK
    serve_role: str = DEFAULT_SERVE_ROLE
    serve_paged_attn: str = DEFAULT_SERVE_PAGED_ATTN
    # the worker's rank (HOROVOD_RANK, set by the launcher), announced in
    # /healthz; None outside a launcher
    rank: Optional[int] = None

    @staticmethod
    def from_env() -> "ServeConfig":
        return ServeConfig(
            serve_port=_env_int("HOROVOD_SERVE_PORT", DEFAULT_SERVE_PORT),
            serve_kv_slots=_env_int(
                "HOROVOD_SERVE_KV_SLOTS", DEFAULT_SERVE_KV_SLOTS
            ),
            serve_max_batch=_env_int(
                "HOROVOD_SERVE_MAX_BATCH", DEFAULT_SERVE_MAX_BATCH
            ),
            serve_max_tokens=_env_int(
                "HOROVOD_SERVE_MAX_TOKENS", DEFAULT_SERVE_MAX_TOKENS
            ),
            serve_deadline_ms=_env_float(
                "HOROVOD_SERVE_DEADLINE_MS", DEFAULT_SERVE_DEADLINE_MS
            ),
            serve_page_tokens=_env_int(
                "HOROVOD_SERVE_PAGE_TOKENS", DEFAULT_SERVE_PAGE_TOKENS
            ),
            serve_pages=_env_int("HOROVOD_SERVE_PAGES", DEFAULT_SERVE_PAGES),
            serve_prefix_cache=_env_bool(
                "HOROVOD_SERVE_PREFIX_CACHE", DEFAULT_SERVE_PREFIX_CACHE
            ),
            serve_page_watermark=_env_int(
                "HOROVOD_SERVE_PAGE_WATERMARK",
                DEFAULT_SERVE_PAGE_WATERMARK,
            ),
            serve_role=_env_choice(
                "HOROVOD_SERVE_ROLE", DEFAULT_SERVE_ROLE,
                ("unified", "prefill", "decode"),
            ),
            serve_paged_attn=_env_choice(
                "HOROVOD_SERVE_PAGED_ATTN", DEFAULT_SERVE_PAGED_ATTN,
                ("auto", "on", "off"),
            ),
            rank=(
                _env_int("HOROVOD_RANK", -1)
                if "HOROVOD_RANK" in os.environ else None
            ),
        )


def live_config() -> ServeConfig:
    """The serving knobs as the environment sets them now."""
    return ServeConfig.from_env()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller names another (the tests pass ``"cpu"``). Raises when CUDA
    is asked for and there is none — never a quiet run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
