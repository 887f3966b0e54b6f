"""The logging subsystem: HOROVOD_LOG_LEVEL / HOROVOD_LOG_TIMESTAMP.

One module owns the ``horovod_tpu_torch`` logger hierarchy; every
subsystem gets its child logger here so the env contract configures them
all at once. Level names are the JAX package's: trace, debug, info,
warning, error, fatal (trace sits below DEBUG, fatal is CRITICAL).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

TRACE = 5  # below logging.DEBUG
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

_ROOT = "horovod_tpu_torch"
_configured = False


def parse_level(name: Optional[str]) -> int:
    """HOROVOD_LOG_LEVEL value → numeric level; unknown names fall back
    to warning."""
    if not name:
        return logging.WARNING
    return _LEVELS.get(str(name).strip().lower(), logging.WARNING)


def configure(
    level: Optional[str] = None,
    timestamp: Optional[bool] = None,
    stream=None,
    force: bool = False,
) -> logging.Logger:
    """Configure the ``horovod_tpu_torch`` logger. Arguments override
    HOROVOD_LOG_LEVEL / HOROVOD_LOG_TIMESTAMP; idempotent unless
    ``force``."""
    global _configured
    root = logging.getLogger(_ROOT)
    if _configured and not force:
        return root
    if level is None:
        level = os.environ.get("HOROVOD_LOG_LEVEL", "warning")
    if timestamp is None:
        raw = os.environ.get("HOROVOD_LOG_TIMESTAMP", "1")
        timestamp = str(raw).lower() not in ("0", "false", "no", "")
    fmt = (
        "[%(asctime)s] [%(levelname)s] %(name)s: %(message)s"
        if timestamp
        else "[%(levelname)s] %(name)s: %(message)s"
    )
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(parse_level(level))
    root.propagate = False
    _configured = True
    return root


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Child logger under the hierarchy (``get_logger('serve')`` →
    ``horovod_tpu_torch.serve``), configured from the environment on
    first use."""
    configure()
    if not name:
        return logging.getLogger(_ROOT)
    return logging.getLogger(f"{_ROOT}.{name}")
