"""The logging subsystem: HOROVOD_LOG_LEVEL / HOROVOD_LOG_TIMESTAMP.

One module owns the ``horovod_tpu_torch`` logger hierarchy; every
subsystem gets its child logger here so the env contract configures them
all at once. Level names are the JAX package's: trace, debug, info,
warning, error, fatal (trace sits below DEBUG, fatal is CRITICAL).
``hvd.init()`` applies its snapshot of the two variables through
:func:`configure_from_init`.
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
_configured_explicitly = False  # a caller passed real arguments


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
    global _configured, _configured_explicitly
    root = logging.getLogger(_ROOT)
    if _configured and not force:
        return root
    if level is not None or timestamp is not None or stream is not None:
        _configured_explicitly = True
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


def configure_from_init(level: str, timestamp: bool) -> logging.Logger:
    """``hvd.init()``'s entry point: the module-level ``get_logger``
    calls configured the tree lazily at import, which would make a plain
    ``configure(...)`` a no-op; init's snapshot wins over that lazy
    default, never over an explicit ``configure(...)`` made first."""
    if _configured_explicitly:
        return logging.getLogger(_ROOT)
    return configure(level=level, timestamp=timestamp, force=True)


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Child logger under the hierarchy (``get_logger('serve')`` →
    ``horovod_tpu_torch.serve``), configured from the environment on
    first use."""
    configure()
    if not name:
        return logging.getLogger(_ROOT)
    return logging.getLogger(f"{_ROOT}.{name}")


def trace(logger: logging.Logger, msg: str, *args) -> None:
    """LOG(TRACE) spelling (``logging`` has no ``.trace`` method)."""
    logger.log(TRACE, msg, *args)
