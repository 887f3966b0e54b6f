"""The port's logging (``common/logging.py``) against the JAX package's:
the same level names, formats and precedence, and ``hvd.init()``
applying ``HOROVOD_LOG_LEVEL``/``HOROVOD_LOG_TIMESTAMP`` through
``configure_from_init`` unless the caller configured the logger
explicitly first."""

import io
import logging

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import logging as plog

NAMES = ["trace", "TRACE", "debug", "info", "warning", "error", "fatal",
         "off", "bogus", "", None, " Info "]


def _jax_logging():
    from horovod_tpu.common import logging as jlog

    return jlog


@pytest.fixture(autouse=True)
def _restore():
    yield
    for mod in (plog, _jax_logging()):
        mod._configured = mod._configured_explicitly = False
        mod.configure(force=True)
        mod._configured_explicitly = False


def test_levels_equal_the_jax_module():
    jlog = _jax_logging()
    assert plog.TRACE == jlog.TRACE
    for name in NAMES:
        assert plog.parse_level(name) == jlog.parse_level(name), name


@pytest.mark.parametrize("level,timestamp", [("trace", False),
                                             ("info", True),
                                             ("error", False)])
def test_formats_and_filters_equal(level, timestamp):
    jlog = _jax_logging()
    out = {}
    for mod in (plog, jlog):
        buf = io.StringIO()
        mod.configure(level=level, timestamp=timestamp, stream=buf,
                      force=True)
        log = mod.get_logger("case")
        mod.trace(log, "t %d", 1)
        log.debug("d")
        log.info("i")
        log.error("e")
        lines = buf.getvalue().splitlines()
        if timestamp:  # "[<asctime>] " differs run to run
            assert all(x.startswith("[") for x in lines)
            lines = [x.split("] ", 1)[1] for x in lines]
        out[mod] = [x.replace(mod._ROOT, "ROOT") for x in lines]
    assert out[plog] == out[jlog] and out[plog]


def test_init_applies_the_environment(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "debug")
    monkeypatch.setenv("HOROVOD_LOG_TIMESTAMP", "0")
    plog.get_logger("x")  # the lazy configuration at import time
    hvd.init(device="cpu")
    buf = io.StringIO()
    root = logging.getLogger("horovod_tpu_torch")
    try:
        assert root.level == logging.DEBUG
        root.handlers[0].setStream(buf)
        hvd.allreduce(torch.ones(2))
        assert "[DEBUG] horovod_tpu_torch.fusion: cycle 1" in buf.getvalue()
    finally:
        hvd.shutdown()
    # an explicit configure made first wins over init's snapshot
    plog.configure(level="error", force=True)
    hvd.init(device="cpu")
    try:
        assert root.level == logging.ERROR
    finally:
        hvd.shutdown()
