"""The serving plane: engine, paged KV pool, continuous batcher, HTTP."""

from .batcher import ContinuousBatcher, Rejected, Request  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .frontend import ServeFrontend, ServeHandle, serve  # noqa: F401
from .kv_cache import KVCacheManager, create_kv_manager  # noqa: F401
from .paged_kv import (  # noqa: F401
    PagedKVCacheManager,
    PagePoolExhausted,
    page_hashes,
)
from .slo import LatencyRecorder  # noqa: F401
