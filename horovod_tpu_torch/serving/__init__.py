"""The serving plane: engine, paged KV pool, continuous batcher, HTTP."""

from .batcher import ContinuousBatcher, Rejected, Request  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .frontend import (  # noqa: F401
    FollowerHandle,
    Router,
    ServeFrontend,
    ServeHandle,
    put_announcement,
    read_announcements,
    serve,
)
from .kv_cache import KVCacheManager, create_kv_manager  # noqa: F401
from .kv_transfer import (  # noqa: F401
    KVTransferServer,
    TransferCoordinator,
    pack_raw_pages,
    unpack_pages,
)
from .paged_kv import (  # noqa: F401
    PagedKVCacheManager,
    PagePoolExhausted,
    page_hashes,
)
from .slo import LatencyRecorder  # noqa: F401
