"""PyTorch/CUDA port of horovod_tpu, for one NVIDIA Hopper card.

This first slice is the serving path: ``serve()`` answers HTTP
``POST /generate`` through a continuous batcher and an engine over a
paged KV pool, and attention reads the pool through a CUDA kernel
written by hand for ``sm_90a`` (``ops/paged_attention.py``). It imports
``torch``, numpy and the standard library only.
"""

from .models.convert import params_from_flax  # noqa: F401
from .models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    init_cache,
)
from .serving import (  # noqa: F401
    ContinuousBatcher,
    InferenceEngine,
    KVCacheManager,
    LatencyRecorder,
    PagedKVCacheManager,
    PagePoolExhausted,
    Rejected,
    ServeFrontend,
    ServeHandle,
    create_kv_manager,
    serve,
)
