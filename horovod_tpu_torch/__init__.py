"""PyTorch/CUDA port of horovod_tpu, for NVIDIA Hopper cards.

``import horovod_tpu_torch as hvd`` stands in for ``import
horovod_tpu.torch as hvd`` for the collectives and the optimizer. These
slices are ported:

- training: ``hvd.init()`` on ``torch.distributed`` (NCCL on the card,
  gloo on the CPU), the eager collectives batched by the fusion manager,
  and ``DistributedOptimizer``, whose gradient hooks put fused
  allreduces in flight during backward. The Transformer trains with
  flash attention, forward and backward, as CUDA kernels written by
  hand for ``sm_90a`` (``ops/flash_attention.py``).
  ``DistributedOptimizer`` takes the reference's options:
  ``backward_passes_per_step`` with ``flush()``, ``average``,
  pre/postscale factors, ``process_set`` and the grad guard's skip step
  (``grad_guard``, ``guard_check()``, ``guard_status()``);
- the model zoo (``models/``): ViT-B/16 through the flash kernels on
  the padded bidirectional path, ResNet-50/101, VGG-16, Inception V3
  and the MNIST ConvNet, with ``SyncBatchNorm``; and the chunked LM
  loss ``fused_linear_cross_entropy``;
- compressed and Adasum reduction: ``Compression.int8``/``int8_block``
  send the fused buffer as block-scaled int8 (``return_residual=`` on
  the allreduce, ``error_feedback=True`` on the optimizer), and
  ``op=hvd.Adasum`` combines gradients by VHDD Adasum, all on the wire
  kernels of ``ops/cuda_kernels.py``;
- the two-level route (``HOROVOD_HIERARCHICAL``, ``HOROVOD_INTRA_SIZE``):
  fused allreduces, reducescatter and allgather reduce within each node,
  then across nodes; ``Compression.hier_int8`` puts bf16 on the intra
  hops and int8 on the inter hop; ``adasum_allreduce(hierarchical=True)``
  sums within each node and runs Adasum across nodes;
- the rest of Horovod's collectives: ``alltoall``, ``reducescatter``,
  the grouped allgather and reducescatter, ``flush`` and ``join``
  (``join_ranks``) with their handles;
- the in-step collectives ``hvd.traced`` (plain functions on tensors,
  built from functional collectives, that ``torch.compile(fullgraph=True)``
  traces: the exact collectives with ``op``, pre/postscale, process sets,
  the join ``mask`` and ``groups=``; the quantized wires on kernels B2
  and B3, which a compiled step reaches as custom operators; the
  two-level recipes) and the bucketed overlap ``hvd.overlap``
  (``bucketed_allreduce``, ``build_bucket_schedule``,
  ``overlap_boundary``, and ``DistributedOptimizer(overlap_buckets=)``,
  whose bucket collectives run beside backward);
- ZeRO: ``ShardedDistributedOptimizer`` (stages 1–3: optimizer state,
  gradients and parameters sharded over the world in the flat layout of
  ``parallel/fsdp.py``) on the sharded bucket legs
  ``bucketed_reduce_scatter`` and ``bucketed_shard_all_gather``;
- local SGD: ``hvd.local_sgd`` (slices train on their own for K steps,
  then merge their deltas by hierarchical Adasum) through either
  optimizer's ``local_sgd_steps``; ``hvd.testing`` holds the seeded
  fault injection (``testing.chaos``) and a recorder of collectives;
- serving: ``serve()`` answers HTTP ``POST /generate`` through a
  continuous batcher and an engine over a paged KV pool, and attention
  reads the pool through a hand-written CUDA kernel
  (``ops/paged_attention.py``).

It imports ``torch``, numpy and the standard library only.
"""

from .common.basics import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
    NotInitializedError,
    add_process_set,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    get_config,
    get_process_set,
    get_process_set_ids,
    global_process_set,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    remove_process_set,
    rocm_built,
    shutdown,
    size,
    topology,
    xla_built,
)
from .common.guard import check as guard_check  # noqa: F401
from .common.guard import status as guard_status  # noqa: F401
from .common.process_sets import ProcessSet  # noqa: F401
from .models import (  # noqa: F401
    VGG16,
    InceptionV3,
    MNISTConvNet,
    ResNet50,
    ResNet101,
    Transformer,
    TransformerConfig,
    ViT,
    ViTConfig,
    init_cache,
)
from .models.convert import params_from_flax  # noqa: F401
from .ops.adasum import adasum_allreduce  # noqa: F401
from .ops.compression import (  # noqa: F401
    Compression,
    Compressor,
    HierarchicalInt8Compressor,
    Int8BlockCompressor,
    Int8Compressor,
)
from .ops.eager import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    current_join_mask,
    flush,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_async,
    grouped_reducescatter,
    grouped_reducescatter_async,
    join,
    join_ranks,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from .ops import overlap, traced  # noqa: F401
from .ops.flash_attention import flash_attention  # noqa: F401
from .ops.fused_xent import fused_linear_cross_entropy  # noqa: F401
from .ops.overlap import (  # noqa: F401
    bucketed_allreduce,
    bucketed_reduce_scatter,
    bucketed_shard_all_gather,
    build_bucket_schedule,
    overlap_boundary,
)
from .ops.reduction_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)
from .optimizer import (  # noqa: F401
    DistributedOptimizer,
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .sharded_optimizer import ShardedDistributedOptimizer  # noqa: F401
from . import local_sgd, testing  # noqa: F401
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
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
