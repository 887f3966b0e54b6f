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
- durability and launch: ``python -m horovod_tpu_torch.runner`` (the
  port's hvdrun: one process a card, ``--gloo`` to share one, elastic
  with ``--host-discovery-script``), ``hvd.elastic`` (``run``,
  ``TorchState``, ``ElasticSampler``, ``ElasticDriver``),
  ``hvd.checkpoint`` (``CheckpointManager``, ``DurableTorchState``:
  atomic steps with digests on ``torch.distributed.checkpoint``),
  ``hvd.audit``/``hvd.maybe_audit``, ``hvd.data`` (sharded samplers and
  files with resumable cursors) and ``hvd.preemption``;
- serving: ``serve()`` answers HTTP ``POST /generate`` through a
  continuous batcher and an engine over a paged KV pool, and attention
  reads the pool through a hand-written CUDA kernel
  (``ops/paged_attention.py``), with request tracing (``traceparent``,
  ``HOROVOD_TRACE``, ``GET /traces``);
- observability and autotune: ``hvd.start_timeline(path,
  mark_cycles=, traced=)``/``hvd.stop_timeline()`` (the eager
  collectives' lifecycle timeline, or with ``traced=True`` a
  ``torch.profiler`` session whose steps ``hvd.timeline_step()`` marks),
  the flight recorder ``hvd.telemetry`` (``hvd.step_begin``/``step_end``,
  ``HOROVOD_TELEMETRY``, ``HOROVOD_METRICS_PORT``: ``/metrics``,
  ``/telemetry``, ``/traces``), the stall inspector, and the tuners
  (``HOROVOD_AUTOTUNE``, ``HOROVOD_FUSION_WIRE=auto``,
  ``HOROVOD_TUNER_CACHE``);
- the warm start and the audit: ``HOROVOD_EXE_CACHE`` keeps Inductor's
  compiled artifacts a graph on disk (``common.exe_cache.backend()`` for
  ``torch.compile``), with the bucketed overlap's schedules beside
  them; ``hvd.analysis`` holds the collective-schedule audit
  (``HOROVOD_SCHED_AUDIT``, checked by the elastic driver) and the
  fleet's trace assembly; ``HOROVOD_WARM_STANDBY`` holds hosts out of an
  elastic gang, staged by ``python -m horovod_tpu_torch.elastic.standby``,
  and swaps one in on a failure or a saturated serve role.

It imports ``torch``, numpy and the standard library only, and each
public name only at its first use.
"""

__version__ = "0.1.0"

# Every public name, by the module that defines it: imported at first
# use (PEP 562), so importing the package imports no torch and
# ``python -m horovod_tpu_torch.runner`` starts without it.
_EXPORTS = {
    ".common.basics": (
        "HorovodInternalError", "HostsUpdatedInterrupt", "NotInitializedError",
        "add_process_set", "ccl_built", "cross_rank", "cross_size",
        "cuda_built", "ddl_built", "get_config", "get_process_set",
        "get_process_set_ids", "global_process_set", "gloo_built",
        "gloo_enabled", "init", "is_homogeneous", "is_initialized",
        "local_rank", "local_size", "mpi_built", "mpi_enabled",
        "mpi_threads_supported", "nccl_built", "rank", "remove_process_set",
        "rocm_built", "shutdown", "size", "topology", "xla_built",
    ),
    ".common.guard": (
        ("guard_check", "check"), ("guard_status", "status"),
    ),
    ".common.process_sets": (
        "ProcessSet",
    ),
    ".models": (
        "VGG16", "InceptionV3", "MNISTConvNet", "ResNet50", "ResNet101",
        "Transformer", "TransformerConfig", "ViT", "ViTConfig", "init_cache",
    ),
    ".models.convert": (
        "params_from_flax",
    ),
    ".ops.adasum": (
        "adasum_allreduce",
    ),
    ".ops.compression": (
        "Compression", "Compressor", "HierarchicalInt8Compressor",
        "Int8BlockCompressor", "Int8Compressor",
    ),
    ".ops.eager": (
        "allgather", "allgather_async", "allreduce", "allreduce_",
        "allreduce_async", "allreduce_async_", "alltoall", "alltoall_async",
        "barrier", "broadcast", "broadcast_", "broadcast_async",
        "broadcast_async_", "current_join_mask", "flush", "grouped_allgather",
        "grouped_allgather_async", "grouped_allreduce",
        "grouped_allreduce_async", "grouped_reducescatter",
        "grouped_reducescatter_async", "join", "join_ranks", "poll",
        "reducescatter", "reducescatter_async", "synchronize",
    ),
    ".ops.flash_attention": (
        "flash_attention",
    ),
    ".ops.fused_xent": (
        "fused_linear_cross_entropy",
    ),
    ".ops.overlap": (
        "bucketed_allreduce", "bucketed_reduce_scatter",
        "bucketed_shard_all_gather", "build_bucket_schedule",
        "overlap_boundary",
    ),
    ".ops.reduction_ops": (
        "Adasum", "Average", "Max", "Min", "Product", "ReduceOp", "Sum",
    ),
    ".optimizer": (
        "DistributedOptimizer", "allgather_object", "broadcast_object",
        "broadcast_optimizer_state", "broadcast_parameters",
    ),
    ".sharded_optimizer": (
        "ShardedDistributedOptimizer",
    ),
    ".serving": (
        "ContinuousBatcher", "InferenceEngine", "KVCacheManager",
        "LatencyRecorder", "PagedKVCacheManager", "PagePoolExhausted",
        "Rejected", "ServeFrontend", "ServeHandle", "create_kv_manager",
        "serve",
    ),
    ".sync_batch_norm": (
        "SyncBatchNorm",
    ),
    ".common.telemetry": (
        "step_begin", "step_end",
    ),
}
_SUBMODULES = {
    "analysis": ".analysis",
    "overlap": ".ops.overlap",
    "traced": ".ops.traced",
    "local_sgd": ".local_sgd",
    "testing": ".testing",
    "checkpoint": ".checkpoint",
    "data": ".data",
    "elastic": ".elastic",
    "preemption": ".preemption",
    "telemetry": ".common.telemetry",
}
_WHERE = {(n if isinstance(n, str) else n[0]):
          (mod, n if isinstance(n, str) else n[1])
          for mod, names in _EXPORTS.items() for n in names}
__all__ = sorted(_WHERE) + sorted(_SUBMODULES) + [
    "audit", "maybe_audit", "start_timeline", "stop_timeline",
    "timeline_step"]

# the submodule audit.py shares the function's name: bound now, before any
# import of the submodule could bind the name to the module (it imports
# no torch)
from .audit import audit, maybe_audit  # noqa: E402,F401


def __getattr__(name: str):
    """Import a public name, or a subpackage, at its first use."""
    import importlib

    if name in _WHERE:
        mod, attr = _WHERE[name]
        value = getattr(importlib.import_module(mod, __name__), attr)
    elif name in _SUBMODULES:
        value = importlib.import_module(_SUBMODULES[name], __name__)
    elif not name.startswith("__"):
        try:
            value = importlib.import_module("." + name, __name__)
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


def start_timeline(file_path: str, mark_cycles: bool = False,
                   traced: bool = False) -> None:
    """Start a timeline at run time (``horovod_tpu/__init__.py:185``).

    ``traced=False``: the eager collectives' lifecycle timeline
    (``common/timeline.py``: QUEUE, the op, the fusion buffer's copies,
    CYCLE marks with ``mark_cycles``), attached to the fusion manager and
    the telemetry hub. ``traced=True``: a ``torch.profiler`` session
    (``common/traced_timeline.py``) whose steps :func:`timeline_step`
    marks; :func:`stop_timeline` writes its chrome-trace JSON."""
    from .common import basics as _basics
    from .common import telemetry

    st = _basics._require_init()
    if traced:
        from .common.traced_timeline import TracedTimeline

        if st.traced_timeline is None or not st.traced_timeline.active:
            st.traced_timeline = TracedTimeline(file_path)
        st.traced_timeline.start()
        return
    from .common.timeline import Timeline

    if st.timeline is None:
        st.timeline = Timeline(file_path, mark_cycles=mark_cycles)
        st.fusion.timeline = st.timeline
        telemetry.hub().timeline = st.timeline
    st.timeline.start()


def stop_timeline() -> None:
    """Stop the timelines and write their files."""
    from .common import basics as _basics

    st = _basics._require_init()
    if st.traced_timeline is not None:
        st.traced_timeline.stop()
    if st.timeline is not None:
        st.timeline.stop()


def timeline_step(name: str = "step", step_num=None):
    """A context manager marking one training step in the traced
    timeline (a ``record_function`` range; nothing when no traced
    timeline runs). When telemetry is on, the same boundary opens and
    closes a flight-recorder record, so profiler steps and telemetry
    steps share ids."""
    import contextlib

    from .common import basics as _basics
    from .common import telemetry
    from .common.traced_timeline import TracedTimeline

    st = _basics._require_init()
    if st.traced_timeline is None:
        st.traced_timeline = TracedTimeline("horovod_timeline.json")
    ctx = st.traced_timeline.step(name, step_num)
    if not telemetry.auto_enabled():
        return ctx

    @contextlib.contextmanager
    def _with_telemetry():
        telemetry.hub().step_begin(step_num)
        try:
            with ctx:
                yield
        finally:
            telemetry.hub().step_end()

    return _with_telemetry()
