"""The ``HOROVOD_*`` environment contract of the ported planes.

Two parts of ``horovod_tpu/common/config.py``, with the same variable
names, defaults and parsing, so a launch script configures either
package the same way:

* :class:`TrainConfig`, the training part (fusion threshold and cycle
  time, the fused buffer's wire format and block, the launcher's rank
  and size variables, the two-level switches ``HOROVOD_HIERARCHICAL``,
  ``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER``,
  ``HOROVOD_FUSION_WIRE_HIER`` and ``HOROVOD_INTRA_SIZE``, and the
  bucketed overlap's ``HOROVOD_OVERLAP``, ``HOROVOD_OVERLAP_BUCKETS`` and
  ``HOROVOD_OVERLAP_MIN_BYTES``, and ZeRO's ``HOROVOD_ZERO_STAGE`` and
  ``HOROVOD_ZERO_WIRE``, local SGD's ``HOROVOD_LOCAL_SGD_STEPS``, and
  the expert wire's ``HOROVOD_MOE_WIRE``, ``HOROVOD_MOE_INTRA_WIRE``,
  ``HOROVOD_MOE_WIRE_BLOCK`` and ``HOROVOD_MOE_CAPACITY_FACTOR``, and
  the launcher's contract: ``HOROVOD_COORDINATOR_ADDR``/``_PORT``, the
  world's store, ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``, the
  launcher's HTTP KV, ``HOROVOD_CONTROLLER``, ``HOROVOD_ELASTIC_EPOCH``,
  ``HOROVOD_SECRET_KEY``, ``HOROVOD_GLOO_TIMEOUT_SECONDS``,
  ``HOROVOD_AUDIT_STEPS``, and the observability and autotune knobs:
  ``HOROVOD_LOG_LEVEL``/``_TIMESTAMP``, ``HOROVOD_TIMELINE``/
  ``_MARK_CYCLES``, ``HOROVOD_TELEMETRY_STEPS``,
  ``HOROVOD_FLIGHT_RECORDER``, ``HOROVOD_METRICS_PORT``,
  ``HOROVOD_TRACE``/``_SAMPLE``/``_SPANS``, ``HOROVOD_STALL_CHECK_*``,
  ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``, ``HOROVOD_STRAGGLER_FACTOR``,
  ``HOROVOD_STRAGGLER_QUARANTINE_POLLS``, ``HOROVOD_REBALANCE``,
  ``HOROVOD_GUARD``, ``HOROVOD_AUTOTUNE*``,
  ``HOROVOD_TUNER_CACHE`` and ``HOROVOD_FUSION_WIRE_MIN_BYTES``),
  snapshotted at ``hvd.init()`` as the JAX package does;
* :class:`ServeConfig`, the serving part (``HOROVOD_SERVE_*``, the
  fleet's ``HOROVOD_SERVE_HEDGE_MS``, ``_DRAIN_DEADLINE_S`` and
  ``_DEDUPE_TTL_S`` included), read by :func:`live_config` when a
  serving object is built (serving needs no init step).

``HOROVOD_FUSION_WIRE=auto`` picks each fused
batch's wire by the wire tuner (``common/autotune.py``).
``HOROVOD_CYCLE_TIME`` is parsed and kept, not acted on: with one
process a rank, a flush driven by the clock would let ranks cut
different batches, which needs the coordinator's negotiation of ready
tensors (ROADMAP A3); ``HOROVOD_AUTOTUNE`` records it as the JAX
parameter manager does and tunes the threshold only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    import torch

# Default fusion threshold matches the reference: 64 MB
# (ref: horovod/common/fusion_buffer_manager.cc).
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Batching window of pending collectives, milliseconds (HOROVOD_CYCLE_TIME).
DEFAULT_CYCLE_TIME_MS = 1.0
# Wire format of the fused buffer (HOROVOD_FUSION_WIRE) and the int8
# wire's scale granularity in elements (HOROVOD_FUSION_WIRE_BLOCK).
DEFAULT_FUSION_WIRE = "fp32"
DEFAULT_FUSION_WIRE_BLOCK = 512
# Two-level routing (HOROVOD_HIERARCHICAL): auto engages it only on
# positive evidence of a second level (common/topology.py).
DEFAULT_HIERARCHICAL = "auto"
# Bucketed overlap (ops/overlap.py): off by default; the bucket count and
# the byte floor under which a bucket merges into its neighbour.
DEFAULT_OVERLAP_BUCKETS = 4
DEFAULT_OVERLAP_MIN_BYTES = 1 << 20
# ShardedDistributedOptimizer(zero_stage=None, wire=None): the sharding
# stage and the wire of its exchange legs (fp32, bf16, int8, or auto:
# the wire tuner's choice a bucket)
DEFAULT_ZERO_STAGE = 1
DEFAULT_ZERO_WIRE = "fp32"
# The expert wire (parallel/moe.py): the dispatch/return wire (fp32,
# bf16, int8, or auto: the shared wire tuner's choice), the intra legs'
# wire under a two-level split, the int8 wire's elements a block scale,
# and the capacity factor of the static per-destination buffer
DEFAULT_MOE_WIRE = "fp32"
DEFAULT_MOE_INTRA_WIRE = "fp32"
DEFAULT_MOE_WIRE_BLOCK = 512
DEFAULT_MOE_CAPACITY_FACTOR = 1.25
# consecutive non-finite steps the grad guard skips before it escalates
DEFAULT_GUARD_MAX_SKIPS = 3
# The retry ladder of common/retry.py (HOROVOD_RETRY_*), the JAX
# package's defaults
DEFAULT_RETRY_ATTEMPTS = 3
DEFAULT_RETRY_BACKOFF_MS = 100.0
DEFAULT_RETRY_BACKOFF_MAX_MS = 2000.0
DEFAULT_RETRY_DEADLINE_S = 60.0
DEFAULT_RETRY_ATTEMPT_TIMEOUT_S = 30.0
DEFAULT_RETRY_CIRCUIT_THRESHOLD = 3
DEFAULT_RETRY_CIRCUIT_COOLDOWN_S = 30.0
# the elastic driver's discovery poll, seconds; the audit cadence in
# steps (0: off); the KV object collectives' wait, seconds
DEFAULT_ELASTIC_DISCOVERY_INTERVAL = 1.0
DEFAULT_AUDIT_STEPS = 0
DEFAULT_GLOO_TIMEOUT_SECONDS = 30.0
# the fused wire tuner's payload floor under which int8 is never tried
DEFAULT_FUSION_WIRE_MIN_BYTES = 64 * 1024
# the stall inspector: the warning age, and the age past which a pending
# entry or a silent rank raises HorovodInternalError (0: never)
DEFAULT_STALL_WARNING_SECONDS = 60.0
DEFAULT_STALL_SHUTDOWN_SECONDS = 0.0
# the driver quarantines a host whose rank stays a straggler this many
# consecutive fresh heartbeats (0: observe only), as the JAX driver does
DEFAULT_STRAGGLER_QUARANTINE_POLLS = 3
DEFAULT_STRAGGLER_FACTOR = 3.0

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
# Fleet role: unified, or one half of a prefill/decode pair.
DEFAULT_SERVE_ROLE = "unified"
# the KV-page wire of prefill → decode transfers (int8: block-scaled
# pages on B3; fp32: the pool dtype's bytes, lossless; bf16 between),
# and the decode worker's transfer port (0: ephemeral, announced either
# way)
DEFAULT_SERVE_KV_WIRE = "int8"
DEFAULT_SERVE_TRANSFER_PORT = 0
# Paged-attention read (ops/paged_attention.py): auto = the hand-written
# kernel on CUDA devices and the plain read elsewhere; on = the kernel
# path anywhere (its plain PyTorch version for CPU tensors); off = always
# the plain read. A kernel asked for that cannot run raises.
DEFAULT_SERVE_PAGED_ATTN = "auto"
# The fleet's control plane (serving/frontend.py): the delay in ms before
# the Router fires a first-writer-wins backup request (0 = off), the
# drain deadline in seconds past which in-flight sequences are
# live-migrated to a peer instead of run to completion (0 = run to
# completion), and the TTL of the completed-result dedupe cache that
# makes a retry by request_id idempotent.
DEFAULT_SERVE_HEDGE_MS = 0.0
DEFAULT_SERVE_DRAIN_DEADLINE_S = 0.0
DEFAULT_SERVE_DEDUPE_TTL_S = 120.0


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


def _env_opt_int(name: str) -> Optional[int]:
    """An integer the launcher may set; None when it did not."""
    if not os.environ.get(name, "").strip():
        return None
    return _env_int(name, -1)


def _fusion_wire() -> str:
    wire = _env_choice("HOROVOD_FUSION_WIRE", DEFAULT_FUSION_WIRE,
                       ("fp32", "bf16", "int8", "auto"))
    return wire


def _controller() -> Optional[str]:
    """``HOROVOD_CONTROLLER``: gloo or nccl, None when unset (the JAX
    launcher's ``tpu`` reads as unset); MPI is not built."""
    val = os.environ.get("HOROVOD_CONTROLLER", "").strip().lower()
    if val in ("", "tpu"):
        return None
    if val == "mpi":
        raise NotImplementedError(
            "HOROVOD_CONTROLLER=mpi: the port runs no MPI; use gloo or nccl"
        )
    if val not in ("gloo", "nccl"):
        raise ValueError(
            f"HOROVOD_CONTROLLER must be gloo or nccl, got {val!r}"
        )
    return val


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Snapshot of the training knobs (field names as in the JAX Config)."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    # parsed and kept, not acted on: the port's fusion ticks at
    # poll/wait/step, which every rank reaches after the same enqueues;
    # a clock would need the negotiation of ready tensors (ROADMAP A3)
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    # the fused buffer's wire when a call names none: fp32, bf16, int8 or
    # auto (each batch's wire from the wire tuner)
    fusion_wire: str = DEFAULT_FUSION_WIRE
    fusion_wire_block: int = DEFAULT_FUSION_WIRE_BLOCK
    # an int8 wire places bf16 on the intra hops and int8 on the inter
    # hop whenever a two-level split resolves (Compression.hier_int8's
    # placement for every int8 batch)
    fusion_wire_hier: bool = False
    # the legacy switches, read as HOROVOD_HIERARCHICAL=on
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # two-level routing of the fused batch, reducescatter and allgather
    # (common/topology.py hierarchy_stages): auto, on or off
    hierarchical: str = DEFAULT_HIERARCHICAL
    # ranks per node for the two-level split (HOROVOD_INTRA_SIZE); a
    # value that does not divide the world degrades to gcd(intra, world)
    intra_size: Optional[int] = None
    # the bucketed overlap (ops/overlap.py): when on, DistributedOptimizer
    # exchanges its gradients in ``overlap_buckets`` buckets unless the
    # caller passes overlap_buckets=; buckets under ``overlap_min_bytes``
    # merge forward (a collective's launch outweighs its overlap there)
    overlap: bool = False
    overlap_buckets: int = DEFAULT_OVERLAP_BUCKETS
    overlap_min_bytes: int = DEFAULT_OVERLAP_MIN_BYTES
    # ZeRO (sharded_optimizer.py): the stage when the optimizer passes
    # zero_stage=None, and its legs' wire when it passes wire=None. The
    # wire is its own knob: HOROVOD_FUSION_WIRE governs the fused
    # allreduce, and inheriting it would change the sharded optimizer's
    # numerics and state layout for deployments that set it before ZeRO
    zero_stage: int = DEFAULT_ZERO_STAGE
    zero_wire: str = DEFAULT_ZERO_WIRE
    # local SGD (local_sgd.py): the optimizers' local_sgd_steps when they
    # pass None; 1 is the every-step path, K > 1 trains K steps within
    # each slice between sync rounds
    local_sgd_steps: int = 1
    # the expert wire (parallel/moe.py) when moe_ffn names none; under a
    # two-level split moe_wire names the inter hop and moe_intra_wire
    # the intra legs (fp32 or bf16, never int8)
    moe_wire: str = DEFAULT_MOE_WIRE
    moe_intra_wire: str = DEFAULT_MOE_INTRA_WIRE
    moe_wire_block: int = DEFAULT_MOE_WIRE_BLOCK
    moe_capacity_factor: float = DEFAULT_MOE_CAPACITY_FACTOR
    # the launcher's view of this process (None outside a launcher)
    rank: Optional[int] = None
    size: Optional[int] = None
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    cross_rank: Optional[int] = None
    cross_size: Optional[int] = None
    # the launcher's HTTP KV (runner/rendezvous.py); without a
    # coordinator it is also where the world's TCP store meets
    rendezvous_addr: Optional[str] = None
    rendezvous_port: Optional[int] = None
    # the world's TCPStore, hosted by rank 0 (the launcher names it)
    coordinator_addr: Optional[str] = None
    coordinator_port: Optional[int] = None
    # the collective backend the launcher asks for: None (the device's
    # default), "nccl" or "gloo" (hvdrun --gloo: gloo for CUDA tensors
    # too, so several ranks can share one card)
    controller: Optional[str] = None
    # the elastic driver's gang generation (0 outside it)
    elastic_epoch: int = 0
    # the job's HMAC key, hex (signs the KV and the worker services)
    secret_key_hex: Optional[str] = None
    # how long a KV object collective waits for its peers
    gloo_timeout_seconds: float = DEFAULT_GLOO_TIMEOUT_SECONDS
    # hvd.maybe_audit's cadence in steps (0: never)
    audit_steps: int = DEFAULT_AUDIT_STEPS
    # the wire tuner's int8 payload floor (HOROVOD_FUSION_WIRE=auto)
    fusion_wire_min_bytes: int = DEFAULT_FUSION_WIRE_MIN_BYTES
    # autotune (common/autotune.py): the parameter manager's switch, log
    # and windows, and the tuners' persistent state directory
    autotune: bool = False
    autotune_log: Optional[str] = None
    tuner_cache: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    # the eager timeline (common/timeline.py): its path at init, CYCLE marks
    timeline: Optional[str] = None
    timeline_mark_cycles: bool = False
    # telemetry (common/telemetry.py): the ring's steps, the flight
    # recorder's dump path, the scrape port (0: no server), and the
    # straggler factor of the stall inspector
    telemetry_steps: int = 256
    flight_recorder: Optional[str] = None
    metrics_port: int = 0
    straggler_factor: float = DEFAULT_STRAGGLER_FACTOR
    # request tracing (common/tracing.py)
    trace: bool = False
    trace_sample: float = 1.0
    trace_spans: int = 2048
    # the stall inspector (common/stall_inspector.py)
    stall_check_disable: bool = False
    stall_warning_seconds: float = DEFAULT_STALL_WARNING_SECONDS
    stall_shutdown_seconds: float = DEFAULT_STALL_SHUTDOWN_SECONDS
    # the elastic driver's straggler quarantine (0: observe only), and
    # its straggler rebalance: micro-batch weights published in the KV
    # for hvd.elastic.rebalance_weight()
    straggler_quarantine_polls: int = DEFAULT_STRAGGLER_QUARANTINE_POLLS
    rebalance: bool = False
    # the non-finite sentinel on every floating fused eager batch, counted
    # by hvd.guard_check() (common/guard.py); the optimizers' default
    # grad_guard
    guard: bool = False
    # the logger's level and timestamp prefix, applied at init
    log_level: str = "warning"
    log_timestamp: bool = True

    @staticmethod
    def from_env() -> "TrainConfig":
        return TrainConfig(
            fusion_threshold_bytes=_env_int(
                "HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD
            ),
            cycle_time_ms=_env_float(
                "HOROVOD_CYCLE_TIME", DEFAULT_CYCLE_TIME_MS
            ),
            fusion_wire=_fusion_wire(),
            fusion_wire_block=_env_int(
                "HOROVOD_FUSION_WIRE_BLOCK", DEFAULT_FUSION_WIRE_BLOCK
            ),
            fusion_wire_hier=_env_bool("HOROVOD_FUSION_WIRE_HIER"),
            hierarchical_allreduce=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLREDUCE"
            ),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER"
            ),
            hierarchical=_env_choice(
                "HOROVOD_HIERARCHICAL", DEFAULT_HIERARCHICAL,
                ("auto", "on", "off"),
            ),
            intra_size=_env_opt_int("HOROVOD_INTRA_SIZE"),
            overlap=_env_bool("HOROVOD_OVERLAP"),
            overlap_buckets=_env_int("HOROVOD_OVERLAP_BUCKETS",
                                     DEFAULT_OVERLAP_BUCKETS),
            overlap_min_bytes=_env_int("HOROVOD_OVERLAP_MIN_BYTES",
                                       DEFAULT_OVERLAP_MIN_BYTES),
            zero_stage=int(_env_choice("HOROVOD_ZERO_STAGE",
                                       str(DEFAULT_ZERO_STAGE),
                                       ("1", "2", "3"))),
            zero_wire=_env_choice("HOROVOD_ZERO_WIRE", DEFAULT_ZERO_WIRE,
                                  ("fp32", "bf16", "int8", "auto")),
            local_sgd_steps=_env_int("HOROVOD_LOCAL_SGD_STEPS", 1),
            moe_wire=_env_choice("HOROVOD_MOE_WIRE", DEFAULT_MOE_WIRE,
                                 ("fp32", "bf16", "int8", "auto")),
            moe_intra_wire=_env_choice("HOROVOD_MOE_INTRA_WIRE",
                                       DEFAULT_MOE_INTRA_WIRE,
                                       ("fp32", "bf16")),
            moe_wire_block=_env_int("HOROVOD_MOE_WIRE_BLOCK",
                                    DEFAULT_MOE_WIRE_BLOCK),
            moe_capacity_factor=_env_float("HOROVOD_MOE_CAPACITY_FACTOR",
                                           DEFAULT_MOE_CAPACITY_FACTOR),
            rank=_env_opt_int("HOROVOD_RANK"),
            size=_env_opt_int("HOROVOD_SIZE"),
            local_rank=_env_opt_int("HOROVOD_LOCAL_RANK"),
            local_size=_env_opt_int("HOROVOD_LOCAL_SIZE"),
            cross_rank=_env_opt_int("HOROVOD_CROSS_RANK"),
            cross_size=_env_opt_int("HOROVOD_CROSS_SIZE"),
            rendezvous_addr=(
                os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR") or None
            ),
            rendezvous_port=_env_opt_int("HOROVOD_GLOO_RENDEZVOUS_PORT"),
            coordinator_addr=(
                os.environ.get("HOROVOD_COORDINATOR_ADDR") or None
            ),
            coordinator_port=_env_opt_int("HOROVOD_COORDINATOR_PORT"),
            controller=_controller(),
            elastic_epoch=_env_int("HOROVOD_ELASTIC_EPOCH", 0),
            secret_key_hex=os.environ.get("HOROVOD_SECRET_KEY") or None,
            gloo_timeout_seconds=_env_float(
                "HOROVOD_GLOO_TIMEOUT_SECONDS", DEFAULT_GLOO_TIMEOUT_SECONDS
            ),
            audit_steps=_env_int("HOROVOD_AUDIT_STEPS", DEFAULT_AUDIT_STEPS),
            fusion_wire_min_bytes=_env_int(
                "HOROVOD_FUSION_WIRE_MIN_BYTES",
                DEFAULT_FUSION_WIRE_MIN_BYTES),
            autotune=_env_bool("HOROVOD_AUTOTUNE"),
            autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG") or None,
            tuner_cache=os.environ.get("HOROVOD_TUNER_CACHE") or None,
            autotune_warmup_samples=_env_int(
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int(
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10),
            autotune_bayes_opt_max_samples=_env_int(
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20),
            autotune_gaussian_process_noise=_env_float(
                "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8),
            timeline=os.environ.get("HOROVOD_TIMELINE") or None,
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
            telemetry_steps=_env_int("HOROVOD_TELEMETRY_STEPS", 256),
            flight_recorder=os.environ.get("HOROVOD_FLIGHT_RECORDER") or None,
            metrics_port=_env_int("HOROVOD_METRICS_PORT", 0),
            straggler_factor=_env_float("HOROVOD_STRAGGLER_FACTOR",
                                        DEFAULT_STRAGGLER_FACTOR),
            trace=_env_bool("HOROVOD_TRACE"),
            trace_sample=_env_float("HOROVOD_TRACE_SAMPLE", 1.0),
            trace_spans=_env_int("HOROVOD_TRACE_SPANS", 2048),
            stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
            stall_warning_seconds=_env_float(
                "HOROVOD_STALL_CHECK_TIME_SECONDS",
                DEFAULT_STALL_WARNING_SECONDS),
            stall_shutdown_seconds=_env_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
                DEFAULT_STALL_SHUTDOWN_SECONDS),
            straggler_quarantine_polls=_env_int(
                "HOROVOD_STRAGGLER_QUARANTINE_POLLS",
                DEFAULT_STRAGGLER_QUARANTINE_POLLS),
            rebalance=_env_bool("HOROVOD_REBALANCE"),
            guard=_env_bool("HOROVOD_GUARD"),
            log_level=os.environ.get("HOROVOD_LOG_LEVEL",
                                     "warning").lower(),
            log_timestamp=_env_bool("HOROVOD_LOG_TIMESTAMP", True),
        )


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
    serve_kv_wire: str = DEFAULT_SERVE_KV_WIRE
    serve_transfer_port: int = DEFAULT_SERVE_TRANSFER_PORT
    serve_hedge_ms: float = DEFAULT_SERVE_HEDGE_MS
    serve_drain_deadline_s: float = DEFAULT_SERVE_DRAIN_DEADLINE_S
    serve_dedupe_ttl_s: float = DEFAULT_SERVE_DEDUPE_TTL_S
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
            serve_kv_wire=_env_choice(
                "HOROVOD_SERVE_KV_WIRE", DEFAULT_SERVE_KV_WIRE,
                ("fp32", "bf16", "int8"),
            ),
            serve_transfer_port=_env_int(
                "HOROVOD_SERVE_TRANSFER_PORT", DEFAULT_SERVE_TRANSFER_PORT
            ),
            serve_hedge_ms=_env_float(
                "HOROVOD_SERVE_HEDGE_MS", DEFAULT_SERVE_HEDGE_MS
            ),
            serve_drain_deadline_s=_env_float(
                "HOROVOD_SERVE_DRAIN_DEADLINE_S",
                DEFAULT_SERVE_DRAIN_DEADLINE_S,
            ),
            serve_dedupe_ttl_s=_env_float(
                "HOROVOD_SERVE_DEDUPE_TTL_S", DEFAULT_SERVE_DEDUPE_TTL_S
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
    is asked for and there is none — never a quiet run on the CPU.

    An unindexed ``cuda`` under a launcher (``HOROVOD_LOCAL_RANK`` set)
    is the local rank's card, ``cuda:{local_rank % device_count}``: each
    rank of a host owns one card, as the JAX launcher's per-slot process
    owns its device; outside a launcher it is the current device."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            local = _env_opt_int("HOROVOD_LOCAL_RANK")
            index = (torch.cuda.current_device() if local is None
                     else local % torch.cuda.device_count())
            dev = torch.device("cuda", index)
    return dev
