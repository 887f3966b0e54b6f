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
  ``HOROVOD_MOE_WIRE_BLOCK`` and ``HOROVOD_MOE_CAPACITY_FACTOR``),
  snapshotted at ``hvd.init()`` as the JAX package does;
* :class:`ServeConfig`, the serving part (``HOROVOD_SERVE_*``), read by
  :func:`live_config` when a serving object is built (serving needs no
  init step).

Knobs of planes not ported yet (timeline, KV transfer, the fleet
router) come with those planes. ``HOROVOD_FUSION_WIRE=auto`` raises: it
needs the wire tuner of ROADMAP A12. ``HOROVOD_CYCLE_TIME`` is parsed
and kept, not acted on: with one process a rank, a flush driven by the
clock would let ranks cut different batches, which needs the
coordinator's negotiation of ready tensors (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

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
# stage and the wire of its exchange legs (fp32, bf16, int8; auto needs
# the wire tuner of ROADMAP A12)
DEFAULT_ZERO_STAGE = 1
DEFAULT_ZERO_WIRE = "fp32"
# The expert wire (parallel/moe.py): the dispatch/return wire (fp32,
# bf16, int8; auto needs the wire tuner of ROADMAP A12), the ICI legs'
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


def _env_opt_int(name: str) -> Optional[int]:
    """An integer the launcher may set; None when it did not."""
    if not os.environ.get(name, "").strip():
        return None
    return _env_int(name, -1)


def _fusion_wire() -> str:
    wire = _env_choice("HOROVOD_FUSION_WIRE", DEFAULT_FUSION_WIRE,
                       ("fp32", "bf16", "int8", "auto"))
    if wire == "auto":
        raise NotImplementedError(
            "HOROVOD_FUSION_WIRE=auto needs the wire tuner, not ported "
            "yet (ROADMAP A12's autotune); use fp32, bf16 or int8"
        )
    return wire


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Snapshot of the training knobs (field names as in the JAX Config)."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    # parsed and kept, not acted on: the port's fusion ticks at
    # poll/wait/step, which every rank reaches after the same enqueues;
    # a clock would need the negotiation of ready tensors (ROADMAP A3)
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    # the fused buffer's wire when a call names none: fp32, bf16 or int8
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
    # TCP rendezvous of a multi-process world (rank 0 hosts the store)
    rendezvous_addr: Optional[str] = None
    rendezvous_port: Optional[int] = None

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
