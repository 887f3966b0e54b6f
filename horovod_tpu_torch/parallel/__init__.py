"""Parallelism over the port's process groups (``horovod_tpu/parallel/``):
the mesh of dp/pp/ep/sp/tp axes (:mod:`.mesh`), tensor (:mod:`.tp`),
sequence (:mod:`.ring_attention`, :mod:`.ulysses`), pipeline
(:mod:`.pipeline`) and expert (:mod:`.moe`) parallelism, the composed
transformer (:mod:`.transformer`), and ZeRO's flat shard geometry
(:mod:`.fsdp`). The JAX package's ``fsdp_spec``/``fsdp_sharding``/
``fsdp_shard`` (GSPMD placements) are not ported (ROADMAP A14)."""

from .fsdp import (  # noqa: F401
    dyn_shard,
    host_shard,
    host_shard_rows,
    host_unshard,
    pad_to,
    reshard_rows,
    shard_cols,
)
from .mesh import MeshSpec  # noqa: F401
from .ring_attention import (  # noqa: F401
    ring_attention,
    ring_flash_attention,
)
from .tp import column_parallel_dense, row_parallel_dense  # noqa: F401
from .pipeline import gpipe, pipeline_1f1b  # noqa: F401
from .moe import MoEParams, moe_ffn, init_moe_params  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
