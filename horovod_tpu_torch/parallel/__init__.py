"""Parallelism layouts of the port (``horovod_tpu/parallel/``): so far
the flat shard geometry of ZeRO, :mod:`.fsdp`."""

from .fsdp import (  # noqa: F401
    dyn_shard,
    host_shard,
    host_shard_rows,
    host_unshard,
    pad_to,
    reshard_rows,
    shard_cols,
)
