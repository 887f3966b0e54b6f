"""Reduction-op constants, as ``horovod_tpu/ops/reduction_ops.py`` has
them (the reference's ``hvd.Average``, ``hvd.Sum``, ``hvd.Adasum``, ...).
``Adasum`` reduces through ``ops/adasum.py``."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def resolve_op(op, average=None) -> ReduceOp:
    """Reconcile the legacy ``average=`` kwarg with ``op=`` the way the
    reference does: passing both is an error; ``average`` maps to
    Average/Sum; no op means Average."""
    if average is not None:
        if op is not None:
            raise ValueError(
                "'op' and deprecated 'average' cannot both be set"
            )
        return Average if average else Sum
    return Average if op is None else ReduceOp(op)
