"""A recorder of the collectives the port hands to ``torch.distributed``.

The JAX package proves that a local-SGD step stays inside its slice by
reading the replica groups of the lowered program. Here every rank is a
process that calls ``torch.distributed`` eagerly, so the proof is a
record of those calls: :func:`record_collectives` wraps the entry points
the port reaches (``all_reduce``, ``all_to_all_single``, ``broadcast``,
``all_gather``, ``batch_isend_irecv`` and the allgather and
reduce-scatter of ``ops/_collectives.py``) for the length of a ``with``
block and lists, for each call, the collective's name, the global ranks
of its group and the bytes, dtype and shape of the input it was
handed (``analysis.fx_parse.parse_calls`` reads them as a program)::

    with record_collectives() as calls:
        loss.backward(); opt.step()
    assert all(set(c.ranks) <= my_slice for c in calls)

Compiled regions call the functional collectives instead, which this
does not see.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..ops import _collectives


class Call(NamedTuple):
    op: str
    ranks: Tuple[int, ...]  # the group's global ranks
    nbytes: int  # the input handed to the call
    dtype: str = ""  # the input's dtype ("torch.float32"), "" unknown
    shape: Tuple[int, ...] = ()  # the input's shape


def _ranks(group) -> Tuple[int, ...]:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _call(name, ranks, t) -> Call:
    if not torch.is_tensor(t):
        return Call(name, ranks, 0)
    return Call(name, ranks, _nbytes(t), str(t.dtype), tuple(t.shape))


# the entry point, the position of its input among the arguments
_DIST = {"all_reduce": 0, "broadcast": 0, "all_gather": 1,
         "all_to_all_single": 1}
_LOCAL = {"_all_gather": "all_gather_into_tensor",
          "_reduce_scatter": "reduce_scatter_tensor"}


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued in the block (module docstring);
    yields the list the calls are appended to."""
    calls: List[Call] = []
    saved = []

    def wrap(owner, attr, name, arg):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def recorded(*args, **kwargs):
            group = kwargs.get("group")
            calls.append(_call(name, _ranks(group),
                               args[arg] if len(args) > arg else None))
            return fn(*args, **kwargs)

        setattr(owner, attr, recorded)

    for name, arg in _DIST.items():
        wrap(dist, name, name, arg)
    for attr, name in _LOCAL.items():
        wrap(_collectives, attr, name, 1)
    p2p = dist.batch_isend_irecv
    saved.append((dist, "batch_isend_irecv", p2p))

    def batch(ops):
        for op in ops:
            if op.op is dist.isend:
                calls.append(_call("send", _ranks(op.group), op.tensor))
            else:
                calls.append(Call("recv", _ranks(op.group), 0))
        return p2p(ops)

    dist.batch_isend_irecv = batch
    try:
        yield calls
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
