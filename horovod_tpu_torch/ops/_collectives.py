"""``torch.distributed`` helpers below both the fusion manager
(``ops/fusion.py``) and Adasum (``ops/adasum.py``)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_into(out: torch.Tensor, x: torch.Tensor, group=None,
                async_op: bool = False):
    """Allgather of every rank's contiguous ``x`` into the contiguous
    ``out`` of n times its size, rank-major. Newer PyTorch releases rename
    ``all_gather_into_tensor`` to ``all_gather_single`` and keeps the old
    name as a warning alias; the old name is the one every release the
    port runs on has."""
    return dist.all_gather_into_tensor(out.view(-1), x.reshape(-1),
                                       group=group, async_op=async_op)
