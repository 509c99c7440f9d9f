"""The collectives of the distributed functions (parallel/blockcyclic.py,
parallel/batched.py).

Only ``broadcast`` and ``all_reduce`` are used: both run on CUDA tensors
under NCCL and under gloo (gloo's ``all_gather`` takes CPU tensors only).

Both may be recorded in a CUDA graph on an NCCL group (utils/graphs.py):
they are issued with ``async_op=False``, and c10d's wait on an NCCL work
only makes the caller's stream wait for NCCL's, on the device; they read
nothing on the host, and the group's rank map is host data.  The
communicator must exist before a capture, which the program's warm run
gives it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_group(mesh, axis: str):
    """``(group, size, rank within the group)`` of the dimension ``axis`` of
    the ``DeviceMesh`` ``mesh``: the counterpart of a JAX mesh axis."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def broadcast(t: torch.Tensor, root: int, group) -> torch.Tensor:
    """Broadcast the contiguous ``t`` in place from the group's rank
    ``root``."""
    dist.broadcast(t, src=dist.get_global_rank(group, root), group=group)
    return t


def gather_by_sum(full: torch.Tensor, group) -> torch.Tensor:
    """Every rank has written its own part of the contiguous ``full`` and
    zeros everywhere else.  One ``all_reduce`` of the bytes gives every
    rank all the parts, bit for bit: at each byte only the owner adds a
    nonzero value, so the integer sum is that value (a float sum would turn
    -0.0 into +0.0).  Any dtype."""
    dist.all_reduce(full.view(torch.uint8), group=group)
    return full
