"""Entry ``lu_solve``: one dense system per call through the port's public
``lu`` (with ``check=False``: the caller reads ``info`` when it wants to)
and ``lu_solve`` of one right-hand side, as HPL solves it.

Set-up warms the cell's shape with the port's ``warmup``, which captures
the programs of ``lu`` and of ``lu_solve`` of a vector, so the window
replays them.
"""

from __future__ import annotations

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.utils import warmup as rt_warmup


def _device(device):
    # the port's entry points take None for CUDA, as its users call them
    return None if device.type == "cuda" else str(device)


def call(A, b, device):
    """The timed call: (factors, ipiv, info, x)."""
    F = rt.lu(A, check=False, device=_device(device))
    x = rt.lu_solve(F, b)
    return F.factors, F.ipiv, F.info, x


def warm(A, b, device):
    """Capture the programs of the shape of (A, b), and replay them once."""
    rt_warmup.warmup(shapes=[tuple(A.shape)], dtypes=[A.dtype], device=_device(device))
    call(A, b, device)


def release():
    """Free the captured programs."""
    rt_warmup.clear_caches()
