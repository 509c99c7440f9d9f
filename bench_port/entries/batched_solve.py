"""Entry ``batched_solve``: a batch of small dense systems per call through
the port's public ``batched_lu_factor`` (the LAPACK ipiv) and
``batched_lu_solve`` of one right-hand side per system, as MAGMA's
``sgetrf_batched`` / ``sgetrs_batched`` testers call them.

Set-up warms the cell's shape inside the port's ``graphs.capturing()``,
which captures the programs of both calls, so the window replays them.
"""

from __future__ import annotations

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.utils import graphs
from recursivefactorization_jl_tpu_torch.utils import warmup as rt_warmup


def _device(device):
    # the port's entry points take None for CUDA, as its users call them
    return None if device.type == "cuda" else str(device)


def call(A, b, device):
    """The timed call: (factors, ipiv, info, x)."""
    dev = _device(device)
    factors, ipiv, info = rt.batched_lu_factor(A, device=dev)
    x = rt.batched_lu_solve(factors, ipiv, b, device=dev)
    return factors, ipiv, info, x


def warm(A, b, device):
    """Capture the programs of the shape of (A, b), and replay them once."""
    with graphs.capturing():
        call(A, b, device)
    call(A, b, device)


def release():
    """Free the captured programs."""
    rt_warmup.clear_caches()
