"""Entry ``dsgesv_solve``: one dense float64 system per call through the
port's mixed-precision solver, as LAPACK's ``DSGESV`` solves it:
``mixed_lu`` (single(A) and its float32 LU with partial pivoting, with
||A||_inf) and ``mixed_lu_solve`` (the float32 solve refined in float64 until
LAPACK's stopping test, at most ``ITERMAX`` steps, the configuration's
``itermax``, ``configs/dsgesv_f64.json``, else the float64 LU).

Set-up runs the call inside the port's ``graphs.capturing()``, which
captures the program of ``mixed_lu``, and runs it once more, so the window
replays that program; the solves of ``mixed_lu_solve`` run eagerly between
the host's reads of the refinement's status (the port's
``mixed_lu_solve.counts.iters`` counts the calls by LAPACK's ITER).
"""

from __future__ import annotations

import json
from pathlib import Path

from recursivefactorization_jl_tpu_torch import mixed_lu, mixed_lu_solve
from recursivefactorization_jl_tpu_torch.utils import graphs
from recursivefactorization_jl_tpu_torch.utils import warmup as rt_warmup

# refinement steps before the fallback
ITERMAX = int(json.loads((Path(__file__).resolve().parent.parent / "configs" / "dsgesv_f64.json")
                         .read_text())["itermax"])


def _device(device):
    # the port's entry points take None for CUDA, as its users call them
    return None if device.type == "cuda" else str(device)


def call(A, b, device):
    """The timed call: (float32 factors, ipiv, info, x)."""
    F = mixed_lu(A, device=_device(device))
    return F.factors, F.ipiv, F.info, mixed_lu_solve(F, b, itermax=ITERMAX)


def warm(A, b, device):
    """Capture the programs of the shape of (A, b), and replay them once."""
    with graphs.capturing():
        call(A, b, device)
    call(A, b, device)


def release():
    """Free the captured programs."""
    rt_warmup.clear_caches()
