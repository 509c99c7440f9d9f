"""Entry ``rbt_solve``: one dense system per call through the port's RBT
solver, as MAGMA's ``magma_sgesv_rbt`` solves it: the depth-2 random
butterfly transform ``A~ = U^T A V``, LU without pivoting, both triangular
solves and ``REFINE`` steps of iterative refinement in working precision
(the configuration's ``refine``, ``configs/rbt_f32.json``).
The calls are ``butterfly_workspace`` (A and b padded, the butterfly values
seeded 888), ``butterfly_factor`` (the transform and the pivot-free LU,
kept) and ``butterfly_factor_solve`` of the workspace's right-hand side.

Set-up runs the call inside the port's ``graphs.capturing()``, which
captures the programs of the three calls, and replays it once, so the
window replays them.
"""

from __future__ import annotations

import json
from pathlib import Path

from recursivefactorization_jl_tpu_torch import (
    butterfly_factor,
    butterfly_factor_solve,
    butterfly_workspace,
)
from recursivefactorization_jl_tpu_torch.utils import graphs
from recursivefactorization_jl_tpu_torch.utils import warmup as rt_warmup

# refinement steps per solve
REFINE = int(json.loads((Path(__file__).resolve().parent.parent / "configs" / "rbt_f32.json")
                        .read_text())["refine"])


def _device(device):
    # the port's entry points take None for CUDA, as its users call them
    return None if device.type == "cuda" else str(device)


def call(A, b, device):
    """The timed call: (factors of A~, ipiv, info, x)."""
    ws = butterfly_workspace(A, b, device=_device(device))
    F = butterfly_factor(ws)
    x = butterfly_factor_solve(F, ws.b, refine=REFINE)
    return F.factors, F.ipiv, F.info, x


def warm(A, b, device):
    """Capture the programs of the shape of (A, b), and replay them once."""
    with graphs.capturing():
        call(A, b, device)
    call(A, b, device)


def release():
    """Free the captured programs."""
    rt_warmup.clear_caches()
