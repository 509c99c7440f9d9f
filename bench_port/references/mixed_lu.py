"""The plain reference of LAPACK's ``DSGESV`` (the ``dsgesv_f64``
configuration, LAPACK Working Note 175): a float32 LU with partial pivoting
of ``single(A)``, refined to float64 accuracy against the float64 A, and the
judge of a factorization and a solution by what they say.

Plain PyTorch only: nothing of the program under test (nor of JAX).  It
takes single matrices (n, n), with TF32 off while it runs
(``dense_lu_f64._tf32_off``), and loads ``dense_lu.py`` and
``dense_lu_f64.py`` beside it by file.

* :func:`lu_factor`: ``dense_lu.lu_factor`` of ``single(A)`` (round to
  nearest, as DLAG2S): float32 factors, ``ipiv``, ``info``.  ``tf32=True``
  rounds the operands of every update's products to TF32 (the control).
  ``A`` and the flag hang on the factors' tensor (``mixed_matrix``,
  ``mixed_tf32``), since this interface's solve (``control.py``'s) is handed
  the factors alone; :func:`lu_solve` refuses factors without them.
* :func:`solve`: DSGESV's loop in float64: ``ANRM = ||A||_inf``, ``CTE =
  ANRM EPS sqrt(n) BWDMAX`` (EPS = 2^-53, BWDMAX = 1); ITER = -2 where b or
  A lies beyond float32's range, -3 where ``info`` is not 0; else ``x`` the
  float32 solve of ``single(b)``, widened, ``r = b - A x``, and while some
  column has ``max|r| > max|x| CTE``: ITER = -(ITERMAX + 1) after ITERMAX
  steps, -2 where r lies beyond float32's range, else ``x += double(solve
  (single(r)))`` and a new residual.  A negative ITER falls back to
  ``dense_lu_f64``'s LU of A and its solve.  ``ITERMAX`` is the
  configuration's ``itermax`` (``configs/dsgesv_f64.json``), which the entry
  reads too.  Returns ``(x, ITER)``.
* :func:`judge`: the numbers a run is held to, in float64 from the inputs
  the run handed the program and the program's outputs.  The factors' numbers
  (``factor_residual``, LAPACK's xGET01, and ``max_abs_l``, pivots, info)
  against ``single(A)`` in float32's unit roundoff, as ``dense_lu.judge``
  reads a float32 LU; the solution's (HPL's scaled residual and LAPACK's
  componentwise backward error) against A in float64's.  An x that meets
  LAPACK's stopping test reads HPL's residual at most ``1 / sqrt(n)``
  (``||b - A x||_inf <= ||x||_inf ||A||_inf EPS sqrt(n)``, and HPL divides
  by at least ``||A||_inf ||x||_inf EPS n``), so the configuration's limit
  there is the test itself, at its N.  Factors that come
  back in float64 (a program that returned its fallback's) are read against
  A in float64's unit roundoff.

Departures from LAPACK: the float32 LU is ``dense_lu.py``'s blocked one
(panels of at most 32 columns by rank-1 updates), not SGETRF's recursive
panels; the products ``A x`` are PyTorch's (cuBLAS's DGEMV on the card),
summed in its order; the fallback factors a copy of A (DSGESV overwrites
A), with ``dense_lu_f64.py``'s LU.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

# refinement steps before the fallback: the configuration's, which the entry reads too
ITERMAX = int(json.loads((Path(__file__).resolve().parent.parent / "configs" / "dsgesv_f64.json")
                         .read_text())["itermax"])
EPS = 2.0 ** -53  # DLAMCH('E') for double
BWDMAX = 1.0
RMAX = float(torch.finfo(torch.float32).max)  # DLAG2S's RMAX, SLAMCH('O')


def _load_sibling(name: str):
    """A module of this folder by file, without importing the benchmark's
    package (a reference stands alone)."""
    spec = importlib.util.spec_from_file_location(f"_{name}_of_mixed_lu",
                                                  Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_DENSE = _load_sibling("dense_lu")
_F64 = _load_sibling("dense_lu_f64")
_TF32_OFF = _F64._tf32_off
_worse = _DENSE._worse


def _beyond_float32(t: torch.Tensor) -> bool:
    """DLAG2S's test: some entry lies beyond float32's largest finite value."""
    return bool(((t < -RMAX) | (t > RMAX)).any())


def lu_factor(A: torch.Tensor, tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(float32 factors of ``single(A)``, ipiv int32, info int32) of the
    float64 A (n, n); ``tf32=True``: every update's products in TF32 (the
    control)."""
    with _TF32_OFF():
        F, ipiv, info = _DENSE.lu_factor(A.float(), tf32)
    # for the solve's refinement (module docstring)
    F.mixed_matrix, F.mixed_tf32 = A, tf32
    return F, ipiv, info


def _apply(factors: torch.Tensor, perm: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The float32 solve of ``single(R)`` (n, k), widened to float64."""
    y = R.float()[perm]
    y = torch.linalg.solve_triangular(factors, y, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(factors, y, upper=True).double()


def _fallback(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    F, ipiv, _ = _F64.lu_factor(A)
    return torch.stack([_DENSE.lu_solve(F, ipiv, B[:, c]) for c in range(B.shape[1])], dim=1)


def solve(factors: torch.Tensor, ipiv: torch.Tensor, info: torch.Tensor, b: torch.Tensor,
          A: torch.Tensor, itermax: int = ITERMAX) -> Tuple[torch.Tensor, int]:
    """``(x, ITER)``: DSGESV's refinement of the float32 factors of
    ``single(A)`` (:func:`lu_factor`'s) against the float64 A, for b (n,) or
    (n, k) (module docstring)."""
    n = A.shape[0]
    vec = b.dim() == 1
    B = (b[:, None] if vec else b).double()
    with _TF32_OFF():
        A64 = A.double()
        cte = A64.abs().sum(dim=1).max() * EPS * math.sqrt(n) * BWDMAX
        if _beyond_float32(B) or _beyond_float32(A64):
            it = -2
        elif int(info) != 0:
            it = -3
        else:
            perm, _ = _DENSE._perm_from_ipiv(ipiv.cpu().long().numpy()[None], n)
            perm = torch.as_tensor(perm[0], device=A.device)
            x = _apply(factors, perm, B)
            for step in range(itermax + 1):
                R = B - A64 @ x
                if not bool((R.abs().amax(dim=0) > x.abs().amax(dim=0) * cte).any()):
                    it = step
                    break
                if step == itermax:
                    it = -(itermax + 1)
                    break
                if _beyond_float32(R):
                    it = -2
                    break
                x = x + _apply(factors, perm, R)
        if it < 0:
            x = _fallback(A64, B)
    return (x[:, 0] if vec else x), it


def lu_solve(factors: torch.Tensor, ipiv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`solve` of :func:`lu_factor`'s results, against the A the
    factors carry (with ``info`` read from their diagonal, as
    ``lu_factor``'s)."""
    if not hasattr(factors, "mixed_matrix"):
        raise ValueError("factors without their matrix (mixed_matrix): lu_factor's own are needed")
    zero = torch.diagonal(factors) == 0
    info = torch.where(zero.any(), zero.int().argmax() + 1, 0)
    return solve(factors, ipiv, info, b, factors.mixed_matrix)[0]


def judge(A, b, factors, ipiv, info, x, measures: Dict[str, str], dtype: torch.dtype,
          block: int = 1024) -> Dict[str, float]:
    """The numbers of one call (module docstring): ``measures`` as
    ``dense_lu.judge`` takes them (``'lapack_dget01'`` and ``'hpl'``);
    ``dtype`` (float64) is the solution's, whose unit roundoff the solve
    numbers are read in.  ``block`` is unused (one system)."""
    if measures.get("factor") != "lapack_dget01" or measures.get("solve") != "hpl":
        raise ValueError(f"unknown measures {measures!r}")
    with _TF32_OFF():
        if factors.dtype == torch.float32:
            fac = _DENSE.judge(A.float(), b.float(), factors, ipiv, info, x.float(), measures,
                               torch.float32)
        else:
            fac = _DENSE.judge(A, b, factors, ipiv, info, x, measures, factors.dtype)
        sol = _DENSE.judge(A, b, factors.double(), ipiv, info, x.double(), measures, dtype)
    return {"factor_residual": fac["factor_residual"], "max_abs_l": fac["max_abs_l"],
            "pivots_out_of_range": fac["pivots_out_of_range"],
            "info_mismatch": fac["info_mismatch"],
            "solve_residual": sol["solve_residual"],
            "solve_backward_error": sol["solve_backward_error"]}
