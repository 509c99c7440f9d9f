"""Solves with a computed LU: ``lu_solve``, ``ldiv``, ``lu_solve_refined``
and the one-shot ``solve``.

A pivoted solve gathers the right-hand side by the composed permutation,
then runs the unit-lower and the upper triangular solves; a no-pivot
solve skips the gather.  ``trans`` accepts 'N'/False/0 (``A x = b``),
'T'/True/1 (``A^T x = b``) and 'H'/2 (``A^H x = b``, the conjugated
factors for complex types).  Solves run on the factorization's device.

Half factors (bfloat16/float16, as the ``promote`` route stores them):
the right-hand side takes the factors' type, as in the JAX package, but
the substitutions run in float32 and the solution is rounded back to
the half type.  PyTorch lacks several half operations on the CPU, and
one rule on both devices keeps the CPU tests valid for the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import trsm
from ..utils.config import HALF_DTYPES, full_matmul_precision
from ..utils.perm import invert_perm


def normalize_trans(trans) -> int:
    """Normalize the transpose selector to 0 (N) / 1 (T) / 2 (H)."""
    if isinstance(trans, bool):
        return 1 if trans else 0
    if trans in (0, 1, 2):
        return int(trans)
    if isinstance(trans, str):
        key = trans.upper()
        if key in ("N", "NOTRANS", "NONE"):
            return 0
        if key in ("T", "TRANS", "TRANSPOSE"):
            return 1
        if key in ("H", "C", "ADJOINT", "CONJTRANS"):
            return 2
    raise ValueError(
        f"unrecognized trans selector {trans!r}; use False/0/'N', "
        "True/1/'T', or 2/'H'"
    )


@full_matmul_precision()
def _lu_solve_impl(factors, perm, b, pivoted: bool, trans=0):
    """``perm`` is the composed row permutation (``L@U == A[perm,:]``)."""
    trans = normalize_trans(trans)
    if factors.shape[0] != factors.shape[1]:
        raise ValueError("lu_solve requires a square factorization")
    if factors.dtype in HALF_DTYPES:
        x = _lu_solve_impl(
            factors.float(), perm, b.to(factors.dtype).float(), pivoted, trans
        )
        return x.to(factors.dtype)
    vec = b.ndim == 1
    B = (b[:, None] if vec else b).to(factors.dtype)
    if trans == 0:
        if pivoted:
            B = B[perm.long()]
        y = trsm.solve_unit_lower(factors, B)
        x = trsm.solve_upper(factors, y)
    else:
        # A = P^T L U  =>  A^T x = b  <=>  U^T y = b, L^T z = y, x = P^T z
        ft = factors.T
        if trans == 2 and factors.dtype.is_complex:
            ft = ft.conj()
        y = trsm.solve_lower(ft, B)
        x = trsm.solve_unit_upper(ft, y)
        if pivoted:
            x = x[invert_perm(perm).long()]
    return x[:, 0] if vec else x


def _rhs(lu_res, b) -> torch.Tensor:
    return torch.as_tensor(b, device=lu_res.factors.device)


def lu_solve(lu_res, b, trans=0) -> torch.Tensor:
    """Solve ``A x = b`` given ``lu_res = lu(A)``; ``b`` moves to the
    factorization's device."""
    perm = lu_res.p if lu_res.pivoted else lu_res.ipiv
    return _lu_solve_impl(
        lu_res.factors, perm, _rhs(lu_res, b), lu_res.pivoted,
        normalize_trans(trans),
    )


def ldiv(lu_res, b) -> torch.Tensor:
    """Reference-style name (``ldiv!``): left-division by the factored A."""
    return lu_solve(lu_res, b)


@full_matmul_precision()
def lu_solve_refined(lu_res, A, b, iters: int = 2, trans=0) -> torch.Tensor:
    """Solve with ``iters`` steps of iterative refinement,
    ``x += A \\ (b - A x)``, re-using the factorization.  The companion of
    the reduced-precision Schur modes; the residual product runs with
    TF32 off (for half factors in float32, rounded back at the end)."""
    trans = normalize_trans(trans)
    if lu_res.factors.dtype in HALF_DTYPES:
        F32 = dataclasses.replace(lu_res, factors=lu_res.factors.float())
        dev = lu_res.factors.device
        x = lu_solve_refined(
            F32, torch.as_tensor(A, device=dev).float(),
            torch.as_tensor(b, device=dev).float(), iters, trans,
        )
        return x.to(lu_res.factors.dtype)
    perm = lu_res.p if lu_res.pivoted else lu_res.ipiv
    A = torch.as_tensor(A, device=lu_res.factors.device)
    b = _rhs(lu_res, b)
    x = _lu_solve_impl(lu_res.factors, perm, b, lu_res.pivoted, trans)
    bm = b if b.ndim > 1 else b[:, None]
    op = A if trans == 0 else (A.T if trans == 1 else A.conj().T)
    for _ in range(iters):
        xm = x if x.ndim > 1 else x[:, None]
        r = bm.to(A.dtype) - op @ xm
        r = r if b.ndim > 1 else r[:, 0]
        x = x + _lu_solve_impl(lu_res.factors, perm, r, lu_res.pivoted, trans)
    return x


def solve(A, b, pivot=True, *, trans=0, check="auto", config=None,
          device=None) -> torch.Tensor:
    """One-shot ``A \\ b``.  Untransposed square solves factor ``[A | b]``
    as one fat LU, so the forward substitution falls out of the
    factorization and only the upper solve remains; ``trans`` solves
    compose :func:`~.lu.lu` and :func:`lu_solve`.  A half ``A`` is
    promoted to float32 for the whole solve and the solution rounded
    back."""
    from .lu import (
        _check_info,
        _dispatch_factor,
        _resolve_check,
        default_config,
        dispatch_route,
        lu,
        normalize_pivot,
    )
    from ..ops.panel import panel_factor
    from ..utils.config import resolve_device

    trans = normalize_trans(trans)
    pivot = normalize_pivot(pivot)
    dev = resolve_device(device)
    A = torch.as_tensor(A, device=dev)
    b = torch.as_tensor(b, device=dev)
    if A.dtype in HALF_DTYPES:
        x = solve(A.float(), b.to(A.dtype).float(), pivot, trans=trans,
                  check=check, config=config, device=dev)
        return x.to(A.dtype)
    if trans != 0 or A.ndim != 2 or A.shape[0] != A.shape[1]:
        F = lu(A, pivot, check=check, config=config, device=dev)
        return lu_solve(F, b, trans)
    cfg = config or default_config()
    n = A.shape[0]
    vec = b.ndim == 1
    B = (b[:, None] if vec else b).to(A.dtype)
    Ab = torch.cat([A, B], dim=1)
    with full_matmul_precision():
        if dispatch_route(A.shape, A.dtype, pivot, cfg) == "whole":
            f, _, _, info = panel_factor(Ab, pivot, cfg)
        else:
            f, _, _, info = _dispatch_factor(Ab, pivot, cfg)
        x = trsm.solve_upper(f[:, :n], f[:, n:], cfg.trsm_block)
    if _resolve_check(check):
        _check_info(info, pivot)
    return x[:, 0] if vec else x
