"""Solves with a computed LU: ``lu_solve``, ``ldiv``, ``lu_solve_refined``
and the one-shot ``solve``.

A pivoted solve gathers the right-hand side by the composed permutation,
then runs the unit-lower and the upper triangular solves; a no-pivot
solve skips the gather.  Both triangles are solved by substitution
(``trsm.substitute``, xTRSM): on an H100 with one right-hand side it takes
0.20 / 0.57 / 1.22 ms a replayed solve at n = 1536 / 4096 / 8192 in float32
(0.71 at 4096 in float64) where ``trsm``'s inverted diagonal blocks took
0.58 / 1.05 / 1.80 (1.16), and eagerly a tenth or less of their time (PERF.md §6).
``trans`` accepts 'N'/False/0 (``A x = b``),
'T'/True/1 (``A^T x = b``) and 'H'/2 (``A^H x = b``, the conjugated
factors for complex types).  Solves run on the factorization's device.

Half factors (bfloat16/float16, as the ``promote`` route stores them):
the right-hand side takes the factors' type, as in the JAX package, but
the substitutions run in float32 and the solution is rounded back to
the half type.  PyTorch lacks several half operations on the CPU, and
one rule on both devices keeps the CPU tests valid for the card.

Compiled programs: ``lu_solve`` / ``ldiv`` (``_lu_solve_impl``),
``lu_solve_refined`` (``_lu_solve_refined_impl``) and the fused ``solve``
(``_solve_fused_impl``) are the counterparts of the JAX package's jitted
functions of the same names, keyed as they are: the tensors' shapes,
dtypes and device, ``pivoted`` and ``trans`` (and ``iters``, or ``pivot``
and ``config``).  A key that ``utils.warmup.warmup`` captured runs as the
replay of its CUDA graph (utils/graphs.py), any other key eagerly.

Spans (``utils/profiling.py``): ``solve.permute`` (the gather by the
permutation), ``solve.forward`` and ``solve.backward`` (the two
substitutions, in the order they run).
"""

from __future__ import annotations

import torch

from ..ops import trsm
from ..utils import graphs
from ..utils.config import HALF_DTYPES, full_matmul_precision
from ..utils.perm import invert_perm
from ..utils.profiling import span


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
            with span("solve.permute", factors):
                B = B[perm.long()]
        with span("solve.forward", factors):
            y = trsm.substitute(factors, B, upper=False, unit=True)
        with span("solve.backward", factors):
            x = trsm.substitute(factors, y, upper=True)
    else:
        # A = P^T L U  =>  A^T x = b  <=>  U^T y = b, L^T z = y, x = P^T z
        ft = factors.T
        if trans == 2 and factors.dtype.is_complex:
            ft = ft.conj()
        with span("solve.forward", factors):
            y = trsm.substitute(ft, B, upper=False)
        with span("solve.backward", factors):
            x = trsm.substitute(ft, y, upper=True, unit=True)
        if pivoted:
            with span("solve.permute", factors):
                x = x[invert_perm(perm).long()]
    return x[:, 0] if vec else x


def _rhs(lu_res, b) -> torch.Tensor:
    return torch.as_tensor(b, device=lu_res.factors.device)


def lu_solve(lu_res, b, trans=0) -> torch.Tensor:
    """Solve ``A x = b`` given ``lu_res = lu(A)``; ``b`` moves to the
    factorization's device."""
    perm = lu_res.p if lu_res.pivoted else lu_res.ipiv
    return graphs.call("lu_solve", _lu_solve_impl, (lu_res.factors, perm, _rhs(lu_res, b)),
                       (lu_res.pivoted, normalize_trans(trans)))


def ldiv(lu_res, b) -> torch.Tensor:
    """Reference-style name (``ldiv!``): left-division by the factored A."""
    return lu_solve(lu_res, b)


def lu_solve_refined(lu_res, A, b, iters: int = 2, trans=0) -> torch.Tensor:
    """Solve with ``iters`` steps of iterative refinement,
    ``x += A \\ (b - A x)``, re-using the factorization.  The companion of
    the reduced-precision Schur modes; the residual product runs with
    TF32 off (for half factors in float32, rounded back at the end).  Where
    ``A`` is wider than the factors (float32 factors of a float64 ``A``), x
    and the residual are kept in ``A``'s type and each correction is solved
    in the factors' (the fixed-step form of ``mixed_lu_solve``)."""
    perm = lu_res.p if lu_res.pivoted else lu_res.ipiv
    A = torch.as_tensor(A, device=lu_res.factors.device)
    return graphs.call("lu_solve_refined", _lu_solve_refined_impl,
                       (lu_res.factors, perm, A, _rhs(lu_res, b)),
                       (lu_res.pivoted, normalize_trans(trans), iters))


@full_matmul_precision()
def _lu_solve_refined_impl(factors, perm, A, b, pivoted: bool, trans: int, iters: int):
    if factors.dtype in HALF_DTYPES:
        x = _lu_solve_refined_impl(factors.float(), perm, A.float(), b.float(), pivoted,
                                   trans, iters)
        return x.to(factors.dtype)
    if not (A.dtype.is_floating_point or A.dtype.is_complex):
        A = A.to(factors.dtype)  # an integer matrix's factors are float64
    # x and r in the wider of the two types; each correction in the factors'
    work = torch.promote_types(A.dtype, factors.dtype)
    x = _lu_solve_impl(factors, perm, b, pivoted, trans).to(work)
    bm = b if b.ndim > 1 else b[:, None]
    op = (A if trans == 0 else (A.T if trans == 1 else A.conj().T)).to(work)
    for _ in range(iters):
        xm = x if x.ndim > 1 else x[:, None]
        r = bm.to(work) - op @ xm
        r = r if b.ndim > 1 else r[:, 0]
        x = x + _lu_solve_impl(factors, perm, r, pivoted, trans).to(work)
    return x


def solve(A, b, pivot=True, *, trans=0, check="auto", config=None,
          device=None) -> torch.Tensor:
    """One-shot ``A \\ b``.  Untransposed square solves factor ``[A | b]``
    as one fat LU, so the forward substitution falls out of the
    factorization and only the upper solve remains; ``trans`` solves
    compose :func:`~.lu.lu` and :func:`lu_solve`.  A half ``A`` is
    promoted to float32 for the whole solve and the solution rounded
    back."""
    from .lu import _check_info, _resolve_check, default_config, lu, normalize_pivot
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
    if not (A.dtype.is_floating_point or A.dtype.is_complex):
        A = A.to(torch.float64)  # the generic route: integer and bool as float64
    if trans != 0 or A.ndim != 2 or A.shape[0] != A.shape[1]:
        F = lu(A, pivot, check=check, config=config, device=dev)
        return lu_solve(F, b, trans)
    vec = b.ndim == 1
    B = (b[:, None] if vec else b).to(A.dtype)
    x, info = graphs.call("solve", _solve_fused_impl, (A, B), (pivot, config or default_config()))
    if _resolve_check(check):
        _check_info(info, pivot)
    return x[:, 0] if vec else x


@full_matmul_precision()
def _solve_fused_impl(A, B, pivot: bool, config):
    """The fused solve's program: ``(x, info)`` of ``[A | B]``'s fat LU
    and the upper solve."""
    from .lu import _dispatch_factor, dispatch_route
    from ..ops.panel import panel_factor

    n = A.shape[0]
    Ab = torch.cat([A, B], dim=1)
    if dispatch_route(A.shape, A.dtype, pivot, config) == "whole":
        f, _, _, info = panel_factor(Ab, pivot, config)
    else:
        f, _, _, info = _dispatch_factor(Ab, pivot, config)
    with span("solve.backward", A):
        return trsm.solve_upper(f[:, :n], f[:, n:], config.trsm_block), info
