"""The plain reference of dense LU with partial pivoting and the solve with
it, and the judge of a factorization and a solution by what they say.

Plain PyTorch and NumPy only: nothing of the program under test (nor of
JAX).  It takes single matrices (n, n) and batches (B, n, n) alike.

* :func:`lu_factor`: a right-looking blocked LU in the LAPACK convention
  (``ipiv[k]`` the 0-based row swapped with row k at step k, ``info`` 0 or
  the 1-based first zero pivot).  ``tf32=True`` rounds the operands of
  every update's products (the panel's rank-1 updates and the trailing
  matrix products) to TF32 (10 explicit mantissa bits), as float32
  products with TF32 on do: the lower precision that serves as the
  control.
* :func:`lu_solve`: the row swaps, then both triangular solves.
* :func:`judge`: the numbers a run is held to, worst over the systems:
  the factorization's and the solution's scaled residuals and the
  solution's componentwise backward error, worked out in float64 from the
  inputs the run handed the program and the program's outputs; the
  largest multiplier (partial pivoting keeps it at 1 or below); pivots out
  of range; info against the factors' own diagonal.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BLOCK = 32  # columns per panel of the reference's blocked LU, at most


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits (to
    nearest, ties away from zero), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _operands(a: torch.Tensor, b: torch.Tensor, tf32: bool):
    if tf32 and a.dtype == torch.float32:
        return round_tf32(a), round_tf32(b)
    return a, b


def _matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    # PyTorch's default keeps TF32 off for float32 products; operands that
    # are already TF32 values give the same product either way
    a, b = _operands(a, b, tf32)
    return a @ b


def lu_factor(A: torch.Tensor, tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(factors, ipiv int32, info int32) of A (n, n) or (B, n, n)."""
    single = A.dim() == 2
    F = (A[None] if single else A).clone()
    B, n, _ = F.shape
    rows = torch.arange(B, device=F.device)
    ipiv = torch.empty((B, n), dtype=torch.int64, device=F.device)
    info = torch.zeros(B, dtype=torch.int64, device=F.device)
    nb = max(1, min(BLOCK, n // 4))
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        for k in range(k0, k1):
            p = k + F[:, k:, k].abs().argmax(dim=1)
            ipiv[:, k] = p
            row_k, row_p = F[rows, k].clone(), F[rows, p].clone()
            F[rows, p] = row_k
            F[rows, k] = row_p
            piv = F[:, k, k]
            zero = piv == 0
            info = torch.where((info == 0) & zero, torch.full_like(info, k + 1), info)
            F[:, k + 1:, k] /= torch.where(zero, torch.ones_like(piv), piv)[:, None]
            col, row = _operands(F[:, k + 1:, k:k + 1], F[:, k:k + 1, k + 1:k1], tf32)
            F[:, k + 1:, k + 1:k1] -= col * row
        if k1 < n:
            L11 = F[:, k0:k1, k0:k1]
            F[:, k0:k1, k1:] = torch.linalg.solve_triangular(
                L11, F[:, k0:k1, k1:], upper=False, unitriangular=True)
            F[:, k1:, k1:] -= _matmul(F[:, k1:, k0:k1], F[:, k0:k1, k1:], tf32)
    out = (F, ipiv.to(torch.int32), info.to(torch.int32))
    return tuple(t[0] for t in out) if single else out


def lu_solve(factors: torch.Tensor, ipiv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b from :func:`lu_factor`'s results; b (n,) or (B, n)."""
    single = factors.dim() == 2
    F = factors[None] if single else factors
    y = (b[None] if single else b).clone().to(F.dtype)
    B, n, _ = F.shape
    rows = torch.arange(B, device=F.device)
    piv = (ipiv[None] if single else ipiv).long()
    for k in range(piv.shape[1]):
        p = piv[:, k]
        yk, yp = y[rows, k].clone(), y[rows, p].clone()
        y[rows, p] = yk
        y[rows, k] = yp
    y = torch.linalg.solve_triangular(F, y[..., None], upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(F, y, upper=True)[..., 0]
    return x[0] if single else x


def unit_roundoff(dtype: torch.dtype) -> float:
    """LAPACK's xLAMCH('E'): 2^-24 for float32, 2^-53 for float64."""
    return torch.finfo(dtype).eps / 2


def _perm_from_ipiv(ipiv: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """Row order after the swaps, per system, and the count of pivots out
    of [k, n) (those are clipped so that the order can be formed)."""
    B, k = ipiv.shape
    bad = int(((ipiv < np.arange(k)) | (ipiv >= n)).sum())
    ip = np.clip(ipiv, 0, n - 1)
    perm = np.tile(np.arange(n), (B, 1))
    r = np.arange(B)
    for j in range(k):
        a = perm[r, j].copy()
        perm[r, j] = perm[r, ip[:, j]]
        perm[r, ip[:, j]] = a
    return perm, bad


def _norm(R: torch.Tensor, which: str) -> torch.Tensor:
    """Per-system norm of (B, n, m) or (B, n): '1' (largest column sum),
    'inf' (largest row sum), 'fro'."""
    if R.dim() == 2:
        R = R[..., None]
    if which == "1":
        return R.abs().sum(dim=1).amax(dim=1)
    if which == "inf":
        return R.abs().sum(dim=2).amax(dim=1)
    return R.pow(2).sum(dim=(1, 2)).sqrt()


def judge(A, b, factors, ipiv, info, x, measures: Dict[str, str], dtype: torch.dtype,
          block: int = 1024) -> Dict[str, float]:
    """The numbers of one call, worst over its systems, in float64, ``block``
    systems at a time.  ``measures['factor']``: ``'lapack_dget01'``
    (||LU - PA||_1 / (n ||A||_1 eps)) or ``'magma_getrf'`` (||PA - LU||_F /
    (n ||A||_F eps)); ``measures['solve']``: ``'hpl'`` (||Ax - b||_inf /
    (eps (||A||_inf ||x||_inf + ||b||_inf) n)) or ``'magma_gesv'``
    (||b - Ax||_inf / (n ||A||_inf ||x||_inf eps)); eps is ``dtype``'s
    unit roundoff.  ``solve_backward_error``: LAPACK's componentwise
    backward error (xGERFS's BERR), max_i |Ax - b|_i / (|A| |x| + |b|)_i,
    in units of eps."""
    single = A.dim() == 2
    if single:
        A, b, factors, ipiv, info, x = (t[None] for t in (A, b, factors, ipiv, info, x))
    B, n, _ = A.shape
    eps = unit_roundoff(dtype)
    perm, bad_pivots = _perm_from_ipiv(ipiv.cpu().numpy().astype(np.int64), n)
    perm = torch.as_tensor(perm, device=A.device)
    worst = {"factor_residual": 0.0, "solve_residual": 0.0, "solve_backward_error": 0.0,
             "max_abs_l": 0.0}
    info_bad = 0
    info_host = info.cpu().numpy().reshape(B)
    for s in range(0, B, block):
        e = min(B, s + block)
        A64 = A[s:e].double()
        F = factors[s:e].double()
        L = torch.tril(F, -1) + torch.eye(n, dtype=F.dtype, device=F.device)
        U = torch.triu(F)
        PA = A64.gather(1, perm[s:e, :, None].expand(-1, -1, n))
        R = L @ U - PA
        if measures["factor"] == "lapack_dget01":
            fr = _norm(R, "1") / (n * _norm(A64, "1") * eps)
        elif measures["factor"] == "magma_getrf":
            fr = _norm(R, "fro") / (n * _norm(A64, "fro") * eps)
        else:
            raise ValueError(f"unknown factor measure {measures['factor']!r}")
        x64, b64 = x[s:e].double(), b[s:e].double()
        r = (A64 @ x64[..., None])[..., 0] - b64
        a_inf, x_inf = _norm(A64, "inf"), x64.abs().amax(dim=1)
        if measures["solve"] == "hpl":
            sr = r.abs().amax(dim=1) / (eps * (a_inf * x_inf + b64.abs().amax(dim=1)) * n)
        elif measures["solve"] == "magma_gesv":
            sr = r.abs().amax(dim=1) / (n * a_inf * x_inf * eps)
        else:
            raise ValueError(f"unknown solve measure {measures['solve']!r}")
        be = (r.abs() / ((A64.abs() @ x64.abs()[..., None])[..., 0] + b64.abs())).amax(dim=1) / eps
        ml = torch.tril(F, -1).abs().amax(dim=(1, 2)) if n > 1 else torch.zeros(e - s)
        for key, v in (("factor_residual", fr), ("solve_residual", sr),
                       ("solve_backward_error", be), ("max_abs_l", ml)):
            worst[key] = _worse(worst[key], v.max().item())
        diag = torch.diagonal(U, dim1=1, dim2=2) == 0
        first = torch.where(diag.any(dim=1), diag.int().argmax(dim=1) + 1,
                            torch.zeros(e - s, dtype=torch.long, device=diag.device))
        info_bad += int((first.cpu().numpy() != info_host[s:e]).sum())
    worst["pivots_out_of_range"] = float(bad_pivots)
    worst["info_mismatch"] = float(info_bad)
    return worst


def _worse(a: float, b: float) -> float:
    """The larger of two readings, NaN counting as the worst."""
    if a != a or b != b:
        return float("nan")
    return max(a, b)
