"""The plain reference of dense LU with partial pivoting in float64 (the
``lu_f64`` configuration, HPL's own precision), with its float32-update
control.

Plain PyTorch only: nothing of the program under test (nor of JAX).  The
solve and the judge are ``dense_lu.py``'s: they work in float64 already,
and take the unit roundoff from the configuration's dtype.

* :func:`lu_factor`: ``dense_lu.py``'s right-looking blocked LU, in
  float64.  ``tf32`` names the control side of ``control.py`` (the
  precision below the configuration's); here it means *float32 products*:
  every update's products (the panel's rank-1 updates and the trailing
  matrix products) are computed from float32 operands in float32, with
  TF32 off, and returned to float64, where the differences are taken.

Departures from LAPACK ``dgetrf`` (the pivots are its rule, the first
largest |a_ik| as ``idamax`` finds it; the order of the roundings is
not): panels of at most 32 columns factored by rank-1 updates, where
``dgetrf`` factors panels of ILAENV's NB (64) by the recursive
``dgetrf2``; the row swaps applied to the whole row at each step, where
``dgetrf`` swaps the columns left and right of the panel after it
(``dlaswp``; the same rows end in the same places); a zero pivot counted in
``info`` with its column left unscaled, as ``dgetrf2`` does.
"""

from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from typing import Tuple

import torch


def _load_sibling(name: str):
    """A module of this folder by file, without importing the benchmark's
    package (a reference stands alone)."""
    spec = importlib.util.spec_from_file_location(f"_{name}_of_dense_lu_f64",
                                                  Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_BASE = _load_sibling("dense_lu")
BLOCK = _BASE.BLOCK
judge = _BASE.judge
lu_solve = _BASE.lu_solve
_worse = _BASE._worse


@contextlib.contextmanager
def _tf32_off():
    """float32 products in float32: TF32 off for CUDA matmuls and
    convolutions inside the block, the caller's settings restored after.
    Once a caller has set PyTorch's current API (``fp32_precision``), the
    legacy flags (``allow_tf32``) refuse to be read: then that API is set
    to ``'ieee'`` and restored instead."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    try:
        legacy = (matmul.allow_tf32, cudnn.allow_tf32)
    except RuntimeError:
        legacy = None
    if legacy is None:
        saved = (matmul.fp32_precision, cudnn.conv.fp32_precision)
        matmul.fp32_precision = cudnn.conv.fp32_precision = "ieee"
    else:
        matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if legacy is None:
            matmul.fp32_precision, cudnn.conv.fp32_precision = saved
        else:
            matmul.allow_tf32, cudnn.allow_tf32 = legacy


def _product(a: torch.Tensor, b: torch.Tensor, f32: bool, outer: bool) -> torch.Tensor:
    """``a * b`` (``outer``: a column times a row) or ``a @ b``, in the
    operands' float64, or from their float32 roundings in float32 and
    back to float64."""
    if f32:
        a, b = a.float(), b.float()
    p = a * b if outer else a @ b
    return p.double() if f32 else p


def lu_factor(A: torch.Tensor, tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(factors float64, ipiv int32, info int32) of A (n, n) or (B, n, n);
    ``tf32=True``: every update's products in float32 (the control)."""
    single = A.dim() == 2
    F = (A[None] if single else A).double().clone()
    B, n, _ = F.shape
    rows = torch.arange(B, device=F.device)
    ipiv = torch.empty((B, n), dtype=torch.int64, device=F.device)
    info = torch.zeros(B, dtype=torch.int64, device=F.device)
    nb = max(1, min(BLOCK, n // 4))
    with _tf32_off():
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
                F[:, k + 1:, k + 1:k1] -= _product(F[:, k + 1:, k:k + 1], F[:, k:k + 1, k + 1:k1],
                                                   tf32, outer=True)
            if k1 < n:
                L11 = F[:, k0:k1, k0:k1]
                F[:, k0:k1, k1:] = torch.linalg.solve_triangular(
                    L11, F[:, k0:k1, k1:], upper=False, unitriangular=True)
                F[:, k1:, k1:] -= _product(F[:, k1:, k0:k1], F[:, k0:k1, k1:], tf32, outer=False)
    out = (F, ipiv.to(torch.int32), info.to(torch.int32))
    return tuple(t[0] for t in out) if single else out
