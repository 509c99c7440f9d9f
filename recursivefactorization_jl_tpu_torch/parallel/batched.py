"""Batched LU and solves: the batch is a first-class axis.

The PyTorch counterpart of the JAX package's parallel/batched.py:

* :func:`batched_lu_factor` -- (B, m, n) -> ``(factors, ipiv, info)`` with
  the exact LAPACK swap sequence per matrix;
* :func:`batched_lu_factor_perm` -- square batches -> ``(factors, perm,
  info)`` with ``L @ U == A[perm, :]``;
* :func:`batched_lu_solve` / :func:`batched_lu_solve_perm` -- solves with
  either result, ``b`` (B, n) or (B, n, k).

Routing on the card: f32/f64 batches with ``0 < min(m, n) <= 128`` whose
matrix fits one block's shared memory run the Hopper kernels
(ops/batched_kernel.py).  What the LU kernel refuses goes to batched
``torch.linalg.lu_factor_ex`` when pivoted and to a loop of the package's
own ``lu_factor_p`` when not; what the solve kernel refuses (``trans``,
n > 128) gathers by the permutation and runs batched
``torch.linalg.solve_triangular`` with TF32 off.  Complex batches take
those library routes on both devices (the JAX package sends complex64
batches to its platform LU; there is no complex batched kernel).  Half
batches (bfloat16/float16) are promoted to float32, run the float32
routes, kernels included, and the factors or solutions are rounded back.
``backend='xla'`` forces
those library routes; ``backend='pallas'`` forces the kernels and raises
for a shape they cannot run.  On the CPU (``device='cpu'``) the kernels'
plain versions run instead.  ``device=None`` means CUDA and raises
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.lu import lu_factor_p, normalize_pivot
from ..models.solve import normalize_trans
from ..ops import batched_kernel as bk
from ..utils.config import (
    HALF_DTYPES,
    LUConfig,
    default_config,
    full_matmul_precision,
    resolve_device,
)
from ..utils.perm import batched_invert_perm, batched_ipiv_to_perm


def _use_batched_kernel(dtype, m: int, n: int, config: LUConfig) -> bool:
    """Does a (B, m, n) batch of ``dtype`` run the LU kernels (on the
    card) or their plain versions (on the CPU)?  ``backend='xla'`` says
    no; ``backend='pallas'`` says yes and raises ``ValueError`` where the
    kernels cannot run the shape."""
    if config.backend == "xla":
        return False
    takes = bk.lu_kernel_takes(dtype, m, n)
    if config.backend == "pallas" and not takes:
        raise ValueError(
            f"backend='pallas' forces the batched LU kernel, which does not "
            f"take ({m}, {n}) matrices of {dtype}: it needs float32/float64, "
            f"0 < min(m, n) <= {bk.KERNEL_MAX_N} and a matrix that fits one "
            "block's shared memory"
        )
    return takes


def _use_solve_kernel(factors: torch.Tensor, b: torch.Tensor, trans,
                      config: Optional[LUConfig] = None) -> bool:
    """Does this solve run the substitution kernel (its plain version on
    the CPU)?  Untransposed, square, f32/f64, n <= 128, fitting shared
    memory; ``backend='xla'`` says no, ``backend='pallas'`` raises where
    the kernel cannot run it."""
    config = config or default_config()
    if config.backend == "xla":
        return False
    n = factors.shape[1]
    nrhs = 1 if b.dim() == 2 else b.shape[2]
    takes = (
        normalize_trans(trans) == 0
        and factors.shape[1] == factors.shape[2]
        and bk.solve_kernel_takes(factors.dtype, n, nrhs)
    )
    if config.backend == "pallas" and not takes:
        raise ValueError(
            "backend='pallas' forces the batched solve kernel, which does "
            f"not take factors {tuple(factors.shape)} {factors.dtype} with "
            f"{nrhs} right-hand sides and trans={trans!r}"
        )
    return takes


def _as_batch(A, device, square=False, what="batched_lu_factor"):
    A = torch.as_tensor(A, device=resolve_device(device))
    if A.dim() != 3 or (square and A.shape[1] != A.shape[2]):
        want = "(B, n, n)" if square else "(B, m, n)"
        raise ValueError(f"{what} expects {want}, got {tuple(A.shape)}")
    if not (A.dtype.is_floating_point or A.dtype.is_complex):
        raise NotImplementedError(
            f"{what}: {A.dtype} batches are not ported (ROADMAP.md Queue 1 "
            "item 14)"
        )
    return A


def _library_lu(A: torch.Tensor, pivot: bool, config: LUConfig):
    """The routes for batches the kernel refuses on the card: batched
    ``torch.linalg.lu_factor_ex`` (pivoted, or nothing to factor), else a
    loop of ``lu_factor_p`` over the batch.  Returns ``(factors, ipiv,
    perm, info)``."""
    B, m, n = A.shape
    if pivot or B == 0:
        f, piv, info = torch.linalg.lu_factor_ex(A)
        ipiv = (piv - 1).to(torch.int32)
        return f, ipiv, batched_ipiv_to_perm(ipiv, m), info.to(torch.int32)
    # the loop runs the panel kernel whatever backend routed the batch here
    cfg = dataclasses.replace(config, backend="auto")
    parts = [lu_factor_p(A[i], False, config=cfg, device=A.device) for i in range(B)]
    f, ipiv, perm, info = (torch.stack(p) for p in zip(*parts))
    return f, ipiv, perm, info


def _factor(A, pivot, config, want_perm: bool):
    """``(factors, ipiv, perm or None, info)`` by the route of ``A``'s
    shape, dtype and device.

    The kernel route is the swap kernel at every size, with the perm
    composed inside the launch where it is wanted.  Swap/noswap crossover:
    never -- in chip_smoke.py's timing (NVIDIA H100 80GB HBM3, 700 W,
    10 000 f32 matrices, n = 16, 32, 64, 128; PERF.md) the noswap kernel
    won clearly at no size, so it is reached only through
    ``ops.batched_kernel.batched_lu_noswap``."""
    _, m, n = A.shape
    if A.dtype in HALF_DTYPES:
        f, ipiv, perm, info = _factor(A.float(), pivot, config, want_perm)
        return f.to(A.dtype), ipiv, perm, info
    kernel = _use_batched_kernel(A.dtype, m, n, config)
    if A.dtype.is_complex:
        return _library_lu(A, pivot, config)
    if kernel or A.device.type != "cuda":
        # on the CPU the plain versions take every shape
        return bk.batched_lu(A, pivot, want_perm)
    return _library_lu(A, pivot, config)


def batched_lu_factor(
    A, pivot=True, config: Optional[LUConfig] = None, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor a batch ``A`` (B, m, n).  Returns ``(factors (B, m, n), ipiv
    (B, min(m, n)), info (B,))``; per matrix the conventions are those of
    :func:`~..models.lu.lu_factor`.  ``A`` is left unchanged."""
    A = _as_batch(A, device)
    f, ipiv, _, info = _factor(
        A, normalize_pivot(pivot), config or default_config(), False
    )
    return f, ipiv, info


def batched_lu_factor_perm(
    A, pivot=True, config: Optional[LUConfig] = None, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor a batch of square matrices.  Returns ``(factors, perm (B, n),
    info)`` with ``L @ U == A[perm, :]`` per matrix: pair it with
    :func:`batched_lu_solve_perm` for bulk solves, and use
    :func:`batched_lu_factor` where the LAPACK swap sequence is needed.
    The factors are those of :func:`batched_lu_factor` and perm equals
    ``ipiv_to_perm(ipiv)``."""
    A = _as_batch(A, device, square=True, what="batched_lu_factor_perm")
    f, _, perm, info = _factor(
        A, normalize_pivot(pivot), config or default_config(), True
    )
    return f, perm, info


@full_matmul_precision()
def _triangular_solve(factors, perm, b, pivoted: bool, trans: int):
    """The library route of the solves: one gather by the permutation and
    two batched triangular solves."""
    vec = b.dim() == 2
    rhs = (b[:, :, None] if vec else b).to(factors.dtype)
    idx = None
    if pivoted:
        idx = (perm if trans == 0 else batched_invert_perm(perm)).long()
        idx = idx[:, :, None].expand_as(rhs)
    if trans == 0:
        if pivoted:
            rhs = rhs.gather(1, idx)
        y = torch.linalg.solve_triangular(factors, rhs, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(factors, y, upper=True)
    else:
        # A = P^T L U  =>  A^T x = b  <=>  U^T y = b, L^T z = y, x = P^T z
        ft = factors.mT
        if trans == 2 and factors.dtype.is_complex:
            ft = ft.conj()
        y = torch.linalg.solve_triangular(ft, rhs, upper=False)
        x = torch.linalg.solve_triangular(ft, y, upper=True, unitriangular=True)
        if pivoted:
            x = x.gather(1, idx)
    return x[:, :, 0] if vec else x


def _solve(factors, b, pivoted, trans, config, dev, perm=None, ipiv=None):
    """The solve behind both public functions: ``perm`` or ``ipiv`` says
    how ``b``'s rows get into pivot order."""
    factors = torch.as_tensor(factors, device=dev)
    b = torch.as_tensor(b, device=dev)
    if factors.dim() != 3 or factors.shape[1] != factors.shape[2]:
        raise ValueError(
            f"batched solves need square factors (B, n, n), got {tuple(factors.shape)}"
        )
    if b.dim() not in (2, 3) or b.shape[:2] != factors.shape[:2]:
        raise ValueError(
            f"right-hand sides {tuple(b.shape)} do not match factors "
            f"{tuple(factors.shape)}"
        )
    if factors.dtype in HALF_DTYPES:
        x = _solve(factors.float(), b.to(factors.dtype).float(), pivoted,
                   trans, config, dev, perm=perm, ipiv=ipiv)
        return x.to(factors.dtype)
    trans = normalize_trans(trans)
    if not pivoted:
        perm = ipiv = None
    if perm is not None:
        perm = torch.as_tensor(perm, device=dev)
    if ipiv is not None:
        ipiv = torch.as_tensor(ipiv, device=dev)
    config = config or default_config()
    kernel = _use_solve_kernel(factors, b, trans, config)
    if dev.type != "cuda" and config.backend != "xla":
        # the plain substitution takes any n; transposed solves have no
        # kernel and stay with the triangular solves
        kernel = trans == 0 and factors.dtype.is_floating_point
    if kernel and factors.shape[0] > 0:
        return bk.batched_solve(factors, b, perm, ipiv)
    if ipiv is not None:
        perm = batched_ipiv_to_perm(ipiv, factors.shape[1])
    return _triangular_solve(factors, perm, b, pivoted, trans)


def batched_lu_solve_perm(
    factors, perm, b, pivoted: bool = True, trans=False,
    config: Optional[LUConfig] = None, device=None,
) -> torch.Tensor:
    """Solve with the composed permutation of :func:`batched_lu_factor_perm`:
    ``factors`` (B, n, n), ``perm`` (B, n), ``b`` (B, n) or (B, n, k).
    Untransposed solves the kernel takes run in one kernel launch, which
    gathers ``b`` by ``perm`` and does both substitutions; the rest runs
    batched triangular solves.  With ``pivoted=False`` ``perm`` is
    ignored."""
    return _solve(factors, b, pivoted, trans, config, resolve_device(device), perm=perm)


def batched_lu_solve(
    factors, ipiv, b, pivoted: bool = True, trans=False,
    config: Optional[LUConfig] = None, device=None,
) -> torch.Tensor:
    """Solve with the swap sequence of :func:`batched_lu_factor`:
    ``factors`` (B, n, n), ``ipiv`` (B, n), ``b`` (B, n) or (B, n, k).
    On the kernel route the interchanges are applied to ``b`` inside the
    launch; the library route first folds them into a permutation (one
    small step per pivot, no host read)."""
    return _solve(factors, b, pivoted, trans, config, resolve_device(device), ipiv=ipiv)
