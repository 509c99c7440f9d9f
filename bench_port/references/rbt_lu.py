"""The plain reference of the random butterfly transform (RBT) solve (the
``rbt_f32`` configuration: MAGMA's ``magma_sgesv_rbt``, LAWN 246), and the
judge of a transformed factorization and a solution by what they say.

Plain PyTorch only: nothing of the program under test (nor of JAX).  It
takes single matrices (n, n), in their own type, with TF32 off while it
runs (``dense_lu_f64._tf32_off``).

* :func:`butterfly_values`: the 4n values of the depth-2 transform by the
  recipe the program documents: a CPU ``torch.Generator`` seeded 888, 4n
  float64 draws of U(-0.05, 0.1), ``exp(.) / 2``, cast to the matrix's
  type; n is the order padded to a multiple of 4.
* :func:`butterflies`: dense ``U = Bu2 Bu1`` and ``V = Bv2 Bv1`` from them
  (``B(x) = [[diag(x_u), diag(x_l)], [diag(x_u), -diag(x_l)]]``, level 2
  block-diagonal), so that the transform is formed by products, not by the
  program's radix code.
* :func:`lu_factor`: ``A~ = U^T A V`` of A padded to a multiple of 4 (the
  identity on the new diagonal block), then LU without pivoting, blocked
  as ``dense_lu.lu_factor`` (panels of at most 32 columns by rank-1
  updates, a triangular solve and a product for the rest).  ``ipiv`` is
  the identity; ``info`` 0, or minus the 1-based first zero pivot (the
  program's no-pivot convention).  ``tf32=True`` rounds the operands of
  every product, the transform's and the solve's included, to TF32: the
  control.
* :func:`solve`: ``x = V U~^-1 L~^-1 U^T b``, b padded with zeros, cut
  back to b's rows, then ``refine`` steps of iterative refinement in
  working precision (``r = b - A x``, ``x += V U~^-1 L~^-1 U^T r``), as the
  entry's solve and MAGMA's ``gesv_rbt`` refine; ``REFINE`` is the
  configuration's ``refine`` (``configs/rbt_f32.json``), which the entry
  reads too.  :func:`lu_solve` is this interface's (``bench_port/control.py``'s)
  solve, which hands it only the factors: :func:`lu_factor` hangs A, and
  whether its products were TF32, on the factors' tensor (``rbt_matrix``,
  ``rbt_tf32``), and :func:`lu_solve` refuses factors without them.
  Departure from MAGMA: a fixed number of steps, where MAGMA refines until
  its stopping test.
* :func:`judge`: the numbers a run is held to, in float64 from the inputs
  the run handed the program and the program's outputs: the factors'
  residual against ``A~`` recomputed here, the solution's HPL residual
  against A, how far the solution lies from the refined solve of the
  program's own factors (``solve_backward_error``, below), the largest
  multiplier (without pivoting it is not bounded by 1: RBT's growth), the
  pivots that are not the identity, and info against the factors' own
  diagonal.

The factors' residual is LAPACK's xGET01 form with ``|| |L| |U| ||_1`` in
place of ``||A~||_1`` (``genp_backward``): LU without pivoting computed in
a precision of unit roundoff eps satisfies ``L U = A~ + E`` with ``|E| <=
n eps |L| |U|`` (Higham, Accuracy and Stability of Numerical Algorithms,
Thm 9.3), so the number reads the rounding of the factorization itself,
at most about 1, whatever the growth.  Against ``||A~||_1`` it would read
the growth too: RBT's multipliers reach 10^6 at n = 4096 on HPL's matrix,
and that form's readings spread over three orders of magnitude and meet
the TF32 control's at small n (PERF.md).

The solve is held to the program's own factors (``refined_steps``, in the
``solve_backward_error`` slot, since the harness compares the same six
numbers in every configuration): ``x^_0 = V (L U)^-1 U^T b`` and
``x^_j = x^_{j-1} + V (L U)^-1 U^T (b - A x^_{j-1})``, all in float64 from
the factors the program returned, and with k = ``REFINE`` the number is
``||x - x^_k||_inf / min(||x - x^_{k-1}||_inf, ||x^_k||_inf)``.  A solution
refined from these factors in working precision lies nearer ``x^_k`` than
``x^_{k-1}``; one that skipped a step sits near ``x^_{k-1}``; one solved in
a lower precision, from other factors or with an entry altered lies far
from ``x^_k`` for its size.  That holds where the exact refinement
contracts, ``||x^_{k+1} - x^_k|| <= CONTRACTS ||x^_k - x^_{k-1}||``; where
it does not (RBT's growth on some HPL matrices at n = 4096 leaves the
unrefined solve without digits, and a step does not reliably improve it)
no solution can be told refined, and the number reads 0 unless it is not
finite.  HPL's residual and LAPACK's componentwise backward error tell
none of these apart at n = 4096 (PERF.md).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, Tuple

import torch

SEED = 888  # the program's default; MAGMA draws its own
# refinement steps of a solve: the configuration's, which the entry reads too
REFINE = int(json.loads((Path(__file__).resolve().parent.parent / "configs" / "rbt_f32.json")
                        .read_text())["refine"])


def _load_sibling(name: str):
    """A module of this folder by file, without importing the benchmark's
    package (a reference stands alone)."""
    spec = importlib.util.spec_from_file_location(f"_{name}_of_rbt_lu",
                                                  Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the exact refinement's contraction per step below which a system can tell
# a refined solution from an unrefined one (judge)
CONTRACTS = 0.25

_DENSE = _load_sibling("dense_lu")
_TF32_OFF = _load_sibling("dense_lu_f64")._tf32_off
BLOCK = _DENSE.BLOCK
_worse = _DENSE._worse


def padded(n: int) -> int:
    return n + (-n) % 4


def butterfly_values(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The 4n values of the padded order n: ``exp(U(-0.05, 0.1)) / 2``."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    u = torch.rand(4 * n, generator=gen, dtype=torch.float64) * 0.15 - 0.05
    return (torch.exp(u) * 0.5).to(device=device, dtype=dtype)


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[0] // 2
    du, dl = torch.diag(x[:h]), torch.diag(x[h:])
    return torch.cat([torch.cat([du, dl], dim=1), torch.cat([du, -dl], dim=1)], dim=0)


def butterflies(uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (U, V) of the depth-2 transform from the 4n values, in their
    type (each entry of U and V is one product of two values)."""
    n = uv.shape[0] // 4
    h = n // 2
    with _TF32_OFF():
        U = torch.block_diag(_butterfly(uv[:h]), _butterfly(uv[n:n + h])) @ _butterfly(
            uv[2 * n:3 * n])
        V = torch.block_diag(_butterfly(uv[h:n]), _butterfly(uv[n + h:2 * n])) @ _butterfly(
            uv[3 * n:4 * n])
    return U, V


def _pad(A: torch.Tensor) -> torch.Tensor:
    n = A.shape[-1]
    m = padded(n)
    if m == n:
        return A
    P = torch.zeros(m, m, dtype=A.dtype, device=A.device)
    P[:n, :n] = A
    P.diagonal()[n:] = 1
    return P


def transformed(A: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``U^T A V`` of A padded, in A's type, by two dense products."""
    Ap = _pad(A)
    U, V = butterflies(butterfly_values(Ap.shape[0], Ap.dtype, Ap.device))
    with _TF32_OFF():
        return _DENSE._matmul(_DENSE._matmul(U.T, Ap, tf32), V, tf32)


def lu_factor(A: torch.Tensor, tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(factors of ``A~`` at the padded order, ipiv int32 (the identity),
    info int32) of A (n, n); ``tf32=True``: every product's operands in
    TF32 (the control)."""
    F = transformed(A, tf32).clone()
    n = F.shape[0]
    info = torch.zeros((), dtype=torch.int64, device=F.device)
    nb = max(1, min(BLOCK, n // 4))
    with _TF32_OFF():
        for k0 in range(0, n, nb):
            k1 = min(n, k0 + nb)
            for k in range(k0, k1):
                piv = F[k, k]
                zero = piv == 0
                info = torch.where((info == 0) & zero, torch.full_like(info, -(k + 1)), info)
                F[k + 1:, k] /= torch.where(zero, torch.ones_like(piv), piv)
                col, row = _DENSE._operands(F[k + 1:, k:k + 1], F[k:k + 1, k + 1:k1], tf32)
                F[k + 1:, k + 1:k1] -= col * row
            if k1 < n:
                F[k0:k1, k1:] = torch.linalg.solve_triangular(
                    F[k0:k1, k0:k1], F[k0:k1, k1:], upper=False, unitriangular=True)
                F[k1:, k1:] -= _DENSE._matmul(F[k1:, k0:k1], F[k0:k1, k1:], tf32)
    # for the solve's refinement and products (module docstring)
    F.rbt_matrix, F.rbt_tf32 = A, tf32
    return F, torch.arange(n, dtype=torch.int32, device=F.device), info.to(torch.int32)


def _apply(factors, U, V, b, tf32):
    """``V U~^-1 L~^-1 U^T b`` for b of at most the factors' order."""
    m, n = factors.shape[0], b.shape[0]
    y = torch.zeros(m, 1, dtype=factors.dtype, device=factors.device)
    y[:n, 0] = b.to(factors.dtype)
    y = _DENSE._matmul(U.T, y, tf32)
    y = torch.linalg.solve_triangular(factors, y, upper=False, unitriangular=True)
    y = torch.linalg.solve_triangular(factors, y, upper=True)
    return _DENSE._matmul(V, y, tf32)[:n, 0]


def solve(factors: torch.Tensor, b: torch.Tensor, A=None, *, refine: int = REFINE,
          tf32: bool = False) -> torch.Tensor:
    """x with A x = b from :func:`lu_factor`'s factors, refined ``refine``
    steps against ``A`` (needed when ``refine`` > 0); b (n,) with n the
    matrix's order, at most the factors' padded one."""
    if refine and A is None:
        raise ValueError("refinement needs the matrix A")
    U, V = butterflies(butterfly_values(factors.shape[0], factors.dtype, factors.device))
    with _TF32_OFF():
        x = _apply(factors, U, V, b, tf32)
        for _ in range(refine):
            Ax = _DENSE._matmul(A.to(x.dtype), x[:, None], tf32)[:, 0]
            x = x + _apply(factors, U, V, b.to(x.dtype) - Ax, tf32)
        return x


def lu_solve(factors: torch.Tensor, ipiv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`solve` of :func:`lu_factor`'s results, refined ``REFINE``
    steps against the A the factors carry, in the precision of their
    products."""
    if not hasattr(factors, "rbt_matrix"):
        raise ValueError("factors without their matrix (rbt_matrix): lu_factor's own are needed")
    return solve(factors, b, factors.rbt_matrix, tf32=factors.rbt_tf32)


def refined_steps(factors: torch.Tensor, A: torch.Tensor, b: torch.Tensor, steps: int,
                  dtype: torch.dtype):
    """``[x^_0, ..., x^_steps]`` in float64 from ``factors`` (the packed LU
    of ``A~`` at the padded order, the butterflies those of ``dtype``'s
    values), each cut back to b's rows."""
    m, n = factors.shape[-1], b.shape[0]
    with _TF32_OFF():
        U, V = butterflies(butterfly_values(m, dtype, factors.device).double())
        F = factors.double()
        Ap = _pad(A.double())
        bp = torch.zeros(m, 1, dtype=torch.float64, device=F.device)
        bp[:n, 0] = b.double()

        def apply(r):
            y = torch.linalg.solve_triangular(F, U.T @ r, upper=False, unitriangular=True)
            return V @ torch.linalg.solve_triangular(F, y, upper=True)

        xs = [apply(bp)]
        for _ in range(steps):
            xs.append(xs[-1] + apply(bp - Ap @ xs[-1]))
    return [x[:n, 0] for x in xs]


def judge(A, b, factors, ipiv, info, x, measures: Dict[str, str], dtype: torch.dtype,
          block: int = 1024) -> Dict[str, float]:
    """The numbers of one call, in float64.  ``measures['factor']`` must be
    ``'genp_backward'``: ||L U - A~||_1 / (m eps || |L| |U| ||_1) with ``A~ =
    U^T A V`` of the padded order m formed here in float64 from the values
    of ``dtype`` (module docstring); ``measures['solve']`` ``'hpl'``: ||A x
    - b||_inf / (eps (||A||_inf ||x||_inf + ||b||_inf) n); eps is
    ``dtype``'s unit roundoff; ``measures['refinement']``
    ``'refined_steps'``: ``solve_backward_error`` is ||x - x^_k||_inf /
    min(||x - x^_{k-1}||_inf, ||x^_k||_inf) with k = ``REFINE`` and the x^
    of :func:`refined_steps` from ``factors``, 0 where their refinement
    contracts by less than ``CONTRACTS`` a step and the number is finite
    (module docstring).  Where the factors hold a zero pivot (A~ has no LU;
    the program reports it in ``info``), the factors' residual reads the
    columns before the pivot and the pivot's down to it, the multipliers
    those before it,
    and the two solve numbers 0: no solution is promised (LAPACK's xGETRS
    is not called after such an info).  ``block`` is unused (one system)."""
    if (measures.get("factor") != "genp_backward" or measures.get("solve") != "hpl"
            or measures.get("refinement") != "refined_steps"):
        raise ValueError(f"unknown measures {measures!r}")
    if REFINE < 1:
        raise ValueError("refined_steps holds a refined solve: refine must be at least 1")
    eps = _DENSE.unit_roundoff(dtype)
    n = A.shape[-1]
    m = factors.shape[-1]
    F = factors.double()
    diag = torch.diagonal(F) == 0
    first = int(diag.int().argmax()) + 1 if bool(diag.any()) else 0
    with _TF32_OFF():
        uv = butterfly_values(m, dtype, A.device).double()
        U, V = butterflies(uv)
        At = U.T @ _pad(A.double()) @ V
        L = torch.tril(F, -1) + torch.eye(m, dtype=F.dtype, device=F.device)
        Uf = torch.triu(F)
        R = L @ Uf - At
        LU = L.abs() @ Uf.abs()
        if first:
            # a zero pivot at step k: A~ has no LU.  The columns before it
            # must hold, and the pivot's column down to the pivot (R_kk is
            # minus the Schur complement's entry, which must be 0); below
            # the pivot and past its column the program may leave anything
            k = first - 1
            held = torch.zeros_like(R, dtype=torch.bool)
            held[:, :k] = True
            held[:first, k] = True
            R, LU = R * held, LU * held
        fr = _DENSE._norm(R[None], "1") / (m * eps * _DENSE._norm(LU[None], "1"))
        A64, x64, b64 = A.double(), x.double(), b.double()
        r = A64 @ x64 - b64
        sr = r.abs().max() / (eps * (A64.abs().sum(1).max() * x64.abs().max()
                                     + b64.abs().max()) * n)
        before, last, after = refined_steps(factors, A, b, REFINE + 1, dtype)[-3:]
        rs = (x64 - last).abs().max() / torch.minimum((x64 - before).abs().max(),
                                                      last.abs().max())
        # the exact refinement's contraction: where it is slow, no solution
        # can be told refined, and only a solution that is not finite counts
        slow = not bool((after - last).abs().max() <= CONTRACTS * (last - before).abs().max())
        if slow and bool(torch.isfinite(rs)):
            rs = torch.zeros(())
    if first:  # no solution is promised past a zero pivot (xGETRS is not called)
        sr = rs = torch.zeros(())
    # the multipliers of the steps taken (all of them, or those before a zero pivot)
    taken = torch.tril(F, -1)[:, :first - 1] if first else torch.tril(F, -1)
    ml = taken.abs().max() if taken.numel() else torch.zeros(())
    steps = torch.arange(ipiv.shape[0], device=ipiv.device)
    bad_pivots = int((ipiv.long() != steps).sum())
    return {"factor_residual": float(fr), "solve_residual": float(sr),
            "solve_backward_error": float(rs), "max_abs_l": float(ml),
            "pivots_out_of_range": float(bad_pivots),
            "info_mismatch": float(abs(int(info)) != first)}
