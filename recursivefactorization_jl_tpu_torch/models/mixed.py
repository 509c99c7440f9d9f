"""Mixed-precision iterative refinement: a float32 LU refined to float64
accuracy, as LAPACK's ``DSGESV`` solves (LAPACK Working Note 175; cuSOLVER's
``cusolverDnDSgesv`` and MAGMA's ``magma_dsgesv_gpu`` are the same solver).

    F = mixed_lu(A)                             # A float64, never written
    x = mixed_lu_solve(F, b)                    # x float64; b a vector or a matrix
    x, it = mixed_lu_solve(F, b, return_iter=True)   # it: LAPACK's ITER

:func:`mixed_lu` narrows ``A`` to float32 (LAPACK's DLAG2S, with its
overflow flag), takes ``||A||_inf`` in float64 (DLANGE('I')) in the same read,
and factors the copy on the port's float32 path (``_dispatch_factor``, as
``lu`` factors: the panel kernels and the blocked schedule).
:func:`mixed_lu_solve` runs DSGESV's loop: ``x0`` from the float32 solve of
``single(b)`` (row gather and two substitutions, as SGETRS); ``r = b - A x``
in float64; the per-column test ``max|r| <=
max|x| ||A||_inf eps sqrt(n) BWDMAX`` (eps = 2^-53, BWDMAX = 1); each step
narrows r (overflow checked), solves in float32, widens and adds.  ITER is
the number of steps, or LAPACK's codes: -2 an overflow in narrowing A, b or
r, -3 the float32 factorization failed (``info`` not 0), ``-(itermax + 1)``
no convergence in ``itermax`` steps.  On any of them the solve falls back to
LAPACK's way: a float64 LU (``lu`` of ``A``, made once and kept on the
factorization, so ``A`` stays as it was) and its solve.

The float64 passes are two kernels of ``csrc/mixed_refine.cu``
(``ops/mixed_refine.py``): the narrowing and the residual pass, which also
takes ``max|r|``, ``max|x|``, ``single(r)`` and writes the test into a
status pair ``[state, steps]`` on the card.  The CPU runs their tensor twins,
bit for bit the kernels.

Compiled programs (utils/graphs.py): ``mixed_lu`` is one, keyed as
``lu_factor`` is; a first call of a shape inside ``graphs.capturing()``
captures it (``with graphs.capturing(): mixed_lu_solve(mixed_lu(A), b)``
warms the shape), and later calls replay it.  The
solves run eagerly: a step count that depends on the data cannot be one
program, so the host reads the status after the first solve and after each
step (span ``mixed.check``, one device-to-host read) and stops at the first
pass of the test, and a step is some ten launches beside two substitutions
of some 0.25 ms each on the card, where a program of its own would copy A
and the factors into its inputs at every step (PERF.md §5).  Nothing in the
solves reads the device but those checks.

Spans: ``mixed.narrow``, ``mixed.factor`` (inside ``mixed_lu``),
``mixed.solve`` (each float32 solve with its narrowing and widening),
``mixed.residual`` (each residual pass), ``mixed.check`` (the host's read of
the status) and ``mixed.fallback``.  Counts: ``mixed_lu_solve.counts``
(:class:`MixedCounts`), zeroed by ``ops._counts.reset_counts()``.

Departures from DSGESV: the fallback factors a copy of A (DSGESV overwrites
A); the row sums of ``||A||_inf`` and the residual's dot products are added
in the kernels' order (ops/mixed_refine.py), not DLANGE's and DGEMV's; ``x``
and ``b`` are kept as columns of one (n, k) tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import _counts
from ..ops import mixed_refine as mr
from ..utils import graphs
from ..utils.config import LUConfig, default_config
from ..utils.profiling import span
from .lu import LU, _as_matrix, _dispatch_factor, lu
from .solve import _lu_solve_impl, lu_solve

ITERMAX = 30  # DSGESV's ITERMAX


@dataclasses.dataclass
class MixedCounts:
    """The mixed solver's counts.  Host side, every call: ``calls`` of
    :func:`mixed_lu_solve`, ``steps`` (refinement steps taken, summed: ITER
    where it is not negative), ``host_checks`` (reads of the status),
    ``iters`` (ITER -> calls) and ``fallbacks`` (ITER code -> calls).  Like
    the panel counts, ``twin_passes`` (kernel name -> passes of its tensor
    twin) and ``kernel_launches`` (kernel name -> launches, as the kernels'
    wrappers count them, ``ops/mixed_refine.py``) count eager calls and
    captures, never the replays of a captured program."""

    calls: int = 0
    steps: int = 0
    host_checks: int = 0
    iters: dict = dataclasses.field(default_factory=dict)
    fallbacks: dict = dataclasses.field(default_factory=dict)
    twin_passes: dict = dataclasses.field(default_factory=dict)

    @property
    def kernel_launches(self) -> dict:
        launched = {mr.NARROW_KERNEL: mr.narrow_cuda.counts.launches,
                    mr.RESIDUAL_KERNEL: mr.residual_cuda.counts.launches}
        return {name: k for name, k in launched.items() if k}


def _tally(table: dict, key) -> None:
    table[key] = table.get(key, 0) + 1


@dataclasses.dataclass
class MixedLU:
    """A kept mixed-precision factorization (:func:`mixed_lu`): the float32
    ``factors`` of ``single(A)`` with ``ipiv``, ``perm`` and ``info`` (as
    ``lu`` gives them), the float64 ``A`` the residuals are taken against
    (the caller's tensor, held, not copied), ``anrm`` = ``||A||_inf`` (0-d
    float64), ``overflow`` (0-d int32, 1 where narrowing A overflowed) and,
    once a solve fell back, the float64 ``fallback`` factorization of A."""

    factors: torch.Tensor
    ipiv: torch.Tensor
    perm: torch.Tensor
    info: torch.Tensor
    A: torch.Tensor
    anrm: torch.Tensor
    overflow: torch.Tensor
    fallback: Optional[LU] = None

    @property
    def n(self) -> int:
        return self.A.shape[0]


def _narrow(A):
    if mr.takes(A):
        return mr.narrow_cuda(A)
    _tally(mixed_lu_solve.counts.twin_passes, mr.NARROW_KERNEL)
    return mr.narrow_tensor(A)


def _residual(A, x, b, anrm, status, step, itermax):
    if mr.takes(A):
        return mr.residual_cuda(A, x, b, anrm, status, step, itermax)
    _tally(mixed_lu_solve.counts.twin_passes, mr.RESIDUAL_KERNEL)
    return mr.residual_tensor(A, x, b, anrm, status, step, itermax)


def _mixed_lu_impl(A, config: LUConfig):
    """The program of :func:`mixed_lu`: ``(factors, ipiv, perm, info, anrm,
    overflow)``, the float32 workspace factored in place."""
    with span("mixed.narrow", A):
        sa, anrm, overflow = _narrow(A)
    with span("mixed.factor", A):
        factors, ipiv, perm, info = _dispatch_factor(sa, True, config)
    return factors, ipiv, perm, info, anrm, overflow


def mixed_lu(A, *, config: Optional[LUConfig] = None, device=None) -> MixedLU:
    """Narrow the square float64 ``A`` to float32, take ``||A||_inf`` and
    factor the copy with partial pivoting (``config``: the float32 path's,
    default :func:`~..utils.config.default_config`, TF32 off).  ``A`` is not
    written; the result holds it for the refinement's residuals.  Runs by
    the replay of the ``mixed_lu`` program of its key where one was
    captured."""
    A = _as_matrix(A, device)
    mr.check_float64(A, "mixed_lu")
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"mixed_lu needs a square matrix, got {tuple(A.shape)}")
    factors, ipiv, perm, info, anrm, overflow = graphs.call(
        "mixed_lu", _mixed_lu_impl, (A,), (config or default_config(),))
    return MixedLU(factors, ipiv, perm, info, A, anrm, overflow)


def _solve32(factors, perm, rhs):
    """The float32 solve of a narrowed (n, k) right-hand side, widened:
    ``lu_solve``'s own (the rows gathered, both triangles by substitution,
    SGETRS's way), run eagerly, never captured as a program of its own."""
    return _lu_solve_impl(factors, perm, rhs, True).double()


def _first(factors, perm, A, b, anrm, overflow, info, itermax: int):
    """The first solve: ``(x, single(r), status)`` from ``x0``, the float32
    solve of ``single(b)``, and its residual and test.  The status starts at
    -2 where narrowing A or b overflowed, else -3 where the float32
    factorization failed, else 0."""
    with span("mixed.solve", A):
        bad = (overflow != 0) | ((b < -mr.RMAX) | (b > mr.RMAX)).any()
        x = _solve32(factors, perm, b.float())
    state = -2 * bad.int() - 3 * ((~bad) & (info != 0)).int()
    status = torch.stack([state, torch.zeros_like(state)])
    with span("mixed.residual", A):
        _, sr = _residual(A, x, b, anrm, status, False, itermax)
    return x, sr, status


def _step(factors, perm, A, b, anrm, x, sr, status, itermax: int):
    """One refinement step: ``(x, single(r))``, the status updated in place."""
    with span("mixed.solve", A):
        x = x + _solve32(factors, perm, sr)
    with span("mixed.residual", A):
        _, sr = _residual(A, x, b, anrm, status, True, itermax)
    return x, sr


def _check(status, A):
    """The host's read of the status pair ``[state, steps]``."""
    with span("mixed.check", A):
        state, taken = status.tolist()
    mixed_lu_solve.counts.host_checks += 1
    return state, taken


def _fallback(F: MixedLU, b, code: int):
    """LAPACK's fallback: the float64 LU of A (made once, kept on ``F``) and
    its solve."""
    _tally(mixed_lu_solve.counts.fallbacks, code)
    with span("mixed.fallback", F.A):
        if F.fallback is None:
            F.fallback = lu(F.A, check=False, device=F.A.device)
        return lu_solve(F.fallback, b)


def mixed_lu_solve(F: MixedLU, b, *, itermax: int = ITERMAX, return_iter: bool = False):
    """Solve ``A x = b`` in float64 with a :class:`MixedLU`, as DSGESV refines
    (module docstring); ``b`` (float64) a vector or an (n, k) matrix, each
    column held to the test.  ``return_iter=True`` returns ``(x, ITER)``:
    the refinement steps taken, or -2, -3 or ``-(itermax + 1)`` where the
    solve fell back to the float64 LU."""
    counts = mixed_lu_solve.counts
    b = torch.as_tensor(b, device=F.A.device)
    mr.check_float64(b, "mixed_lu_solve")
    if b.ndim not in (1, 2) or b.shape[0] != F.n:
        raise ValueError(f"right-hand side of shape {tuple(b.shape)} for A of order {F.n}")
    if itermax < 0:
        raise ValueError(f"itermax must be at least 0, got {itermax}")
    counts.calls += 1
    vec = b.ndim == 1
    B = (b[:, None] if vec else b).contiguous()
    if F.n == 0 or B.shape[1] == 0:
        _tally(counts.iters, 0)
        return (b.clone(), 0) if return_iter else b.clone()
    tensors = (F.factors, F.perm, F.A, B, F.anrm)
    x, sr, status = _first(*tensors, F.overflow, F.info, itermax)
    state, taken = _check(status, F.A)
    while state == 0:
        x, sr = _step(*tensors, x, sr, status, itermax)
        state, taken = _check(status, F.A)
    counts.steps += taken
    if state == 1:
        it = taken
    else:
        it = state
        x = _fallback(F, B, it)
    _tally(counts.iters, it)
    x = x[:, 0] if vec else x
    return (x, it) if return_iter else x


_counts.counted(mixed_lu_solve, MixedCounts)
