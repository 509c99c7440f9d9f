"""The float64 passes of mixed-precision refinement on the card:
csrc/mixed_refine.cu, and their tensor twins.

* :func:`narrow_cuda` (``mixed_narrow_kernel``): LAPACK's DLAG2S and
  DLANGE('I') in one read of the float64 A: ``single(A)``, ``||A||_inf``
  and the overflow flag;
* :func:`residual_cuda` (``mixed_residual_kernel``): one refinement pass,
  ``r = b - A x`` in float64, ``single(r)`` and LAPACK's stopping test
  written into the status.

:func:`narrow_tensor` and :func:`residual_tensor` are their plain versions,
with the kernels' order of operations, so the two give the same bits: the
CPU runs them, and the tests hold the kernels to them on the card.  Each
row's sum is taken as a block of :data:`THREADS` threads takes it: thread t
sums the columns t, t + THREADS, ... in turn, then the partial sums are added
in the tree ``s_t += s_{t + h}``, h = THREADS / 2, ..., 1.

The status is an int32 pair ``[state, steps]``: state 0 while refining, 1
once converged, -2 after an overflow in narrowing, -3 where the float32
factorization failed, ``-(itermax + 1)`` when ``itermax`` steps did not
converge; ``steps`` counts the refinement steps taken.  A pass whose state is
not 0 leaves it as it is (a masked step).  Only float64 is taken: LAPACK's
complex form, ZCGESV, is not supported.

Counts (:class:`KernelCounts`, ``narrow_cuda.counts`` and
``residual_cuda.counts``, zeroed by ``ops._counts.reset_counts()``): the
launches of each kernel, counted where they are made; like the panel counts
they count eager calls and captures, never the replays of a captured
program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import _counts, _kernels

THREADS = 256  # csrc/mixed_refine.cu kThreads: threads a row, the sums' order
EPS = 2.0 ** -53  # DLAMCH('E') for double
BWDMAX = 1.0  # DSGESV's BWDMAX
RMAX = float(torch.finfo(torch.float32).max)  # DLAG2S's RMAX, SLAMCH('O')
NARROW_KERNEL = "mixed_narrow_kernel"
RESIDUAL_KERNEL = "mixed_residual_kernel"


@dataclasses.dataclass
class KernelCounts:
    """``launches``: the kernel's launches so far."""

    launches: int = 0


def check_float64(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float64:
        raise TypeError(f"{what} takes float64 (LAPACK's DSGESV), got {t.dtype}; "
                        "the complex form ZCGESV is not supported")


def takes(A: torch.Tensor) -> bool:
    """Do the kernels run for this matrix (a CUDA float64 tensor)?"""
    return A.is_cuda and A.dtype == torch.float64


def _ptr_args(device):
    return _counts.device_index(device), torch.cuda.current_stream(device).cuda_stream


def narrow_cuda(A: torch.Tensor):
    """``(single(A), ||A||_inf, overflow)`` of the contiguous square float64
    ``A`` on the card: a float32 matrix, a 0-d float64 and a 0-d int32 (1
    where an entry lies beyond float32's range)."""
    check_float64(A, "narrow_cuda")
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n or not A.is_cuda:
        raise ValueError(f"a square CUDA matrix is needed, got {tuple(A.shape)} on {A.device}")
    A = A.contiguous()
    sa = torch.empty((n, n), dtype=torch.float32, device=A.device)
    anrm = torch.zeros((), dtype=torch.float64, device=A.device)
    overflow = torch.zeros((), dtype=torch.int32, device=A.device)
    lib = _kernels.load("mixed_refine")
    code = lib.rf_mixed_narrow_f64(A.data_ptr(), sa.data_ptr(), anrm.data_ptr(),
                                   overflow.data_ptr(), n, *_ptr_args(A.device))
    _kernels.check(lib, code, "mixed narrowing launch")
    narrow_cuda.counts.launches += 1
    return sa, anrm, overflow


def residual_cuda(A, x, b, anrm, status, step: bool, itermax: int):
    """``(r, single(r))`` of ``r = b - A x`` for the float64 ``A`` (n, n) and
    ``x``, ``b`` (n, k), on the card; ``status`` (int32 ``[state, steps]``)
    takes the stopping test of ``anrm`` (module docstring), in place.  The
    refinement reads only ``single(r)``; ``r`` is written all the same (8nk
    bytes, 32 KiB at n = 4096 beside the pass's 128 MiB read of A) so that
    the card's tests hold the float64 residual itself bit for bit to
    :func:`residual_tensor`."""
    for t, what in ((A, "residual_cuda's A"), (x, "residual_cuda's x"), (b, "residual_cuda's b"),
                    (anrm, "residual_cuda's anrm")):
        check_float64(t, what)
    n, k = x.shape
    if tuple(A.shape) != (n, n) or tuple(b.shape) != (n, k) or not 1 <= k <= 65535:
        raise ValueError(f"A (n, n) and x, b (n, k) are needed, got {tuple(A.shape)}, "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    if status.dtype != torch.int32 or tuple(status.shape) != (2,) or not status.is_contiguous():
        raise ValueError("status must be a contiguous int32 pair [state, steps]")
    A, x, b = A.contiguous(), x.contiguous(), b.contiguous()
    r = torch.empty((n, k), dtype=torch.float64, device=A.device)
    sr = torch.empty((n, k), dtype=torch.float32, device=A.device)
    work = torch.zeros(2 * k + 2, dtype=torch.int64, device=A.device)
    lib = _kernels.load("mixed_refine")
    code = lib.rf_mixed_residual_f64(A.data_ptr(), x.data_ptr(), b.data_ptr(), anrm.data_ptr(),
                                     r.data_ptr(), sr.data_ptr(), status.data_ptr(),
                                     work.data_ptr(), n, k, int(bool(step)), int(itermax),
                                     *_ptr_args(A.device))
    _kernels.check(lib, code, "mixed residual launch")
    residual_cuda.counts.launches += 1
    return r, sr


_counts.counted(narrow_cuda, KernelCounts)
_counts.counted(residual_cuda, KernelCounts)


def _rows(terms) -> torch.Tensor:
    """Each row's sum, in the kernels' order, of ``terms``: per column block
    the (rows, ..., THREADS) terms its threads add and whether each thread
    has a column there (past n no thread adds)."""
    p = None
    for term, valid in terms:
        p = term.new_zeros(term.shape) if p is None else p
        p = torch.where(valid, p + term, p)
    h = THREADS // 2
    while h >= 1:
        p = p[..., :h] + p[..., h:2 * h]
        h //= 2
    return p[..., 0]


def _blocks(n: int, device):
    """Per column block: the column indices a thread reads and whether they
    lie inside n."""
    cols = torch.arange(THREADS, device=device)
    for start in range(0, n, THREADS):
        j = start + cols
        yield j.clamp(max=n - 1), j < n


def narrow_tensor(A: torch.Tensor):
    """:func:`narrow_cuda`'s plain version, on any device."""
    check_float64(A, "narrow_tensor")
    n = A.shape[0]
    if n == 0:
        return A.float(), A.new_zeros(()), torch.zeros((), dtype=torch.int32, device=A.device)
    absA = A.abs()
    anrm = _rows((absA[:, j], valid) for j, valid in _blocks(n, A.device)).amax()
    overflow = ((A < -RMAX) | (A > RMAX)).any().to(torch.int32)
    return A.float(), anrm, overflow


def residual_tensor(A, x, b, anrm, status, step: bool, itermax: int):
    """:func:`residual_cuda`'s plain version, on any device; ``status`` is
    updated in place, with tensor operations only (no host read)."""
    for t, what in ((A, "residual_tensor's A"), (x, "residual_tensor's x"),
                    (b, "residual_tensor's b"), (anrm, "residual_tensor's anrm")):
        check_float64(t, what)
    n, k = x.shape
    # terms (n, k, THREADS): A[i, j_t] * x[j_t, c]
    s = _rows((A[:, None, j] * x[j].T[None], valid) for j, valid in _blocks(n, A.device))
    r = b - s
    rnrm, xnrm = r.abs().amax(dim=0), x.abs().amax(dim=0)
    overflow = ((r < -RMAX) | (r > RMAX)).any()
    state, steps = status[0], status[1] + int(bool(step))
    cte = anrm * EPS * math.sqrt(n) * BWDMAX
    converged = ~(rnrm > xnrm * cte).any()
    out = torch.where(converged, 1, torch.where(
        steps >= itermax, -(itermax + 1), torch.where(overflow, -2, 0))).to(torch.int32)
    status.copy_(torch.where(state == 0, torch.stack([out, steps.to(torch.int32)]), status))
    return r, r.float()
