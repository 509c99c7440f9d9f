"""Unblocked right-looking LU in plain PyTorch.

The plain version of the Hopper panel kernel (csrc/panel_lu.cu) and the
CPU route of the panel layer.  Per step k: first-occurrence argmax of
``|A[k:, k]|``, row interchange, scale of the column below the diagonal
by ``1/p``, rank-1 update ``A - outer(l, u)`` of the trailing block.

Semantics (those of the JAX package's ``unblocked_lu``):

* the argmax takes the largest magnitude and the smallest row among ties;
* a zero pivot means no swap and no scale, but the rank-1 update still
  runs with the unscaled column;
* ``info`` is the 1-based first zero-pivot step, negated without
  pivoting.

Each product and difference is a separate rounded tensor op, which is
the rounding the kernel reproduces, so the two agree bitwise on the card.

``unblocked_lu`` pivots by the modulus ``|a|`` (the JAX function of the
same name).  ``unblocked_lu_cabs1`` is the plain version of the complex
kernel (csrc/panel_lu_c64.cu): it pivots by CABS1, ``|re| + |im|``, and
works on the real and imaginary planes.  ``micro_blocked_lu`` is the
plain version of the two micro-blocked kernels (csrc/panel_lu_micro.cu)
and, with ``precision='bf16x3'``, of csrc/panel_lu.cu's bf16x3 form
(``panel_boundary_precision='bf16x3'``); ``unblocked_lu_noswap`` is that
of the physical-order kernel (csrc/panel_lu_noswap.cu); both serve real
panels only.
``offset_panel_lu`` is the plain version of the offset kernel (the
tensor-parallel panel of csrc/panel_lu.cu, ``kOffset``), and
``offset_panel_lu_cabs1`` that of the complex one (csrc/panel_lu_c64.cu).
"""

from __future__ import annotations

import torch

from .schur import schur_product


def unblocked_lu(A: torch.Tensor, pivot: bool):
    """Factor ``A`` (m x n). Returns ``(LU, ipiv, perm, info)``.

    ``LU`` is a new tensor packing unit-lower L (strictly below the
    diagonal) and U; ``ipiv`` (min(m, n),) and ``perm`` (m,) are int32 on
    ``A``'s device; ``info`` is a 0-d int32 tensor.  The input is not
    modified.  Each step reads the pivot on the host, so on the card this
    is a comparison oracle, not a fast path."""
    A = A.clone()
    m, n = A.shape
    minmn = min(m, n)
    dev = A.device
    ipiv = torch.arange(minmn, dtype=torch.int32, device=dev)
    perm = torch.arange(m, dtype=torch.int32, device=dev)
    info = 0
    for k in range(minmn):
        if pivot:
            kp = k + int(torch.argmax(A[k:, k].abs()))
        else:
            kp = k
        ipiv[k] = kp
        pv = A[kp, k]
        nonzero = bool(pv != 0)
        if nonzero and kp != k:
            A[[k, kp]] = A[[kp, k]]
            perm[[k, kp]] = perm[[kp, k]]
        if nonzero:
            A[k + 1 :, k].mul_(torch.reciprocal(A[k, k]))
        elif info == 0:
            info = k + 1 if pivot else -(k + 1)
        if k + 1 < m and k + 1 < n:
            A[k + 1 :, k + 1 :].sub_(torch.outer(A[k + 1 :, k], A[k, k + 1 :]))
    return A, ipiv, perm, torch.tensor(info, dtype=torch.int32, device=dev)


def offset_panel_lu(panel: torch.Tensor, ofs: int, pivot: bool):
    """LU of the full-height panel ``panel`` (H x w) whose elimination
    starts at row ``ofs``: column k eliminates row ``ofs + k``, and the rows
    above ``ofs`` are neither searched nor written.  Returns ``(LU, piv,
    perm, info)``: a new tensor, the GLOBAL pivot row of each step (w,),
    the composed permutation of all H rows (the identity above ``ofs``)
    and the 1-based panel-local info, negated without pivoting.  The input
    is not modified; ``0 <= ofs <= H - w``.

    The port of the JAX package's ``parallel/blockcyclic.py
    _offset_panel_lu`` and the plain version of the offset kernel.  Each
    step is :func:`unblocked_lu`'s (first-occurrence argmax, a NaN
    candidate wins; a zero pivot means no swap and no scale but the rank-1
    update still runs), so this is ``unblocked_lu`` of the rows ``ofs:``
    with their indices shifted by ``ofs``."""
    H, w = panel.shape
    if not 0 <= ofs <= H - w:
        raise ValueError(f"offset {ofs} outside [0, {H - w}] for a {H} x {w} panel")
    f, piv, perm, info = unblocked_lu(panel[ofs:], pivot)
    out = panel.clone()
    out[ofs:] = f
    head = torch.arange(ofs, dtype=torch.int32, device=panel.device)
    return out, piv + ofs, torch.cat([head, perm + ofs]), info


def unblocked_lu_cabs1(A: torch.Tensor, pivot: bool):
    """Factor complex ``A`` (m x n) with CABS1 pivoting.  Returns ``(LU,
    ipiv, perm, info)`` as :func:`unblocked_lu` does; the input is not
    modified.

    The plain version of the Hopper complex panel kernel and the CPU
    route of complex panels.  It computes on the real and imaginary
    planes with one tensor op per rounding (torch's complex multiply,
    which may fuse, never enters), in the TPU kernel's order:

    * pivot: ``c = |re| + |im|`` over rows ``k:``, the first row with
      ``c == max(c)`` (LAPACK ``cgetrf``'s rule); a NaN candidate makes
      the maximum NaN, which equals no row, and the pivot row is m - 1;
    * a zero pivot (re == 0 and im == 0) means no swap and no scale, the
      rank-1 update still runs, ``info`` records the first such step;
    * scale by ``conj(p) / |p|^2``: ``d = pr*pr + pi*pi``, ``ir = pr/d``,
      ``ii = -pi/d``, ``re' = re*ir - im*ii``, ``im' = re*ii + im*ir``.
      ``d`` overflows or underflows for pivots beyond the square root of
      the type's range, where LAPACK's ``cladiv`` would not; the TPU
      kernel has the same limit;
    * update: ``a_re -= l_re*u_re - l_im*u_im``,
      ``a_im -= l_re*u_im + l_im*u_re``.

    Each step reads the pivot on the host, so on the card this is a
    comparison oracle, not a fast path."""
    if not A.is_complex():
        raise ValueError(f"unblocked_lu_cabs1 takes a complex matrix, got {A.dtype}")
    A = A.resolve_conj().clone(memory_format=torch.contiguous_format)
    m, n = A.shape
    minmn = min(m, n)
    dev = A.device
    V = torch.view_as_real(A)
    Re, Im = V[..., 0], V[..., 1]
    ipiv = torch.arange(minmn, dtype=torch.int32, device=dev)
    perm = torch.arange(m, dtype=torch.int32, device=dev)
    info = 0
    for k in range(minmn):
        kp = k
        if pivot:
            cabs = Re[k:, k].abs() + Im[k:, k].abs()
            hit = (cabs == cabs.max()).nonzero()
            kp = k + int(hit[0]) if hit.numel() else m - 1
        ipiv[k] = kp
        nonzero = bool((Re[kp, k] != 0) | (Im[kp, k] != 0))
        if nonzero and kp != k:
            V[[k, kp]] = V[[kp, k]]
            perm[[k, kp]] = perm[[kp, k]]
        lre, lim = Re[k + 1 :, k], Im[k + 1 :, k]
        if nonzero:
            pr, pi = Re[k, k], Im[k, k]
            d = pr * pr + pi * pi
            ir, ii = pr / d, -pi / d
            sre = lre * ir - lim * ii
            sim = lre * ii + lim * ir
            lre.copy_(sre)
            lim.copy_(sim)
        elif info == 0:
            info = k + 1 if pivot else -(k + 1)
        if k + 1 < m and k + 1 < n:
            ure, uim = Re[k, k + 1 :], Im[k, k + 1 :]
            Re[k + 1 :, k + 1 :].sub_(torch.outer(lre, ure) - torch.outer(lim, uim))
            Im[k + 1 :, k + 1 :].sub_(torch.outer(lre, uim) + torch.outer(lim, ure))
    return A, ipiv, perm, torch.tensor(info, dtype=torch.int32, device=dev)


def offset_panel_lu_cabs1(panel: torch.Tensor, ofs: int, pivot: bool):
    """:func:`offset_panel_lu` for a complex panel: the LU of the rows
    ``ofs:`` of the full-height ``panel`` (H x w) by
    :func:`unblocked_lu_cabs1` (CABS1 pivots; a NaN candidate makes the
    pivot row H - 1), with the pivot rows shifted to global rows and the
    permutation of all H rows.  Returns ``(LU, piv, perm, info)`` as
    :func:`offset_panel_lu` does; the input is not modified.

    The plain version of the complex offset kernel (csrc/panel_lu_c64.cu,
    ``rf_offset_panel_lu_c*``) and the CPU route of the complex
    tensor-parallel panel step.  The JAX package's
    ``_offset_panel_lu`` pivots complex panels by the modulus instead."""
    H, w = panel.shape
    if not 0 <= ofs <= H - w:
        raise ValueError(f"offset {ofs} outside [0, {H - w}] for a {H} x {w} panel")
    f, piv, perm, info = unblocked_lu_cabs1(panel[ofs:], pivot)
    out = panel.resolve_conj().clone()
    out[ofs:] = f
    head = torch.arange(ofs, dtype=torch.int32, device=panel.device)
    return out, piv + ofs, torch.cat([head, perm + ofs]), info


def _delayed_trsm(A, q0: int, p0: int, c0: int) -> None:
    """Unit-lower solve of rows ``[q0, p0)`` against columns ``c0:`` in
    place: row i is eliminated from the rows below it before row i + 1,
    one rounded product and one rounded difference per entry."""
    for i in range(q0, p0 - 1):
        A[i + 1 : p0, c0:].sub_(torch.outer(A[i + 1 : p0, i], A[i, c0:]))


def _delayed_update(A, q0: int, p0: int) -> None:
    """``A[p0:, p0:] -= A[p0:, q0:p0] @ A[q0:p0, p0:]`` with the order of
    the sum fixed: the accumulator starts at 0 and takes ``l[i, j] *
    u[j, c]`` for j = q0 .. p0 - 1 in turn, every product and every sum
    rounded once, then one subtraction."""
    acc = torch.zeros_like(A[p0:, p0:])
    for j in range(q0, p0):
        acc.add_(torch.outer(A[p0:, j], A[j, p0:]))
    A[p0:, p0:].sub_(acc)


def _delayed_update_bf16x3(A, q0: int, p0: int) -> None:
    """``A[p0:, p0:] -= hh + (hl + lh)``: the bf16x3 split of
    ``A[p0:, q0:p0] @ A[q0:p0, p0:]`` (ops/schur.py), each of the three
    products bf16 x bf16 with an f32 sum, the ``ll`` term dropped."""
    A[p0:, p0:].sub_(schur_product(A[p0:, q0:p0], A[q0:p0, p0:], "bf16x3"))


def micro_blocked_lu(A: torch.Tensor, pivot: bool, micro: int,
                     precision: str = "float32"):
    """Micro-blocked LU of a real ``A`` (m x n).  Returns ``(LU, ipiv,
    perm, info)`` as :func:`unblocked_lu` does; the input is not modified.

    The plain version of both micro-blocked Hopper kernels (the staged
    ``shadow`` one and the in-place ``basic`` one) and the CPU route of
    those variants.  The pivot rule, the zero-pivot rule and info are
    those of :func:`unblocked_lu`; what differs is when the trailing
    columns are updated.  With blocks of ``micro`` steps (the last one
    ragged, none beyond min(m, n)):

    * a step swaps rows across all n columns, scales its column by
      ``1/p`` and applies its rank-1 update to the columns of its own
      block only;
    * at the start of the next block the finished block ``[q0, p0)`` is
      applied to the columns ``p0:``: a unit-lower solve of the rows
      ``[q0, p0)`` (row by row), then the rank-``micro`` update of the
      rows ``p0:`` with the sum's order fixed (:func:`_delayed_update`);
    * a fat matrix (n > m) ends with the solve of the last block against
      the columns ``m:``.

    Every product, sum and difference is its own rounded tensor op in the
    order the kernels use, so kernel and plain version agree bitwise on
    the card.  In exact arithmetic the result is :func:`unblocked_lu`'s;
    in floating point the factors differ by the order of the updates.

    ``precision='bf16x3'`` (float32 only) replaces the rank-``micro``
    update by :func:`_delayed_update_bf16x3`: the plain version of
    csrc/panel_lu.cu under ``panel_boundary_precision='bf16x3'``, whose
    tensor-core sums agree with it to the bf16x3 class, not bitwise.
    The solve of the U rows stays in f32."""
    if A.is_complex():
        raise ValueError(f"micro_blocked_lu takes a real matrix, got {A.dtype}")
    if micro < 1:
        raise ValueError(f"micro must be positive, got {micro}")
    if precision not in ("float32", "bf16x3"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "bf16x3" and A.dtype != torch.float32:
        raise ValueError(f"the bf16x3 update takes float32, got {A.dtype}")
    update = _delayed_update_bf16x3 if precision == "bf16x3" else _delayed_update
    A = A.clone()
    m, n = A.shape
    minmn = min(m, n)
    dev = A.device
    ipiv = torch.arange(minmn, dtype=torch.int32, device=dev)
    perm = torch.arange(m, dtype=torch.int32, device=dev)
    info = 0
    for k in range(minmn):
        p0 = (k // micro) * micro
        p1 = min(p0 + micro, minmn)
        if k == p0 and k > 0:
            _delayed_trsm(A, p0 - micro, p0, p0)
            update(A, p0 - micro, p0)
        kp = k + int(torch.argmax(A[k:, k].abs())) if pivot else k
        ipiv[k] = kp
        nonzero = bool(A[kp, k] != 0)
        if nonzero and kp != k:
            A[[k, kp]] = A[[kp, k]]
            perm[[k, kp]] = perm[[kp, k]]
        if nonzero:
            A[k + 1 :, k].mul_(torch.reciprocal(A[k, k]))
        elif info == 0:
            info = k + 1 if pivot else -(k + 1)
        if k + 1 < m and k + 1 < p1:
            A[k + 1 :, k + 1 : p1].sub_(torch.outer(A[k + 1 :, k], A[k, k + 1 : p1]))
    if n > minmn and minmn > 0:
        _delayed_trsm(A, ((minmn - 1) // micro) * micro, minmn, minmn)
    return A, ipiv, perm, torch.tensor(info, dtype=torch.int32, device=dev)


def unblocked_lu_noswap(A: torch.Tensor, used0: torch.Tensor, pivot: bool):
    """Physical-order LU of a real panel ``A`` (m x w): no row ever moves.
    Returns ``(LU, prow, used, info)``; the inputs are not modified.

    The plain version of the no-swap Hopper kernel and the CPU route of
    ``schedule='physical'``.  ``used0`` (m,) marks the rows consumed by
    earlier panels (nonzero: consumed); they are neither searched nor
    updated.  Per step k:

    * the pivot row ``prow[k]`` is the available row with the largest
      ``|a[i, k]|``, the smallest row among ties (a NaN wins over any
      number); without pivoting it is the first available row;
    * the row is marked used and keeps its place: from here on it holds
      row k of U in the columns ``k:`` and its multipliers before them;
    * the rows still available are scaled by ``1/p`` in column k and take
      the rank-1 update of the columns ``k+1:``; a zero pivot means no
      scale, the update still runs and the column still consumes its
      row; ``info`` is the 1-based first such step, negated without
      pivoting.

    With no row left to take, ``prow[k]`` is -1 and the step does
    nothing.  ``L @ U == A[perm]`` for ``perm`` = ``prow`` followed by
    the rows never taken."""
    if A.is_complex():
        raise ValueError(f"unblocked_lu_noswap takes a real panel, got {A.dtype}")
    A = A.clone()
    m, w = A.shape
    dev = A.device
    if used0.shape != (m,):
        raise ValueError(f"used0 must have shape ({m},), got {tuple(used0.shape)}")
    used = (used0 != 0).to(torch.int32)
    prow = torch.full((min(m, w),), -1, dtype=torch.int32, device=dev)
    info = 0
    for k in range(min(m, w)):
        avail = used == 0
        if not bool(avail.any()):
            continue
        if pivot:
            mag = torch.where(avail, A[:, k].abs(), torch.full_like(A[:, k], -1))
            kp = int(torch.argmax(mag))
        else:
            kp = int(torch.argmax(avail.to(torch.int32)))
        prow[k] = kp
        used[kp] = 1
        rest = used == 0
        pv = A[kp, k]
        if bool(pv != 0):
            A[rest, k] = A[rest, k] * torch.reciprocal(pv)
        elif info == 0:
            info = k + 1 if pivot else -(k + 1)
        if k + 1 < w:
            A[rest, k + 1 :] = A[rest, k + 1 :] - torch.outer(A[rest, k], A[kp, k + 1 :])
    return A, prow, used, torch.tensor(info, dtype=torch.int32, device=dev)
