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
works on the real and imaginary planes.
"""

from __future__ import annotations

import torch


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
