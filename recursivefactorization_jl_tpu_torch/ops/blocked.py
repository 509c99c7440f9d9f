"""Static blocked right-looking LU schedule.

    for each panel s (width w):
        1. factor the tall panel A[s:, s:s+w] in place (panel kernel)
        2. laswp: apply the panel's composed permutation to the other
           columns of rows s: as one row gather (dense) or by moving only
           the rows the panel's swaps touched (sparse)
        3. TRSM:  U12 = L11^-1 @ A12 via triangular inverse + matmul
        4. Schur: A22 -= L21 @ U12

The schedule updates ``A`` in place, where the JAX package wrote new
arrays with ``.at[].set``.  Fat matrices (m < n) factor the left m x m
block, then solve for the remaining columns.  With ``tail_threshold``
set, a narrow enough trailing block is finished in one whole-block
panel call (the recursion's base case).  The panels run
``blocked_panel_variant`` (None: ``panel_variant``).

``blocked_lu_physical`` is the opt-in ``schedule='physical'``: no row
moves until one final gather.

    for each panel s (width w), at full height m:
        1. factor A[:, s:s+w] in place with the no-swap panel kernel,
           which skips the rows consumed so far
        2. U12 = L11^-1 @ A[pivot rows, s+w:], L11 gathered from the
           panel at the pivot rows
        3. A[:, s+w:] -= Lmasked @ U12, where Lmasked is the panel with
           zeros wherever the row was consumed at or before that column's
           step: consumed rows stay as they are, the panel's pivot rows
           receive their rows of U12, the others their Schur update
    then factors = A[perm]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.config import LUConfig, full_matmul_precision
from .panel import panel_factor, panel_factor_noswap
from .schur import schur_product
from .trsm import solve_unit_lower, unit_lower_inverse

# Trailing blocks of at least this many bytes take the sparse laswp:
# a composition of w row swaps moves at most 2*w rows, so gathering only
# those beats a dense gather of the whole (m - s) x n block once the
# block is large.  Tests lower it to reach both branches.
SPARSE_LASWP_MIN_BYTES = 32 * 1024 * 1024


def _offset_info(info, local_info, s: int):
    """First zero pivot wins; offset panel-local info by the panel start
    (sign-aware for the no-pivot negative convention)."""
    glob = torch.where(local_info < 0, local_info - s, local_info + s)
    return torch.where((info == 0) & (local_info != 0), glob, info)


def _laswp(A, perm, perm_local, piv_local, s: int, cols):
    """Apply panel-local row permutation ``perm_local`` to rows ``s:`` of
    the column ranges ``cols`` of ``A`` and to the global ``perm``.

    The sparse branch moves only the rows the panel's swaps touched: the
    first len(piv_local) rows and the pivot rows, with no host sync to
    find them (a row listed twice receives the same value twice)."""
    mh = A.shape[0] - s
    pl = perm_local.long()
    if mh * A.shape[1] * A.element_size() >= SPARSE_LASWP_MIN_BYTES:
        k = piv_local.shape[0]
        aff = torch.cat([torch.arange(k, device=A.device), piv_local.long()])
        dst, src = s + aff, s + pl[aff]
        for c0, c1 in cols:
            if c1 > c0:
                A[dst, c0:c1] = A[src, c0:c1]
        perm[dst] = perm[src]
    else:
        for c0, c1 in cols:
            if c1 > c0:
                A[s:, c0:c1] = A[s:, c0:c1][pl]
        perm[s:] = perm[s:][pl]


def blocked_lu(
    A: torch.Tensor, pivot: bool, config: LUConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor ``A`` (m x n) in place with the blocked schedule.

    Returns ``(A, ipiv, perm, info)``: ``A`` holds the packed factors,
    ``ipiv`` is the 0-based global swap sequence of length min(m, n),
    ``perm`` the composed global row permutation (``L @ U == A0[perm]``)
    and ``info`` a 0-d int32 tensor."""
    variant = config.resolved_blocked_variant()
    if variant != config.panel_variant:
        config = dataclasses.replace(config, panel_variant=variant)
    with full_matmul_precision():
        return _blocked_lu(A, pivot, config)


def _blocked_lu(A, pivot, config):
    m, n = A.shape
    if m < n:
        # Fat: factor the left square block, then permute and solve for
        # the remaining columns.
        _, ipiv, perm, info = _blocked_lu(A[:, :m], pivot, config)
        AR = A[:, m:]
        if pivot:
            AR.copy_(AR[perm.long()])
        AR.copy_(solve_unit_lower(A[:, :m], AR, config.trsm_block))
        return A, ipiv, perm, info

    minmn = n
    dev = A.device
    w = config.resolved_panel_width()
    prec = config.resolved_schur_precision()
    tail = config.resolved_tail_threshold()
    ipiv = torch.zeros(minmn, dtype=torch.int32, device=dev)
    perm = torch.arange(m, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)

    s = 0
    while s < n:
        if pivot and s > 0 and tail is not None and n - s <= tail:
            # Recursive tail: factor the trailing block in one call, then
            # pull its row permutation through the finished L columns.
            _, piv_l, perm_l, linfo = panel_factor(A[s:, s:], pivot, config)
            ipiv[s:] = piv_l + s
            info = _offset_info(info, linfo, s)
            _laswp(A, perm, perm_l, piv_l, s, [(0, s)])
            return A, ipiv, perm, info
        ws = min(w, n - s)
        _, piv_l, perm_l, linfo = panel_factor(A[s:, s : s + ws], pivot, config)
        ipiv[s : s + ws] = piv_l + s
        info = _offset_info(info, linfo, s)
        if pivot:
            _laswp(A, perm, perm_l, piv_l, s, [(0, s), (s + ws, n)])
        if s + ws < n:
            L11_inv = unit_lower_inverse(A[s : s + ws, s : s + ws])
            A12 = A[s : s + ws, s + ws :]
            A12.copy_(L11_inv @ A12)
            A[s + ws :, s + ws :].sub_(
                schur_product(A[s + ws :, s : s + ws], A12, prec).to(A.dtype)
            )
        s += ws
    return A, ipiv, perm, info


def blocked_lu_physical(
    A: torch.Tensor, pivot: bool, config: LUConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor a real ``A`` (m x n, m >= n) in place with the physical-
    order schedule: rows never move during the factorization, so there
    are no row interchanges inside the panel kernel and no laswp between
    panels; the price is trailing updates at full height m on every
    panel and one row gather at the end.

    Returns ``(A, prow, perm, info)``: ``A`` holds the packed factors in
    pivot order (``L @ U == A0[perm]``), ``perm`` is the composed row
    permutation (for m > n the rows never chosen follow in ascending
    order) and ``prow`` its first n entries, the row chosen at each step.
    ``prow`` is not a swap sequence: solve with ``perm``.  Nothing here
    waits for the device."""
    m, n = A.shape
    if m < n:
        raise ValueError("blocked_lu_physical requires m >= n")
    with full_matmul_precision():
        return _blocked_lu_physical(A, pivot, config)


def _blocked_lu_physical(A, pivot, config):
    m, n = A.shape
    dev = A.device
    w = config.resolved_panel_width()
    prec = config.resolved_schur_precision()
    used = torch.zeros(m, dtype=torch.int32, device=dev)
    # the elimination step that consumed each row; n: not consumed
    taken_at = torch.full((m,), n, dtype=torch.int64, device=dev)
    prow = torch.empty(n, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    steps = torch.arange(n, device=dev)

    s = 0
    while s < n:
        ws = min(w, n - s)
        panel = A[:, s : s + ws]
        prow_l, used, linfo = panel_factor_noswap(panel, used, pivot)
        info = _offset_info(info, linfo, s)
        prow[s : s + ws] = prow_l
        rows = prow_l.long()
        taken_at[rows] = steps[s : s + ws]
        if s + ws < n:
            # entry (i, r) stays iff row i was still available after
            # step s + r: the zeros cut the sums of consumed rows, so one
            # full-height product leaves earlier panels' rows alone,
            # writes U12 into this panel's pivot rows and updates the rest
            keep = taken_at[:, None] > steps[None, s : s + ws]
            Lm = torch.where(keep, panel, torch.zeros((), dtype=A.dtype, device=dev))
            U12 = unit_lower_inverse(Lm[rows]) @ A[rows, s + ws :]
            A[:, s + ws :].sub_(schur_product(Lm, U12, prec).to(A.dtype))
        s += ws

    if m > n:
        # the rows never chosen, in ascending order, without a host sync
        rest = torch.argsort(used, stable=True)[: m - n].to(torch.int32)
        perm = torch.cat([prow, rest])
    else:
        perm = prow
    A.copy_(A[perm.long()])
    return A, prow, perm, info
