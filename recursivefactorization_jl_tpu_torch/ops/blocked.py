"""Static blocked right-looking LU schedule.

    for each panel s (width w):
        1. factor the tall panel A[s:, s:s+w] in place (panel kernel)
        2. laswp: apply the panel's composed permutation to the other
           columns of rows s: as one row gather (dense) or by moving only
           the rows the panel's swaps touched (sparse)
        3. TRSM:  U12 = L11^-1 @ A12 by substitution (``trsm.substitute``,
           cuBLAS's trsm on the card), with and without pivoting
        4. Schur: A22 -= L21 @ U12, the subtraction in the product's
           epilogue (``addmm_``) at full precision

One panel of look-ahead.  Panel s + w reads only its own columns, the
*strip* [s+w, s+2w), until its laswp.  So where the next step is a panel
with columns past it (``lookahead(n, s, w, pivot, tail)``), steps 2-4 run
on the strip first, on the current stream, and then on the rest (the
columns left of the panel in 2, the *trailing block* [s+2w, n) in 2-4),
which on the card runs on a side stream (the calling thread's own)
beside panel s + w's kernels and is joined back before that panel's
laswp (or before the function returns).  Its Schur update runs in row chunks of a partial wave each
(``TRAILING_TILES``), so that the next panel's chain launches find their
SMs.  Every element takes the same arithmetic as without the split (the
products' kernels may differ with their shapes).  On the CPU the two
parts run one after the other.  ``blocked_lu.counts.lookahead_panels``
counts the panels that split (eager calls and captures, never replays;
zeroed by ``ops._counts.reset_counts``).

Each step is cut into spans (``utils/profiling.py``): ``blocked.panel``
(1, with the ipiv / info bookkeeping), ``blocked.laswp`` (2),
``blocked.trsm`` (3), ``blocked.schur`` (4) with no gap between them,
``blocked.trailing`` around the trailing block's share of 2-4 (on the
side stream on the card), and ``blocked.tail`` for the recursive tail's
panel call.

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
           which skips the rows consumed so far (m - s of them are left)
        2. U12 = L11^-1 @ A[pivot rows, s+w:], L11 gathered from the
           panel at the pivot rows
        3. A[:, s+w:] -= Lmasked @ U12, where Lmasked is the panel with
           zeros wherever the row was consumed at or before that column's
           step: consumed rows stay as they are, the panel's pivot rows
           receive their rows of U12, the others their Schur update
    then factors = A[perm]

Its spans: ``blocked.panel`` (1), ``blocked.trsm`` (2, with the mask),
``blocked.schur`` (3) and ``blocked.laswp`` for the final gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Tuple

import torch

from ..utils.config import LUConfig, full_matmul_precision
from ..utils.profiling import span
from . import _counts
from .panel import panel_factor, panel_factor_noswap
from .schur import schur_update_
from .trsm import solve_unit_lower, substitute, unit_lower_inverse

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
    the column ranges ``cols`` of ``A`` and to the global ``perm`` (None:
    left as it is).

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
        if perm is not None:
            perm[dst] = perm[src]
    else:
        for c0, c1 in cols:
            if c1 > c0:
                A[s:, c0:c1] = A[s:, c0:c1][pl]
        if perm is not None:
            perm[s:] = perm[s:][pl]


@dataclasses.dataclass
class BlockedCounts:
    """``lookahead_panels``: panels whose trailing block's laswp, TRSM and
    Schur update were split from the next panel's strip (on the card: ran
    on the side stream beside the next panel's kernels)."""

    lookahead_panels: int = 0


def lookahead(n: int, s: int, w: int, pivot: bool, tail) -> bool:
    """Does the panel at column ``s`` of an ``n``-column blocked schedule
    with panels of ``w`` columns split its trailing block from the next
    panel's strip?  Where the next step is a panel, not the recursive tail
    (``tail``: the resolved ``tail_threshold``, taken with pivoting only),
    and columns lie past that panel."""
    nxt = s + w
    if pivot and tail is not None and n - nxt <= tail:
        return False
    return nxt + w < n


# The trailing block's Schur update runs in row chunks of at most about
# this many 128 x 128 tiles of output.  On an H100 (132 SMs, 16 of them
# held by the next panel's chain) 64 is under half a wave: no tile of a
# chunk waits for an SM, and each chunk's end frees SMs for the chain
# launch queued behind it.  116 tiles (every SM the chain leaves) measured
# slower at n = 4096 and 8192, 32 faster at 8192 and slower at 4096
# (PERF.md §6; ``lookahead_variants.py`` runs them in turns).
TRAILING_TILES = 64


def _schur_waves(C, L, U, prec):
    """``schur_update_`` in row chunks of at most ``TRAILING_TILES``
    tiles."""
    rows = 128 * max(1, TRAILING_TILES // -(-C.shape[1] // 128))
    for i in range(0, C.shape[0], rows):
        schur_update_(C[i : i + rows], L[i : i + rows], U, prec)


class _Side(threading.local):
    """The side streams of the trailing blocks, one per host thread and
    device (made once each): a thread that captures a program joins its
    side stream to the capture, and another thread's calls must not queue
    their work there, nor wait behind the first thread's."""

    def __init__(self):
        self.streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def get(self, device) -> "torch.cuda.Stream":
        side = self.streams.get(device)
        if side is None:
            side = self.streams[device] = torch.cuda.Stream(device)
        return side


_SIDE = _Side()


def _fork(A):
    """The context of a trailing block's work: on the card this thread's
    side stream of ``A``'s device after it waits for the current stream;
    on the CPU none."""
    if A.device.type != "cuda":
        return contextlib.nullcontext()
    side = _SIDE.get(A.device)
    side.wait_stream(torch.cuda.current_stream(A.device))
    return torch.cuda.stream(side)


def _join(A) -> None:
    """The current stream waits for this thread's trailing block work."""
    if A.device.type == "cuda":
        torch.cuda.current_stream(A.device).wait_stream(_SIDE.get(A.device))


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
            with span("blocked.laswp", A):
                AR.copy_(AR[perm.long()])
        with span("blocked.trsm", A):
            L = A[:, :m]
            AR.copy_(solve_unit_lower(L, AR, config.trsm_block) if pivot
                     else substitute(L, AR, upper=False, unit=True))
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
    held = None  # what the trailing block's work reads, kept until the join
    while s < n:
        if pivot and s > 0 and tail is not None and n - s <= tail:
            # Recursive tail: factor the trailing block in one call, then
            # pull its row permutation through the finished L columns.
            with span("blocked.tail", A):
                _, piv_l, perm_l, linfo = panel_factor(A[s:, s:], pivot, config)
                ipiv[s:] = piv_l + s
                info = _offset_info(info, linfo, s)
            with span("blocked.laswp", A):
                _laswp(A, perm, perm_l, piv_l, s, [(0, s)])
            return A, ipiv, perm, info
        ws = min(w, n - s)
        with span("blocked.panel", A):
            _, piv_l, perm_l, linfo = panel_factor(A[s:, s : s + ws], pivot, config)
            ipiv[s : s + ws] = piv_l + s
            info = _offset_info(info, linfo, s)
        if held is not None:
            _join(A)  # before this panel's laswp touches the trailing block
            held = None
        # the strip: every column past the panel, or the next panel's own
        ahead = lookahead(n, s, w, pivot, tail)
        c1 = s + 2 * w if ahead else n
        if pivot:
            with span("blocked.laswp", A):
                cols = [(s + ws, c1)] if ahead else [(0, s), (s + ws, n)]
                _laswp(A, perm, perm_l, piv_l, s, cols)
        L11, L21 = A[s : s + ws, s : s + ws], A[s + ws :, s : s + ws]
        if s + ws < n:
            with span("blocked.trsm", A):
                A12 = A[s : s + ws, s + ws : c1]
                A12.copy_(substitute(L11, A12, upper=False, unit=True))
            with span("blocked.schur", A):
                schur_update_(A[s + ws :, s + ws : c1], L21, A12, prec)
        if ahead:
            with _fork(A), span("blocked.trailing", A):
                if pivot:
                    _laswp(A, None, perm_l, piv_l, s, [(0, s), (c1, n)])
                A12 = A[s : s + ws, c1:]
                A12.copy_(substitute(L11, A12, upper=False, unit=True))
                _schur_waves(A[s + ws :, c1:], L21, A12, prec)
            held = (piv_l, perm_l)
            blocked_lu.counts.lookahead_panels += 1
        s += ws
    if held is not None:
        _join(A)
    return A, ipiv, perm, info


_counts.counted(blocked_lu, BlockedCounts)


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
        with span("blocked.panel", A):
            # every earlier step consumed one row: m - s are left
            prow_l, used, linfo = panel_factor_noswap(panel, used, pivot, live=m - s)
            info = _offset_info(info, linfo, s)
            prow[s : s + ws] = prow_l
            rows = prow_l.long()
            taken_at[rows] = steps[s : s + ws]
        if s + ws < n:
            # entry (i, r) stays iff row i was still available after
            # step s + r: the zeros cut the sums of consumed rows, so one
            # full-height product leaves earlier panels' rows alone,
            # writes U12 into this panel's pivot rows and updates the rest
            with span("blocked.trsm", A):
                keep = taken_at[:, None] > steps[None, s : s + ws]
                Lm = torch.where(keep, panel, torch.zeros((), dtype=A.dtype, device=dev))
                U12 = unit_lower_inverse(Lm[rows]) @ A[rows, s + ws :]
            with span("blocked.schur", A):
                schur_update_(A[:, s + ws :], Lm, U12, prec)
        s += ws

    with span("blocked.laswp", A):
        if m > n:
            # the rows never chosen, in ascending order, without a host sync
            rest = torch.argsort(used, stable=True)[: m - n].to(torch.int32)
            perm = torch.cat([prow, rest])
        else:
            perm = prow
        A.copy_(A[perm.long()])
    return A, prow, perm, info
