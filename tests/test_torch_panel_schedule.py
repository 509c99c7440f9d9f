"""The order of csrc/panel_lu.cu's cluster route, emulated on the CPU, and
the two public-API repairs (the port exports every name of the JAX
package; ``lu_factor(donate=True)`` factors in place).

The cluster route of the panel kernel factors a panel in blocks of ``b``
columns.  For each block ``[k0, k1)`` it first runs the block's pivot
chain on the slab (the live rows from ``ofs + k0`` down, the block's
columns only), with every rank-1 update confined to the slab; then it
applies the block's row swaps to every column outside the slab, solves
the block's U rows in the columns ``>= k1`` row by row, and updates every
row below the block with the block's ``b`` rank-1 updates in step order.
Every element still receives its updates in step order, each product and
difference rounded on its own, so the result is ``unblocked_lu``'s (and
``offset_panel_lu``'s) bit for bit.  ``blocked_order_lu`` below does the
same steps with one rounded tensor op per rounding; the tests hold it to
the plain versions bitwise (pivots, perm and info exactly).
``lookahead_order_lu`` does the chain kernel's step order inside a block
(the one-column look-ahead: most of a step's update deferred behind the
next candidate exchange, the rows that exchange sends brought up to date
first), for real and complex panels.  On the card tests/test_torch_cuda.py
holds the kernel to the plain versions.
"""

import numpy as np
import pytest
import torch

import recursivefactorization_jl_tpu as rf
import recursivefactorization_jl_tpu_torch as rt
from lookahead_cases import KINDS, lookahead_panel, next_block_panel, scaled_rows
from plan_rules import (
    AUTO_PLANS,
    CAND_BYTES,
    CARRIED_PER_CALL,
    CARRY_MAX,
    CARRY_RULE,
    EXCHANGE_RULE,
    HEADER,
    ITEM_BYTES,
    WIDTH,
    exchange_bytes,
    SMEM_MAX,
    carried_blocks,
    header_exchange_rule,
    lu_carried,
    rule_of,
    rule_plan,
)
from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    micro_blocked_lu,
    offset_panel_lu,
    unblocked_lu,
    unblocked_lu_cabs1,
)

torch.set_num_threads(1)


def blocked_order_lu(A, ofs, pivot, b):
    """The cluster route's order on the (H, w) panel ``A`` from row
    ``ofs``.  Returns ``(LU, piv, perm, info)`` as ``offset_panel_lu``
    does (global pivot rows, the permutation of all H rows)."""
    A = A.clone()
    H, w = A.shape
    steps = min(H - ofs, w)
    piv = torch.arange(steps, dtype=torch.int32) + ofs
    perm = torch.arange(H, dtype=torch.int32)
    info = 0
    for k0 in range(0, steps, b):
        k1 = min(k0 + b, steps)
        nb, r0 = k1 - k0, ofs + k0
        # 1. the chain on the slab: rows [r0, H), columns [k0, k1)
        S = A[r0:, k0:k1].clone()
        src = torch.arange(H - r0)  # which slab row each position holds
        pid = perm[r0:].clone()
        for kk in range(nb):
            kp = kk + int(torch.argmax(S[kk:, kk].abs())) if pivot else kk
            piv[k0 + kk] = r0 + kp
            nz = bool(S[kp, kk] != 0)
            if nz and kp != kk:
                S[[kk, kp]] = S[[kp, kk]]
                src[[kk, kp]] = src[[kp, kk]]
                pid[[kk, kp]] = pid[[kp, kk]]
            if nz:
                S[kk + 1:, kk].mul_(torch.reciprocal(S[kk, kk]))
            elif info == 0:
                info = k0 + kk + 1 if pivot else -(k0 + kk + 1)
            if kk + 1 < nb:
                S[kk + 1:, kk + 1:].sub_(torch.outer(S[kk + 1:, kk], S[kk, kk + 1:]))
        perm[r0:] = pid
        # 2. the delayed pass: swaps outside the slab, U rows, rows below
        outside = [c for c in range(w) if not k0 <= c < k1]
        if outside:
            A[r0:, outside] = A[r0:][src][:, outside]
        A[r0:, k0:k1] = S
        for s in range(nb - 1):
            A[r0 + s + 1:r0 + nb, k1:].sub_(
                torch.outer(A[r0 + s + 1:r0 + nb, k0 + s], A[r0 + s, k1:]))
        for s in range(nb):
            A[r0 + nb:, k1:].sub_(torch.outer(A[r0 + nb:, k0 + s], A[r0 + s, k1:]))
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


def _outer_sub(Re, Im, lre, lim, ure, uim):
    """The complex rank-1 update on the planes, each product, sum and
    difference a rounded tensor op (``unblocked_lu_cabs1``'s order)."""
    Re.sub_(torch.outer(lre, ure) - torch.outer(lim, uim))
    Im.sub_(torch.outer(lre, uim) + torch.outer(lim, ure))


def blocked_order_lu_cabs1(A, pivot, b):
    """The cluster route's order on the complex (m, w) panel ``A``, with the
    complex kernel's rules: CABS1 pivots (the first row of the largest
    |re| + |im|; a NaN among the candidates makes the pivot row m - 1),
    the scale by conj(p) / |p|^2 and the complex update, each rounding a
    tensor op on the real and imaginary planes.  Returns ``(LU, piv,
    perm, info)`` as ``unblocked_lu_cabs1`` does."""
    A = A.clone()
    V = torch.view_as_real(A)
    Re, Im = V[..., 0], V[..., 1]
    m, w = A.shape
    steps = min(m, w)
    piv = torch.arange(steps, dtype=torch.int32)
    perm = torch.arange(m, dtype=torch.int32)
    info = 0
    for k0 in range(0, steps, b):
        k1 = min(k0 + b, steps)
        nb = k1 - k0
        # 1. the chain on the slab: rows [k0, m), columns [k0, k1)
        S = V[k0:, k0:k1].clone()
        Sre, Sim = S[..., 0], S[..., 1]
        src = torch.arange(m - k0)
        pid = perm[k0:].clone()
        for kk in range(nb):
            kp = kk
            if pivot:
                cabs = Sre[kk:, kk].abs() + Sim[kk:, kk].abs()
                hit = (cabs == cabs.max()).nonzero()
                kp = kk + int(hit[0]) if hit.numel() else m - k0 - 1
            piv[k0 + kk] = k0 + kp
            nz = bool((Sre[kp, kk] != 0) | (Sim[kp, kk] != 0))
            if nz and kp != kk:
                S[[kk, kp]] = S[[kp, kk]]
                src[[kk, kp]] = src[[kp, kk]]
                pid[[kk, kp]] = pid[[kp, kk]]
            lre, lim = Sre[kk + 1:, kk], Sim[kk + 1:, kk]
            if nz:
                pr, pi = Sre[kk, kk], Sim[kk, kk]
                d = pr * pr + pi * pi
                ir, ii = pr / d, -pi / d
                sre = lre * ir - lim * ii
                sim = lre * ii + lim * ir
                lre.copy_(sre)
                lim.copy_(sim)
            elif info == 0:
                info = k0 + kk + 1 if pivot else -(k0 + kk + 1)
            if kk + 1 < nb:
                _outer_sub(Sre[kk + 1:, kk + 1:], Sim[kk + 1:, kk + 1:], lre, lim,
                           Sre[kk, kk + 1:], Sim[kk, kk + 1:])
        perm[k0:] = pid
        # 2. the delayed pass: swaps outside the slab, U rows, rows below
        outside = [c for c in range(w) if not k0 <= c < k1]
        if outside:
            V[k0:, outside] = V[k0:][src][:, outside]
        V[k0:, k0:k1] = S
        for s in range(nb - 1):
            rows = slice(k0 + s + 1, k0 + nb)
            _outer_sub(Re[rows, k1:], Im[rows, k1:], Re[rows, k0 + s], Im[rows, k0 + s],
                       Re[k0 + s, k1:], Im[k0 + s, k1:])
        for s in range(nb):
            _outer_sub(Re[k0 + nb:, k1:], Im[k0 + nb:, k1:], Re[k0 + nb:, k0 + s],
                       Im[k0 + nb:, k0 + s], Re[k0 + s, k1:], Im[k0 + s, k1:])
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


class _RealOps:
    """One element kind's arithmetic, one rounded tensor op per rounding:
    real elements."""

    @staticmethod
    def mag(x):
        return x.abs()

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def rcp(p):
        return torch.reciprocal(p)

    @staticmethod
    def nonzero(p):
        return bool(p != 0)


class _Cabs1Ops:
    """The same on (re, im) pairs, the last dimension of a real view:
    CABS1 magnitudes and the complex kernel's product and reciprocal."""

    @staticmethod
    def mag(x):
        return x[..., 0].abs() + x[..., 1].abs()

    @staticmethod
    def mul(a, b):
        return torch.stack((a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                            a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]), -1)

    @staticmethod
    def rcp(p):
        d = p[0] * p[0] + p[1] * p[1]
        return torch.stack((p[0] / d, -p[1] / d))

    @staticmethod
    def nonzero(p):
        return bool((p[0] != 0) | (p[1] != 0))


def _first_best(v):
    """The kernels' pivot order on magnitudes ``v``: the first NaN, else
    the first of the largest."""
    nan = torch.isnan(v).nonzero()
    return int(nan[0]) if nan.numel() else int((v == v.max()).nonzero()[0])


def _rank1(E, S, rows, kd, cmin, u):
    """Step kd's update of slab ``rows`` in the columns >= cmin."""
    if rows and cmin < S.shape[1]:
        idx = torch.tensor(rows)
        S[idx, cmin:] = S[idx, cmin:] - E.mul(S[idx, kd][:, None], u[cmin:][None])


def _lookahead_chain(E, S, src, pid, piv, info, k0, r0, nb, ncol, pivot, C, cplx):
    """The chain kernel's steps on the slab ``S`` (the block's live rows from
    global row ``r0``, its ``ncol`` columns) on a cluster of ``C`` CTAs, as
    ``lookahead_order_lu`` describes them; ``src`` / ``pid`` travel with the
    rows, ``piv`` takes the global pivot rows.  Returns info."""
    M = S.shape[0]
    R = -(-M // C)
    u = None
    for kk in range(nb):
        late, ahead = kk > 0, kk + 1 < ncol
        cands = []
        if pivot:
            for s0 in range(0, M, R):
                lo, hi = max(kk, s0), min(M, s0 + R)
                if lo < hi:
                    q = lo + _first_best(E.mag(S[lo:hi, kk]))
                    cands.append((q, E.mag(S[q, kk])))
        pub = {q for q, _ in cands} | {kk}
        if late:
            _rank1(E, S, sorted(pub), kk - 1, kk + 1, u)
            _rank1(E, S, [q for q in range(kk, M) if q not in pub], kk - 1, kk + 2, u)
        kp, urow = kk, S[kk].clone()
        if pivot:
            best = min(cands, key=lambda c: (0, 0.0, c[0]) if bool(torch.isnan(c[1]))
                       else (1, -float(c[1]), c[0]))
            kp, urow = best[0], S[best[0]].clone()
            if cplx and bool(torch.isnan(best[1])):
                kp, urow = M - 1, S[M - 1].clone()
                if late and ahead and kp not in pub:
                    urow[kk + 1] = urow[kk + 1] - E.mul(S[kp, kk - 1], u[kk + 1])
        piv[k0 + kk] = r0 + kp
        nz = E.nonzero(urow[kk])
        moved = -1
        if nz and kp != kk:
            S[kp] = S[kk].clone()
            S[kk] = urow
            src[[kk, kp]] = src[[kp, kk]]
            pid[[kk, kp]] = pid[[kp, kk]]
            moved = kp
        elif not nz and info == 0:
            info = k0 + kk + 1 if pivot else -(k0 + kk + 1)
        if nz:
            S[kk + 1:, kk] = E.mul(S[kk + 1:, kk], E.rcp(urow[kk]))
        if ahead:
            due = [q for q in range(kk + 1, M) if late and q != moved and q not in pub]
            if due:
                idx = torch.tensor(due)
                S[idx, kk + 1] = S[idx, kk + 1] - E.mul(S[idx, kk - 1], u[kk + 1])
            S[kk + 1:, kk + 1] = S[kk + 1:, kk + 1] - E.mul(S[kk + 1:, kk], urow[kk + 1])
        u = urow
    if ncol > nb + 1:
        _rank1(E, S, list(range(nb, M)), nb - 1, nb + 1, u)
    return info


def lookahead_order_lu(A, ofs, pivot, b, C):
    """The cluster route's order with the chain kernel's one-column
    look-ahead, on the (H, w) panel ``A`` from row ``ofs`` (real or
    complex) and a cluster of ``C`` CTAs.  Per step kk of a block:

    1. each CTA's candidate in column kk (its rows >= kk), which is up to
       date;
    2. the rows the step publishes (every candidate, row kk) take step
       kk - 1's update in their columns > kk;
    3. every other row >= kk takes it in its columns > kk + 1 (the
       deferred update, inside the exchange on the card);
    4. the pivot (complex panels: row m - 1 after a NaN candidate, brought
       up to date in column kk + 1 as its owner publishes it), the swap;
    5. the rows below kk: column kk scaled, column kk + 1 takes step
       kk - 1's update where it is still due (not a published row, not the
       row the swap brought) and step kk's, the look-ahead column.

    After the block's last step the columns past it (one block of a panel
    with fewer live rows than columns) take its update; then the delayed
    pass, as in ``blocked_order_lu``.  Returns ``(LU, piv, perm, info)``
    as ``offset_panel_lu`` (``unblocked_lu_cabs1`` for complex) does."""
    cplx = A.is_complex()
    E = _Cabs1Ops if cplx else _RealOps
    A = A.clone()
    V = torch.view_as_real(A) if cplx else A
    H, w = A.shape
    steps = min(H - ofs, w)
    piv = torch.arange(steps, dtype=torch.int32) + ofs
    perm = torch.arange(H, dtype=torch.int32)
    info = 0
    one = b >= w
    for k0 in range(0, steps, b):
        k1 = min(k0 + b, steps)
        nb, r0 = k1 - k0, ofs + k0
        ncol = w if one else nb
        S = V[r0:, k0:k0 + ncol].clone()
        src = torch.arange(H - r0)
        pid = perm[r0:].clone()
        info = _lookahead_chain(E, S, src, pid, piv, info, k0, r0, nb, ncol, pivot, C, cplx)
        perm[r0:] = pid
        # the delayed pass: swaps outside the slab, U rows, rows below
        outside = [c for c in range(w) if not k0 <= c < k0 + ncol]
        if outside:
            V[r0:, outside] = V[r0:][src][:, outside]
        V[r0:, k0:k0 + ncol] = S
        if one:
            continue
        for s in range(nb - 1):
            rows = slice(r0 + s + 1, r0 + nb)
            V[rows, k1:] = V[rows, k1:] - E.mul(V[rows, k0 + s][:, None], V[r0 + s, k1:][None])
        for s in range(nb):
            rows = slice(r0 + nb, H)
            V[rows, k1:] = V[rows, k1:] - E.mul(V[rows, k0 + s][:, None], V[r0 + s, k1:][None])
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


def _delayed_pass(E, V, k0, nb, r0, src, cols, sum_first):
    """Block ``[k0, k0 + nb)``'s delayed pass (its rows from global row
    ``r0``, ``src`` the slab row each position holds) in the columns
    ``cols``, as panel_swap_solve_kernel and panel_update_kernel run it: the
    row moves, then in the columns past the block its U rows solved row by
    row and the rank-nb update of the rows below in step order (``sum_first``:
    an accumulator from 0 takes each product, then one difference)."""
    if not cols:
        return
    idx = torch.tensor(cols)
    V[r0:, idx] = V[r0:][src][:, idx]
    right = torch.tensor([c for c in cols if c >= k0 + nb])
    if not right.numel():
        return
    for s in range(nb - 1):
        rows = slice(r0 + s + 1, r0 + nb)
        V[rows, right] = V[rows, right] - E.mul(V[rows, k0 + s][:, None], V[r0 + s, right][None])
    rows = slice(r0 + nb, V.shape[0])
    acc = torch.zeros_like(V[rows, right])
    for s in range(nb):
        prod = E.mul(V[rows, k0 + s][:, None], V[r0 + s, right][None])
        if sum_first:
            acc = acc + prod
        else:
            V[rows, right] = V[rows, right] - prod
    if sum_first:
        V[rows, right] = V[rows, right] - acc


def carry_order_lu(A, ofs, pivot, b, C, sum_first=False):
    """The cluster route's order with one block of look-ahead
    (csrc/panel_cluster.cuh `run_cluster`'s carry), on the (H, w) panel
    ``A`` from row ``ofs``, each block's chain in the chain kernel's order
    on a cluster of ``C`` CTAs (``_lookahead_chain``).  Block j's delayed
    pass is split in two:

    * the near part, block j + 1's own columns: chain j + 1 applies block
      j's row moves to its slab as it loads it, solves block j's U rows in
      those columns and updates the slab with block j's rank-nb update,
      before its first step;
    * the far part, every other column: the two delayed kernels, run
      beside chain j + 1 (disjoint columns), after it here.

    The panel's last block takes its whole pass after its chain, as does
    every block of a one-block plan (none).  ``sum_first``: the
    micro-blocked kernels' update (``_delayed_update``'s order).  Returns
    ``(LU, piv, perm, info)`` as ``offset_panel_lu`` does."""
    cplx = A.is_complex()
    E = _Cabs1Ops if cplx else _RealOps
    A = A.clone()
    V = torch.view_as_real(A) if cplx else A
    H, w = A.shape
    steps = min(H - ofs, w)
    piv = torch.arange(steps, dtype=torch.int32) + ofs
    perm = torch.arange(H, dtype=torch.int32)
    info = 0
    one = b >= w
    prev = None  # (k0, nb, r0, src) of the block whose far part is due
    for k0 in range(0, steps, b):
        k1 = min(k0 + b, steps)
        nb, r0 = k1 - k0, ofs + k0
        ncol = w if one else nb
        if prev is not None:  # the near part, at load
            _delayed_pass(E, V, *prev, list(range(k0, k1)), sum_first)
        S = V[r0:, k0:k0 + ncol].clone()
        src = torch.arange(H - r0)
        pid = perm[r0:].clone()
        info = _lookahead_chain(E, S, src, pid, piv, info, k0, r0, nb, ncol, pivot, C, cplx)
        perm[r0:] = pid
        V[r0:, k0:k0 + ncol] = S
        if prev is not None:  # the far part, beside this chain
            pk0 = prev[0]
            _delayed_pass(E, V, *prev, [c for c in range(w) if c < pk0 or c >= k1], sum_first)
        prev = None
        if one:
            continue
        if k1 < steps:
            prev = (k0, nb, r0, src)
        else:
            _delayed_pass(E, V, k0, nb, r0, src, [c for c in range(w) if not k0 <= c < k1],
                          sum_first)
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t).contiguous()
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _assert_same(got, want):
    assert torch.equal(got[1], want[1]), "piv"
    assert torch.equal(got[2], want[2]), "perm"
    assert int(got[3]) == int(want[3]), "info"
    assert torch.equal(_bits(got[0]), _bits(want[0])), "factors"


def _panel(seed, m, w, dtype, pivot, ofs=0):
    A = np.random.default_rng(seed).standard_normal((m, w))
    if not pivot:
        k = min(m - ofs, w)
        A[ofs + np.arange(k), np.arange(k)] += m
    return torch.tensor(A, dtype=dtype)


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("w", [1, 5, 32, 64])
@pytest.mark.parametrize("m", [7, 64, 200])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_blocked_order_equals_unblocked_lu(b, m, w, pivot):
    b = w if b == "w" else b
    A = _panel(1000 * m + w, m, w, torch.float32, pivot)
    _assert_same(blocked_order_lu(A, 0, pivot, b), unblocked_lu(A, pivot))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_blocked_order_on_ties_zero_column_and_nan(dtype, b):
    m, w = 64, 32
    b = w if b == "w" else b
    g = torch.Generator().manual_seed(3)
    ties = torch.randint(-2, 3, (m, w), generator=g).to(dtype)
    _assert_same(blocked_order_lu(ties, 0, True, b), unblocked_lu(ties, True))
    for pivot in (True, False):
        Z = _panel(5, m, w, dtype, pivot)
        Z[:, 9] = 0  # a zero pivot at step 10: no swap, no scale, update runs
        got = blocked_order_lu(Z, 0, pivot, b)
        _assert_same(got, unblocked_lu(Z, pivot))
        assert int(got[3]) == (10 if pivot else -10)
    N = _panel(6, m, w, dtype, True)
    N[40, 3] = N[50, 3] = float("nan")  # the first NaN row wins
    got = blocked_order_lu(N, 0, True, b)
    _assert_same(got, unblocked_lu(N, True))
    assert int(got[1][3]) == 40


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("ofs", [1, 37, 136])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_blocked_order_equals_offset_panel_lu(b, ofs, pivot):
    H, w = 200, 64
    b = w if b == "w" else b
    A = _panel(ofs, H, w, torch.float64, pivot, ofs)
    A[ofs + 20:, 11] = 0
    got = blocked_order_lu(A, ofs, pivot, b)
    _assert_same(got, offset_panel_lu(A, ofs, pivot))
    assert torch.equal(_bits(got[0][:ofs]), _bits(A[:ofs]))  # rows above untouched


def _complex_panel(name, m, w, dtype, pivot):
    rng = np.random.default_rng([m, w, len(name), ord(name[-1])])
    if name == "ties":  # exact CABS1 ties on integer parts
        A = rng.integers(-2, 3, (m, w)) + 1j * rng.integers(-2, 3, (m, w))
    else:
        A = rng.standard_normal((m, w)) + 1j * rng.standard_normal((m, w))
    if not pivot:
        A[np.arange(min(m, w)), np.arange(min(m, w))] += m
    if name == "zero_col":
        A[:, 9] = 0
    if name == "nan_re":
        A[40, 3] = complex(np.nan, 1.0)
    if name == "nan_im":
        A[40, 3] = complex(1.0, np.nan)
    if name == "nan_last_row":
        A[m - 1, 3] = complex(np.nan, 1.0)
    return torch.tensor(A, dtype=dtype)


@pytest.mark.parametrize("name, pivot", [("randn", True), ("randn", False), ("ties", True),
                                         ("zero_col", True), ("zero_col", False),
                                         ("nan_re", True), ("nan_im", True),
                                         ("nan_last_row", True)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b", [8, 16, 32, "w"])
def test_complex_blocked_order_equals_unblocked_lu_cabs1(b, dtype, name, pivot):
    """The cluster route's delayed order keeps the complex kernel's bits:
    ties take the first row, a zeroed column gives info 10 (-10 unpivoted)
    with no swap and no scale, and a NaN in re, in im or at row m - 1 makes
    every later pivot row m - 1."""
    m, w = 96, 40  # ragged last blocks at b = 16 and 32
    b = w if b == "w" else b
    A = _complex_panel(name, m, w, dtype, pivot)
    got = blocked_order_lu_cabs1(A, pivot, b)
    want = unblocked_lu_cabs1(A, pivot)
    nan = torch.isnan(torch.view_as_real(want[0]))
    assert torch.equal(torch.isnan(torch.view_as_real(got[0])), nan)
    _assert_same((got[0].masked_fill(nan.any(-1), 0),) + got[1:],
                 (want[0].masked_fill(nan.any(-1), 0),) + want[1:])
    if name == "zero_col":
        assert int(got[3]) == (10 if pivot else -10)
    if name.startswith("nan"):
        assert (got[1][3:] == m - 1).all() and (got[1][:3] != m - 1).all()


@pytest.mark.parametrize("C", [4, 16])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("w", [1, 5, 32, 64])
@pytest.mark.parametrize("m", [7, 64, 200])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_lookahead_order_equals_unblocked_lu(b, m, w, pivot, C):
    """The chain kernel's one-column look-ahead (the update deferred behind
    the next exchange, the published rows brought up to date first and
    skipped) keeps unblocked_lu's bits."""
    b = w if b == "w" else b
    A = _panel(1000 * m + w, m, w, torch.float32, pivot)
    _assert_same(lookahead_order_lu(A, 0, pivot, b, C), unblocked_lu(A, pivot))


@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_lookahead_order_on_ties_zero_column_and_nan(dtype, b, C):
    m, w = 64, 32
    b = w if b == "w" else b
    g = torch.Generator().manual_seed(3)
    ties = torch.randint(-2, 3, (m, w), generator=g).to(dtype)
    _assert_same(lookahead_order_lu(ties, 0, True, b, C), unblocked_lu(ties, True))
    for pivot in (True, False):
        Z = _panel(5, m, w, dtype, pivot)
        Z[:, 9] = 0  # a zero pivot at step 10: no swap, no scale, update runs
        got = lookahead_order_lu(Z, 0, pivot, b, C)
        _assert_same(got, unblocked_lu(Z, pivot))
        assert int(got[3]) == (10 if pivot else -10)
    N = _panel(6, m, w, dtype, True)
    N[40, 3] = N[50, 3] = float("nan")  # the first NaN row wins
    got = lookahead_order_lu(N, 0, True, b, C)
    _assert_same(got, unblocked_lu(N, True))
    assert int(got[1][3]) == 40


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
@pytest.mark.parametrize("b", [8, 16, "w"])
def test_lookahead_order_on_pivots_at_published_rows(b, dtype, kind):
    """Pivots on the rows the look-ahead brings up to date early: every
    winner row gk itself (``diag``), winners on CTA boundaries, the same
    row its CTA's candidate in many steps running."""
    m, w, C = 200, 48, 8
    b = w if b == "w" else b
    A = lookahead_panel(kind, m, w, C, dtype)
    plain = unblocked_lu_cabs1 if dtype.is_complex else unblocked_lu
    want = plain(A, True)
    _assert_same(lookahead_order_lu(A, 0, True, b, C), want)
    if kind == "diag":
        assert torch.equal(want[1], torch.arange(w, dtype=torch.int32))
    elif kind != "randn":  # the first steps' winners are the scaled rows
        assert int(want[1][0]) in scaled_rows(kind, m, C)


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("ofs", [1, 37, 136])
@pytest.mark.parametrize("b", [1, 3, 8, 32, "w"])
def test_lookahead_order_equals_offset_panel_lu(b, ofs, pivot):
    H, w = 200, 64
    b = w if b == "w" else b
    A = _panel(ofs, H, w, torch.float64, pivot, ofs)
    A[ofs + 20:, 11] = 0
    got = lookahead_order_lu(A, ofs, pivot, b, 16)
    _assert_same(got, offset_panel_lu(A, ofs, pivot))
    assert torch.equal(_bits(got[0][:ofs]), _bits(A[:ofs]))  # rows above untouched


@pytest.mark.parametrize("name, pivot", [("randn", True), ("randn", False), ("ties", True),
                                         ("zero_col", True), ("zero_col", False),
                                         ("nan_re", True), ("nan_im", True),
                                         ("nan_last_row", True)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b", [8, 16, 32, "w"])
def test_complex_lookahead_order_equals_unblocked_lu_cabs1(b, dtype, name, pivot):
    """The look-ahead keeps the complex kernel's bits, the NaN rule too:
    row m - 1, published after a NaN candidate, takes the update its
    look-ahead column still owes."""
    m, w = 96, 40
    b = w if b == "w" else b
    A = _complex_panel(name, m, w, dtype, pivot)
    got = lookahead_order_lu(A, 0, pivot, b, 16)
    want = unblocked_lu_cabs1(A, pivot)
    nan = torch.isnan(torch.view_as_real(want[0]))
    assert torch.equal(torch.isnan(torch.view_as_real(got[0])), nan)
    _assert_same((got[0].masked_fill(nan.any(-1), 0),) + got[1:],
                 (want[0].masked_fill(nan.any(-1), 0),) + want[1:])
    if name.startswith("nan"):
        assert (got[1][3:] == m - 1).all() and (got[1][:3] != m - 1).all()


# ---- one block of look-ahead: the next chain takes the pass at load --------
#
# run_cluster's carry (csrc/panel_cluster.cuh): block j's delayed pass in
# block j + 1's columns runs inside chain j + 1's load, the rest beside that
# chain.  carry_order_lu emulates it; every form keeps its plain version's
# bits, the sum-first one (the micro-blocked kernels) micro_blocked_lu's.


@pytest.mark.parametrize("ofs", [0, 37])
@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
@pytest.mark.parametrize("m,w", [(45, 40), (301, 100)])
def test_carry_order_equals_the_plain_versions(m, w, b, C, ofs):
    """Ragged heights (CTAs with fewer rows, at 45 rows and C = 16 one with
    none; ragged last blocks), every b of the cluster route, from row 0 and
    from an offset, with and without pivoting."""
    H = m + ofs
    for pivot in (True, False):
        A = _panel(7 * m + b + ofs, H, w, torch.float32, pivot, ofs)
        want = offset_panel_lu(A, ofs, pivot) if ofs else unblocked_lu(A, pivot)
        got = carry_order_lu(A, ofs, pivot, b, C)
        _assert_same(got, want)
        assert torch.equal(_bits(got[0][:ofs]), _bits(A[:ofs]))


@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
@pytest.mark.parametrize("m,w", [(45, 40), (301, 100), (100, 301)])
def test_carry_order_sum_first_equals_micro_blocked_lu(m, w, b, C):
    """The micro-blocked kernels' form: the update sums its products first
    (``_delayed_update``'s order), in the near part as in the far part; a
    fat panel ends with the last block's solve."""
    for pivot in (True, False):
        A = _panel(11 * m + b, m, w, torch.float64, pivot)
        _assert_same(carry_order_lu(A, 0, pivot, b, C, sum_first=True),
                     micro_blocked_lu(A, pivot, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
@pytest.mark.parametrize("b", [8, 16, 32])
def test_carry_order_on_pivots_in_the_next_blocks_rows(dtype, b):
    """Every pivot of a block in the next block's rows: the moves bring rows
    into the next chain's slab and send its rows into the block's U rows."""
    m, w, C = 200, 96, 8
    A = next_block_panel(m, w, b, dtype)
    plain = unblocked_lu_cabs1 if dtype.is_complex else unblocked_lu
    want = plain(A, True)
    k = torch.arange(min(w, m - b), dtype=torch.int32)
    assert torch.equal(want[1][:len(k)], k + b)  # the panel puts them there
    _assert_same(carry_order_lu(A, 0, True, b, C), want)


@pytest.mark.parametrize("name, pivot", [("randn", True), ("ties", True), ("zero_col", False),
                                         ("nan_re", True), ("nan_last_row", True)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b", [8, 16])
def test_complex_carry_order_equals_unblocked_lu_cabs1(b, dtype, name, pivot):
    m, w = 96, 40
    A = _complex_panel(name, m, w, dtype, pivot)
    got = carry_order_lu(A, 0, pivot, b, 16)
    want = unblocked_lu_cabs1(A, pivot)
    nan = torch.isnan(torch.view_as_real(want[0]))
    assert torch.equal(torch.isnan(torch.view_as_real(got[0])), nan)
    _assert_same((got[0].masked_fill(nan.any(-1), 0),) + got[1:],
                 (want[0].masked_fill(nan.any(-1), 0),) + want[1:])


def test_carry_rule_is_the_headers():
    """tests/plan_rules.py mirrors run_cluster's engagement rule: its
    conditions, kCarryMax and kSmemMax as the header has them."""
    import re

    text = HEADER.read_text()
    assert CARRY_RULE in " ".join(text.split())
    assert int(re.search(r"constexpr int kCarryMax = (\d+);", text).group(1)) == CARRY_MAX
    assert "constexpr size_t kSmemMax = 232448 - 1024;" in text and SMEM_MAX == 232448 - 1024
    assert "carry_base(chain_smem<T>(chain_rows(k1), pl.C, pl.B, true).total) +" in text


@pytest.mark.parametrize("dtype_name,n", sorted(CARRIED_PER_CALL))
def test_carried_blocks_in_the_cells_keys(dtype_name, n):
    """Every chain of the cells' lu calls but each panel's first takes the
    previous block's pass: 200 / 704 / 136 a call."""
    assert lu_carried(dtype_name, n) == CARRIED_PER_CALL[(dtype_name, n)]
    blocks = sum(-(-min(m, WIDTH) // (AUTO_PLANS[dtype_name].get(m)
                                       or rule_plan(rule_of(dtype_name), m))[0])
                 for m in range(n, 0, -WIDTH))
    assert lu_carried(dtype_name, n) == blocks - n // WIDTH


def test_carried_blocks_stay_zero_where_the_rule_says():
    """None for the bf16x3 form, for one-block plans, for blocks beside a
    grid-chain block, or past kCarryMax steps; one fewer than the blocks on
    a plan that fits."""
    assert carried_blocks("float32", 4096, 512, 16, 16) == 31
    assert carried_blocks("float32", 4096, 512, 32, 16, form="bf16x3") == 0
    assert carried_blocks("float32", 4096, 512, 512, 16) == 0  # one block
    assert carried_blocks("float32", 100, 40, 64, 1) == 0
    assert carried_blocks("float64", 1536, 512, 64, 16) == 0  # b past kCarryMax
    assert carried_blocks("float64", 1536, 512, 32, 16, form="sum_first", grid_blocks=4) == 11
    # a slab too large for the carry's room beside it (the chain alone fits
    # up to ~89 000 float32 rows at b 8, with the carry ~47 000): no carry
    assert carried_blocks("float32", 60000, 512, 8, 16) == 0
    assert carried_blocks("float32", 40000, 512, 8, 16) == 63


# ---- the chain's exchange: the bytes each CTA receives in a step -----------
#
# panel_chain_kernel arms each CTA's mbarrier of the step's parity with
# chain_exchange_bytes (tests/plan_rules.py mirrors it); the emulation below
# replays who sends what in each step (the candidate search over the CTA's
# rows, warp 0's candidate and row, the owner's row gk, each row in the
# kernel's 16-byte pieces by lane) and counts what each CTA receives.

INT_MAX = 2**31 - 1


def _row_bytes_by_receiver(dtype_name, B, C):
    """What each CTA receives when one CTA sends one row (send_row: V pieces
    of 16 bytes; lane l sends piece l % V to the CTAs l / V, l / V + DV, ...
    when V <= 32, else pieces l, l + 32, ... to every CTA)."""
    V = B * ITEM_BYTES[dtype_name] // 16
    NCH, DV = (V // 32, 1) if V > 32 else (1, 32 // V)
    got = [0] * C
    for lane in range(32):
        for _ in range(NCH):
            for d in range(0 if V > 32 else lane // V, C, DV):
                got[d] += 16
    return got


def _sent_in_a_block(dtype_name, mags, nb, C, B, pivot):
    """Per step of a block with M = len(mags) slab rows (the magnitudes of
    a step's column: the search ranks them as the kernel's `better` does,
    a NaN first, then the largest, then the first row) on a cluster of C,
    the bytes each CTA receives."""
    M = len(mags)
    rows = -(-M // C)
    row = _row_bytes_by_receiver(dtype_name, B, C)
    cand = CAND_BYTES[dtype_name]
    steps = []
    for kk in range(nb):
        got = [0] * C
        for d in range(C):
            s0 = d * rows
            seg = mags[max(kk, s0):min(M, s0 + rows)]
            qc = -1
            if pivot and seg.size and (np.isnan(seg) | (seg > -1)).any():
                nan = np.flatnonzero(np.isnan(seg))
                qc = max(kk, s0) - s0 + int(nan[0] if nan.size else np.argmax(seg))
            qk = kk - s0 if d == kk // rows else -1
            for lane in range(min(C, 32)):  # warp 0: the candidate, to every CTA
                got[lane] += cand
            if qc >= 0:  # its row
                got = [g + r for g, r in zip(got, row)]
            if qk >= 0:  # row gk and its (perm id, origin): warp 0 when qc == qk, else
                got = [g + r + 8 for g, r in zip(got, row)]  # the last warp
        steps.append(got)
    return steps


def _check_exchange(dtype_name, m, w, b, C, pivot, rng):
    """Every block of an (m, w) panel on plan (b, C): the rule equals what
    every CTA receives at every step."""
    steps = min(m, w)
    B = b if b < w else 1 << max(3, (w - 1).bit_length())
    for k0 in range(0, steps, b):
        M = m - k0
        mags = np.abs(rng.standard_normal(M))
        mags[rng.integers(0, M, 3)] = 0.0
        mags[rng.integers(0, M, 2)] = mags[0]  # ties
        if rng.random() < 0.5:
            mags[rng.integers(0, M)] = np.nan
        rows = -(-M // C)
        nb = min(b, steps - k0)
        for kk, got in enumerate(_sent_in_a_block(dtype_name, mags, nb, C, B, pivot)):
            want = exchange_bytes(dtype_name, M, rows, C, B, kk, pivot)
            assert got == [want] * C, (dtype_name, m, w, b, C, pivot, k0, kk, got, want)


def test_exchange_byte_rule_is_the_headers():
    """csrc/panel_cluster.cuh's chain_exchange_bytes is the rule that
    tests/plan_rules.py mirrors, and the chain kernel arms its barrier with it."""
    assert header_exchange_rule() == EXCHANGE_RULE
    text = HEADER.read_text()
    assert "mbar_arrive_tx(bar, chain_exchange_bytes<T>(M, R_, C, B, kk, p.pivot != 0))" in text


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype_name", sorted(ITEM_BYTES))
def test_exchange_bytes_equal_what_the_ctas_send_on_ragged_heights(dtype_name, pivot):
    """Heights that are no multiple of C x rows (some CTAs hold fewer rows,
    at 45 rows and C = 16 one holds none), where CTAs run out of live rows
    partway through a block, at every b and C of the cluster route."""
    rng = np.random.default_rng([4, len(dtype_name), pivot])
    for m, w in ((45, 40), (301, 100), (1001, 100)):
        for b in (8, 16, 32, 64):
            for C in (2, 4, 8, 16):
                _check_exchange(dtype_name, m, w, b, C, pivot, rng)


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype_name,n", [("float32", 4096), ("float32", 8192),
                                          ("float64", 4096), ("complex64", 4096),
                                          ("complex128", 4096)])
def test_exchange_bytes_equal_what_the_ctas_send_at_the_cells_plans(dtype_name, n, pivot):
    """Every panel of a blocked lu at n (n - 512 k live rows, 512 columns)
    on its auto plan: the pinned one (tests/plan_rules.py), the header's
    rule where none is pinned."""
    rng = np.random.default_rng([5, n, len(dtype_name), pivot])
    for m in range(n, 0, -WIDTH):
        b, C = AUTO_PLANS[dtype_name].get(m) or rule_plan(rule_of(dtype_name), m)
        _check_exchange(dtype_name, m, WIDTH, b, C, pivot, rng)


def test_panel_plan_takes_complex_dtypes_and_refuses_bad_requests(monkeypatch):
    """panel_plan hands complex dtypes to csrc/panel_lu_c64.cu's plan (with
    the element's byte size), with an offset too (its offset form), and
    refuses, before any build, what no kernel takes: other dtypes, a block
    or cluster that is not an int."""
    asked = []

    def fake_plan(cplx, m, w, size, ofs, block, cluster, index):
        asked.append((cplx, m, w, size, ofs, block, cluster, index))
        return (1, 16, 4, 3, 1, 99, 0) if block >= 0 else (0, -1, 132, 1, 7, 8, 0)

    monkeypatch.setattr(panel_mod, "_plan", fake_plan)
    plan = panel_mod.panel_plan(1000, 40, torch.complex64, device="cuda:0")
    assert plan == {"route": "cluster", "block": 16, "cluster": 4, "grid": None, "blocks": 3,
                    "ws_reals": 1, "iws_ints": 99, "grid_blocks": 0}
    plan = panel_mod.panel_plan(1000, 40, torch.complex128, block=-1, device="cuda:0")
    assert plan["route"] == "grid" and plan["grid"] == 132 and plan["block"] is None
    panel_mod.panel_plan(1000, 40, torch.float64, ofs=5, block=8, cluster=2, device="cuda:0")
    panel_mod.panel_plan(1000, 40, torch.complex64, ofs=960, device="cuda:0")
    assert asked == [(True, 1000, 40, 8, None, 0, 0, 0), (True, 1000, 40, 16, None, -1, 0, 0),
                     (False, 1000, 40, 8, 5, 8, 2, 0), (True, 1000, 40, 8, 960, 0, 0, 0)]
    for kw in ({"dtype": torch.int32}, {"dtype": torch.int32, "ofs": 0},
               {"dtype": torch.float16}, {"dtype": torch.complex64, "block": True},
               {"dtype": torch.float32, "cluster": 2.0}):
        with pytest.raises(ValueError):
            panel_mod.panel_plan(1000, 40, device="cuda:0", **kw)
    assert len(asked) == 4
    with pytest.raises(ValueError):  # the launching wrapper takes CUDA tensors only
        panel_mod.panel_factor_c64_cuda(torch.zeros(8, 4, dtype=torch.complex64), True,
                                        block=8, cluster=1)
    assert panel_mod.panel_factor_c64_cuda.counts.launches == 0
    assert panel_mod.panel_factor_c64_cuda.counts.grid_route_launches == 0


def test_reset_counts_zeroes_every_panel_wrapper():
    """Every launching wrapper of ops/panel.py keeps one LaunchCounts in
    ``.counts``, and ``reset_counts`` zeroes all of them: the launches, the
    routes' and chains' counts and the launches by plan."""
    import dataclasses
    import inspect

    wrappers = [f for name, f in inspect.getmembers(panel_mod, inspect.isfunction)
                if name.endswith("_cuda") and name != "micro_max_cuda"]
    assert {f.__name__ for f in wrappers} == {
        "panel_factor_cuda", "panel_factor_c64_cuda", "offset_panel_factor_cuda",
        "offset_panel_factor_c64_cuda", "panel_factor_shadow_cuda", "panel_factor_basic_cuda",
        "panel_factor_noswap_cuda", "panel_update_bf16x3_cuda"}
    for k, f in enumerate(wrappers):
        assert isinstance(f.counts, panel_mod.LaunchCounts), f.__name__
        for field in dataclasses.fields(f.counts):
            if field.name != "chain_launches_by_plan":
                setattr(f.counts, field.name, k + 1)
        f.counts.chain_launches_by_plan[("float32", 32, 16)] = k + 1
    assert len({id(f.counts) for f in wrappers}) == len(wrappers)
    panel_mod.reset_counts()
    for f in wrappers:
        assert f.counts == panel_mod.LaunchCounts(), f.__name__
        assert f.counts.chain_launches_by_plan == {}


def test_port_exports_every_public_name_of_the_jax_package():
    assert set(rf.__all__) <= set(rt.__all__)
    assert {"materialize_uv", "pad_to_multiple_of_4"} <= set(rt.__all__)
    for name in rt.__all__:
        assert getattr(rt, name) is not None


@pytest.mark.parametrize("fn", ["lu_factor", "lu_factor_p"])
def test_lu_factor_donate(fn):
    """donate=True factors A in place and returns A itself as the factors;
    donate=False copies and leaves A as it was.  Both give the same bits."""
    A0 = torch.tensor(np.random.default_rng(8).standard_normal((96, 96)))
    cfg = rt.LUConfig(panel_width=16, small_threshold=16)
    call = getattr(rt, fn)
    A = A0.clone()
    kept = call(A, config=cfg, device="cpu")
    assert torch.equal(A, A0) and kept[0] is not A
    donated = call(A, config=cfg, donate=True, device="cpu")
    assert donated[0] is A
    assert torch.equal(_bits(A), _bits(kept[0]))
    for x, y in zip(donated[1:], kept[1:]):
        assert torch.equal(x, y)


def test_lu_factor_donate_refuses_what_lu_inplace_refuses():
    A0 = np.random.default_rng(9).standard_normal((8, 8))
    with pytest.raises(ValueError):
        rt.lu_factor(torch.tensor(A0).T, donate=True, device="cpu")  # not contiguous
    with pytest.raises(TypeError):
        rt.lu_factor(A0, donate=True, device="cpu")  # not a tensor
    with pytest.raises(ValueError):
        rt.lu_factor_p(torch.tensor(A0), donate=True, device="meta")  # another device


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C function ops/_kernels.py binds for csrc/panel_lu.cu,
    csrc/panel_lu_c64.cu, csrc/panel_lu_micro.cu, csrc/panel_lu_noswap.cu
    and csrc/batched_solve.cu, and every other one its source spells out
    (some are stamped out by a macro), is declared with as many parameters,
    pointers where ctypes passes pointers: a mismatch would cut a pointer
    or shift every argument on the card.  Every panel entry point ends in
    one shared tail, the workspaces, ONE host PanelStats record (ctypes'
    `PanelStats` mirrors csrc/panel_cluster.cuh's field by field), the
    device and the stream, and takes no other host count; before it, its
    family's own arguments (the micro-blocked ones micro, block, cluster and
    the chain to force, the bf16x3 form block, cluster, the update kernel
    and the chain, the no-swap ones the live row count, block, cluster and
    the mask).  Every panel family's plan fills the kPlanInts ints that
    `write_plan` writes, as many as `_kernels.PLAN_INTS`; the bf16x3
    update alone takes the three row strides, nb and the kernel to force,
    its plan the shape alone."""
    import ctypes
    import re

    from recursivefactorization_jl_tpu_torch.ops import _kernels

    spelled_out = {"panel_lu", "panel_lu_c64", "panel_lu_micro", "panel_lu_noswap",
                   "batched_solve"}
    assert {"rf_panel_lu_c_plan", "rf_panel_lu_c64", "rf_panel_lu_c128",
            "rf_offset_panel_lu_c_plan", "rf_offset_panel_lu_c64", "rf_offset_panel_lu_c128",
            "rf_panel_lu_c_set_trace"} <= set(_kernels.SIGNATURES["panel_lu_c64"])
    assert {"rf_panel_lu_micro_plan", "rf_panel_lu_shadow_f32", "rf_panel_lu_shadow_f64",
            "rf_panel_lu_basic_f32", "rf_panel_lu_basic_f64",
            "rf_panel_lu_micro_set_trace"} <= set(_kernels.SIGNATURES["panel_lu_micro"])
    assert {"rf_panel_lu_noswap_plan", "rf_panel_lu_noswap_f32", "rf_panel_lu_noswap_f64",
            "rf_panel_lu_noswap_set_trace"} <= set(_kernels.SIGNATURES["panel_lu_noswap"])
    # the bf16x3 form (panel_boundary_precision='bf16x3') and its update alone
    assert {"rf_panel_lu_bf16x3_plan", "rf_panel_lu_bf16x3_f32", "rf_panel_update_bf16x3_f32",
            "rf_panel_update_bf16x3_plan"} <= set(_kernels.SIGNATURES["panel_lu"])
    cluster = (_kernels.PACKAGE_DIR / "csrc" / "panel_cluster.cuh").read_text()
    fields = re.search(r"struct PanelStats \{\s*int ([^;]*);\s*\};", cluster).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        f for f, _ in _kernels.PanelStats._fields_]
    assert all(t is ctypes.c_int for _, t in _kernels.PanelStats._fields_)
    assert int(re.search(r"constexpr int kPlanInts = (\d+);", cluster).group(1)) \
        == _kernels.PLAN_INTS == 7
    stats = ctypes.POINTER(_kernels.PanelStats)
    tail = "void* ws, void* iws, PanelStats* stats, int device, void* stream"
    entries, plans = set(), set()
    for lib in ("panel_lu", "panel_lu_c64", "panel_lu_micro", "panel_lu_noswap"):
        src = _kernels.SOURCES[lib].read_text()
        for fn, (_, argtypes) in _kernels.SIGNATURES[lib].items():
            found = re.search(r"\b" + fn + r"\(([^)]*)\)", src)
            decl = " ".join(found.group(1).split()) if found else ""
            if stats in argtypes:
                entries.add(fn)
                assert decl.endswith(tail) and "int*" not in decl, (fn, decl)
                assert argtypes.count(stats) == 1 and argtypes[-3] is stats, fn
            if fn.endswith("_plan") and "update" not in fn:
                plans.add(fn)
                body = src[src.index(fn + "("):]
                body = body[:body.index("\n}\n")]
                assert "write_plan(pl, out)" in body or "plan_entry<" in body, fn
                assert decl.endswith("int* out"), (fn, decl)
    assert entries == {f"rf_{p}_{k}" for p in ("panel_lu", "offset_panel_lu")
                       for k in ("f32", "f64", "c64", "c128")} | {
        f"rf_panel_lu_{v}_{k}" for v in ("shadow", "basic", "noswap") for k in ("f32", "f64")
    } | {"rf_panel_lu_bf16x3_f32"}
    assert plans == {"rf_panel_lu_plan", "rf_offset_panel_lu_plan", "rf_panel_lu_c_plan",
                     "rf_offset_panel_lu_c_plan", "rf_panel_lu_micro_plan",
                     "rf_panel_lu_bf16x3_plan", "rf_panel_lu_noswap_plan"}
    assert "write_plan(pl, out)" in _kernels.SOURCES["panel_lu"].read_text()
    assert "write_plan(pl, out)" in _kernels.SOURCES["panel_lu_c64"].read_text()
    for name, params, lib in (
            ("rf_panel_lu_shadow_f32", ("int pivot, int micro, int b, int C, int chain, void* piv",),
             "panel_lu_micro"),
            ("rf_panel_lu_micro_plan", ("int micro", "int chain", "int* out"), "panel_lu_micro"),
            ("rf_panel_lu_noswap_f64",
             ("int pivot, int live, int b, int C, const void* used0, void* prow, void* used",),
             "panel_lu_noswap"),
            ("rf_offset_panel_lu_f64", ("int pivot, int ofs, int b, int C, void* piv",),
             "panel_lu"),
            ("rf_panel_lu_c128", ("int pivot, int b, int C, void* piv",), "panel_lu_c64"),
            ("rf_panel_lu_bf16x3_f32", ("int pivot, int b, int C, int simple, int chain, void* piv",),
             "panel_lu"),
            ("rf_panel_lu_bf16x3_plan", ("int b", "int C", "int chain", "int* out"), "panel_lu"),
            ("rf_panel_update_bf16x3_f32", ("int ldl", "int ldu", "int ldc", "int nb",
                                            "int simple"), "panel_lu"),
            ("rf_panel_update_bf16x3_plan", ("int rows", "int cols", "int nb", "int* out"),
             "panel_lu")):
        src = _kernels.SOURCES[lib]
        decl = " ".join(re.search(r"\b" + name + r"\(([^)]*)\)", src.read_text()).group(1)
                        .split())
        assert all(p in decl for p in params), (name, decl)
    headers = "".join(h.read_text() for h in _kernels.HEADERS)
    for name, fns in _kernels.SIGNATURES.items():
        text = _kernels.source(name).read_text() + headers
        for fn, (_, argtypes) in fns.items():
            decl = re.search(r"\b" + fn + r"\(([^)]*)\)\s*\{", text)
            if decl is None and name not in spelled_out:
                continue
            assert decl, f"{name}: {fn} not declared"
            params = [p.strip() for p in decl.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), (fn, params)
            for p, t in zip(params, argtypes):
                pointer = t is ctypes.c_void_p or issubclass(t, ctypes._Pointer)
                assert ("*" in p) == pointer, (fn, p, t)
