"""The cluster routes of the micro-blocked and the no-swap panel kernels
(csrc/panel_lu_micro.cu, csrc/panel_lu_noswap.cu), emulated on the CPU,
and their wrappers' argument checks.

The micro-blocked route is the swapping kernels' cluster route
(tests/test_torch_panel_schedule.py) with blocks of exactly ``micro`` steps
and the trailing update summed first: per element an accumulator from 0
takes ``l[i, j] * u[j, c]`` for the block's steps in turn, then one
difference (``micro_blocked_lu``'s ``_delayed_update``).

The no-swap route moves no row.  Per block of ``b`` steps it lists the
rows still available in ascending physical order (the slab), runs the
block's chain on the slab's columns (the pivot the first row of the largest
magnitude among the rows not yet taken, a NaN first; without pivoting the
first row available), then solves the block's pivot rows, gathered by
index, in the columns right of the block and updates every listed row still
available with the block's rank-1 updates in step order.  Rows consumed
before the block are never touched.

A block whose live rows do not fit a cluster (the blocked forms: the
micro-blocked kernels and the bf16x3 form) runs its chain on the grid
instead: the live rows split into ranges, one candidate per range reduced
by the kernels' `better`, the block's columns in place, the row moves read
off each row's origin; ``grid_chain_order_micro`` emulates that order, and
the tests hold it bitwise to the cluster route's.

``blocked_order_micro``, ``grid_chain_order_micro`` and
``blocked_order_lu_noswap`` do these steps with one rounded tensor op per
rounding; the tests hold them bitwise to the plain versions, and the plain
versions once more to the JAX package on the same seeds.  On the card
tests/test_torch_cuda.py and ``chip_smoke.py`` hold the kernels to the
plain versions.
"""

import numpy as np
import pytest
import torch

from recursivefactorization_jl_tpu.ops.panel import (
    panel_factor_noswap_pallas,
    panel_factor_pallas,
)
from recursivefactorization_jl_tpu_torch.ops import blocked as blocked_mod
from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    micro_blocked_lu,
    unblocked_lu_noswap,
)
import recursivefactorization_jl_tpu_torch as rt
from test_torch_common import jx, to_np

torch.set_num_threads(1)

# the JAX tests' own tolerance for the Pallas panel kernels (their delayed
# updates are matmuls, so the sums differ in order)
ATOL32 = 2e-5


def blocked_order_micro(A, pivot, micro):
    """The micro-blocked cluster route's order on the real (m, w) panel
    ``A``.  Returns ``(LU, piv, perm, info)`` as ``micro_blocked_lu``
    does."""
    A = A.clone()
    m, w = A.shape
    steps = min(m, w)
    piv = torch.arange(steps, dtype=torch.int32)
    perm = torch.arange(m, dtype=torch.int32)
    info = 0
    for k0 in range(0, steps, micro):
        k1 = min(k0 + micro, steps)
        nb = k1 - k0
        # 1. the chain on the slab: rows [k0, m), columns [k0, k1)
        S = A[k0:, k0:k1].clone()
        src = torch.arange(m - k0)
        pid = perm[k0:].clone()
        for kk in range(nb):
            kp = kk + int(torch.argmax(S[kk:, kk].abs())) if pivot else kk
            piv[k0 + kk] = k0 + kp
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
        perm[k0:] = pid
        # 2. the delayed pass: swaps outside the slab, U rows, then the rows
        # below with the sum first
        outside = [c for c in range(w) if not k0 <= c < k1]
        if outside:
            A[k0:, outside] = A[k0:][src][:, outside]
        A[k0:, k0:k1] = S
        for s in range(nb - 1):
            A[k0 + s + 1:k1, k1:].sub_(torch.outer(A[k0 + s + 1:k1, k0 + s], A[k0 + s, k1:]))
        if k1 < m and k1 < w:
            acc = torch.zeros_like(A[k1:, k1:])
            for s in range(nb):
                acc.add_(torch.outer(A[k1:, k0 + s], A[k0 + s, k1:]))
            A[k1:, k1:].sub_(acc)
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


def _better(va, ia, vb, ib):
    """csrc/rf_common.cuh `better`: a NaN beats numbers, a larger
    magnitude a smaller one, the smaller row breaks ties."""
    na, nb = va != va, vb != vb
    if na != nb:
        return na
    if not na and va != vb:
        return va > vb
    return ia < ib


def grid_chain_order_micro(A, pivot, micro, grid_blocks, G):
    """The micro-blocked route's order with the chains of the leading
    ``grid_blocks`` blocks on the grid (csrc/panel_cluster.cuh
    `panel_grid_chain_kernel` on G CTAs): the live rows split into G
    ranges, the block's columns in place; per step every range's
    candidate (its first row of the largest magnitude, a NaN first), the G
    candidates reduced by `better`, rows gk and kp swapped in the block's
    columns with their perm ids and origins, the rows below scaled and
    updated in the block's columns; then every row whose origin changed
    is a row move, and the delayed pass follows as on the cluster route.
    The later blocks take the cluster route (``blocked_order_micro``'s
    chain).  Returns ``(LU, piv, perm, info)`` as ``micro_blocked_lu``
    does."""
    A = A.clone()
    m, w = A.shape
    steps = min(m, w)
    piv = torch.arange(steps, dtype=torch.int32)
    perm = torch.arange(m, dtype=torch.int32)
    info = 0
    for blk, k0 in enumerate(range(0, steps, micro)):
        k1 = min(k0 + micro, steps)
        nb = k1 - k0
        if blk < grid_blocks:
            rows = -(-(m - k0) // G)
            src = torch.arange(k0, m)
            for kk in range(nb):
                gk, col = k0 + kk, k0 + kk
                kp = gk
                if pivot:
                    best, bi = -1.0, m
                    for g in range(G):
                        lo, hi = max(gk, k0 + g * rows), min(m, k0 + (g + 1) * rows)
                        if lo >= hi:
                            continue
                        mags = A[lo:hi, col].abs()
                        q = lo + int(torch.argmax(mags))  # the first NaN, else the first max
                        v = float(A[q, col].abs())
                        if _better(v, q, best, bi):
                            best, bi = v, q
                    kp = bi
                piv[gk] = kp
                nz = bool(A[kp, col] != 0)
                if nz and kp != gk:
                    A[[gk, kp], k0:k1] = A[[kp, gk], k0:k1]
                    perm[[gk, kp]] = perm[[kp, gk]]
                    src[[gk - k0, kp - k0]] = src[[kp - k0, gk - k0]]
                if nz:
                    A[gk + 1:, col].mul_(torch.reciprocal(A[gk, col]))
                elif info == 0:
                    info = gk + 1 if pivot else -(gk + 1)
                if kk + 1 < nb:
                    A[gk + 1:, col + 1:k1].sub_(torch.outer(A[gk + 1:, col], A[gk, col + 1:k1]))
            S = A[k0:, k0:k1].clone()
        else:
            S = A[k0:, k0:k1].clone()
            src = torch.arange(m - k0)
            pid = perm[k0:].clone()
            for kk in range(nb):
                kp = kk + int(torch.argmax(S[kk:, kk].abs())) if pivot else kk
                piv[k0 + kk] = k0 + kp
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
            perm[k0:] = pid
            src = src + k0
        # the delayed pass: the row moves outside the block's columns (every
        # old value read before any is written), U rows, then the sum first
        moved = [(i, int(s)) for i, s in zip(range(k0, m), src.tolist()) if s != i]
        outside = [c for c in range(w) if not k0 <= c < k1]
        if moved and outside:
            dst = [i for i, _ in moved]
            old = A[[s_ for _, s_ in moved]][:, outside].clone()
            A[torch.tensor(dst)[:, None], torch.tensor(outside)[None, :]] = old
        A[k0:, k0:k1] = S
        for s_ in range(nb - 1):
            A[k0 + s_ + 1:k1, k1:].sub_(torch.outer(A[k0 + s_ + 1:k1, k0 + s_], A[k0 + s_, k1:]))
        if k1 < m and k1 < w:
            acc = torch.zeros_like(A[k1:, k1:])
            for s_ in range(nb):
                acc.add_(torch.outer(A[k1:, k0 + s_], A[k0 + s_, k1:]))
            A[k1:, k1:].sub_(acc)
    return A, piv, perm, torch.tensor(info, dtype=torch.int32)


def blocked_order_lu_noswap(A, used0, pivot, b):
    """The no-swap cluster route's order on the real (m, w) panel ``A``
    under the mask ``used0``.  Returns ``(LU, prow, used, info)`` as
    ``unblocked_lu_noswap`` does."""
    A = A.clone()
    m, w = A.shape
    steps = min(m, w)
    used = (used0 != 0).to(torch.int32)
    prow = torch.full((steps,), -1, dtype=torch.int32)
    info = 0
    for k0 in range(0, steps, b):
        k1 = min(k0 + b, steps)
        nb = k1 - k0
        # 1. the slab: the available rows, ascending, x the block's columns
        rows = (used == 0).nonzero()[:, 0]
        S = A[rows, k0:k1].clone()
        taken = torch.zeros(len(rows), dtype=torch.bool)
        for kk in range(nb):
            avail = ~taken
            if not bool(avail.any()):
                continue  # prow stays -1
            if pivot:
                key = torch.where(avail, S[:, kk].abs(), torch.full_like(S[:, kk], -1))
                q = int(torch.argmax(key))
            else:
                q = int(torch.argmax(avail.to(torch.int32)))
            taken[q] = True
            prow[k0 + kk] = rows[q]
            used[rows[q]] = 1
            rest = ~taken
            pv = S[q, kk]
            if bool(pv != 0):
                S[rest, kk] = S[rest, kk] * torch.reciprocal(pv)
            elif info == 0:
                info = k0 + kk + 1 if pivot else -(k0 + kk + 1)
            if kk + 1 < nb:
                S[rest, kk + 1:] = S[rest, kk + 1:] - torch.outer(S[rest, kk], S[q, kk + 1:])
        A[rows, k0:k1] = S
        # 2. the delayed pass: the pivot rows by index, then the rows left
        pr = prow[k0:k1]
        pr = pr[pr >= 0].long()
        for s in range(len(pr) - 1):
            t = pr[s + 1:]
            A[t, k1:] = A[t, k1:] - torch.outer(A[t, k0 + s], A[pr[s], k1:])
        rest = rows[~taken]
        for s in range(len(pr)):
            A[rest, k1:] = A[rest, k1:] - torch.outer(A[rest, k0 + s], A[pr[s], k1:])
    return A, prow, used, torch.tensor(info, dtype=torch.int32)


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _assert_same(got, want):
    """Index outputs exactly, factors bitwise, NaN for NaN."""
    for x, y, what in zip(got[1:3], want[1:3], ("pivots", "perm / used")):
        assert torch.equal(x, y), what
    assert int(got[3]) == int(want[3]), "info"
    nan = torch.isnan(want[0])
    assert torch.equal(torch.isnan(got[0]), nan), "NaN positions"
    assert torch.equal(_bits(got[0].masked_fill(nan, 0)), _bits(want[0].masked_fill(nan, 0))), \
        "factors"


def _panel(seed, m, w, dtype, pivot, kind="randn"):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        A = rng.integers(-2, 3, (m, w)).astype(np.float64)
    else:
        A = rng.standard_normal((m, w))
        if not pivot:
            k = min(m, w)
            A[np.arange(k), np.arange(k)] += m
    if kind == "zero_col":
        A[:, 9] = 0
    if kind == "nan":
        A[m // 3, 3] = A[m // 2, 3] = np.nan
    return torch.tensor(A, dtype=dtype)


def _mask(seed, m, kind):
    """A scattered mask of consumed rows: none, about a third, or all but
    a few (fewer than the panel's steps, so the last steps find no row)."""
    u = np.zeros(m, dtype=np.int32)
    rng = np.random.default_rng(seed)
    if kind == "third":
        u[rng.permutation(m)[: m // 3]] = 1
    elif kind == "all_but_few":
        u[rng.permutation(m)[: m - 5]] = 1
    return torch.tensor(u)


# ---------------------------------------------------------------------------
# the micro-blocked cluster route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(200, 64), (96, 40), (40, 96)])
@pytest.mark.parametrize("micro", [1, 4, 8, 12, 16, 32, 64])
def test_micro_cluster_order_equals_micro_blocked_lu(micro, shape, pivot, dtype):
    """Blocks of exactly ``micro`` steps (the ones of the plan's b list
    and odd ones; ragged last blocks at 40 and 64 columns; one block when
    micro covers the panel), tall and fat panels: pivots, perm and info
    exactly, factors bitwise."""
    m, w = shape
    A = _panel(7 * m + w, m, w, dtype, pivot)
    mc = min(micro, m, w)
    _assert_same(blocked_order_micro(A, pivot, mc), micro_blocked_lu(A, pivot, mc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(256, 240), (240, 256), (256, 130)])
@pytest.mark.parametrize("micro", [65, 96, 128, 200, 256])
def test_micro_cluster_order_past_64_equals_micro_blocked_lu(micro, shape, dtype):
    """Blocks of 65 to 256 steps (the delayed kernels stage them in chunks,
    in the same order): tall, fat and narrow panels, ragged last blocks,
    one block where micro covers the panel; pivots, perm and info exactly,
    factors bitwise."""
    m, w = shape
    A = _panel(5 * m + w + micro, m, w, dtype, True)
    mc = min(micro, m, w)
    _assert_same(blocked_order_micro(A, True, mc), micro_blocked_lu(A, True, mc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("micro, shape, grid_blocks, G", [
    (16, (200, 64), 99, 7),     # every block's chain on the grid, ragged row ranges
    (32, (200, 64), 1, 132),    # the first on the grid (more CTAs than rows), then a cluster
    (12, (96, 40), 2, 5),       # ragged last block
    (16, (40, 96), 99, 3),      # fat: the last block's solve
    (96, (256, 200), 99, 16),   # past 64 steps
    (130, (256, 256), 1, 9),
    (256, (256, 200), 99, 4),   # one block on the grid (no delayed pass)
])
@pytest.mark.parametrize("pivot", [True, False])
def test_grid_chain_order_equals_micro_blocked_lu(micro, shape, grid_blocks, G, pivot, dtype):
    """The grid block chain's step order (candidates per row range, reduced
    by `better`; the block's columns in place; the row moves from the
    rows' origins), alone and followed by cluster blocks: pivots, perm and
    info exactly, factors bitwise, as the cluster route gives them."""
    m, w = shape
    A = _panel(7 * m + w + micro, m, w, dtype, pivot)
    mc = min(micro, m, w)
    got = grid_chain_order_micro(A, pivot, mc, grid_blocks, G)
    _assert_same(got, micro_blocked_lu(A, pivot, mc))
    _assert_same(got, blocked_order_micro(A, pivot, mc))


@pytest.mark.parametrize("kind, pivot", [("ties", True), ("zero_col", True),
                                         ("zero_col", False), ("nan", True)])
@pytest.mark.parametrize("micro, G", [(12, 5), (16, 132), (80, 7)])
def test_grid_chain_order_on_ties_zero_column_and_nan(kind, pivot, micro, G):
    """Exact ties across row ranges (the smallest row wins the reduction),
    a zeroed column 9 (no swap, no scale, the update runs, info 10 / -10)
    and two NaN candidates in column 3 in different ranges (the first NaN
    row wins) on the grid chain."""
    m, w = 96, 48
    A = _panel(11, m, w, torch.float32, pivot, kind)
    got = grid_chain_order_micro(A, pivot, min(micro, w), 99, G)
    _assert_same(got, micro_blocked_lu(A, pivot, min(micro, w)))
    if kind == "zero_col":
        assert int(got[3]) == (10 if pivot else -10)
    if kind == "nan":
        assert int(got[1][3]) == m // 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("micro", [4, 12, 16, 32])
@pytest.mark.parametrize("kind, pivot", [("ties", True), ("zero_col", True),
                                         ("zero_col", False), ("nan", True)])
def test_micro_cluster_order_on_ties_zero_column_and_nan(kind, pivot, micro, dtype):
    """Exact ties (the first row), a zeroed column 9 (no swap, no scale,
    the update runs, info 10 / -10) and two NaN candidates in column 3
    (the first NaN row wins)."""
    m, w = 96, 48
    A = _panel(11, m, w, dtype, pivot, kind)
    got = blocked_order_micro(A, pivot, micro)
    _assert_same(got, micro_blocked_lu(A, pivot, micro))
    if kind == "zero_col":
        assert int(got[3]) == (10 if pivot else -10)
    if kind == "nan":
        assert int(got[1][3]) == m // 3


# ---------------------------------------------------------------------------
# the no-swap cluster route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("mask", ["none", "third", "all_but_few"])
@pytest.mark.parametrize("shape", [(200, 64), (96, 40), (40, 64)])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_noswap_cluster_order_equals_unblocked_lu_noswap(b, shape, mask, pivot, dtype):
    """Blocks of b in {8, 16, 32, 64}, tall and fat panels, masks with no
    row, a scattered third and all rows but five taken (the later steps
    find no row: prow -1): prow, used and info exactly, factors bitwise,
    the rows taken before untouched."""
    m, w = shape
    A = _panel(3 * m + w, m, w, dtype, pivot)
    used0 = _mask(m + w, m, mask)
    got = blocked_order_lu_noswap(A, used0, pivot, b)
    _assert_same(got, unblocked_lu_noswap(A, used0, pivot))
    before = used0.bool()
    assert torch.equal(_bits(got[0][before]), _bits(A[before]))
    if mask == "all_but_few":
        assert (got[1][5:] == -1).all() and (got[1][:5] >= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [3, 8, 16, 32, "w"])
def test_noswap_cluster_order_on_ties_zero_column_and_nan(b, dtype):
    """Exact ties (the smallest physical row), a zeroed column 9 (no
    scale, the update runs, the column still consumes a row, info 10 /
    -10) and two NaN candidates (the first NaN row among the available
    ones), each under a scattered mask; b = w is one block."""
    m, w = 120, 48
    b = w if b == "w" else b
    used0 = _mask(5, m, "third")
    T = _panel(12, m, w, dtype, True, "ties")
    _assert_same(blocked_order_lu_noswap(T, used0, True, b), unblocked_lu_noswap(T, used0, True))
    for pivot in (True, False):
        Z = _panel(13, m, w, dtype, pivot, "zero_col")
        got = blocked_order_lu_noswap(Z, used0, pivot, b)
        _assert_same(got, unblocked_lu_noswap(Z, used0, pivot))
        assert int(got[3]) == (10 if pivot else -10)
    N = _panel(14, m, w, dtype, True, "nan")
    free = used0 == 0
    N[~free, 3] = float("nan")  # NaNs in consumed rows are never candidates
    got = blocked_order_lu_noswap(N, used0, True, b)
    _assert_same(got, unblocked_lu_noswap(N, used0, True))
    nan_rows = [i for i in (m // 3, m // 2) if bool(free[i])]
    if nan_rows and int(got[1][3]) in nan_rows:
        assert int(got[1][3]) == nan_rows[0]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package, on the emulations' seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant, shape, micro, pivot", [
    ("shadow", (96, 40), 12, True),   # an odd micro, ragged last block
    ("basic", (40, 96), 16, True),    # fat: the last block's solve
    ("shadow", (96, 40), 8, False),
])
def test_micro_plain_matches_pallas_on_the_emulation_seeds(variant, shape, micro, pivot):
    m, w = shape
    A = _panel(7 * m + w, m, w, torch.float32, pivot)
    port = micro_blocked_lu(A, pivot, micro)
    ref = panel_factor_pallas(jx(to_np(A), np.float32), pivot, interpret=True,
                              variant=variant, micro=micro)
    np.testing.assert_array_equal(to_np(port[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(to_np(port[2]), np.asarray(ref[2]))
    assert int(port[3]) == int(ref[3])
    # the fat panel's right columns grow: the tolerance goes with the
    # largest entry, as in tests/test_torch_physical.py
    scale = max(1.0, float(np.max(np.abs(np.asarray(ref[0])))))
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=ATOL32 * scale)


@pytest.mark.parametrize("shape, mask, pivot, micro", [
    ((96, 40), "third", True, 8),
    ((96, 40), "none", False, 8),
    ((200, 64), "third", True, 16),
])
def test_noswap_plain_matches_pallas_on_the_emulation_seeds(shape, mask, pivot, micro):
    m, w = shape
    A = _panel(3 * m + w, m, w, torch.float32, pivot)
    used0 = _mask(m + w, m, mask)
    f, prow, used, info = unblocked_lu_noswap(A, used0, pivot)
    ref = panel_factor_noswap_pallas(jx(to_np(A), np.float32),
                                     jx(to_np(used0)[None, :], np.float32), pivot,
                                     interpret=True, micro=micro)
    np.testing.assert_array_equal(to_np(prow), np.asarray(ref[1]))
    np.testing.assert_array_equal(to_np(used), np.asarray(ref[2])[0].astype(np.int32))
    assert int(info) == int(ref[3])
    scale = max(1.0, float(np.max(np.abs(np.asarray(ref[0])))))
    np.testing.assert_allclose(to_np(f), np.asarray(ref[0]), atol=ATOL32 * scale)


# ---------------------------------------------------------------------------
# the wrappers' and plans' argument checks (no card needed: they refuse
# before anything is built)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw, match", [
    ({"micro": 0}, "micro"), ({"micro": 2.0}, "micro"), ({"micro": True}, "micro"),
    ({"block": 8}, "block"), ({"block": 1.0}, "block"), ({"cluster": -2}, "cluster"),
    ({"cluster": False}, "cluster"), ({"_chain": "cluster"}, "_chain"),
    ({"block": -1, "_chain": "grid"}, "_chain"),
])
@pytest.mark.parametrize("variant", ["shadow", "basic"])
def test_micro_wrappers_refuse_bad_arguments(variant, kw, match):
    """The block of the micro route is micro itself: ``block`` takes 0 or
    -1 only; ``cluster`` a size or 0; nothing is launched or counted."""
    wrapper = panel_mod.panel_factor_shadow_cuda if variant == "shadow" \
        else panel_mod.panel_factor_basic_cuda
    args = {"micro": 4, "block": 0, "cluster": 0, "_chain": "auto", **kw}
    before = panel_mod.LaunchCounts(**vars(wrapper.counts))
    with pytest.raises(ValueError, match=match):
        wrapper(torch.zeros(8, 4), True, args["micro"], block=args["block"],
                cluster=args["cluster"], _chain=args["_chain"])
    with pytest.raises(ValueError, match=match):
        panel_mod.micro_plan(64, 32, torch.float32, args["micro"], variant,
                             block=args["block"], cluster=args["cluster"], device="cuda:0",
                             _chain=args["_chain"])
    assert wrapper.counts == before


@pytest.mark.parametrize("kw, match", [
    ({"live": -1}, "live"), ({"live": 9}, "live"), ({"live": 3.0}, "live"),
    ({"live": True}, "live"), ({"block": "8"}, "block"), ({"cluster": -1}, "cluster"),
])
def test_noswap_wrapper_refuses_bad_arguments(kw, match):
    """``live`` is an int in [0, m]; block and cluster ints, cluster not
    negative; nothing is launched or counted."""
    wrapper = panel_mod.panel_factor_noswap_cuda
    before = panel_mod.LaunchCounts(**vars(wrapper.counts))
    with pytest.raises(ValueError, match=match):
        wrapper(torch.zeros(8, 4), torch.zeros(8, dtype=torch.int32), True, **kw)
    with pytest.raises(ValueError, match=match):
        panel_mod.noswap_plan(8, 4, torch.float32, device="cuda:0", **kw)
    assert wrapper.counts == before
    with pytest.raises(ValueError, match="live"):  # the CPU layer checks it too
        panel_mod.panel_factor_noswap(torch.zeros(8, 4), torch.zeros(8, dtype=torch.int32),
                                      True, live=kw.get("live", 9))


def test_micro_and_noswap_plans_pass_their_requests_on(monkeypatch):
    """micro_plan cuts micro to the panel and hands the variant, block and
    cluster to csrc/panel_lu_micro.cu's plan; noswap_plan hands the live
    count (m when none is given); both refuse other dtypes before any
    build."""
    asked = []

    def fake_micro(m, w, size, micro, shadow, block, cluster, chain, index):
        asked.append(("micro", m, w, size, micro, shadow, block, cluster, chain, index))
        return (1, micro, 16, 2, 1, 99, chain) if block == 0 else (0, -1, 132, 1, 7, 8, 0)

    def fake_noswap(m, w, size, live, block, cluster, index):
        asked.append(("noswap", m, w, size, live, block, cluster, index))
        return (1, 32, 16, 4, 1, live + 1, 0)

    monkeypatch.setattr(panel_mod, "_micro_plan", fake_micro)
    monkeypatch.setattr(panel_mod, "_noswap_plan", fake_noswap)
    plan = panel_mod.micro_plan(1000, 40, torch.float32, 64, "basic", device="cuda:0")
    assert plan == {"route": "cluster", "block": 40, "cluster": 16, "grid": None,
                    "blocks": 2, "ws_reals": 1, "iws_ints": 99, "grid_blocks": 0}
    plan = panel_mod.micro_plan(1000, 40, torch.float64, 12, block=-1, device="cuda:0")
    assert plan["route"] == "grid" and plan["grid"] == 132
    assert panel_mod.noswap_plan(300, 64, torch.float32, device="cuda:0")["iws_ints"] == 301
    panel_mod.noswap_plan(300, 64, torch.float64, live=150, block=8, cluster=4, device="cuda:0")
    # past the grid route's 64 steps: the cluster route's plan, any width
    plan = panel_mod.micro_plan(200, 100, torch.float32, 65, device="cuda:0")
    assert plan["block"] == 65 and plan["grid_blocks"] == 0
    plan = panel_mod.micro_plan(300, 256, torch.float32, 200, _chain="grid", device="cuda:0")
    assert plan["grid_blocks"] == 1
    assert asked == [("micro", 1000, 40, 4, 40, False, 0, 0, 0, 0),
                     ("micro", 1000, 40, 8, 12, True, -1, 0, 0, 0),
                     ("noswap", 300, 64, 4, 300, 0, 0, 0),
                     ("noswap", 300, 64, 8, 150, 8, 4, 0),
                     ("micro", 200, 100, 4, 65, True, 0, 0, 0, 0),
                     ("micro", 300, 256, 4, 200, True, 0, 0, 1, 0)]
    for bad in (lambda: panel_mod.micro_plan(64, 32, torch.complex64, 8, device="cuda:0"),
                lambda: panel_mod.micro_plan(64, 32, torch.float32, 8, "fori", device="cuda:0"),
                # the grid route (block=-1) takes at most 64 steps after the cut
                lambda: panel_mod.micro_plan(200, 100, torch.float32, 65, block=-1,
                                             device="cuda:0"),
                lambda: panel_mod.micro_plan(200, 100, torch.float32, 8, block=-1,
                                             _chain="grid", device="cuda:0"),
                lambda: panel_mod.micro_plan(200, 100, torch.float32, 8, _chain="all",
                                             device="cuda:0"),
                lambda: panel_mod.noswap_plan(64, 32, torch.float16, device="cuda:0")):
        with pytest.raises(ValueError):
            bad()
    assert len(asked) == 6
    # a micro past 64 cut to 64 or less by the panel takes the grid route
    panel_mod.micro_plan(200, 40, torch.float32, 65, block=-1, device="cuda:0")
    assert asked[-1] == ("micro", 200, 40, 4, 40, True, -1, 0, 0, 0)


def test_physical_schedule_passes_the_live_count(monkeypatch):
    """``schedule='physical'`` tells each panel how many rows are left: m
    at the first panel, m - s at panel s (every earlier step consumed one
    row); the result does not change."""
    seen = []
    plain = blocked_mod.panel_factor_noswap

    def spy(panel, used0, pivot, live=None):
        seen.append((live, int((used0 == 0).sum())))
        return plain(panel, used0, pivot, live=live)

    A = torch.tensor(np.random.default_rng(21).standard_normal((100, 70)))
    cfg = rt.LUConfig(schedule="physical", panel_width=16)
    want = rt.lu(A, config=cfg, device="cpu")
    monkeypatch.setattr(blocked_mod, "panel_factor_noswap", spy)
    got = rt.lu(A, config=cfg, device="cpu")
    assert seen == [(100 - s, 100 - s) for s in range(0, 70, 16)]
    assert torch.equal(got.factors, want.factors) and torch.equal(got.p, want.p)
