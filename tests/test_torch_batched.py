"""The port's batched small-matrix path against the JAX package, on the CPU.

Per kernel module: each plain version (the CPU route of the Hopper
kernels) against the interpret-mode Pallas original on the same seeded
inputs.  For the slice: the four public functions against the JAX
package's, with ``backend='pallas'`` forcing its kernels in f32 and its
default route in f64.

Tolerances: ipiv, perm and info are compared exactly.  Factors and
solutions are compared within ``20 * n * eps * max|A|`` (solutions scaled
by their own magnitude): the interpret-mode kernels may fuse or reorder
roundings that the port keeps separate.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax

import recursivefactorization_jl_tpu as rf
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu.ops.batched_kernel import (
    batched_lu_pallas,
    batched_lu_pallas_noswap,
    batched_solve_pallas,
)
from recursivefactorization_jl_tpu.parallel import batched as jb
from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
from recursivefactorization_jl_tpu_torch.parallel import batched as pb
from test_torch_common import EPS, jx, tc, to_np

torch.set_num_threads(1)

F32 = np.float32


def value_tol(A, dtype=F32):
    A = np.asarray(A)
    return 20 * max(A.shape[1:]) * EPS[dtype] * float(np.max(np.abs(A)))


def make_batch(seed, B, m, n, pivot, zero=(), dtype=F32):
    """randn batch (diagonally dominant without pivoting); the matrices
    listed in ``zero`` as (index, column) get that column zeroed."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    if not pivot:
        A += max(m, n) * np.eye(m, n)
    for i, c in zero:
        A[i, :, c] = 0.0
    return A.astype(dtype)


def expected_info(B, pivot, zero):
    want = np.zeros(B, dtype=np.int32)
    for i, c in zero:
        want[i] = c + 1 if pivot else -(c + 1)
    return want


def batch_residual(A, factors, perm):
    """max over the batch of max|L@U - A[perm]| in f64."""
    A = np.asarray(A, dtype=np.float64)
    f = to_np(factors).astype(np.float64)
    p = to_np(perm).astype(np.int64)
    B, m, n = f.shape
    k = min(m, n)
    worst = 0.0
    for i in range(B):
        L = np.tril(f[i][:, :k], -1) + np.eye(m, k)
        U = np.triu(f[i][:k, :])
        worst = max(worst, float(np.max(np.abs(L @ U - A[i][p[i]]))))
    return worst


# ---------------------------------------------------------------------------
# kernel module: plain versions against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(7, 16, 16), (5, 33, 33), (6, 12, 7), (6, 7, 12)])
def test_swap_plain_matches_pallas(shape, pivot):
    B, m, n = shape
    zero = [(1, 2), (4, min(m, n) - 1)]
    A = make_batch(11, B, m, n, pivot, zero)
    f_j, ipiv_j, perm_j, info_j = batched_lu_pallas(
        jx(A, F32), pivot, interpret=True, group=4
    )
    f, ipiv, perm, info = bk.batched_lu_plain(tc(A, F32), pivot, True)
    assert f.shape == (B, m, n) and ipiv.shape == (B, min(m, n)) and perm.shape == (B, m)
    assert ipiv.dtype == perm.dtype == info.dtype == torch.int32
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_array_equal(to_np(info), expected_info(B, pivot, zero))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))
    # the tracked permutation is the folded swap sequence
    np.testing.assert_array_equal(to_np(perm), to_np(rt.batched_ipiv_to_perm(ipiv, m)))
    assert bk.batched_lu_plain(tc(A, F32), pivot, False)[2] is None


def test_swap_plain_exact_ties_match_pallas():
    rng = np.random.default_rng(12)
    A = rng.integers(-2, 3, size=(8, 14, 14)).astype(F32)
    f_j, ipiv_j, perm_j, info_j = batched_lu_pallas(
        jx(A, F32), True, interpret=True, group=4
    )
    f, ipiv, perm, info = bk.batched_lu_plain(tc(A, F32), True, True)
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))


@pytest.mark.parametrize("swap", [True, False])
def test_nan_among_candidates_picks_the_last_row_as_pallas_does(swap):
    """A NaN among the pivot candidates makes the Pallas kernel's
    max/equality search select row m - 1; the plain versions reproduce
    the choice (ipiv, perm, info).  Values are not compared: the port
    leaves finished rows untouched, the Pallas kernel's masked update
    turns some of them into NaN."""
    A = make_batch(13, 4, 8, 8, True)
    A[1, 5, 2] = np.nan
    A[2, 0, 0] = np.nan
    if swap:
        _, ipiv_j, perm_j, info_j = batched_lu_pallas(jx(A, F32), True, interpret=True, group=4)
        _, ipiv, perm, info = bk.batched_lu_plain(tc(A, F32), True, True)
        np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
        assert to_np(ipiv)[2, 0] == 7
    else:
        _, perm_j, info_j = batched_lu_pallas_noswap(jx(A, F32), True, interpret=True, group=4)
        _, perm, info = bk.batched_lu_noswap_plain(tc(A, F32), True)
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("n", [16, 33])
def test_noswap_plain_matches_pallas(n, pivot):
    B = 6
    zero = [(2, 3), (5, n - 2)]
    A = make_batch(14, B, n, n, pivot, zero)
    f_j, perm_j, info_j = batched_lu_pallas_noswap(
        jx(A, F32), pivot, interpret=True, group=4
    )
    f, perm, info = bk.batched_lu_noswap_plain(tc(A, F32), pivot)
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_array_equal(to_np(info), expected_info(B, pivot, zero))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))
    for i in range(B):
        assert sorted(to_np(perm)[i]) == list(range(n))
    assert batch_residual(A, f, perm) < value_tol(A) * (1 if pivot else 50)


def test_noswap_requires_square():
    with pytest.raises(ValueError):
        bk.batched_lu_noswap_plain(torch.zeros(2, 4, 5), True)
    with pytest.raises(ValueError):
        bk.batched_solve_plain(torch.zeros(2, 4, 5), torch.zeros(2, 4))


@pytest.mark.parametrize("nrhs", [None, 3])
@pytest.mark.parametrize("n", [16, 33])
def test_solve_plain_matches_pallas(n, nrhs):
    B = 7
    A = make_batch(15, B, n, n, True)
    rng = np.random.default_rng(16)
    b = rng.standard_normal((B, n) if nrhs is None else (B, n, nrhs)).astype(F32)
    f, _, perm, _ = bk.batched_lu_plain(tc(A, F32), True, True)
    idx = perm.long() if nrhs is None else perm.long()[:, :, None].expand(B, n, nrhs)
    rhs = tc(b, F32).gather(1, idx)
    x_j = np.asarray(batched_solve_pallas(jx(to_np(f), F32), jx(to_np(rhs), F32),
                                          interpret=True, group=4))
    x = to_np(bk.batched_solve_plain(f, rhs))
    assert x.shape == b.shape
    tol = 20 * n * EPS[F32] * float(np.max(np.abs(x_j))) * 50
    np.testing.assert_allclose(x, x_j, rtol=0, atol=tol)
    Ax = np.einsum("bij,bj...->bi...", A.astype(np.float64), x.astype(np.float64))
    assert float(np.max(np.abs(Ax - b))) < 1e-3


@pytest.mark.parametrize("nrhs", [None, 2])
def test_solve_plain_takes_perm_or_ipiv(nrhs):
    """Handing the solve the factorization's perm, or its ipiv, equals
    permuting the right-hand sides first."""
    B, n = 6, 13
    A = make_batch(35, B, n, n, True)
    b = tc(np.random.default_rng(36).standard_normal((B, n) if nrhs is None else (B, n, nrhs)), F32)
    f, ipiv, perm, _ = bk.batched_lu_plain(tc(A, F32), True, True)
    idx = perm.long() if nrhs is None else perm.long()[:, :, None].expand(B, n, nrhs)
    x = bk.batched_solve_plain(f, b.gather(1, idx))
    assert torch.equal(bk.batched_solve_plain(f, b, perm=perm), x)
    assert torch.equal(bk.batched_solve_plain(f, b, ipiv=ipiv), x)
    assert torch.equal(bk.batched_solve(f, b, ipiv=ipiv), x)
    with pytest.raises(ValueError):
        bk.batched_solve_plain(f, b, perm=perm, ipiv=ipiv)
    with pytest.raises(ValueError):
        bk.batched_solve_plain(f, b, perm=perm[:, :-1])


def test_solve_plain_zero_diagonal_poisons_only_its_matrix():
    n = 12
    A = make_batch(17, 5, n, n, True, zero=[(3, 4)])
    f, _, _, info = bk.batched_lu_plain(tc(A, F32), True, True)
    assert to_np(info).tolist() == [0, 0, 0, 5, 0]
    b = tc(np.random.default_rng(18).standard_normal((5, n)), F32)
    x = bk.batched_solve_plain(f, b)
    finite = torch.isfinite(x).all(dim=1)
    assert finite.tolist() == [True, True, True, False, True]
    x_j = np.asarray(batched_solve_pallas(jx(to_np(f), F32), jx(to_np(b), F32),
                                          interpret=True, group=4))
    np.testing.assert_array_equal(np.isfinite(x_j).all(axis=1), to_np(finite))


@pytest.mark.parametrize("shape", [(5, 9, 9), (4, 11, 6), (4, 6, 11)])
def test_batched_ipiv_to_perm_matches_the_single_one(shape):
    B, m, n = shape
    _, ipiv, perm, _ = bk.batched_lu_plain(tc(make_batch(19, B, m, n, True), F32), True, True)
    folded = rt.batched_ipiv_to_perm(ipiv, m)
    assert folded.dtype == torch.int32
    for i in range(B):
        assert torch.equal(folded[i], rt.ipiv_to_perm(ipiv[i], m))
    assert torch.equal(folded, perm)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launching wrappers take CUDA tensors only; nothing falls back."""
    for fn, args in ((bk.batched_lu_cuda, (torch.zeros(2, 4, 4),)),
                     (bk.batched_lu_noswap_cuda, (torch.zeros(2, 4, 4),)),
                     (bk.batched_solve_cuda, (torch.zeros(2, 4, 4), torch.zeros(2, 4)))):
        with pytest.raises(ValueError):
            fn(*args)
        assert fn.launches == 0


def test_shared_memory_counts():
    """The eligibility predicate takes the shared-memory tile's byte count
    (the tile route and the noswap kernel launch with it); the register
    routes count their own, smaller buffers."""
    assert bk.tile_smem_bytes(64, 64, 4) == (64 * 65 + 64) * 4 + 8 * 64
    assert bk.lu_smem_bytes(64, 64, 4, "tile") == bk.tile_smem_bytes(64, 64, 4)
    # the block route at 64 x 64 (8 x 8 threads): rows k and kp and the
    # multipliers (3 x 64), 8 candidate values, a[m - 1, k] and a[k, k],
    # then 8 + 64 ints
    assert bk.lu_smem_bytes(64, 64, 4) == (3 * 64 + 10) * 4 + 4 * 72
    assert bk.lu_kernel_takes(torch.float32, 128, 128)
    assert bk.lu_kernel_takes(torch.float64, 128, 128)
    assert bk.tile_smem_bytes(128, 128, 8) > 48 * 1024  # the tile needs the opt-in
    assert bk.lu_smem_bytes(128, 128, 8) < 48 * 1024  # the block route does not
    assert not bk.lu_kernel_takes(torch.float32, 129, 129)
    assert not bk.lu_kernel_takes(torch.float16, 8, 8)
    assert not bk.lu_kernel_takes(torch.float32, 4096, 64)  # tile too large
    assert bk.lu_kernel_takes(torch.float32, 600, 64)
    with pytest.raises(ValueError, match="no route"):  # the solve has no block route
        bk.solve_smem_bytes(64, 1, 4, "block")
    assert bk.solve_kernel_takes(torch.float64, 128, 8)
    # the wide route holds a tile of the factors only: any nrhs fits
    assert bk.solve_kernel_takes(torch.float32, 128, 400)
    assert bk.solve_smem_bytes(128, 400, 4) == bk.solve_smem_bytes(128, 1, 4) <= bk.SMEM_LIMIT
    assert not bk.solve_kernel_takes(torch.float32, 0, 1)
    assert not bk.solve_kernel_takes(torch.float32, 129, 1)


# the swap kernel's routes (csrc/batched_lu.cu): warp at m, n <= 32, block
# up to 128, the shared-memory tile beyond; the shapes at their boundaries
BOUNDARY_SHAPES = [(3, 1, 1), (5, 16, 16), (4, 31, 31), (5, 32, 32), (4, 33, 33),
                   (3, 32, 40), (3, 40, 32), (5, 20, 32)]


@pytest.mark.parametrize(
    "m, n, route, smem4, smem8",
    [
        # warp: 128 / lanes matrices per block, each with two (row k, row kp)
        # exchange buffers of the column capacity (8, 16, 32) and the
        # m x (n | 1) staging tile
        (1, 1, "warp", 8 * (4 * 8 + 1) * 4, 8 * (4 * 8 + 1) * 8),
        (16, 16, "warp", 8 * (4 * 16 + 16 * 17) * 4, 8 * (4 * 16 + 16 * 17) * 8),
        (17, 5, "warp", 4 * (4 * 8 + 17 * 5) * 4, 4 * (4 * 8 + 17 * 5) * 8),
        (31, 31, "warp", 4 * (4 * 32 + 31 * 31) * 4, 4 * (4 * 32 + 31 * 31) * 8),
        (32, 32, "warp", 4 * (4 * 32 + 32 * 33) * 4, 4 * (4 * 32 + 32 * 33) * 8),
        (20, 32, "warp", 4 * (4 * 32 + 20 * 33) * 4, 4 * (4 * 32 + 20 * 33) * 8),
        (8, 20, "warp", 8 * (4 * 32 + 8 * 21) * 4, 8 * (4 * 32 + 8 * 21) * 8),
        # block: a side x side thread grid with S slots, cap = side S:
        # (3 cap + side + 2) values + (side + cap) ints; (8, 6) up to 48,
        # (8, 8) up to 64, (16, 6) up to 96, (16, 8) up to 128
        (33, 33, "block", 154 * 4 + 4 * 56, 154 * 8 + 4 * 56),
        (32, 40, "block", 154 * 4 + 4 * 56, 154 * 8 + 4 * 56),
        (40, 32, "block", 154 * 4 + 4 * 56, 154 * 8 + 4 * 56),
        (48, 10, "block", 154 * 4 + 4 * 56, 154 * 8 + 4 * 56),
        (64, 64, "block", 202 * 4 + 4 * 72, 202 * 8 + 4 * 72),
        (65, 3, "block", 306 * 4 + 4 * 112, 306 * 8 + 4 * 112),
        (96, 96, "block", 306 * 4 + 4 * 112, 306 * 8 + 4 * 112),
        (20, 100, "block", 402 * 4 + 4 * 144, 402 * 8 + 4 * 144),
        (128, 128, "block", 402 * 4 + 4 * 144, 402 * 8 + 4 * 144),
        # tile: (m (n + 1) + m) values + 2 m ints
        (129, 64, "tile", (129 * 66) * 4 + 8 * 129, (129 * 66) * 8 + 8 * 129),
        (300, 24, "tile", (300 * 26) * 4 + 8 * 300, (300 * 26) * 8 + 8 * 300),
        (40, 200, "tile", (40 * 202) * 4 + 8 * 40, (40 * 202) * 8 + 8 * 40),
    ],
)
def test_lu_route_rule_and_its_shared_memory(m, n, route, smem4, smem8):
    """The route of each shape and the byte count its launch must give
    (the kernel refuses another), shape by shape."""
    assert bk.lu_route(m, n) == route
    assert bk.lu_smem_bytes(m, n, 4) == smem4
    assert bk.lu_smem_bytes(m, n, 8) == smem8
    assert bk.lu_smem_bytes(m, n, 8, route) == smem8
    assert bk.lu_smem_bytes(m, n, 4, "tile") == bk.tile_smem_bytes(m, n, 4)
    assert max(smem4, smem8) <= bk.SMEM_LIMIT


@pytest.mark.parametrize(
    "n, nrhs, route, lanes",
    [
        # warp: 8, 16 or 32 lanes per matrix, 128 / lanes matrices per block,
        # each with an n x (n | 1) staging tile, whatever nrhs
        (1, 1, "warp", 8), (8, 1, "warp", 8), (8, 7, "warp", 8), (9, 1, "warp", 16),
        (15, 3, "warp", 16), (16, 1, "warp", 16), (17, 1, "warp", 32), (31, 64, "warp", 32),
        (32, 1, "warp", 32), (32, 600, "warp", 32),
        # wide: a warp per matrix beyond 32, 1, 2 or 4 per block (lanes: the
        # f32 count; see test_wide_solve_route_rule)
        (33, 1, "wide", 4), (64, 1, "wide", 2), (64, 9, "wide", 2),
        (128, 1, "wide", 1),
    ],
)
def test_solve_route_rule_and_its_shared_memory(n, nrhs, route, lanes):
    """The solve kernel's route of each shape and the byte count its launch
    must give (csrc/batched_solve.cu refuses another), by route: lanes per
    matrix on the warp route, matrices per block on the wide route."""
    assert bk.solve_route(n, nrhs) == route
    with pytest.raises(ValueError, match="no route"):
        bk.solve_smem_bytes(n, nrhs, 4, "block")
    if route == "warp":
        warp = (128 // lanes) * n * (n | 1)
        assert bk.solve_smem_bytes(n, nrhs, 4) == warp * 4
        assert bk.solve_smem_bytes(n, nrhs, 8, "warp") == warp * 8
        assert warp * 8 <= 48 * 1024  # no opt-in at any nrhs
    else:
        assert bk.wide_group(n, 4) == lanes
        assert bk.solve_smem_bytes(n, nrhs, 4) == lanes * n * 33 * 4
    # the predicate counts the shape's own route, which holds no rhs
    assert bk.solve_kernel_takes(torch.float32, n, nrhs)


def test_solve_routes_are_counted_apart():
    """The solve wrapper keeps a launch count per route beside the total,
    and the reset sets both to 0; CPU tensors launch nothing."""
    assert (set(bk.batched_solve_cuda.route_launches) == set(bk.SOLVE_ROUTES)
            == {"warp", "wide"})
    bk.batched_solve_cuda.route_launches["warp"] += 1
    bk.reset_solve_launches()
    assert bk.batched_solve_cuda.route_launches == {"warp": 0, "wide": 0}
    assert bk.batched_solve_cuda.launches == 0
    for route in ("warp", "block", "tile"):
        with pytest.raises(ValueError):
            bk.batched_solve_cuda(torch.zeros(2, 4, 4), torch.zeros(2, 4), route=route)
    assert bk.batched_solve_cuda.route_launches == {"warp": 0, "wide": 0}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize(
    "n, route, side, slots",
    [(1, "warp", None, None), (31, "warp", None, None), (32, "warp", None, None),
     (33, "block", 8, 6), (64, "block", 8, 8), (96, "block", 16, 6), (128, "block", 16, 8)],
)
def test_noswap_route_rule_and_its_shared_memory(n, route, side, slots, itemsize):
    """The noswap kernel takes the swap kernel's route for (n, n) and counts
    its own shared memory: on the warp route one pair of row-kp buffers
    per matrix (the swap mode holds two pairs), on the block route row kp,
    the multipliers, BT candidates and a[n - 1, k], then BT + 2 BT S ints
    (candidates' rows, pivot row per step, step per row); it has no tile
    route."""
    assert bk.noswap_route(n) == route == bk.lu_route(n, n)
    if route == "warp":
        lanes = 16 if n <= 16 else 32
        cols = 8 if n <= 8 else 16 if n <= 16 else 32
        want = (128 // lanes) * (2 * cols + n * (n | 1)) * itemsize
        assert bk.lu_smem_bytes(n, n, itemsize) - want == (128 // lanes) * 2 * cols * itemsize
    else:
        cap = side * slots
        want = (2 * cap + side + 1) * itemsize + 4 * (side + 2 * cap)
    assert bk.noswap_smem_bytes(n, itemsize) == want
    assert bk.noswap_smem_bytes(n, itemsize, route) == want
    with pytest.raises(ValueError, match="no route"):
        bk.noswap_smem_bytes(n, itemsize, "tile")
    assert want <= 48 * 1024  # no opt-in on the register routes


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 96, 128])
def test_wide_solve_route_rule(n, itemsize):
    """The solve's route and shared memory at the route boundaries: warp up
    to 32, wide beyond with an n x 33 tile per matrix and 1, 2 or 4
    matrices per block (the most resident warps per SM by shared memory:
    32 blocks, 64 warps, 228 KB with 1 KB per block); no block route
    whatever the shape."""
    route = bk.solve_route(n, 1)
    assert route == ("warp" if n <= 32 else "wide")
    with pytest.raises(ValueError, match="no route"):
        bk.solve_smem_bytes(n, 1, itemsize, "block")
    if route == "wide":
        tile = n * 33 * itemsize
        resident = {g: min(64, min(32, 233472 // (g * tile + 1024)) * g) for g in (1, 2, 4)}
        g = bk.wide_group(n, itemsize)
        assert resident[g] == max(resident.values())
        assert all(resident[h] < resident[g] for h in (1, 2, 4) if h < g)
        assert bk.solve_smem_bytes(n, 1, itemsize) == g * tile
        assert bk.solve_smem_bytes(n, 7, itemsize) == g * tile  # whatever nrhs
    assert bk.solve_kernel_takes(torch.float32 if itemsize == 4 else torch.float64, n, 1)


@pytest.mark.parametrize(
    "what, shape, route",
    [("noswap", (2, 33, 33), "warp"), ("noswap", (2, 129, 129), "block"),
     ("noswap", (2, 8, 8), "wide"), ("solve", (2, 33, 33), "warp"),
     ("solve", (2, 32, 32), "wide"), ("solve", (2, 129, 129), "wide"),
     ("solve", (2, 8, 8), "tile"),
     # the retired routes: the noswap tile and the solve's block route
     ("noswap", (2, 8, 8), "tile"), ("noswap", (2, 64, 64), "tile"),
     ("noswap", (2, 128, 128), "tile"), ("solve", (2, 8, 8), "block"),
     ("solve", (2, 64, 64), "block"), ("solve", (2, 129, 129), "block")],
)
def test_forced_route_that_does_not_take_the_shape_raises(what, shape, route):
    """Forcing a route that does not take the shape, or a route the kernel
    does not have, raises before anything else is checked (here: before
    the CPU tensor is refused), and nothing is launched."""
    bk.reset_noswap_launches()
    bk.reset_solve_launches()
    A = torch.zeros(shape)
    with pytest.raises(ValueError, match="route"):
        if what == "noswap":
            bk.batched_lu_noswap_cuda(A, True, route=route)
        else:
            bk.batched_solve_cuda(A, torch.zeros(shape[:2]), route=route)
    assert bk.batched_lu_noswap_cuda.launches == bk.batched_solve_cuda.launches == 0
    assert not any(bk.batched_lu_noswap_cuda.route_launches.values())


def test_noswap_routes_are_counted_apart():
    assert (set(bk.batched_lu_noswap_cuda.route_launches) == set(bk.NOSWAP_ROUTES)
            == {"warp", "block"})
    bk.batched_lu_noswap_cuda.route_launches["block"] += 1
    bk.batched_lu_noswap_cuda.launches += 1
    bk.reset_noswap_launches()
    assert bk.batched_lu_noswap_cuda.route_launches == {"warp": 0, "block": 0}
    assert bk.batched_lu_noswap_cuda.launches == 0


def test_lu_kernel_takes_the_shapes_it_always_took():
    """The routes change nothing in which shapes the kernels take: 0 <
    min(m, n) <= 128 and an (m, n + 1) tile, a column and 2 m ints within
    the shared-memory limit."""
    for dtype in (torch.float32, torch.float64):
        size = dtype.itemsize
        for m in list(range(1, 140, 3)) + [200, 438, 439, 600, 4096, 11571, 11572]:
            for n in list(range(1, 140, 3)) + [200, 600, 4096, 57850, 57851]:
                old = (0 < min(m, n) <= 128
                       and (m * (n + 1) + m) * size + 8 * m <= 232448 - 1024)
                assert bk.lu_kernel_takes(dtype, m, n) == old, (dtype, m, n)


def _pallas_swap(A, dtype, pivot):
    f, ipiv, perm, info = batched_lu_pallas(jx(A, dtype), pivot, interpret=True, group=4)
    return np.asarray(f), np.asarray(ipiv), np.asarray(perm), np.asarray(info)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", BOUNDARY_SHAPES)
def test_swap_plain_matches_pallas_at_route_boundaries(shape, pivot, dtype):
    """randn with zeroed columns: ipiv, perm, info exact; factors within
    20 max(m, n) eps max|A|."""
    B, m, n = shape
    zero = [(B - 1, min(m, n) // 2)] + ([(0, 0)] if B > 2 else [])
    A = make_batch(41, B, m, n, pivot, zero, dtype=dtype)
    f_j, ipiv_j, perm_j, info_j = _pallas_swap(A, dtype, pivot)
    f, ipiv, perm, info = bk.batched_lu_plain(tc(A, dtype), pivot, True)
    np.testing.assert_array_equal(to_np(ipiv), ipiv_j)
    np.testing.assert_array_equal(to_np(perm), perm_j)
    np.testing.assert_array_equal(to_np(info), info_j)
    np.testing.assert_array_equal(to_np(info), expected_info(B, pivot, zero))
    np.testing.assert_allclose(to_np(f), f_j, rtol=0, atol=value_tol(A, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", BOUNDARY_SHAPES)
def test_swap_plain_ties_and_nan_match_pallas_at_route_boundaries(shape, dtype):
    """Exact ties (integers in [-2, 2]): ipiv, perm, info exact, factors
    within tolerance.  A NaN candidate (and an inf beside it in the
    pivot row): ipiv, perm, info exact (the values part by design, see
    test_nan_among_candidates_picks_the_last_row_as_pallas_does)."""
    B, m, n = shape
    rng = np.random.default_rng(42)
    T = rng.integers(-2, 3, size=(B, m, n)).astype(dtype)
    f_j, ipiv_j, perm_j, info_j = _pallas_swap(T, dtype, True)
    f, ipiv, perm, info = bk.batched_lu_plain(tc(T, dtype), True, True)
    np.testing.assert_array_equal(to_np(ipiv), ipiv_j)
    np.testing.assert_array_equal(to_np(perm), perm_j)
    np.testing.assert_array_equal(to_np(info), info_j)
    np.testing.assert_allclose(to_np(f), f_j, rtol=0, atol=value_tol(T, dtype))
    A = make_batch(43, B, m, n, True, dtype=dtype)
    A[B // 2, m // 2, min(1, n - 1)] = np.nan
    A[B - 1, m - 1, 0] = 1e3
    A[B - 1, m - 1, n - 1] = np.inf
    _, ipiv_j, perm_j, info_j = _pallas_swap(A, dtype, True)
    _, ipiv, perm, info = bk.batched_lu_plain(tc(A, dtype), True, True)
    np.testing.assert_array_equal(to_np(ipiv), ipiv_j)
    np.testing.assert_array_equal(to_np(perm), perm_j)
    np.testing.assert_array_equal(to_np(info), info_j)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", BOUNDARY_SHAPES)
def test_batched_lu_factor_matches_jax_at_route_boundaries(shape, dtype):
    """The public factor functions at the routes' boundaries against the
    JAX package (its kernels in f32, its default route in f64): ipiv,
    perm and info exact, factors within 20 max(m, n) eps max|factors|,
    perm the folded ipiv."""
    B, m, n = shape
    zero = [(B - 1, min(m, n) - 1)]
    A = make_batch(44, B, m, n, True, zero, dtype=dtype)
    cfg = rf.LUConfig(backend="pallas") if dtype == np.float32 else None
    f_j, ipiv_j, info_j = jb.batched_lu_factor(jx(A, dtype), True, cfg)
    f, ipiv, info = rt.batched_lu_factor(A, device="cpu")
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_array_equal(to_np(info), expected_info(B, True, zero))
    # the scale is that of the factors, which grow past max|A|: the JAX
    # route rounds in another order than the kernels' plain version
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0,
                               atol=value_tol(np.asarray(f_j), dtype))
    if m == n:
        f2, perm, info2 = rt.batched_lu_factor_perm(A, device="cpu")
        _, perm_j, _ = jb.batched_lu_factor_perm(jx(A, dtype), True, cfg)
        np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
        assert torch.equal(f2, f) and torch.equal(info2, info)
        assert torch.equal(perm, rt.batched_ipiv_to_perm(ipiv, m))


@pytest.mark.parametrize("case", ["randn", "ties", "nan_used_last", "nan_free_last"])
@pytest.mark.parametrize("n", [31, 32, 33])
def test_noswap_plain_matches_pallas_at_route_boundaries(n, case):
    """The noswap plain version against the interpret-mode Pallas kernel at
    the warp / block boundary: randn with a zeroed column, exact ties
    (integers in [-2, 2]), and a NaN candidate at step 1, after row n - 1
    won step 0 (the NaN rule picks it again although it is used) or while
    it is still free.  perm and info exact; factors within 20 n eps max|A|
    where they are finite (with a NaN the values part by design, see
    test_nan_among_candidates_picks_the_last_row_as_pallas_does)."""
    B = 5
    if case == "ties":
        A = np.random.default_rng(45).integers(-2, 3, size=(B, n, n)).astype(F32)
    else:
        A = make_batch(46, B, n, n, True, zero=[(B - 1, n // 2)] if case == "randn" else [])
    if case.startswith("nan"):
        if case == "nan_used_last":
            A[::2, n - 1, 0] = 1e3  # row n - 1 wins step 0
        A[::2, 0, 1] = np.nan
    f_j, perm_j, info_j = batched_lu_pallas_noswap(jx(A, F32), True, interpret=True, group=4)
    f, perm, info = bk.batched_lu_noswap_plain(tc(A, F32), True)
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    if case == "nan_used_last":
        assert (to_np(perm)[::2, :2] == n - 1).all()  # row n - 1 twice
    elif case == "nan_free_last":
        assert (to_np(perm)[::2, 1] == n - 1).all()
    else:
        np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))
        for i in range(B):
            assert sorted(to_np(perm)[i]) == list(range(n))


@pytest.mark.parametrize("nrhs", [None, 3])
@pytest.mark.parametrize("n", [33, 48])
def test_solve_plain_matches_pallas_on_the_wide_route(n, nrhs):
    """The solve's plain version against the interpret-mode Pallas kernel
    at n = 33 and 48 (the wide route's two-rows-per-lane shapes), on
    pre-permuted right-hand sides; within 50 x 20 n eps max|x| as
    test_solve_plain_matches_pallas, and every solve through perm or ipiv
    equal to the pre-permuted one."""
    B = 6
    A = make_batch(47, B, n, n, True)
    rng = np.random.default_rng(48)
    b = rng.standard_normal((B, n) if nrhs is None else (B, n, nrhs)).astype(F32)
    f, ipiv, perm, _ = bk.batched_lu_plain(tc(A, F32), True, True)
    idx = perm.long() if nrhs is None else perm.long()[:, :, None].expand(B, n, nrhs)
    rhs = tc(b, F32).gather(1, idx)
    x_j = np.asarray(batched_solve_pallas(jx(to_np(f), F32), jx(to_np(rhs), F32),
                                          interpret=True, group=4))
    x = bk.batched_solve_plain(f, rhs)
    tol = 20 * n * EPS[F32] * float(np.max(np.abs(x_j))) * 50
    np.testing.assert_allclose(to_np(x), x_j, rtol=0, atol=tol)
    assert torch.equal(bk.batched_solve_plain(f, tc(b, F32), perm=perm), x)
    assert torch.equal(bk.batched_solve_plain(f, tc(b, F32), ipiv=ipiv), x)


# ---------------------------------------------------------------------------
# the slice: the public functions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(5, 12, 12), (4, 10, 6), (4, 6, 10)])
def test_batched_lu_factor_matches_jax_f32(shape, pivot):
    B, m, n = shape
    zero = [(2, 1)]
    A = make_batch(21, B, m, n, pivot, zero)
    f_j, ipiv_j, info_j = jb.batched_lu_factor(jx(A, F32), pivot, rf.LUConfig(backend="pallas"))
    f, ipiv, info = rt.batched_lu_factor(A, pivot, device="cpu")
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_array_equal(to_np(info), expected_info(B, pivot, zero))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))
    assert f.dtype == torch.float32 and f.device.type == "cpu"


@pytest.mark.parametrize("pivot", [True, False])
def test_batched_lu_factor_perm_and_solve_perm_match_jax_f32(pivot):
    B, n = 5, 12
    A = make_batch(22, B, n, n, pivot)
    cfg = rf.LUConfig(backend="pallas")
    f_j, perm_j, info_j = jb.batched_lu_factor_perm(jx(A, F32), pivot, cfg)
    f, perm, info = rt.batched_lu_factor_perm(A, pivot, device="cpu")
    np.testing.assert_array_equal(to_np(perm), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A))
    assert batch_residual(A, f, perm) < value_tol(A) * (1 if pivot else 50)
    rng = np.random.default_rng(23)
    for shape in ((B, n), (B, n, 3)):
        b = rng.standard_normal(shape).astype(F32)
        x_j = np.asarray(jb.batched_lu_solve_perm(f_j, perm_j, jx(b, F32), pivot))
        x = to_np(rt.batched_lu_solve_perm(f, perm, b, pivot, device="cpu"))
        assert x.shape == shape
        np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-4 * float(np.max(np.abs(x_j))))


@pytest.mark.parametrize("rhs_cols", [None, 2])
def test_batched_factor_and_solve_match_jax_f64(rhs_cols):
    """f64 against the JAX package's default route (its pure-JAX loop)."""
    B, n = 4, 20
    A = make_batch(24, B, n, n, True, dtype=np.float64)
    b = np.random.default_rng(25).standard_normal((B, n) if rhs_cols is None else (B, n, rhs_cols))
    f_j, ipiv_j, info_j = jb.batched_lu_factor(jx(A, np.float64))
    f, ipiv, info = rt.batched_lu_factor(A, device="cpu")
    assert f.dtype == torch.float64
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipiv_j))
    np.testing.assert_array_equal(to_np(info), np.asarray(info_j))
    np.testing.assert_allclose(to_np(f), np.asarray(f_j), rtol=0, atol=value_tol(A, np.float64))
    x_j = np.asarray(jb.batched_lu_solve(f_j, ipiv_j, jx(b, np.float64)))
    x = to_np(rt.batched_lu_solve(f, ipiv, b, device="cpu"))
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-11 * float(np.max(np.abs(x_j))))
    f2, perm2, _ = rt.batched_lu_factor_perm(A, device="cpu")
    f2_j, perm2_j, _ = jb.batched_lu_factor_perm(jx(A, np.float64))
    np.testing.assert_array_equal(to_np(perm2), np.asarray(perm2_j))
    np.testing.assert_allclose(to_np(f2), np.asarray(f2_j), rtol=0, atol=value_tol(A, np.float64))


@pytest.mark.parametrize("trans", ["T", "H", 1])
def test_batched_solve_trans_matches_jax(trans):
    B, n = 4, 10
    A = make_batch(26, B, n, n, True, dtype=np.float64)
    b = np.random.default_rng(27).standard_normal((B, n))
    f_j, ipiv_j, _ = jb.batched_lu_factor(jx(A, np.float64))
    f, ipiv, _ = rt.batched_lu_factor(A, device="cpu")
    x_j = np.asarray(jb.batched_lu_solve(f_j, ipiv_j, jx(b, np.float64), True, True))
    x = to_np(rt.batched_lu_solve(f, ipiv, b, trans=trans, device="cpu"))
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-11 * float(np.max(np.abs(x_j))))
    np.testing.assert_allclose(np.einsum("bji,bj->bi", A, x), b, atol=1e-10)


@pytest.mark.parametrize("rhs_cols", [None, 2])
def test_library_route_solve_matches_the_plain_route(rhs_cols):
    """backend='xla' selects the gather + triangular-solve route."""
    B, n = 4, 14
    A = make_batch(28, B, n, n, True, dtype=np.float64)
    b = np.random.default_rng(29).standard_normal((B, n) if rhs_cols is None else (B, n, rhs_cols))
    f, perm, _ = rt.batched_lu_factor_perm(A, device="cpu")
    x = rt.batched_lu_solve_perm(f, perm, b, device="cpu")
    x_lib = rt.batched_lu_solve_perm(f, perm, b, device="cpu", config=rt.LUConfig(backend="xla"))
    np.testing.assert_allclose(to_np(x_lib), to_np(x), rtol=0, atol=1e-11 * float(x.abs().max()))


def test_jax_factorization_solved_by_the_port_and_back():
    B, n = 5, 12
    A = make_batch(30, B, n, n, True)
    b = np.random.default_rng(31).standard_normal((B, n)).astype(F32)
    cfg = rf.LUConfig(backend="pallas")
    # JAX factors, the port solves
    f_j, ipiv_j, info_j = jax.device_get(jb.batched_lu_factor(jx(A, F32), True, cfg))
    f, ipiv, info = rt.batched_from_numpy(f_j, ipiv_j, info_j, device="cpu")
    assert ipiv.dtype == info.dtype == torch.int32 and f.dtype == torch.float32
    x = to_np(rt.batched_lu_solve(f, ipiv, b, device="cpu"))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x), b, atol=1e-3)
    f_j, perm_j, info_j = jax.device_get(jb.batched_lu_factor_perm(jx(A, F32), True, cfg))
    f, perm, _ = rt.batched_from_numpy(f_j, perm_j, info_j, device="cpu")
    x2 = to_np(rt.batched_lu_solve_perm(f, perm, b, device="cpu"))
    np.testing.assert_allclose(x2, x, rtol=0, atol=1e-4 * float(np.max(np.abs(x))))
    # the port factors, JAX solves
    f, ipiv, _ = rt.batched_lu_factor(A, device="cpu")
    x_j = np.asarray(jb.batched_lu_solve(jx(to_np(f), F32), jx(to_np(ipiv), np.int32), jx(b, F32)))
    np.testing.assert_allclose(x_j, x, rtol=0, atol=1e-4 * float(np.max(np.abs(x))))
    with pytest.raises(RuntimeError):
        if torch.cuda.is_available():
            raise RuntimeError("a card is present: device=None is legal here")
        rt.batched_from_numpy(f_j, perm_j, info_j)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_ipiv_matches_scipy(dtype):
    B, n = 6, 24
    A = make_batch(32, B, n, n, True, dtype=dtype)
    f, ipiv, info = rt.batched_lu_factor(A, device="cpu")
    assert to_np(info).tolist() == [0] * B
    for i in range(B):
        lu_s, piv_s = scipy.linalg.lu_factor(A[i])
        np.testing.assert_array_equal(to_np(ipiv)[i], piv_s)
        np.testing.assert_allclose(to_np(f)[i], lu_s, rtol=0, atol=value_tol(A, dtype))


def test_routing_predicates():
    auto, xla, pallas = rt.LUConfig(), rt.LUConfig(backend="xla"), rt.LUConfig(backend="pallas")
    assert pb._use_batched_kernel(torch.float32, 64, 64, auto)
    assert pb._use_batched_kernel(torch.float64, 128, 128, auto)
    assert pb._use_batched_kernel(torch.float32, 200, 40, auto)
    assert not pb._use_batched_kernel(torch.float32, 129, 129, auto)
    assert not pb._use_batched_kernel(torch.float32, 64, 0, auto)
    assert not pb._use_batched_kernel(torch.float16, 64, 64, auto)
    assert not pb._use_batched_kernel(torch.float32, 64, 64, xla)
    assert pb._use_batched_kernel(torch.float32, 64, 64, pallas)
    with pytest.raises(ValueError):
        pb._use_batched_kernel(torch.float32, 129, 129, pallas)
    f = torch.zeros(3, 64, 64)
    b = torch.zeros(3, 64)
    assert pb._use_solve_kernel(f, b, False)
    assert pb._use_solve_kernel(f, torch.zeros(3, 64, 5), 0, auto)
    assert not pb._use_solve_kernel(f, b, "T")
    assert not pb._use_solve_kernel(f, b, False, xla)
    assert not pb._use_solve_kernel(torch.zeros(3, 129, 129), torch.zeros(3, 129), False)
    assert not pb._use_solve_kernel(f.half(), b.half(), False)
    with pytest.raises(ValueError):
        pb._use_solve_kernel(f, b, "T", pallas)
    # batched_lu_factor_perm is the swap route: the factors and info of
    # batched_lu_factor, perm the folded ipiv
    A = np.random.default_rng(7).integers(-2, 3, (4, 9, 9)).astype(F32)
    f, perm, info = rt.batched_lu_factor_perm(A, device="cpu")
    f2, ipiv, info2 = rt.batched_lu_factor(A, device="cpu")
    assert torch.equal(f, f2) and torch.equal(info, info2)
    assert torch.equal(perm, rt.batched_ipiv_to_perm(ipiv, 9))


def test_forced_kernel_on_a_refused_shape_raises():
    A = np.zeros((2, 129, 129), dtype=F32)
    with pytest.raises(ValueError):
        rt.batched_lu_factor(A, config=rt.LUConfig(backend="pallas"), device="cpu")
    with pytest.raises(ValueError):
        rt.batched_lu_factor_perm(np.zeros((2, 5, 6), dtype=F32), device="cpu")
    with pytest.raises(ValueError):
        rt.batched_lu_factor(np.zeros((5, 6), dtype=F32), device="cpu")
    with pytest.raises(ValueError):
        rt.batched_lu_solve_perm(np.zeros((2, 5, 6), dtype=F32), np.zeros((2, 5), dtype=np.int32),
                                 np.zeros((2, 5), dtype=F32), device="cpu")


def test_wide_batch_beyond_the_kernel_limit_runs_the_plain_version_on_cpu():
    """n = 129 is past the kernel's limit; on the CPU the plain version
    factors it all the same (on the card it goes to the library)."""
    B, n = 2, 129
    A = make_batch(33, B, n, n, True)
    f, perm, info = rt.batched_lu_factor_perm(A, device="cpu")
    assert to_np(info).tolist() == [0, 0]
    assert batch_residual(A, f, perm) < value_tol(A)


def test_device_rule():
    """device=None means CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is legal here")
    A = make_batch(34, 2, 4, 4, True)
    for call in (lambda: rt.batched_lu_factor(A),
                 lambda: rt.batched_lu_factor_perm(A),
                 lambda: rt.batched_lu_solve(A, np.zeros((2, 4), np.int32), A[:, :, 0]),
                 lambda: rt.batched_lu_solve_perm(A, np.zeros((2, 4), np.int32), A[:, :, 0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_port_imports_no_jax():
    """The port's batched modules import torch and numpy only."""
    import pathlib

    root = pathlib.Path(rt.__file__).parent
    for rel in ("ops/batched_kernel.py", "parallel/batched.py", "parallel/__init__.py"):
        text = (root / rel).read_text()
        assert "import jax" not in text and "from jax" not in text
        assert "recursivefactorization_jl_tpu " not in text
        assert "recursivefactorization_jl_tpu." not in text
