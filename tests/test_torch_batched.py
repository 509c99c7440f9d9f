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
    """The eligibility predicate and the launch use one byte count."""
    assert bk.lu_smem_bytes(64, 64, 4) == (64 * 65 + 64) * 4 + 8 * 64
    assert bk.lu_kernel_takes(torch.float32, 128, 128)
    assert bk.lu_kernel_takes(torch.float64, 128, 128)
    assert bk.lu_smem_bytes(128, 128, 8) > 48 * 1024  # needs the opt-in
    assert not bk.lu_kernel_takes(torch.float32, 129, 129)
    assert not bk.lu_kernel_takes(torch.float16, 8, 8)
    assert not bk.lu_kernel_takes(torch.float32, 4096, 64)  # tile too large
    assert bk.lu_kernel_takes(torch.float32, 600, 64)
    assert bk.solve_smem_bytes(64, 1, 4) == (64 * 65 + 2 * 64) * 4 + 4 * 64
    assert bk.solve_kernel_takes(torch.float64, 128, 8)
    assert not bk.solve_kernel_takes(torch.float32, 128, 400)
    assert not bk.solve_kernel_takes(torch.float32, 0, 1)


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
