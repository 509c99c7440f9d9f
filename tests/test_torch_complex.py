"""The port's complex and half-precision path against the JAX package.

Complex matrices pivot by CABS1 (``|re| + |im|``) in the port, on both
devices and for both complex types: the rule of the TPU kernel being
ported (``_panel_kernel_fori_c64``) and of LAPACK ``cgetrf``/``zgetrf``.
So complex64 results are held to the JAX package with its Pallas kernel
forced (``backend="pallas"``, interpret mode on the CPU) and complex128
pivots to scipy; the JAX package's pure-JAX complex routes pivot by the
modulus, and against them only info and the residual gates are held.
bfloat16/float16 matrices are factored as their float32 copies
(``promote``).  The Hopper kernel's own tests are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.ops.panel import panel_factor_pallas_c64
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops import blocked
from recursivefactorization_jl_tpu_torch.ops.panel import (
    panel_factor,
    panel_factor_c64_cuda,
    panel_route,
)
from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    unblocked_lu,
    unblocked_lu_cabs1,
)
from test_torch_common import assert_pivots_equal, lu_residual, to_np

torch.set_num_threads(1)

RNG = np.random.default_rng(53)
EPS = {np.complex64: np.finfo(np.float32).eps, np.complex128: np.finfo(np.float64).eps}
BLOCKED = dict(small_threshold=32, panel_width=32)


def _cmatrix(shape, dtype=np.complex64, shift=False, zero_col=None):
    A = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
    if shift:
        A = A + max(shape) * np.eye(*shape)
    if zero_col is not None:
        A[:, zero_col] = 0
    return A.astype(dtype)


def _gate(A, dtype, pivot=True):
    g = 20 * max(A.shape) * EPS[dtype] * float(np.max(np.abs(A)))
    return g if pivot else 10 * np.sqrt(g)


def _jax_kernel(A, pivot):
    """The TPU kernel being ported, in interpret mode."""
    return panel_factor_pallas_c64(jnp.asarray(A), pivot, interpret=True, micro=16)


# ---- (a) the CABS1 plain version against the TPU kernel -------------------


@pytest.mark.parametrize("shape,pivot", [
    ((64, 64), True), ((64, 64), False), ((96, 32), True), ((96, 32), False),
    ((32, 80), True), ((32, 80), False),
    # ragged against the micro block and past one 128-lane row
    ((130, 130), True), ((40, 40), False),
])
def test_cabs1_plain_matches_jax_c64_kernel(shape, pivot):
    """ipiv, perm and info exactly; factors within 20*max(m, w)*eps(f32)*
    max|A|, not bitwise: the TPU kernel delays the updates across a
    micro block and applies them as matmuls."""
    A = _cmatrix(shape, shift=not pivot)
    port = unblocked_lu_cabs1(torch.as_tensor(A), pivot)
    ref = _jax_kernel(A, pivot)
    assert_pivots_equal(port, ref)
    assert int(port[3]) == 0
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]),
                               atol=_gate(A, np.complex64))
    assert lu_residual(A, port[0], port[2]) < _gate(A, np.complex64, pivot)


@pytest.mark.parametrize("pivot", [True, False])
def test_cabs1_plain_zero_column_matches_jax_c64_kernel(pivot):
    """A zero pivot: no swap, no scale, the update still runs, info is
    the signed 1-based step."""
    A = _cmatrix((96, 32), shift=not pivot, zero_col=7)
    port = unblocked_lu_cabs1(torch.as_tensor(A), pivot)
    ref = _jax_kernel(A, pivot)
    assert_pivots_equal(port, ref)
    assert int(port[3]) == (8 if pivot else -8)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]),
                               atol=_gate(A, np.complex64))


@pytest.mark.parametrize("where", ["re", "im", "last_row"])
def test_cabs1_plain_nan_candidate_matches_jax_c64_kernel(where):
    """A NaN among a step's candidates: the maximum is NaN, no candidate
    equals it, and the pivot row is m - 1, as in the TPU kernel."""
    A = _cmatrix((64, 64))
    row = 63 if where == "last_row" else 20
    A[row, 5] = complex(1.0, np.nan) if where == "im" else complex(np.nan, 1.0)
    port = unblocked_lu_cabs1(torch.as_tensor(A), True)
    ref = _jax_kernel(A, True)
    # The TPU kernel carries perm as a float row of its shadow, which the
    # NaN destroys; the port's perm stays the fold of ipiv.
    np.testing.assert_array_equal(to_np(port[1]), np.asarray(ref[1]))
    assert int(port[3]) == int(ref[3])
    assert torch.equal(port[2], rt.ipiv_to_perm(port[1], 64))
    # from the step that meets the NaN on, every step picks row m - 1
    assert (to_np(port[1])[5:] == 63).all() and 63 not in to_np(port[1])[:5]
    f, fj = to_np(port[0]), np.asarray(ref[0])
    # the TPU kernel's masked sums and boundary matmuls spread the NaN
    # further (0 * NaN); the port's NaNs are a subset of its NaNs
    assert not (np.isnan(f) & ~np.isnan(fj)).any()
    assert np.isfinite(f[:, :5]).all()
    ok = ~np.isnan(fj)
    # forced pivots bound no growth: the gate scales with the factors
    np.testing.assert_allclose(f[ok], fj[ok], atol=_gate(np.where(ok, f, 0), np.complex64))


def test_cabs1_plain_exact_ties_take_the_first_row():
    A = RNG.integers(-2, 3, (48, 48)) + 1j * RNG.integers(-2, 3, (48, 48))
    A = A.astype(np.complex64)
    port = unblocked_lu_cabs1(torch.as_tensor(A), True)
    ref = _jax_kernel(A, True)
    np.testing.assert_array_equal(to_np(port[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(to_np(port[2]), np.asarray(ref[2]))


def test_cabs1_plain_takes_views_and_refuses_real():
    A = torch.as_tensor(_cmatrix((40, 40), np.complex128))
    view = A[8:, 4:20]
    keep = A.clone()
    f, piv, perm, info = unblocked_lu_cabs1(view, True)
    assert torch.equal(A, keep) and f.is_contiguous()
    g = unblocked_lu_cabs1(view.clone(), True)
    assert torch.equal(f, g[0]) and torch.equal(piv, g[1])
    h = unblocked_lu_cabs1(view.conj(), True)
    assert torch.equal(h[0], unblocked_lu_cabs1(view.conj().resolve_conj(), True)[0])
    with pytest.raises(ValueError):
        unblocked_lu_cabs1(torch.zeros(4, 4), True)


# ---- (b) pivots against LAPACK ----------------------------------------------


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(70, 70), (100, 40), (40, 100)])
def test_cabs1_ipiv_matches_scipy_getrf(dtype, shape):
    A = _cmatrix(shape, dtype)
    f, ipiv, perm, info = unblocked_lu_cabs1(torch.as_tensor(A), True)
    lu, piv, linfo = scipy.linalg.lapack.get_lapack_funcs(("getrf",), (A,))[0](A)
    np.testing.assert_array_equal(to_np(ipiv), piv)
    np.testing.assert_allclose(to_np(f), lu, atol=_gate(A, dtype))
    assert int(info) == linfo == 0


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(150, 150), (200, 120), (90, 140)])
def test_blocked_complex_ipiv_matches_scipy(dtype, shape, monkeypatch):
    """The blocked schedule on complex (three or more 32-wide panels, the
    fat wrapper, both laswp branches): LAPACK's pivots exactly."""
    A = _cmatrix(shape, dtype)
    cfg = rt.LUConfig(**BLOCKED)
    dense = rt.lu_factor_p(A, config=cfg, device="cpu")
    np.testing.assert_array_equal(to_np(dense[1]), scipy.linalg.lu_factor(A)[1])
    assert int(dense[3]) == 0
    assert lu_residual(A, dense[0], dense[2]) < _gate(A, dtype)
    monkeypatch.setattr(blocked, "SPARSE_LASWP_MIN_BYTES", 0)
    sparse = rt.lu_factor_p(A, config=cfg, device="cpu")
    for d, s in zip(dense, sparse):
        assert torch.equal(d, s)


# ---- (c) the whole path: lu, lu_solve, solve, lu_solve_refined -------------


def _ops(A):
    return {0: A, 1: A.T, 2: A.conj().T}


@pytest.mark.parametrize("route", ["whole", "blocked"])
def test_c64_lu_and_solves_match_jax_pallas(route):
    """``lu`` + ``lu_solve`` (N/T/H, 1 and 3 right-hand sides) + ``solve``
    + ``lu_solve_refined`` on complex64 against the JAX package with its
    c64 kernel forced: the same pivots, factors within the gate,
    solutions within 200 gates of each other and of the residual."""
    n = 64 if route == "whole" else 80
    kw = {} if route == "whole" else BLOCKED
    A = _cmatrix((n, n))
    pc, jc = rt.LUConfig(**kw), rf.LUConfig(backend="pallas", **kw)
    assert rt.dispatch_route((n, n), torch.complex64, True, pc) == route
    assert rf.dispatch_route((n, n), jnp.complex64, True, jc) == route
    F = rt.lu(A, config=pc, device="cpu")
    J = rf.lu(jnp.asarray(A), config=jc)
    assert F.factors.dtype == torch.complex64
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info), (J.factors, J.ipiv, J.p, J.info))
    gate = _gate(A, np.complex64)
    np.testing.assert_allclose(to_np(F.factors), np.asarray(J.factors), atol=gate)
    assert lu_residual(A, F.factors, F.p) < gate
    for nrhs in (None, 3):
        b = _cmatrix((n,) if nrhs is None else (n, nrhs))
        for trans, op in _ops(A).items():
            x = to_np(rt.lu_solve(F, b, trans=trans))
            xj = np.asarray(rf.lu_solve(J, jnp.asarray(b), trans=trans))
            assert x.shape == b.shape and x.dtype == np.complex64
            assert np.max(np.abs(op @ x - b)) < 200 * gate
            np.testing.assert_allclose(x, xj, atol=200 * gate)
    b = _cmatrix((n,))
    x = to_np(rt.solve(A, b, config=pc, device="cpu"))
    xj = np.asarray(rf.solve(jnp.asarray(A), jnp.asarray(b), config=jc))
    np.testing.assert_allclose(x, xj, atol=200 * gate)
    xr = to_np(rt.lu_solve_refined(F, A, b))
    xrj = np.asarray(rf.lu_solve_refined(J, jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(xr, xrj, atol=200 * gate)
    # refinement does not lose to the plain solve
    assert np.max(np.abs(A @ xr - b)) <= 2 * np.max(np.abs(A @ x - b)) + gate
    for trans, op in _ops(A).items():
        xt = to_np(rt.solve(A, b, trans=trans, config=pc, device="cpu"))
        assert np.max(np.abs(op @ xt - b)) < 200 * gate


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("route", ["whole", "blocked"])
def test_c128_lu_and_solves_against_jax_default_and_scipy(route, pivot):
    """complex128: the JAX package has no kernel and pivots by the
    modulus, so info and the residual gates are held against it, and the
    pivots against scipy ``zgetrf``."""
    n = 80
    kw = {} if route == "whole" else BLOCKED
    A = _cmatrix((n, n), np.complex128, shift=not pivot)
    b = _cmatrix((n, 2), np.complex128)
    F = rt.lu(A, pivot, config=rt.LUConfig(**kw), device="cpu")
    J = rf.lu(jnp.asarray(A), pivot, config=rf.LUConfig(**kw))
    gate = _gate(A, np.complex128, pivot)
    assert int(F.info) == int(J.info) == 0
    assert lu_residual(A, F.factors, F.p) < gate
    assert lu_residual(A, np.asarray(J.factors), np.asarray(J.p)) < gate
    if pivot:
        np.testing.assert_array_equal(to_np(F.ipiv), scipy.linalg.lu_factor(A)[1])
    else:
        np.testing.assert_array_equal(to_np(F.ipiv), np.arange(n))
    for trans, op in _ops(A).items():
        x = to_np(rt.lu_solve(F, b, trans=trans))
        xj = np.asarray(rf.lu_solve(J, jnp.asarray(b), trans=trans))
        assert np.max(np.abs(op @ x - b)) < 200 * gate
        np.testing.assert_allclose(x, xj, atol=200 * gate)


def test_complex_zero_column_info_and_check():
    A = _cmatrix((80, 80), np.complex64, zero_col=50)
    cfg = rt.LUConfig(**BLOCKED)
    F = rt.lu(A, check=False, config=cfg, device="cpu")
    J = rf.lu(jnp.asarray(A), check=False, config=rf.LUConfig(backend="pallas", **BLOCKED))
    assert int(F.info) == int(J.info) == 51
    np.testing.assert_array_equal(to_np(F.ipiv), np.asarray(J.ipiv))
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(A, config=cfg, device="cpu")
    G = rt.lu(A, pivot=False, check=False, device="cpu")
    assert int(G.info) == -51


def test_complex_routing_and_library_delegation():
    cfg = rt.LUConfig()
    for dt in (torch.complex64, torch.complex128):
        assert rt.dispatch_route((64, 64), dt, True, cfg) == "whole"
        assert rt.dispatch_route((64, 100), dt, True, cfg) == "blocked"
        assert rt.dispatch_route((600, 600), dt, True, cfg) == "blocked"
        assert panel_route(64, 32, dt, cfg, "cuda") == "kernel"
        assert panel_route(64, 32, dt, cfg, "cpu") == "unblocked"
    A = _cmatrix((50, 50), np.complex128)
    xla = rt.LUConfig(xla_threshold=64)
    assert rt.dispatch_route((50, 50), torch.complex128, True, xla) == "xla"
    F = rt.lu(A, config=xla, device="cpu")
    np.testing.assert_array_equal(to_np(F.ipiv), scipy.linalg.lu_factor(A)[1])
    assert lu_residual(A, F.factors, F.p) < _gate(A, np.complex128)
    # the physical schedule's kernel is real: complex matrices keep the
    # swap schedule under it
    phys = rt.LUConfig(schedule="physical")
    assert rt.dispatch_route((50, 50), torch.complex128, True, phys) == "whole"
    P, D = rt.lu(A, config=phys, device="cpu"), rt.lu(A, device="cpu")
    assert torch.equal(P.ipiv, D.ipiv) and torch.equal(P.factors, D.factors)
    # the kernel wrapper never takes a CPU tensor (no silent fallback)
    with pytest.raises(ValueError):
        panel_factor_c64_cuda(torch.as_tensor(A), True)
    # in place, on a strided panel view, through the panel layer
    M = torch.as_tensor(_cmatrix((60, 60), np.complex64))
    keep = M.clone()
    out = panel_factor(M[10:, 10:30], True, cfg)
    assert out[0].data_ptr() == M[10:, 10:30].data_ptr()
    assert torch.equal(out[0], unblocked_lu_cabs1(keep[10:, 10:30], True)[0])
    assert torch.equal(M[:, :10], keep[:, :10]) and torch.equal(M[:10], keep[:10])


@pytest.mark.parametrize("precision", ["float32", "bf16x3", "bf16"])
def test_schur_product_is_full_precision_on_complex(precision):
    """The reduced Schur modes apply to float32 only, as in the JAX
    ``schur_update``: complex products stay full under every setting."""
    A = torch.as_tensor(_cmatrix((40, 24)))
    B = torch.as_tensor(_cmatrix((24, 30)))
    assert torch.equal(schur_product(A, B, precision), A @ B)
    M = _cmatrix((80, 80))
    if precision != "bf16":  # 'bf16' warns by design
        cfg = rt.LUConfig(schur_precision=precision, **BLOCKED)
        F = rt.lu(M, config=cfg, device="cpu")
        assert lu_residual(M, F.factors, F.p) < _gate(M, np.complex64)


# ---- (d) promote -------------------------------------------------------------


@pytest.mark.parametrize("route", ["whole", "blocked"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_promote_matches_jax(half, route):
    """bf16/f16: both packages factor the exact float32 promotion and
    round the factors back, so ipiv, perm and info are equal and the
    factors agree to one rounding of the half type (the two float32
    eliminations round in different orders, which can move a value
    across a half rounding boundary)."""
    n = 80
    tdt, jdt = getattr(torch, half), getattr(jnp, half)
    A32 = torch.tensor(RNG.standard_normal((n, n)) + n * np.eye(n)).to(tdt).float().numpy()
    kw = {} if route == "whole" else BLOCKED
    At = torch.tensor(A32).to(tdt)
    assert rt.dispatch_route((n, n), tdt, True, rt.LUConfig(**kw)) == "promote"
    F = rt.lu(At, config=rt.LUConfig(**kw), device="cpu")
    J = rf.lu(jnp.asarray(A32).astype(jdt), config=rf.LUConfig(**kw))
    assert F.factors.dtype == tdt
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info), (J.factors, J.ipiv, J.p, J.info))
    f = F.factors.float().numpy()
    fj = np.asarray(J.factors.astype(jnp.float32))
    eps = float(torch.finfo(tdt).eps)
    np.testing.assert_allclose(f, fj, rtol=eps, atol=eps * 1e-2)
    assert np.mean(f == fj) > 0.99
    # and exactly the float32 run of the port, rounded
    G = rt.lu(At.float(), config=rt.LUConfig(**kw), device="cpu")
    assert torch.equal(F.factors, G.factors.to(tdt)) and torch.equal(F.ipiv, G.ipiv)
    b = torch.tensor(RNG.standard_normal(n)).to(tdt)
    for trans in (0, 1):
        x = rt.lu_solve(F, b, trans=trans)
        assert x.dtype == tdt
        op = At.double() if trans == 0 else At.double().T
        assert float((op @ x.double() - b.double()).abs().max()) < 20 * n * eps
    x = rt.solve(At, b, device="cpu")
    xr = rt.lu_solve_refined(F, At, b)
    assert x.dtype == xr.dtype == tdt
    for y in (x, xr):
        assert float((At.double() @ y.double() - b.double()).abs().max()) < 20 * n * eps


# ---- (e) det, logabsdet, inv ----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_det_logabsdet_inv(dtype):
    n = 24
    A = _cmatrix((n, n), dtype)
    F = rt.lu(A, device="cpu")
    tol = 50 * n * EPS[dtype]
    det = np.linalg.det(A.astype(np.complex128))
    assert abs(complex(F.det()) - det) < tol * abs(det)
    logabs, sign = F.logabsdet()
    s, l = np.linalg.slogdet(A.astype(np.complex128))
    assert abs(float(logabs) - l) < tol * max(1.0, abs(l))
    assert abs(complex(sign) - s) < tol
    assert abs(abs(complex(sign)) - 1) < tol
    inv = to_np(F.inv())
    assert np.max(np.abs(inv @ A - np.eye(n))) < tol * np.linalg.cond(A)
    np.testing.assert_allclose(to_np(F.P) @ A, to_np(F.L) @ to_np(F.U),
                               atol=_gate(A, dtype))
    assert to_np(F.P).dtype == dtype


def test_half_det_logabsdet_inv():
    n = 6  # det stays inside float16's range
    A = torch.tensor(RNG.standard_normal((n, n)) + 3 * np.eye(n)).to(torch.float16)
    F = rt.lu(A, device="cpu")
    s, l = np.linalg.slogdet(A.double().numpy())
    logabs, sign = F.logabsdet()
    assert logabs.dtype == torch.float16 and float(sign) == s
    assert abs(float(logabs) - l) < 0.05
    assert abs(float(F.det()) / (s * np.exp(l)) - 1) < 0.05
    assert float((F.inv().double() @ A.double() - torch.eye(n)).abs().max()) < 0.05


# ---- (f) a factorization made by the JAX package solves in the port --------------


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_from_numpy_round_trip(dtype):
    n = 64
    A = _cmatrix((n, n), dtype)
    b = _cmatrix((n, 2), dtype)
    cfg = rf.LUConfig(backend="pallas") if dtype == np.complex64 else rf.LUConfig()
    J = rf.lu(jnp.asarray(A), config=cfg)
    gate = _gate(A, dtype)
    for perm in (np.asarray(J.p), None):
        F = rt.from_numpy(np.asarray(J.factors), np.asarray(J.ipiv),
                          np.asarray(J.info), perm=perm, device="cpu")
        assert isinstance(F, rt.LU) and F.factors.dtype == getattr(torch, dtype.__name__)
        np.testing.assert_array_equal(to_np(F.p), np.asarray(J.p))
        for trans, op in _ops(A).items():
            x = to_np(rt.lu_solve(F, b, trans=trans))
            assert np.max(np.abs(op @ x - b)) < 200 * gate
    # and back: the port's factors solve in the JAX package
    F = rt.lu(A, device="cpu")
    x = np.asarray(rf.lu_solve(
        rf.LU(jnp.asarray(to_np(F.factors)), jnp.asarray(to_np(F.ipiv)),
              jnp.asarray(to_np(F.info)), True, jnp.asarray(to_np(F.p))),
        jnp.asarray(b)))
    assert np.max(np.abs(A @ x - b)) < 200 * gate
    N = rt.from_numpy(to_np(F.factors), np.arange(n), 0, pivoted=False, device="cpu")
    assert N.pivoted is False and N.perm is None


# ---- (g) batches -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("pivot", [True, False])
def test_batched_complex_matches_jax(dtype, pivot):
    """Complex batches take the library routes.  The JAX package's CPU
    route pivots by the modulus, so info, the residual gate and the
    solutions are held, not the pivots; those are held to scipy."""
    B, n = 4, 24
    A = np.stack([_cmatrix((n, n), dtype, shift=not pivot) for _ in range(B)])
    A[2, :, 9] = 0
    b = np.stack([_cmatrix((n,), dtype) for _ in range(B)])
    f, perm, info = rt.batched_lu_factor_perm(A, pivot, device="cpu")
    f2, ipiv, info2 = rt.batched_lu_factor(A, pivot, device="cpu")
    fj, permj, infoj = rf.batched_lu_factor_perm(jnp.asarray(A), pivot)
    np.testing.assert_array_equal(to_np(info), np.asarray(infoj))
    np.testing.assert_array_equal(to_np(info2), np.asarray(infoj))
    assert int(info[2]) == (10 if pivot else -10)
    assert torch.equal(rt.batched_ipiv_to_perm(ipiv, n), perm)
    gate = _gate(A[0], dtype, pivot)
    ok = [i for i in range(B) if i != 2]
    for i in ok:
        assert lu_residual(A[i], f[i], perm[i]) < gate
        if pivot:
            np.testing.assert_array_equal(to_np(ipiv[i]), scipy.linalg.lu_factor(A[i])[1])
    for trans in (0, 1, 2):
        x = to_np(rt.batched_lu_solve_perm(f, perm, b, pivot, trans=trans, device="cpu"))
        x2 = to_np(rt.batched_lu_solve(f2, ipiv, b, pivot, trans=trans, device="cpu"))
        np.testing.assert_array_equal(x[ok], x2[ok])
        for i in ok:
            assert np.max(np.abs(_ops(A[i])[trans] @ x[i] - b[i])) < 200 * gate
    xj = np.asarray(rf.batched_lu_solve_perm(fj, permj, jnp.asarray(b), pivot))
    x = to_np(rt.batched_lu_solve_perm(f, perm, b, pivot, device="cpu"))
    np.testing.assert_allclose(x[ok], xj[ok], atol=200 * gate)
    with pytest.raises(ValueError):
        rt.batched_lu_factor(A, config=rt.LUConfig(backend="pallas"), device="cpu")


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_batched_half_promotes(half):
    """Half batches: the float32 routes on the promoted batch, rounded
    back.  The JAX package's batched functions on the promoted batch give
    the same pivots."""
    B, n = 6, 16
    tdt = getattr(torch, half)
    At = torch.tensor(RNG.standard_normal((B, n, n)) + n * np.eye(n)).to(tdt)
    bt = torch.tensor(RNG.standard_normal((B, n))).to(tdt)
    f, ipiv, info = rt.batched_lu_factor(At, device="cpu")
    g, perm, _ = rt.batched_lu_factor_perm(At, device="cpu")
    f32, ipiv32, info32 = rt.batched_lu_factor(At.float(), device="cpu")
    assert f.dtype == g.dtype == tdt
    assert torch.equal(f, f32.to(tdt)) and torch.equal(f, g)
    assert torch.equal(ipiv, ipiv32) and torch.equal(info, info32)
    fj, ipivj, infoj = rf.batched_lu_factor(jnp.asarray(At.float().numpy()))
    np.testing.assert_array_equal(to_np(ipiv), np.asarray(ipivj))
    np.testing.assert_array_equal(to_np(info), np.asarray(infoj))
    eps = float(torch.finfo(tdt).eps)
    np.testing.assert_allclose(f.float().numpy(), np.asarray(fj), rtol=eps, atol=eps * 1e-2)
    for x in (rt.batched_lu_solve(f, ipiv, bt, device="cpu"),
              rt.batched_lu_solve_perm(g, perm, bt, device="cpu"),
              rt.batched_lu_solve_perm(g, perm, bt, trans="T", device="cpu")):
        assert x.dtype == tdt and x.shape == bt.shape
    x = rt.batched_lu_solve(f, ipiv, bt, device="cpu")
    r = torch.bmm(At.double(), x.double()[:, :, None])[:, :, 0] - bt.double()
    assert float(r.abs().max()) < 20 * n * eps


# ---- (h) the pinned difference: CABS1 against the modulus ---------------------------


def test_cabs1_pivot_differs_from_the_modulus_by_design():
    """First column 1+0j and 0.6+0.6j: CABS1 (1.0 against 1.2) picks the
    second row, the modulus (1.0 against 0.85) the first.  The port and
    LAPACK pick by CABS1 on every route; the JAX package's default
    (pure-JAX) complex route picks by the modulus, its c64 kernel by
    CABS1.  Both factorizations are valid."""
    A = np.array([[1.0 + 0.0j, 2.0 - 1.0j, 0.5j],
                  [0.6 + 0.6j, 1.0 + 1.0j, 1.0 + 0.0j],
                  [0.1 + 0.1j, -2.0 + 0.0j, 2.0 + 0.5j]])
    lapack = scipy.linalg.lu_factor(A)[1]
    assert lapack[0] == 1
    for dtype in (np.complex64, np.complex128):
        M = A.astype(dtype)
        for cfg in (rt.LUConfig(), rt.LUConfig(small_threshold=1, panel_width=1)):
            F = rt.lu(M, config=cfg, device="cpu")
            np.testing.assert_array_equal(to_np(F.ipiv), lapack)
            assert lu_residual(M, F.factors, F.p) < _gate(M, dtype)
        J = rf.lu(jnp.asarray(M))
        assert int(J.ipiv[0]) == 0  # the modulus rule
        assert lu_residual(M, np.asarray(J.factors), np.asarray(J.p)) < _gate(M, dtype)
    K = rf.lu(jnp.asarray(A.astype(np.complex64)), config=rf.LUConfig(backend="pallas"))
    np.testing.assert_array_equal(np.asarray(K.ipiv), lapack)
    # the port's modulus-pivoting plain LU keeps the JAX function's rule
    assert int(unblocked_lu(torch.as_tensor(A), True)[1][0]) == 0
    assert int(unblocked_lu_cabs1(torch.as_tensor(A), True)[1][0]) == 1
