"""The port's triangular inverses/solves (ops/trsm.py) and Schur update
(ops/schur.py) against the JAX package and scipy."""

import numpy as np
import pytest
import scipy.linalg
import torch

from recursivefactorization_jl_tpu.ops import schur as jschur
from recursivefactorization_jl_tpu.ops import trsm as jtrsm
from recursivefactorization_jl_tpu_torch.ops import schur, trsm
from recursivefactorization_jl_tpu_torch.utils.config import full_matmul_precision
from test_torch_common import jx, tc, to_np

torch.set_num_threads(1)

RNG = np.random.default_rng(21)


def _tri(n, dtype):
    A = RNG.standard_normal((n, n))
    L = np.tril(A, -1) / np.sqrt(n) + np.eye(n)       # unit lower
    U = np.triu(A) + np.diag(np.sign(np.diag(A)) * 2.0)  # well-scaled upper
    return L.astype(dtype), U.astype(dtype)


# n: base case, power-of-2 batched base, ragged recursive split, and
# blocked sweeps (block 64) with full and ragged last blocks; the JAX
# side runs op by op, so it is compared in f64 only
@pytest.mark.parametrize("n", [24, 100, 128, 192, 200])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solves_match_scipy_and_jax(n, dtype):
    L, U = _tri(n, dtype)
    B = RNG.standard_normal((n, 3)).astype(dtype)
    tol = 100 * n * np.finfo(dtype).eps
    cases = [
        (trsm.solve_unit_lower, jtrsm.solve_unit_lower, L,
         dict(lower=True, unit_diagonal=True)),
        (trsm.solve_upper, jtrsm.solve_upper, U, {}),
        (trsm.solve_lower, jtrsm.solve_lower, U.T.copy(), dict(lower=True)),
        (trsm.solve_unit_upper, jtrsm.solve_unit_upper, L.T.copy(),
         dict(unit_diagonal=True)),
    ]
    for port, ref, T, kw in cases:
        x = to_np(port(tc(T, dtype), tc(B, dtype), 64))
        xs = scipy.linalg.solve_triangular(T.astype(np.float64), B, **kw)
        scale = np.max(np.abs(xs))
        np.testing.assert_allclose(x, xs, atol=tol * scale, err_msg=port.__name__)
        if dtype == np.float64 and n in (24, 100, 200):
            xj = np.asarray(ref(jx(T, dtype), jx(B, dtype), 64))
            np.testing.assert_allclose(x, xj, atol=tol * scale, err_msg=port.__name__)


@pytest.mark.parametrize("n", [32, 64, 96])
def test_inverses_match_jax(n):
    dtype = np.float64
    L, U = _tri(n, dtype)
    pairs = [
        (trsm.unit_lower_inverse, jtrsm.unit_lower_inverse, L),
        (trsm.upper_inverse, jtrsm.upper_inverse, U),
        (trsm.unit_upper_inverse, jtrsm.unit_upper_inverse, L.T.copy()),
        (trsm.lower_inverse, jtrsm.lower_inverse, U.T.copy()),
    ]
    for port, ref, T in pairs:
        X = to_np(port(tc(T, dtype)))
        Xj = np.asarray(ref(jx(T, dtype)))
        np.testing.assert_allclose(X, Xj, atol=1e-12, err_msg=port.__name__)


def test_unit_lower_inverse_reads_only_strict_lower():
    """Packed LU factors: the diagonal and upper part are U's, ignored."""
    L, U = _tri(64, np.float64)
    packed = np.tril(L, -1) + np.triu(U)
    X = to_np(trsm.unit_lower_inverse(tc(packed, np.float64)))
    np.testing.assert_allclose(X @ L, np.eye(64), atol=1e-12)


@pytest.mark.parametrize("precision,tol", [
    ("float32", 1e-5), ("bf16x3", 1e-5), ("bf16", 3e-2),
])
def test_schur_update_modes_match_jax(precision, tol):
    """C - A@B in each mode against the JAX package on the CPU, relative
    to max|A@B|: f32 to f32 rounding; bf16x3 drops the al@bl term (about
    2^-16 relative per product) on both sides; bf16 keeps 8 bits."""
    m, k, n = 48, 32, 40
    C = RNG.standard_normal((m, n)).astype(np.float32)
    A = RNG.standard_normal((m, k)).astype(np.float32)
    B = RNG.standard_normal((k, n)).astype(np.float32)
    got = to_np(schur.schur_update(tc(C, np.float32), tc(A, np.float32),
                                   tc(B, np.float32), precision))
    ref = np.asarray(jschur.schur_update(jx(C, np.float32), jx(A, np.float32),
                                         jx(B, np.float32), precision))
    exact = C.astype(np.float64) - A.astype(np.float64) @ B.astype(np.float64)
    scale = np.max(np.abs(A.astype(np.float64) @ B))
    assert np.max(np.abs(got - exact)) < tol * scale
    assert np.max(np.abs(got - ref)) < tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
@pytest.mark.parametrize("precision", ["float32", "bf16x3", "bf16"])
def test_schur_update_in_place_matches_the_returned_update(dtype, precision):
    """``schur_update_`` writes into ``C`` and returns it; in float32's
    reduced modes it is ``schur_update`` bit for bit, at full precision
    (every other dtype takes it, whatever the mode) one ``addmm_``, the
    same product to the dtype's rounding."""
    m, k, n = 40, 24, 36
    C, A, B = (torch.tensor(RNG.standard_normal(s), dtype=torch.float64).to(dtype)
               for s in ((m, n), (m, k), (k, n)))
    want = schur.schur_update(C, A, B, precision)
    C0 = C.clone()
    got = schur.schur_update_(C, A, B, precision)
    assert got is C
    if dtype == torch.float32 and precision != "float32":
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, torch.addmm(C0, A, B, alpha=-1))
        eps = torch.finfo(got.real.dtype).eps
        assert float((got - want).abs().max()) < 8 * k * eps * float((A @ B).abs().max())


def test_schur_f64_ignores_reduced_modes():
    A = RNG.standard_normal((8, 4))
    B = RNG.standard_normal((4, 8))
    C = RNG.standard_normal((8, 8))
    for p in ("float32", "bf16x3", "bf16"):
        got = to_np(schur.schur_update(tc(C, np.float64), tc(A, np.float64),
                                       tc(B, np.float64), p))
        np.testing.assert_allclose(got, C - A @ B, atol=1e-13)


def test_full_matmul_precision_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with full_matmul_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True

        @full_matmul_precision()
        def probe():
            return torch.backends.cuda.matmul.allow_tf32

        assert probe() is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
