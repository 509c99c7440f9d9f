"""Integer and bool matrices (the ``generic`` route) on the CPU.

The port factors them as their float64 copies, as scipy's ``lu_factor``
does, and returns float64 factors and solutions: ``lu`` / ``lu_solve`` /
``solve``, the batched functions and the tensor-parallel LU.  The JAX
package computes them in the integer type, which gives wrong factors (a
fault of the reference the port does not inherit, pinned below), so the
reference here is the JAX package on ``A.astype(float64)`` and scipy.

Tolerances: ipiv, perm and info exactly; factors within
``1e-12 * max|f|`` of scipy's and of the JAX package's (other orders of
the same float64 sums); solutions within ``1e-10 * max|x|``.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu as rf
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu.parallel.blockcyclic import tp_lu_factor_p
from test_torch_common import to_np
from test_torch_parallel import RankPool, mesh_1d

torch.set_num_threads(1)

DTYPES = [torch.int8, torch.int32, torch.int64, torch.uint8, torch.bool]
NP = {torch.int8: np.int8, torch.int32: np.int32, torch.int64: np.int64,
      torch.uint8: np.uint8, torch.bool: np.bool_}


def int_matrix(dtype, shape, seed):
    """Integer entries of the type's range, made with numpy.  bool: a
    random pattern for vectors; for matrices the rows of a unit upper
    triangle with random entries above the diagonal, shuffled, so that
    every step has one nonzero candidate (pivots without ties, exact
    arithmetic, no singular matrix)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.bool and len(shape) > 1 and shape[-1] == shape[-2]:
        n = shape[-1]
        A = np.triu(rng.random(shape) < 0.3, 1) | np.eye(n, dtype=bool)
        order = np.argsort(rng.random(shape[:-1]), axis=-1)
        A = np.take_along_axis(A, order[..., None], axis=-2)
    elif dtype == torch.bool:
        A = rng.random(shape) < 0.3
    elif dtype == torch.uint8:
        A = rng.integers(0, 256, shape)
    else:
        A = rng.integers(-100, 101, shape)
    return A.astype(NP[dtype])


def assert_close(got, want, tol=1e-12):
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("config", ["whole", "blocked"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_factors_as_float64(dtype, config):
    """``lu`` of an integer or bool matrix: float64 factors equal to
    scipy's ``lu_factor`` and to the JAX package's ``lu`` of the float64
    copy, on the whole-matrix and the blocked route."""
    n = 48
    A = int_matrix(dtype, (n, n), 1 + DTYPES.index(dtype))
    cfg = rt.LUConfig(panel_width=16, small_threshold=16) if config == "blocked" else None
    assert rt.dispatch_route((n, n), dtype, True, cfg) == "generic"
    F = rt.lu(torch.as_tensor(A), config=cfg, check=False, device="cpu")
    assert F.factors.dtype == torch.float64
    lu, piv = scipy.linalg.lu_factor(A.astype(np.float64))
    np.testing.assert_array_equal(to_np(F.ipiv), piv)
    assert_close(F.factors, lu)
    J = rf.lu(jnp.asarray(A.astype(np.float64)), check=False)
    np.testing.assert_array_equal(to_np(F.ipiv), np.asarray(J.ipiv))
    np.testing.assert_array_equal(to_np(F.p), np.asarray(J.p))
    assert int(F.info) == int(J.info)
    assert_close(F.factors, J.factors)
    # the same bits as the float64 copy's own factorization
    G = rt.lu(torch.as_tensor(A.astype(np.float64)), config=cfg, check=False, device="cpu")
    assert torch.equal(F.factors, G.factors) and torch.equal(F.p, G.p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_solve_and_solve_with_an_integer_rhs(dtype):
    """An integer right-hand side solves in float64: ``lu_solve`` (N, T),
    ``solve``, ``lu_solve_refined`` against scipy's ``lu_solve``."""
    n = 32
    A = int_matrix(dtype, (n, n), 11 + DTYPES.index(dtype))
    b = int_matrix(dtype, (n,), 21)
    Af = A.astype(np.float64)
    F = rt.lu(torch.as_tensor(A), device="cpu")
    fac = scipy.linalg.lu_factor(Af)
    for t, trans in (("N", 0), ("T", 1)):
        x = rt.lu_solve(F, torch.as_tensor(b), trans=t)
        assert x.dtype == torch.float64
        assert_close(x, scipy.linalg.lu_solve(fac, b.astype(np.float64), trans=trans), 1e-10)
    want = scipy.linalg.lu_solve(fac, b.astype(np.float64))
    assert_close(rt.solve(torch.as_tensor(A), torch.as_tensor(b), device="cpu"), want, 1e-10)
    x = rt.lu_solve_refined(F, torch.as_tensor(A), torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert_close(x, want, 1e-10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_functions_factor_as_float64(dtype):
    """``batched_lu_factor`` / ``_perm`` and both solves on an integer
    batch: float64 factors and solutions, per matrix those of scipy and of
    the JAX package's batched functions on the float64 copy."""
    B, n = 5, 12
    A = int_matrix(dtype, (B, n, n), 31 + DTYPES.index(dtype))
    b = int_matrix(dtype, (B, n), 41)
    Af = A.astype(np.float64)
    f, ipiv, info = rt.batched_lu_factor(torch.as_tensor(A), device="cpu")
    fp, perm, infop = rt.batched_lu_factor_perm(torch.as_tensor(A), device="cpu")
    assert f.dtype == fp.dtype == torch.float64 and torch.equal(f, fp)
    x = rt.batched_lu_solve(f, ipiv, torch.as_tensor(b), device="cpu")
    xp = rt.batched_lu_solve_perm(fp, perm, torch.as_tensor(b), device="cpu")
    assert x.dtype == xp.dtype == torch.float64
    for i in range(B):
        lu, piv = scipy.linalg.lu_factor(Af[i])
        np.testing.assert_array_equal(to_np(ipiv[i]), piv)
        assert_close(f[i], lu)
        want = scipy.linalg.lu_solve((lu, piv), b[i].astype(np.float64))
        assert_close(x[i], want, 1e-10)
        assert_close(xp[i], want, 1e-10)
    fj, ipj, infj = (np.asarray(t) for t in rf.batched_lu_factor(jnp.asarray(Af)))
    _, permj, _ = (np.asarray(t) for t in rf.batched_lu_factor_perm(jnp.asarray(Af)))
    np.testing.assert_array_equal(to_np(ipiv), ipj)
    np.testing.assert_array_equal(to_np(perm), permj)
    np.testing.assert_array_equal(to_np(info), infj)
    np.testing.assert_array_equal(to_np(infop), infj)
    assert_close(f, fj)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tp_lu_factors_as_float64(pool, dtype):
    """``tp_lu`` / ``tp_lu_solve`` on two gloo ranks: float64 factors equal
    to the JAX package's tp on the float64 copy (ipiv, perm, info; factors
    to 1e-12) and pivots equal to scipy's; the solve in float64."""
    n, w = 64, 8
    A = int_matrix(dtype, (n, n), 51 + DTYPES.index(dtype))
    b = int_matrix(dtype, (n,), 61)
    Af = A.astype(np.float64)
    port = pool.run("tp_solve", A=A, w=w, rhs=[(b, "N")])
    assert port["dtype"] == "torch.float64" and port["x_dtype"] == ["torch.float64"]
    F, ipiv, perm, info = (np.asarray(t) for t in tp_lu_factor_p(
        jnp.asarray(Af), mesh_1d("tp", 2), "tp", w))
    np.testing.assert_array_equal(port["ipiv"], ipiv)
    np.testing.assert_array_equal(port["perm"], perm[:n])
    assert port["info"] == int(info)
    assert_close(port["F"], F)
    fac = scipy.linalg.lu_factor(Af)
    np.testing.assert_array_equal(port["ipiv"], fac[1])
    assert_close(port["x"][0], scipy.linalg.lu_solve(fac, b.astype(np.float64)), 1e-10)


def test_integer_fault_of_the_reference_is_not_inherited():
    """``[[2, 1], [4, 3]]`` in int32: the JAX package factors it in integer
    arithmetic (multiplier 2 // 4 = 0: factors ``[[4, 3], [0, 1]]``, info
    0, and the solve of ``[1, 2]`` gives ``[0, 1]``, which is wrong); the
    port gives scipy's float64 answer, ``[[4, 3], [0.5, -0.5]]`` and
    ``x = [0.5, 0]``."""
    A = np.array([[2, 1], [4, 3]], dtype=np.int32)
    b = np.array([1, 2], dtype=np.int32)
    J = rf.lu(jnp.asarray(A))
    np.testing.assert_array_equal(np.asarray(J.factors), [[4, 3], [0, 1]])
    np.testing.assert_array_equal(np.asarray(rf.lu_solve(J, jnp.asarray(b))), [0, 1])
    F = rt.lu(torch.as_tensor(A), device="cpu")
    assert F.factors.dtype == torch.float64 and int(F.info) == 0
    np.testing.assert_array_equal(to_np(F.factors), [[4.0, 3.0], [0.5, -0.5]])
    np.testing.assert_array_equal(to_np(rt.lu_solve(F, torch.as_tensor(b))), [0.5, 0.0])
    np.testing.assert_array_equal(to_np(F.factors), scipy.linalg.lu_factor(A.astype(float))[0])


def test_integer_matrices_cannot_be_factored_in_place():
    """``lu_inplace`` and ``lu_factor(donate=True)`` keep the factors in
    ``A``, which an integer or bool tensor cannot hold: they raise, and
    ``A`` is left as it was."""
    A = torch.as_tensor(int_matrix(torch.int32, (8, 8), 71))
    A0 = A.clone()
    for call in (lambda: rt.lu_inplace(A, device="cpu"),
                 lambda: rt.lu_factor(A, donate=True, device="cpu")):
        with pytest.raises(TypeError, match="float64"):
            call()
    assert torch.equal(A, A0)
