"""Complex and half tensor-parallel LU (parallel/blockcyclic.py) and the
plain version of the complex offset kernel, on the CPU.

``offset_panel_lu_cabs1`` (ops/unblocked.py) is the plain version of the
offset form of csrc/panel_lu_c64.cu, which tests/test_torch_cuda.py holds
to it bitwise on the card.  Here it meets ``unblocked_lu_cabs1`` of the
live rows, the cluster route's delayed order emulated on them, and
scipy's ``zgetrf`` / ``cgetrf`` pivots.

``tp_lu_factor_p`` / ``tp_lu`` / ``tp_lu_solve`` run in pools of spawned
gloo ranks (D = 1, 2, 4; tests/torch_dist_worker.py is the rank body) on
complex64 / complex128 and bfloat16 / float16 matrices:

* complex: the JAX package's tp pivots by the modulus and the port by
  CABS1 (a deliberate difference), so against it info and the residual
  gate ``20 * n * eps * max|A|``; pivots exactly against scipy and against
  the port's single-device ``lu``; solutions (N, T, H) to ``1e-4`` /
  ``1e-10`` of ``max|x|`` (complex64 / complex128) against the
  single-device solve and under the residual of the JAX package's;
* half: the port factors the exact float32 promotion, so against the JAX
  package's tp on that promotion: pivots, perm and info exactly, factors
  within one rounding to the half type (``eps * |f|``) plus the float32
  run's own spread (``1e-5 * max|f|``).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu as rf
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu.parallel.blockcyclic import tp_lu_factor_p
from recursivefactorization_jl_tpu_torch.ops.panel import (
    offset_panel_factor,
    offset_panel_factor_c64_cuda,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    offset_panel_lu_cabs1,
    unblocked_lu_cabs1,
)
from test_torch_common import lu_residual, to_np
from test_torch_panel_schedule import _assert_same, _bits, blocked_order_lu_cabs1
from test_torch_parallel import RankPool, mesh_1d

torch.set_num_threads(1)

H, W = 96, 16  # the plain version's panel
N, TW = 96, 8  # the tp matrices and panel width
EPS = {np.complex64: np.finfo(np.float32).eps, np.complex128: np.finfo(np.float64).eps}
SOLVE_TOL = {np.complex64: 1e-4, np.complex128: 1e-10}


def complex_panel(name, dtype, ofs, pivot=True):
    rng = np.random.default_rng([ofs, len(name), 7])
    if name == "ties":  # exact CABS1 ties on integer parts
        A = rng.integers(-2, 3, (H, W)) + 1j * rng.integers(-2, 3, (H, W))
    else:
        A = rng.standard_normal((H, W)) + 1j * rng.standard_normal((H, W))
    if not pivot:
        A[ofs + np.arange(W), np.arange(W)] += H
    if name == "zero_col":
        A[ofs:, 5] = 0
    if name == "nan":
        A[ofs + 10, 3] = complex(np.nan, 1.0)
    return torch.tensor(A, dtype=torch.complex64 if dtype == np.complex64 else torch.complex128)


OFFSETS = [0, 3, H - W]


@pytest.mark.parametrize("name,pivot", [("randn", True), ("randn", False), ("ties", True),
                                        ("zero_col", True), ("zero_col", False), ("nan", True)])
@pytest.mark.parametrize("ofs", OFFSETS)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_offset_panel_lu_cabs1_is_unblocked_lu_cabs1_of_the_live_rows(dtype, ofs, name, pivot):
    """Bitwise the CABS1 LU of rows ``ofs:`` with global pivot rows, the
    identity above ``ofs`` and those rows untouched; a zeroed column gives
    info 6 (-6 unpivoted); a NaN candidate makes every later pivot row
    H - 1, the rule of the complex kernel."""
    A = complex_panel(name, dtype, ofs, pivot)
    f, piv, perm, info = offset_panel_lu_cabs1(A, ofs, pivot)
    lf, lpiv, lperm, linfo = unblocked_lu_cabs1(A[ofs:], pivot)
    assert torch.equal(_bits(f[ofs:]), _bits(lf)) and torch.equal(_bits(f[:ofs]), _bits(A[:ofs]))
    assert torch.equal(piv, lpiv + ofs) and int(info) == int(linfo)
    assert torch.equal(perm, torch.cat([torch.arange(ofs, dtype=torch.int32), lperm + ofs]))
    if name == "zero_col":
        assert int(info) == (6 if pivot else -6)
    if name == "nan":
        assert (piv[3:] == H - 1).all() and (piv[:3] != H - 1).all()


@pytest.mark.parametrize("b", [8, 16, "w"])
@pytest.mark.parametrize("ofs", OFFSETS)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_offset_panel_lu_cabs1_equals_the_cluster_order(dtype, ofs, b):
    """The cluster route runs the chain and the delayed pass on the live
    rows from ``ofs``: its order, emulated there, gives the plain version's
    bits, ties and a zeroed column included."""
    b = W if b == "w" else b
    for name in ("randn", "ties", "zero_col"):
        A = complex_panel(name, dtype, ofs)
        lf, lpiv, lperm, linfo = blocked_order_lu_cabs1(A[ofs:], True, b)
        got = (torch.cat([A[:ofs], lf]), lpiv + ofs,
               torch.cat([torch.arange(ofs, dtype=torch.int32), lperm + ofs]), linfo)
        _assert_same(got, offset_panel_lu_cabs1(A, ofs, True))


@pytest.mark.parametrize("ofs", OFFSETS)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_offset_panel_lu_cabs1_pivots_are_lapacks(dtype, ofs):
    """The live rows' pivots are scipy's ``cgetrf`` / ``zgetrf`` ones (both
    take the first row of the largest CABS1), shifted by ``ofs``."""
    A = complex_panel("randn", dtype, ofs)
    _, piv, _, info = offset_panel_lu_cabs1(A, ofs, True)
    _, lapack = scipy.linalg.lu_factor(A[ofs:].numpy())
    np.testing.assert_array_equal(to_np(piv), lapack[:W] + ofs)
    assert int(info) == 0


def test_offset_panel_factor_routes_complex_panels_and_refuses():
    """A complex CPU panel takes ``offset_panel_lu_cabs1`` under every
    backend, in place; the complex kernel's wrapper takes CUDA tensors of a
    complex type only."""
    A = complex_panel("randn", np.complex64, 10)
    want = offset_panel_lu_cabs1(A, 10, True)
    for backend in ("auto", "pallas", "jax"):
        P = A.clone()
        out = offset_panel_factor(P, 10, True, rt.LUConfig(tp_panel_backend=backend))
        assert out[0] is P
        _assert_same(out, want)
    for bad in (A, A.real.contiguous()):
        with pytest.raises(ValueError):
            offset_panel_factor_c64_cuda(bad, 10, True)
    with pytest.raises(ValueError, match="offset"):
        offset_panel_lu_cabs1(A, H - W + 1, True)
    assert offset_panel_factor_c64_cuda.counts.launches == 0


@pytest.fixture(scope="module")
def pools():
    started = {D: RankPool(D) for D in (1, 2, 4)}
    yield started
    for pool in started.values():
        pool.close()


def cmatrix(seed, dtype, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)


@pytest.fixture(scope="module")
def complex_cases():
    """Per complex dtype: the matrix and the JAX package's tp factorization
    of it on 4 devices (modulus pivots)."""
    out = {}
    for seed, dtype in ((31, np.complex64), (32, np.complex128)):
        A = cmatrix(seed, dtype)
        F, ipiv, perm, info = (np.asarray(x) for x in tp_lu_factor_p(
            jnp.asarray(A), mesh_1d("tp", 4), "tp", TW))
        out[dtype] = dict(A=A, F=F, perm=perm, info=int(info))
    return out


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_tp_complex_factor_matches_jax_scipy_and_lu(pools, complex_cases, dtype, D):
    case = complex_cases[dtype]
    A = case["A"]
    port = pools[D].run("tp_factor", A=A, w=TW)
    gate = 20 * N * EPS[dtype] * np.abs(A).max()
    assert port["dtype"] == str(torch.complex64 if dtype == np.complex64 else torch.complex128)
    assert port["info"] == case["info"] == 0
    assert lu_residual(A, port["F"], port["perm"]) < gate
    assert lu_residual(A, case["F"], case["perm"]) < gate  # the reference, by its own pivots
    np.testing.assert_array_equal(port["ipiv"], scipy.linalg.lu_factor(A)[1])
    single = rt.lu(A, device="cpu")
    np.testing.assert_array_equal(port["ipiv"], to_np(single.ipiv))
    np.testing.assert_array_equal(port["perm"][:N], to_np(single.p))
    # one broadcast of a complex panel per panel, one all_reduce of the bytes
    kinds = [c[0] for c in port["calls"]]
    assert kinds == ["broadcast"] * (N // TW) + ["all_reduce"]
    assert {c[2] for c in port["calls"][:-1]} == {port["dtype"]}


@pytest.mark.parametrize("single_device", [False, True])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_tp_complex_solve_n_t_h(pools, complex_cases, dtype, single_device):
    """``tp_lu_solve`` with trans N, T and H (H conjugates the factors) on a
    ``tp_lu`` and on a single-device ``lu``: the single-device solve's
    solution, and the residual the JAX package's tp solve reaches."""
    A = complex_cases[dtype]["A"]
    rng = np.random.default_rng(33)
    b = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(dtype)
    B = (rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))).astype(dtype)
    rhs = [(b, "N"), (b, "T"), (b, "H"), (B, "N")]
    port = pools[2].run("tp_solve", A=A, w=TW, rhs=rhs, single_device=single_device)
    F = rt.lu(A, device="cpu")
    Fj = rf.tp_lu(jnp.asarray(A), mesh_1d("tp", 2), "tp", panel_width=TW)
    for x, (r, t) in zip(port["x"], rhs):
        assert x.dtype == dtype and x.shape == r.shape
        want = to_np(rt.lu_solve(F, r, trans=t))
        np.testing.assert_allclose(x, want, rtol=0, atol=SOLVE_TOL[dtype] * np.abs(want).max())
        op = {"N": A, "T": A.T, "H": A.conj().T}[t]
        xj = np.asarray(rf.tp_lu_solve(Fj, jnp.asarray(r), mesh_1d("tp", 2), "tp", TW,
                                       trans=t))
        rj = np.abs(op @ xj - r).max()
        assert np.abs(op @ x - r).max() <= max(4 * rj, 50 * N * EPS[dtype] * np.abs(r).max())


HALF = {"bfloat16": np.finfo(np.float32).eps * 2 ** 16, "float16": np.finfo(np.float16).eps}


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_tp_half_factor_matches_jax_on_the_float32_promotion(pools, half, D):
    A = torch.tensor(np.random.default_rng(34).standard_normal((N, N))).to(getattr(torch, half))
    A32 = A.float().numpy()  # exact: the promotion both sides factor
    F, ipiv, perm, info = (np.asarray(x) for x in tp_lu_factor_p(
        jnp.asarray(A32), mesh_1d("tp", 4), "tp", TW))
    port = pools[D].run("tp_factor", A=A32, w=TW, dtype=half)
    assert port["dtype"] == f"torch.{half}"
    np.testing.assert_array_equal(port["ipiv"], ipiv)
    np.testing.assert_array_equal(port["perm"], perm)
    assert port["info"] == int(info) == 0
    err = np.abs(port["F"] - F)
    assert (err <= HALF[half] * np.abs(F) + 1e-5 * np.abs(F).max()).all(), err.max()


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_tp_half_solve_runs_in_float32_and_rounds_back(pools, half):
    """A half ``tp_lu`` solves as the single-device half solve does: the
    right-hand side rounded to the half type, the substitutions in
    float32, the solution rounded back."""
    A = torch.tensor(np.random.default_rng(35).standard_normal((N, N)) + N * np.eye(N))
    A = A.to(getattr(torch, half))
    b = np.random.default_rng(36).standard_normal(N)
    port = pools[2].run("tp_solve", A=A.float().numpy(), w=TW, rhs=[(b, "N"), (b, "T")],
                        dtype=half)
    assert port["x_dtype"] == [f"torch.{half}"] * 2
    F = rt.LU.from_numpy(port["F"], port["ipiv"], port["info"], perm=port["perm"],
                         device="cpu")
    F = rt.LU(F.factors.to(A.dtype), F.ipiv, F.info, perm=F.perm)
    for x, t in zip(port["x"], ("N", "T")):
        want = rt.lu_solve(F, torch.tensor(b), trans=t).float().numpy()
        np.testing.assert_allclose(x, want, rtol=2 * HALF[half], atol=2 * HALF[half])
