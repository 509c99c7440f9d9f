"""The port's public API (models/lu.py, models/solve.py) against the JAX
package: factor + solve through both packages on the same seeded inputs,
the cross-package handover, and the port's device and error rules."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg
import torch

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.models.lu import _dispatch_factor as jax_dispatch
from recursivefactorization_jl_tpu.models.solve import _lu_solve_impl as jax_solve_impl
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.models.lu import _dispatch_factor
from recursivefactorization_jl_tpu_torch.models.solve import _lu_solve_impl
from test_torch_common import (
    assert_pivots_equal,
    jx,
    lu_residual,
    residual_gate,
    tc,
    to_np,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(route):
    """The same routing on both sides: whole-matrix (one panel call) or
    blocked with 32-wide panels; the JAX side forces its Pallas kernel
    (interpret mode on the CPU)."""
    kw = dict(small_threshold=128) if route == "whole" else dict(
        small_threshold=32, panel_width=32)
    port = rt.LUConfig(**kw)
    ref = rf.LUConfig(backend="pallas", tail_threshold=None,
                      schur_precision="float32", **kw)
    return port, ref


@pytest.mark.parametrize("route", ["whole", "blocked"])
def test_entry_step_matches_jax(route):
    """The main path of the entry point at a small size: factor
    (``_dispatch_factor``) then solve (``_lu_solve_impl``) of randn + n*I
    in f32, through both packages."""
    n = 96
    A = (RNG.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = RNG.standard_normal(n).astype(np.float32)
    pc, jc = _cfgs(route)
    assert rt.dispatch_route((n, n), torch.float32, True, pc) == route
    port = _dispatch_factor(tc(A, np.float32), True, pc)
    ref = jax_dispatch(jx(A, np.float32), True, jc)
    assert_pivots_equal(port, ref)
    gate = residual_gate(A, np.float32, True)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    x = to_np(_lu_solve_impl(port[0], port[2], tc(b, np.float32), True, 0))
    xj = np.asarray(jax_solve_impl(ref[0], ref[2], jx(b, np.float32),
                                   pivoted=True, trans=False))
    xs = np.linalg.solve(A.astype(np.float64), b)
    # kappa(A) ~ 1 here: both solutions within a few hundred f32 ulps
    np.testing.assert_allclose(x, xs, atol=1e-5 * np.max(np.abs(xs)))
    np.testing.assert_allclose(x, xj, atol=1e-5 * np.max(np.abs(xs)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pivot", [True, False])
def test_lu_and_trans_solves(dtype, pivot):
    """lu + lu_solve with trans N/T/H on the blocked route (n=80, three
    panels), residual-gated and against numpy."""
    n = 80
    A = RNG.standard_normal((n, n))
    if not pivot:
        A = A + n * np.eye(n)
    A = A.astype(dtype)
    pc, _ = _cfgs("blocked")
    F = rt.lu(A, pivot, config=pc, device="cpu")
    assert F.pivoted is pivot and F.factors.device.type == "cpu"
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, dtype, pivot)
    np.testing.assert_array_equal(to_np(F.p), to_np(rt.ipiv_to_perm(F.ipiv, n)))
    B = RNG.standard_normal((n, 2)).astype(dtype)
    cond = np.linalg.cond(A.astype(np.float64))
    tol = 50 * n * np.finfo(dtype).eps * cond
    for trans, M in (("N", A), ("T", A.T), ("H", A.T), (1, A.T), (False, A)):
        x = to_np(rt.lu_solve(F, B, trans=trans))
        xs = np.linalg.solve(M.astype(np.float64), B)
        np.testing.assert_allclose(x, xs, atol=tol * np.max(np.abs(xs)),
                                   err_msg=str(trans))
    v = to_np(F.solve(B[:, 0]))
    np.testing.assert_allclose(v, to_np(rt.ldiv(F, B))[:, 0],
                               atol=tol * np.max(np.abs(v)))


def test_trans_solve_matches_jax():
    """f32 through the JAX whole-matrix Pallas route (its kernels take
    f32 only), trans N and T."""
    n = 64
    A = (RNG.standard_normal((n, n)) + 8 * np.eye(n)).astype(np.float32)
    b = RNG.standard_normal(n).astype(np.float32)
    pc, jc = _cfgs("whole")
    F = rt.lu(A, config=pc, device="cpu")
    G = rf.lu(jx(A, np.float32), config=jc)
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info),
                        (G.factors, G.ipiv, G.p, G.info))
    for trans in ("N", "T"):
        x = to_np(rt.lu_solve(F, b, trans=trans))
        xj = np.asarray(rf.lu_solve(G, jx(b, np.float32), trans=trans))
        np.testing.assert_allclose(x, xj, atol=1e-4 * np.max(np.abs(xj)))


def test_factor_in_jax_solve_in_port():
    """Configuration and factorization cross from the JAX package to the
    port as plain data: ``config_from_mapping`` and ``LU.from_numpy``."""
    jcfg = rf.LUConfig(panel_width=64, small_threshold=32, tail_threshold=None)
    pcfg = rt.config_from_mapping(dataclasses.asdict(jcfg))
    assert pcfg.panel_width == 64 and pcfg.small_threshold == 32
    assert {f.name for f in dataclasses.fields(pcfg)} == set(dataclasses.asdict(jcfg))
    with pytest.raises(ValueError):
        rt.config_from_mapping({"panel_width": 64, "not_a_field": 1})
    n = 72
    A = RNG.standard_normal((n, n)).astype(np.float64)
    b = RNG.standard_normal((n, 3))
    G = rf.lu(jx(A, np.float64))  # the JAX package's f64 route on the CPU
    F = rt.LU.from_numpy(np.asarray(G.factors), np.asarray(G.ipiv),
                         np.asarray(G.info), perm=np.asarray(G.p),
                         pivoted=True, device="cpu")
    x = to_np(rt.lu_solve(F, b))
    np.testing.assert_allclose(x, np.asarray(rf.lu_solve(G, jx(b, np.float64))),
                               atol=1e-10)
    np.testing.assert_allclose(A @ x, b, atol=1e-9)
    # and back: the port's factorization solved by the JAX package
    P = rt.lu(A, config=pcfg, device="cpu")
    J = rf.LU(jx(to_np(P.factors), np.float64), jx(to_np(P.ipiv), np.int32),
              jx(to_np(P.info), np.int32), pivoted=True,
              perm=jx(to_np(P.p), np.int32))
    np.testing.assert_allclose(np.asarray(rf.lu_solve(J, jx(b, np.float64))),
                               x, atol=1e-10)


def test_port_imports_without_jax():
    """The port loads with jax blocked and pulls in no module of the JAX
    package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import recursivefactorization_jl_tpu_torch as rt\n"
        "import recursivefactorization_jl_tpu_torch.ops._kernels\n"
        "import numpy as np\n"
        "F = rt.lu(np.eye(4) * 2.0, device='cpu')\n"
        "assert float(F.det()) == 16.0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == "
        "'recursivefactorization_jl_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_device_rule(monkeypatch):
    """device=None means CUDA and raises without it; the CPU runs only
    when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.eye(3)
    for call in (lambda: rt.lu(A), lambda: rt.lu_factor(A),
                 lambda: rt.lu_factor_p(A), lambda: rt.solve(A, np.ones(3)),
                 lambda: rt.LU.from_numpy(A, [0, 1, 2], 0),
                 lambda: rt.lu_inplace(torch.eye(3))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    f, ipiv, info = rt.lu_factor(A, device="cpu")
    assert f.device.type == "cpu" and int(info) == 0


def test_lu_object_accessors():
    n = 48
    A = RNG.standard_normal((n, n))
    F = rt.lu(A, device="cpu")
    L, U, P = to_np(F.L), to_np(F.U), to_np(F.P)
    np.testing.assert_allclose(P @ A, L @ U, atol=1e-12)
    assert np.allclose(np.tril(L, -1) + np.triu(U), to_np(F.factors))
    np.testing.assert_allclose(float(F.det()), np.linalg.det(A), rtol=1e-10)
    logabs, sign = F.logabsdet()
    s, la = np.linalg.slogdet(A)
    assert float(sign) == s and abs(float(logabs) - la) < 1e-10
    np.testing.assert_allclose(to_np(F.inv()), np.linalg.inv(A), atol=1e-10)
    assert F.shape == (n, n)
    # rectangular factors: L is (m, k), U is (k, n)
    R = rt.lu(RNG.standard_normal((30, 20)), device="cpu")
    assert tuple(R.L.shape) == (30, 20) and tuple(R.U.shape) == (20, 20)
    with pytest.raises(ValueError):
        R.det()


def test_lu_inplace_overwrites_a():
    n = 64
    A0 = RNG.standard_normal((n, n))
    A = torch.tensor(A0)
    F = rt.lu_inplace(A, device="cpu", config=rt.LUConfig(panel_width=16, small_threshold=16))
    assert F.factors is A
    G = rt.lu(A0, device="cpu")
    np.testing.assert_array_equal(to_np(F.ipiv), to_np(G.ipiv))
    assert lu_residual(A0, A, F.p) < residual_gate(A0, np.float64, True)
    with pytest.raises(ValueError):
        rt.lu_inplace(torch.tensor(A0).T, device="cpu")
    with pytest.raises(TypeError):
        rt.lu_inplace(A0, device="cpu")


@pytest.mark.parametrize("route", ["whole", "blocked"])
def test_fused_solve(route):
    """solve() factors [A | b] as one fat LU: same answer as lu + lu_solve
    and as the JAX package's fused solve."""
    n = 64
    A = RNG.standard_normal((n, n)).astype(np.float64)
    b = RNG.standard_normal(n)
    B = RNG.standard_normal((n, 3))
    pc, jc = _cfgs(route)
    x = to_np(rt.solve(A, b, config=pc, device="cpu"))
    X = to_np(rt.solve(A, B, config=pc, device="cpu"))
    np.testing.assert_allclose(A @ x, b, atol=1e-10)
    np.testing.assert_allclose(A @ X, B, atol=1e-10)
    np.testing.assert_allclose(
        x, to_np(rt.lu_solve(rt.lu(A, config=pc, device="cpu"), b)), atol=1e-10)
    xt = to_np(rt.solve(A, b, trans="T", config=pc, device="cpu"))
    np.testing.assert_allclose(A.T @ xt, b, atol=1e-10)
    if route == "whole":
        # the JAX package's fused solve, f32 through its Pallas kernel
        A32, b32 = (A + 8 * np.eye(n)).astype(np.float32), b.astype(np.float32)
        x32 = to_np(rt.solve(A32, b32, config=pc, device="cpu"))
        xj = np.asarray(rf.solve(jx(A32, np.float32), jx(b32, np.float32), config=jc))
        np.testing.assert_allclose(x32, xj, atol=1e-4 * np.max(np.abs(xj)))


def test_singular_matrix_info_and_check():
    n = 40
    A = RNG.standard_normal((n, n))
    A[:, 9] = 0
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(A, device="cpu")
    with pytest.raises(rt.SingularMatrixError):
        rt.solve(A, np.ones(n), device="cpu")
    F = rt.lu(A, check=False, device="cpu")
    assert int(F.info) == 10
    G = rf.lu(jx(A, np.float64), check=False)
    assert int(G.info) == 10
    B = A + n * np.eye(n)
    B[:, 9] = 0
    F = rt.lu(B, pivot="none", check=False, device="cpu")
    assert int(F.info) == -10
    with pytest.raises(ValueError):
        rt.lu(A, check="sometimes", device="cpu")


def test_refined_solve_recovers_bf16_schur():
    n = 96
    A = (RNG.standard_normal((n, n)) + 4 * np.eye(n)).astype(np.float32)
    b = RNG.standard_normal(n).astype(np.float32)
    cfg = rt.LUConfig(panel_width=32, small_threshold=32, schur_precision="bf16")
    with pytest.warns(UserWarning, match="bf16"):
        F = rt.lu(A, config=cfg, device="cpu")
    xs = np.linalg.solve(A.astype(np.float64), b)
    e0 = np.max(np.abs(to_np(rt.lu_solve(F, b)) - xs))
    e2 = np.max(np.abs(to_np(rt.lu_solve_refined(F, A, b, iters=2)) - xs))
    assert e2 < e0 / 10
    x3 = to_np(rt.lu_solve_refined(F, A, np.stack([b, b], 1), iters=3, trans="T"))
    np.testing.assert_allclose(x3[:, 0], np.linalg.solve(A.T.astype(np.float64), b),
                               atol=1e-4 * np.max(np.abs(xs)))


def test_schur_bf16x3_blocked_route():
    n = 96
    A = RNG.standard_normal((n, n)).astype(np.float32)
    cfg = rt.LUConfig(panel_width=32, small_threshold=32, schur_precision="bf16x3")
    F = rt.lu(A, config=cfg, device="cpu")
    np.testing.assert_array_equal(to_np(F.ipiv), scipy.linalg.lu_factor(A)[1])
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, np.float32, True)


def test_xla_threshold_delegates_to_torch_lu():
    n = 50
    A = RNG.standard_normal((n, n))
    cfg = rt.LUConfig(xla_threshold=64)
    assert rt.dispatch_route((n, n), torch.float64, True, cfg) == "xla"
    assert rt.dispatch_route((n, n), torch.float64, False, cfg) == "whole"
    assert rt.dispatch_route((n, n), torch.float64, True, rt.LUConfig()) == "whole"
    F = rt.lu(A, config=cfg, device="cpu")
    np.testing.assert_array_equal(to_np(F.ipiv), scipy.linalg.lu_factor(A)[1])
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, np.float64, True)
    A[:, 3] = 0
    F = rt.lu(A, config=cfg, check=False, device="cpu")
    assert int(F.info) == 4


# ids name the JAX package's route of each dtype
@pytest.mark.parametrize("dtype,route", [
    pytest.param(torch.float16, "promote", id="dtype0-promote"),
    pytest.param(torch.bfloat16, "promote", id="dtype1-promote"),
    pytest.param(torch.complex64, "whole", id="dtype2-complex-unblocked"),
    pytest.param(torch.int32, "generic", id="dtype3-generic"),
])
def test_deferred_routes_raise(dtype, route):
    """The generic route still raises; half matrices take the promote
    route and complex ones the routes of real matrices, and factor."""
    assert rt.dispatch_route((8, 8), dtype) == route
    A = torch.ones(8, 8, dtype=dtype) + 8 * torch.eye(8, dtype=dtype)
    if route == "generic":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.lu(A, device="cpu")
        return
    cfg = rt.LUConfig(small_threshold=4, panel_width=4)
    if dtype.is_complex:
        assert rt.dispatch_route((8, 8), dtype, True, cfg) == "blocked"
        assert rt.dispatch_route((8, 8), dtype, True, rt.LUConfig(xla_threshold=8)) == "xla"
    else:
        assert rt.dispatch_route((8, 8), dtype, True, cfg) == "promote"
    for c in (None, cfg):
        F = rt.lu(A, config=c, device="cpu")
        assert F.factors.dtype == dtype and int(F.info) == 0
        G = rt.lu(A.to(torch.complex128 if dtype.is_complex else torch.float32),
                  config=c, device="cpu")
        assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p)
        torch.testing.assert_close(F.factors, G.factors.to(dtype), rtol=1e-5, atol=1e-5)


def test_unported_knobs_raise():
    """``panel_boundary_precision='bf16x3'`` still raises; the physical
    schedule and the micro-blocked variants, which used to, factor."""
    A = np.eye(8)
    with pytest.raises(NotImplementedError):
        rt.lu(A, config=rt.LUConfig(panel_boundary_precision="bf16x3"), device="cpu")
    with pytest.raises(ValueError):
        rt.lu(np.ones(3), device="cpu")
    M = RNG.standard_normal((8, 8))
    ref = rt.lu(M, device="cpu")
    for cfg in (rt.LUConfig(schedule="physical"), rt.LUConfig(panel_variant="basic"),
                rt.LUConfig(panel_variant="shadow", panel_micro=4)):
        F = rt.lu(M, config=cfg, device="cpu")
        assert int(F.info) == 0 and torch.equal(F.p, ref.p)
        assert lu_residual(M, F.factors, F.p) < residual_gate(M, np.float64, True)


def test_selectors_and_empty():
    assert rt.normalize_pivot("RowMaximum") and not rt.normalize_pivot("no_pivot")
    assert rt.normalize_pivot(None) is False
    with pytest.raises(ValueError):
        rt.normalize_pivot("sometimes")
    assert [rt.normalize_trans(t) for t in ("n", "T", "c", True, 2)] == [0, 1, 2, 1, 2]
    with pytest.raises(ValueError):
        rt.normalize_trans("X")
    f, ipiv, perm, info = rt.lu_factor_p(np.zeros((0, 3)), device="cpu")
    assert tuple(f.shape) == (0, 3) and ipiv.numel() == 0 and int(info) == 0
