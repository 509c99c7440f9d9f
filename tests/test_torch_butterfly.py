"""The port's Random Butterfly Transform module (models/butterfly.py) against
the JAX package's: every function on the same numpy inputs and the
JAX-generated butterfly values, the implicit applies against the dense
U and V, padding, the Wilkinson accuracy gate, refinement, the handover
of a workspace, and the port's own seeded generator.  Then the port's own
factor / solve split against ``butterfly_solve``, the transform's counters
and the RBT spans."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.models import butterfly as jbf
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.models import butterfly as tbf
from recursivefactorization_jl_tpu_torch.ops.butterfly import ButterflyCounts, butterfly_mul_cuda
from recursivefactorization_jl_tpu_torch.ops.panel import panel_factor_cuda, reset_counts
from recursivefactorization_jl_tpu_torch.utils import profiling
from test_torch_common import jx, tc, to_np

torch.set_num_threads(1)

RNG = np.random.default_rng(71)
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def wilkinson(n):
    """The worst-growth matrix of the reference's RBT gate."""
    A = np.zeros((n, n))
    np.fill_diagonal(A, 1.0)
    A[:, -1] = 1.0
    A[np.tril_indices(n, -1)] = -1.0
    return A


def _close(port, ref, dtype):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(port), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * float(np.max(np.abs(ref))))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_every_function_matches_jax(dtype):
    """butterfly_level, butterfly_mul, materialize_uv, apply_ut, apply_v
    (vector and matrix right-hand sides) and pad_to_multiple_of_4 on the
    JAX-generated values."""
    n = 32
    uvj = jbf.generate_butterfly_values(n, dtype=dtype)
    uv = tc(np.asarray(uvj), dtype)
    A = RNG.standard_normal((n, n)).astype(dtype)
    b = RNG.standard_normal(n).astype(dtype)
    B = RNG.standard_normal((n, 3)).astype(dtype)
    _close(tbf.butterfly_level(tc(A, dtype), uv[:n], uv[n : 2 * n]),
           jbf.butterfly_level(jx(A, dtype), uvj[:n], uvj[n : 2 * n]), dtype)
    R = RNG.standard_normal((12, 20)).astype(dtype)  # a rectangular quadrant
    _close(tbf.butterfly_level(tc(R, dtype), uv[:12], uv[12:32]),
           jbf.butterfly_level(jx(R, dtype), uvj[:12], uvj[12:32]), dtype)
    _close(tbf.butterfly_mul(tc(A, dtype), uv), jbf.butterfly_mul(jx(A, dtype), uvj), dtype)
    for port, ref in zip(tbf.materialize_uv(uv, n), jbf.materialize_uv(uvj, n)):
        _close(port, ref, dtype)
    for rhs in (b, B):
        _close(tbf.apply_ut(uv, tc(rhs, dtype)), jbf.apply_ut(uvj, jx(rhs, dtype)), dtype)
        _close(tbf.apply_v(uv, tc(rhs, dtype)), jbf.apply_v(uvj, jx(rhs, dtype)), dtype)
    P = RNG.standard_normal((5, 5)).astype(dtype)
    np.testing.assert_array_equal(to_np(tbf.pad_to_multiple_of_4(tc(P, dtype))),
                                  np.asarray(jbf.pad_to_multiple_of_4(jx(P, dtype))))
    assert tbf.pad_to_multiple_of_4(tc(A, dtype)).shape == (n, n)
    with pytest.raises(ValueError):
        tbf.butterfly_mul(tc(P, dtype), uv)


def test_implicit_applies_match_the_dense_factors():
    n = 24
    uv = tc(RNG.random(4 * n) + 0.5, np.float64)
    A = tc(RNG.random((n, n)), np.float64)
    U, V = tbf.materialize_uv(uv, n)
    np.testing.assert_allclose(to_np(tbf.butterfly_mul(A, uv)), to_np(U.T @ A @ V), atol=1e-12)
    for rhs in (RNG.random(n), RNG.random((n, 2))):
        r = tc(rhs, np.float64)
        np.testing.assert_allclose(to_np(tbf.apply_ut(uv, r)), to_np(U.T @ r), atol=1e-12)
        np.testing.assert_allclose(to_np(tbf.apply_v(uv, r)), to_np(V @ r), atol=1e-12)
    ws = rt.butterfly_workspace(to_np(A), RNG.random(n), uv=to_np(uv), device="cpu")
    Uw, Vw = ws.UV()
    assert torch.equal(Uw, U) and torch.equal(Vw, V)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,k", [(48, None), (53, None), (48, 3), (53, 2), (50, 1)])
def test_solve_matches_jax_with_its_values(dtype, n, k):
    """The whole pipeline, padded sizes and vector / matrix right-hand
    sides included, fed the JAX values: the same solution, and the
    residual of a well-conditioned system at the type's level."""
    A = (RNG.random((n, n)) + n * np.eye(n)).astype(dtype)
    b = RNG.random(n if k is None else (n, k)).astype(dtype)
    jws = rf.butterfly_workspace(jx(A, dtype), jx(b, dtype))
    xj = np.asarray(rf.butterfly_solve(jws))
    ws = rt.butterfly_workspace(A, b, uv=np.asarray(jws.uv), device="cpu")
    assert ws.n == n and ws.A.shape[0] % 4 == 0 and ws.A.shape == tuple(jws.A.shape)
    np.testing.assert_array_equal(to_np(ws.A), np.asarray(jws.A))
    np.testing.assert_array_equal(to_np(ws.b), np.asarray(jws.b))
    x, info = rt.butterfly_solve(ws, return_info=True)
    assert int(info) == 0 and tuple(x.shape) == b.shape and x.device.type == "cpu"
    _close(x, xj, dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(A.astype(np.float64) @ to_np(x), b, atol=tol)
    # the handover of the JAX workspace as numpy arrays
    ws2 = rt.butterfly_from_numpy(np.asarray(jws.A), np.asarray(jws.b),
                                  np.asarray(jws.uv), jws.n, device="cpu")
    assert torch.equal(rt.butterfly_solve(ws2), x)


@pytest.mark.parametrize("n", [793, 808])
def test_wilkinson_gate(n):
    """The reference's accuracy gate (n in 790..810, ||A x - b|| <= 1e-10
    without pivoting) at a padded and an unpadded size of that range,
    with the JAX values and with the port's own."""
    A = wilkinson(n)
    b = np.random.RandomState(7).rand(n)
    uv = np.asarray(jbf.generate_butterfly_values(n + (-n) % 4))
    for kw in ({"uv": uv}, {}):
        ws = rt.butterfly_workspace(A, b, device="cpu", **kw)
        x = to_np(rt.butterfly_solve(ws))
        assert x.shape == (n,)
        err = np.linalg.norm(A @ x - b)
        assert err <= 1e-10, (n, sorted(kw), err)


def test_refine_contracts_the_residual():
    """A Gaussian matrix without diagonal help: growth without pivoting
    costs digits, and each refinement step wins some back."""
    n = 130
    rng = np.random.RandomState(0)
    A = rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    uv = np.asarray(jbf.generate_butterfly_values(n + (-n) % 4))
    ws = rt.butterfly_workspace(A, b, uv=uv, device="cpu")
    r = [float(np.max(np.abs(A @ to_np(rt.butterfly_solve(ws, refine=k)) - b)))
         for k in (0, 1)]
    r_piv = float(np.max(np.abs(A @ to_np(rt.lu_solve(rt.lu(A, device="cpu"), b)) - b)))
    assert r[1] < r[0] / 100 and r[1] < 100 * r_piv, (r, r_piv)
    jws = rf.butterfly_workspace(jnp.asarray(A), jnp.asarray(b))
    xj = np.asarray(rf.butterfly_solve(jws, refine=1))
    np.testing.assert_allclose(to_np(rt.butterfly_solve(ws, refine=1)), xj,
                               atol=1e-9 * np.max(np.abs(xj)))
    wf = rt.butterfly_workspace(A.astype(np.float32), b.astype(np.float32),
                                uv=uv, device="cpu")
    f = [float(np.max(np.abs(A @ to_np(rt.butterfly_solve(wf, refine=k)).astype(np.float64) - b)))
         for k in (0, 4)]
    assert f[1] < f[0] / 10, f


def test_own_generator_values():
    """exp(U(-0.05, 0.1)) / 2 from an explicit CPU generator: in range,
    the same on repeated calls with one seed, other values from another
    seed, the same values in both types and from the workspace."""
    if not torch.cuda.is_available():  # the device rule of every entry point
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbf.generate_butterfly_values(16)
    uv = tbf.generate_butterfly_values(16, device="cpu")
    assert uv.shape == (64,) and uv.dtype == torch.float64 and uv.device.type == "cpu"
    lo, hi = np.exp(-0.05) / 2, np.exp(0.1) / 2
    assert float(uv.min()) >= lo and float(uv.max()) < hi
    big = tbf.generate_butterfly_values(5000, device="cpu")
    assert float(big.min()) >= lo and float(big.max()) < hi
    assert float(big.min()) < lo + 1e-3 and float(big.max()) > hi - 1e-3
    assert torch.equal(uv, tbf.generate_butterfly_values(16, device="cpu"))
    assert torch.equal(uv, tbf.generate_butterfly_values(16, seed=tbf.DEFAULT_SEED, device="cpu"))
    assert tbf.DEFAULT_SEED == 888
    assert not torch.equal(uv, tbf.generate_butterfly_values(16, seed=1, device="cpu"))
    assert torch.equal(tbf.generate_butterfly_values(16, dtype=torch.float32, device="cpu"), uv.float())
    ws = rt.butterfly_workspace(np.eye(14), np.ones(14), device="cpu")
    assert torch.equal(ws.uv, uv) and ws.n == 14 and ws.A.shape == (16, 16)
    ws7 = rt.butterfly_workspace(np.eye(14), np.ones(14), seed=7, device="cpu")
    assert not torch.equal(ws7.uv, uv)


def test_workspace_checks_and_device_rule(monkeypatch):
    with pytest.raises(ValueError):
        rt.butterfly_workspace(np.ones((3, 4)), np.ones(3), device="cpu")
    with pytest.raises(ValueError):
        rt.butterfly_workspace(np.eye(4), np.ones(5), device="cpu")
    with pytest.raises(ValueError):
        rt.butterfly_workspace(np.eye(4), np.ones(4), uv=np.ones(12), device="cpu")
    with pytest.raises(ValueError):
        rt.butterfly_from_numpy(np.eye(6), np.ones(6), np.ones(24), 6, device="cpu")
    with pytest.raises(ValueError):
        rt.butterfly_from_numpy(np.eye(8), np.ones(8), np.ones(32), 3, device="cpu")
    # a zero pivot of the transformed matrix is reported, not raised
    ws = rt.butterfly_workspace(np.zeros((4, 4)), np.ones(4), device="cpu")
    _, info = rt.butterfly_solve(ws, return_info=True)
    assert int(info) == -1
    # the pivot-free LU inside is lu_factor(pivot=False): on the CPU it
    # launches no kernel
    before = panel_factor_cuda.counts.launches
    rt.butterfly_solve(rt.butterfly_workspace(np.eye(8) * 2, np.ones(8), device="cpu"))
    assert panel_factor_cuda.counts.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.butterfly_workspace(np.eye(4), np.ones(4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.butterfly_from_numpy(np.eye(4), np.ones(4), np.ones(16), 4)


# ---- the factor / solve split, its counters and spans --------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("n", [96, 130, 128])
def test_factor_then_solve_equals_butterfly_solve_bitwise(n, refine, dtype):
    """``butterfly_factor`` + ``butterfly_factor_solve`` of ``ws.b`` (and of
    the unpadded b) give ``butterfly_solve``'s solution and info bit for bit;
    the factorization is the pivot-free LU of ``butterfly_mul(A, uv)``,
    with the identity for ``ipiv``."""
    rng = np.random.default_rng(2500 + n)
    A = (rng.random((n, n)) - 0.5).astype(dtype)
    b = (rng.random(n) - 0.5).astype(dtype)
    ws = rt.butterfly_workspace(A, b, device="cpu")
    x, info = rt.butterfly_solve(ws, refine=refine, return_info=True)
    F = rt.butterfly_factor(ws)
    assert isinstance(F, rt.BFactor) and F.n == n and F.A is ws.A and F.uv is ws.uv
    np_ = n + (-n) % 4
    assert F.factors.shape == (np_, np_)
    assert torch.equal(F.ipiv, torch.arange(np_, dtype=F.ipiv.dtype))
    want, _, _ = rt.lu_factor(tbf.butterfly_mul(ws.A, ws.uv), pivot=False, device="cpu")
    assert torch.equal(F.factors, want)
    x2, info2 = rt.butterfly_factor_solve(F, ws.b, refine=refine, return_info=True)
    assert torch.equal(x2, x) and torch.equal(info2, info) and x2.shape == (n,)
    assert torch.equal(rt.butterfly_factor_solve(F, b, refine=refine), x)


def test_one_factorization_solves_three_right_hand_sides():
    """A kept factorization solves a vector, a matrix of two columns and
    another vector (given unpadded), each bit for bit a fresh
    ``butterfly_solve`` of its own workspace; wrong row counts raise."""
    n = 70
    rng = np.random.default_rng(25)
    A = rng.random((n, n)) - 0.5
    F = rt.butterfly_factor(rt.butterfly_workspace(A, np.zeros(n), device="cpu"))
    for rhs in (rng.random(n), rng.random((n, 2)), rng.random(n)):
        x = rt.butterfly_factor_solve(F, rhs, refine=1)
        fresh = rt.butterfly_solve(rt.butterfly_workspace(A, rhs, device="cpu"), refine=1)
        assert x.shape == rhs.shape and torch.equal(x, fresh)
    with pytest.raises(ValueError, match="rows"):
        rt.butterfly_factor_solve(F, np.ones(n + 1))


def test_transform_counters_zero_and_count():
    """``butterfly_mul_cuda.counts``: the CPU transforms count as tensor
    transforms (one per factor or solve), no launch; ``reset_counts`` of the
    panel layer zeroes them with the panel wrappers'."""
    reset_counts()
    counts = butterfly_mul_cuda.counts
    assert counts == ButterflyCounts() and counts.launches == {}
    ws = rt.butterfly_workspace(np.eye(12) * 3, np.ones(12), device="cpu")
    F = rt.butterfly_factor(ws)
    rt.butterfly_factor_solve(F, ws.b, refine=2)
    assert butterfly_mul_cuda.counts.tensor_transforms == 1
    rt.butterfly_solve(ws)
    tbf.butterfly_mul(ws.A, ws.uv)
    assert butterfly_mul_cuda.counts.tensor_transforms == 3
    assert butterfly_mul_cuda.counts.launches == {}
    reset_counts()
    assert butterfly_mul_cuda.counts == ButterflyCounts()
    with pytest.raises(ValueError, match="CUDA float32/float64"):
        butterfly_mul_cuda(ws.A, ws.uv)


def test_one_reset_zeroes_the_transform_and_the_panel_counts():
    """The counts registry (``ops._counts``) is shared: the panel layer's
    ``reset_counts`` is its, and zeroes both kinds, each to its own."""
    from recursivefactorization_jl_tpu_torch.ops import _counts
    from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod

    assert panel_mod.reset_counts is _counts.reset_counts
    butterfly_mul_cuda.counts.tensor_transforms = 3
    butterfly_mul_cuda.counts.launches[("float32", 4096)] = 2
    panel_factor_cuda.counts.launches = 5
    _counts.reset_counts()
    assert butterfly_mul_cuda.counts == ButterflyCounts()
    assert panel_factor_cuda.counts == panel_mod.LaunchCounts()


def test_the_rbt_spans_lie_inside_their_programs():
    """``rbt.transform`` and ``rbt.factor`` inside ``butterfly_factor``,
    ``rbt.apply`` and one ``rbt.refine`` a step inside
    ``butterfly_factor_solve``; ``butterfly_solve`` holds all four."""
    ws = rt.butterfly_workspace(np.eye(16) * 2, np.ones(16), device="cpu")
    with profiling.recording() as rec:
        F = rt.butterfly_factor(ws)
        rt.butterfly_factor_solve(F, ws.b, refine=2)
        rt.butterfly_solve(ws, refine=1)
    spans = rec.collect()
    roots = {s.name: s for s in spans if s.parent is None}
    assert set(roots) == {"butterfly_factor", "butterfly_factor_solve", "butterfly_solve"}

    def children(root):
        return [s.name for s in spans if s.parent == roots[root].id]

    assert children("butterfly_factor") == ["rbt.transform", "rbt.factor"]
    assert children("butterfly_factor_solve") == ["rbt.apply", "rbt.refine", "rbt.refine"]
    assert children("butterfly_solve") == ["rbt.transform", "rbt.factor", "rbt.apply",
                                           "rbt.refine"]
    (factor,) = [s for s in spans if s.name == "rbt.factor" and s.call == roots[
        "butterfly_factor"].id]
    assert [s.name for s in spans if s.parent == factor.id] == ["lu_factor_donated"]
