"""The physical-order schedule of the port (``schedule='physical'``) against
the JAX package: the plain version ``unblocked_lu_noswap`` against the
no-swap Pallas kernel in interpret mode, ``blocked_lu_physical`` through
the public entry points against the JAX dispatch, and what the ``LU``
object does with a factorization whose ``ipiv`` is the pivot-row
sequence.  The Hopper kernel's own tests are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.models.lu import _dispatch_factor as jax_dispatch
from recursivefactorization_jl_tpu.ops.panel import panel_factor_noswap_pallas
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops.blocked import blocked_lu_physical
from recursivefactorization_jl_tpu_torch.ops.panel import (
    panel_factor_noswap,
    panel_factor_noswap_cuda,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    unblocked_lu,
    unblocked_lu_noswap,
)
from test_torch_common import (
    assert_pivots_equal,
    jx,
    lu_residual,
    residual_gate,
    tc,
    to_np,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(61)

# float32 factors against the micro-blocked Pallas kernel: its delayed
# updates are matmuls, the port's kernel is unblocked, so the sums differ in
# order (the JAX tests' own tolerance for its panel kernels)
ATOL32 = 2e-5


def _matrix(shape, pivot, dtype=np.float32):
    A = RNG.standard_normal(shape)
    if not pivot:
        A = A + max(shape) * np.eye(*shape)
    return A.astype(dtype)


def _used0(m, taken):
    u = np.zeros(m, dtype=np.int32)
    u[list(taken)] = 1
    return u


@pytest.mark.parametrize("shape,micro,taken,pivot", [
    ((24, 8), 4, (), True),
    ((24, 8), 4, (0, 1, 5, 6, 7, 8, 20, 23), True),
    ((24, 8), 8, (0, 1, 5, 6, 7, 8, 20, 23), False),
    ((33, 16), 8, (3, 30, 31, 32), True),
])
def test_noswap_plain_matches_pallas_kernel(shape, micro, taken, pivot, dtype=np.float32):
    """With an empty and a partly filled mask: prow, used and info
    exactly, the factors (rows left in place) to tolerance."""
    m, w = shape
    A = _matrix(shape, True, dtype)  # unpivoted: rows are taken in order
    used0 = _used0(m, taken)
    f, prow, used, info = unblocked_lu_noswap(tc(A, dtype), torch.tensor(used0), pivot)
    ref = panel_factor_noswap_pallas(
        jx(A, dtype), jx(used0[None, :], np.float32), pivot, interpret=True,
        micro=micro)
    np.testing.assert_array_equal(to_np(prow), np.asarray(ref[1]))
    np.testing.assert_array_equal(to_np(used), np.asarray(ref[2])[0].astype(np.int32))
    assert int(info) == int(ref[3]) == 0
    np.testing.assert_allclose(to_np(f), np.asarray(ref[0]), atol=ATOL32)
    # rows consumed before are untouched, and none of them is chosen
    assert torch.equal(f[list(taken)], tc(A, dtype)[list(taken)])
    assert not set(to_np(prow).tolist()) & set(taken)
    if not pivot:
        free = [i for i in range(m) if i not in taken]
        assert to_np(prow).tolist() == free[:w]


@pytest.mark.parametrize("shape,taken,pivot", [
    ((24, 8), (2, 4, 6, 8, 10), True), ((40, 24), (0, 39), True),
    ((16, 16), (), False),
])
def test_noswap_plain_f64_matches_jax_unblocked_lu(shape, taken, pivot):
    """float64 (the Pallas kernel keeps float32 scratch, so it is no f64
    oracle): the rows left free, factored in physical order and gathered
    by the pivot rows, are the JAX package's ``unblocked_lu`` of those
    rows to 1e-12, with the same pivot rows and info."""
    from recursivefactorization_jl_tpu.ops.unblocked import unblocked_lu as jax_unblocked_lu

    m, w = shape
    A = _matrix(shape, True, np.float64)
    free = np.array([i for i in range(m) if i not in taken])
    f, prow, used, info = unblocked_lu_noswap(
        tc(A, np.float64), torch.tensor(_used0(m, taken)), pivot)
    ref = jax_unblocked_lu(jx(A[free], np.float64), pivot)
    perm = np.asarray(ref[2])
    np.testing.assert_array_equal(to_np(prow), free[perm[:w]])
    assert int(info) == int(ref[3]) == 0
    np.testing.assert_allclose(to_np(f)[free[perm]], np.asarray(ref[0]), atol=1e-12)
    assert int(used.sum()) == len(taken) + w


def test_noswap_plain_is_unblocked_lu_up_to_the_row_order():
    """From an empty mask the physical-order factors, gathered by perm,
    are ``unblocked_lu``'s: the same pivots (ties by the smaller physical
    row are ties by the smaller original row) and the same arithmetic."""
    A = tc(_matrix((40, 24), True, np.float64), np.float64)
    f, prow, used, info = unblocked_lu_noswap(A, torch.zeros(40, dtype=torch.int32), True)
    g, ipiv, perm, ginfo = unblocked_lu(A, True)
    assert torch.equal(prow, perm[:24]) and int(info) == int(ginfo) == 0
    assert int(used.sum()) == 24
    np.testing.assert_allclose(to_np(f[perm.long()]), to_np(g), atol=1e-13)


def test_noswap_zero_column_nan_and_exhausted_rows():
    """A zeroed column: no scale, the update still runs, the column still
    consumes its row (the first one available), info = +-(k+1), as in the
    Pallas kernel.  A NaN candidate wins and takes the first NaN row
    among the available ones: a deliberate difference from the Pallas
    kernel, which clamps to row m - 1 even when that row is already
    consumed (ROADMAP.md Queue 3).  With no row left, prow is -1."""
    A = _matrix((20, 8), True)
    A[:, 3] = 0
    used0 = _used0(20, (0, 19))
    for pivot in (True, False):
        f, prow, used, info = unblocked_lu_noswap(tc(A, np.float32), torch.tensor(used0), pivot)
        ref = panel_factor_noswap_pallas(
            jx(A, np.float32), jx(used0[None, :], np.float32), pivot,
            interpret=True, micro=4)
        assert int(info) == int(ref[3]) == (4 if pivot else -4)
        np.testing.assert_array_equal(to_np(prow), np.asarray(ref[1]))
        # unpivoted steps on randn and the unscaled column let entries
        # grow: the tolerance goes with the largest one
        scale = max(1.0, float(np.max(np.abs(np.asarray(ref[0])))))
        np.testing.assert_allclose(to_np(f), np.asarray(ref[0]), atol=ATOL32 * scale)
    N = _matrix((12, 4), True)
    N[:, 0] *= 0.01
    N[3, 0] = 10.0  # step 0 takes row 3, so the NaNs stay in rows 7 and 9
    N[7, 1] = np.nan
    N[9, 1] = np.nan
    used0 = _used0(12, (11,))
    _, prow, used, _ = unblocked_lu_noswap(tc(N, np.float32), torch.tensor(used0), True)
    assert int(prow[1]) == 7 and int(used[11]) == 1 and int(used.max()) == 1
    ref = panel_factor_noswap_pallas(
        jx(N, np.float32), jx(used0[None, :], np.float32), True, interpret=True,
        micro=4)
    assert int(ref[1][1]) == 11 and float(np.asarray(ref[2])[0, 11]) > 1.0
    # two rows free, four steps
    few = _used0(6, (0, 1, 2, 5))
    E = tc(_matrix((6, 4), True), np.float32)
    f, prow, used, info = unblocked_lu_noswap(E, torch.tensor(few), True)
    assert sorted(to_np(prow[:2]).tolist()) == [3, 4]
    assert to_np(prow[2:]).tolist() == [-1, -1] and int(used.sum()) == 6
    with pytest.raises(ValueError):
        unblocked_lu_noswap(E, torch.zeros(5, dtype=torch.int32), True)
    with pytest.raises(ValueError):
        unblocked_lu_noswap(E.to(torch.complex64), torch.tensor(few), True)


@pytest.mark.parametrize("shape,w", [((48, 48), 16), ((70, 50), 16), ((33, 33), 8)])
@pytest.mark.parametrize("pivot", [True, False])
def test_physical_factor_matches_jax_dispatch(shape, w, pivot):
    """``lu_factor_p`` under ``schedule='physical'`` against the JAX
    dispatch with the same configuration (its no-swap Pallas kernel in
    interpret mode): prow, the whole perm (the tail order of a tall
    matrix included) and info exactly, factors to tolerance."""
    A = _matrix(shape, pivot)
    pc = rt.LUConfig(schedule="physical", panel_width=w)
    jc = rf.LUConfig(schedule="physical", panel_width=w, schur_precision="float32")
    assert rt.dispatch_route(shape, torch.float32, pivot, pc) == "physical"
    port = rt.lu_factor_p(A, pivot, config=pc, device="cpu")
    ref = jax_dispatch(jx(A, np.float32), pivot, jc)
    assert_pivots_equal(port, ref)
    assert int(port[3]) == 0
    gate = residual_gate(A, np.float32, pivot)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    assert lu_residual(A, port[0], port[2]) < gate
    np.testing.assert_array_equal(to_np(port[1]), to_np(port[2])[: shape[1]])
    if shape[0] > shape[1]:
        tail = to_np(port[2])[shape[1]:]
        assert np.all(np.diff(tail) > 0)


def test_physical_zero_column_gives_the_jax_info():
    n = 40
    A = _matrix((n, n), True)
    A[:, 7] = 0
    pc = rt.LUConfig(schedule="physical", panel_width=16)
    jc = rf.LUConfig(schedule="physical", panel_width=16, schur_precision="float32")
    port = rt.lu_factor_p(A, True, config=pc, device="cpu")
    ref = jax_dispatch(jx(A, np.float32), True, jc)
    assert int(port[3]) == int(ref[3]) == 8
    np.testing.assert_array_equal(to_np(port[1]), np.asarray(ref[1]))
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(A, config=pc, device="cpu")
    B = _matrix((n, n), False)
    B[:, 20] = 0  # in the second panel: the offset is sign-aware
    assert int(rt.lu(B, pivot=False, check=False, config=pc, device="cpu").info) == -21


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_physical_pivots_equal_the_swap_schedule(dtype):
    """In exact arithmetic both schedules choose the same rows; at this
    size they do in floating point too, and for m > n only the order of
    the rows never chosen differs."""
    A = _matrix((70, 50), True, dtype)
    P = rt.lu(A, config=rt.LUConfig(schedule="physical", panel_width=16), device="cpu")
    S = rt.lu(A, config=rt.LUConfig(panel_width=16, small_threshold=16), device="cpu")
    assert torch.equal(P.ipiv, S.p[:50])
    assert sorted(to_np(P.p[50:]).tolist()) == sorted(to_np(S.p[50:]).tolist())
    gate = residual_gate(A, dtype, True)
    np.testing.assert_allclose(to_np(P.factors[:50]), to_np(S.factors[:50]), atol=gate)


def test_lu_object_on_a_physical_factorization():
    """``ipiv`` is prow here, so everything must go by ``perm``: solves
    (N, T, H), det, logabsdet and inv against numpy."""
    n = 60
    A = _matrix((n, n), True, np.float64)
    F = rt.lu(A, config=rt.LUConfig(schedule="physical", panel_width=16), device="cpu")
    assert torch.equal(F.ipiv, F.p) and F.pivoted
    assert not torch.equal(F.p, rt.ipiv_to_perm(F.ipiv, n))  # not a swap sequence
    np.testing.assert_allclose(to_np(F.P) @ A, to_np(F.L) @ to_np(F.U), atol=1e-12)
    B = RNG.standard_normal((n, 3))
    for trans, M in (("N", A), ("T", A.T), ("H", A.T)):
        np.testing.assert_allclose(M @ to_np(rt.lu_solve(F, B, trans=trans)), B, atol=1e-10)
    np.testing.assert_allclose(A @ to_np(F.solve(B[:, 0])), B[:, 0], atol=1e-10)
    np.testing.assert_allclose(float(F.det()), np.linalg.det(A), rtol=1e-9)
    s, la = np.linalg.slogdet(A)
    logabs, sign = F.logabsdet()
    assert float(sign) == s and abs(float(logabs) - la) < 1e-9
    np.testing.assert_allclose(to_np(F.inv()), np.linalg.inv(A), atol=1e-9)
    x = to_np(rt.lu_solve_refined(F, A, B[:, 0]))
    np.testing.assert_allclose(A @ x, B[:, 0], atol=1e-11)
    xs = to_np(rt.solve(A, B, config=rt.LUConfig(schedule="physical", panel_width=16),
                        device="cpu"))
    np.testing.assert_allclose(A @ xs, B, atol=1e-10)


def test_physical_fallthroughs_and_promote():
    """m < n and complex matrices take the swap schedule, as in the JAX
    package (fat) and as non-f32 types do on the TPU; half matrices are
    factored as their float32 copies by the physical schedule."""
    cfg = rt.LUConfig(schedule="physical", panel_width=16, small_threshold=16)
    swap = rt.LUConfig(panel_width=16, small_threshold=16)
    assert rt.dispatch_route((30, 50), torch.float32, True, cfg) == "blocked"
    assert rt.dispatch_route((40, 40), torch.complex64, True, cfg) == "blocked"
    assert rt.dispatch_route((40, 40), torch.bfloat16, True, cfg) == "promote"
    assert rt.dispatch_route((8, 8), torch.float64, True, cfg) == "physical"
    assert rt.dispatch_route((40, 40), torch.float32, True,
                             rt.LUConfig(schedule="physical", xla_threshold=64)) == "xla"
    with pytest.raises(ValueError, match="schedule"):
        rt.dispatch_route((8, 8), torch.float32, True, rt.LUConfig(schedule="logical"))
    fat = _matrix((30, 50), True)
    for a, b in zip(rt.lu_factor_p(fat, config=cfg, device="cpu"),
                    rt.lu_factor_p(fat, config=swap, device="cpu")):
        assert torch.equal(a, b)
    Z = (_matrix((40, 40), True) + 1j * _matrix((40, 40), True)).astype(np.complex64)
    for a, b in zip(rt.lu_factor_p(Z, config=cfg, device="cpu"),
                    rt.lu_factor_p(Z, config=swap, device="cpu")):
        assert torch.equal(a, b)
    H = torch.tensor(_matrix((40, 40), False)).to(torch.bfloat16)
    F = rt.lu(H, config=cfg, device="cpu")
    G = rt.lu(H.float(), config=cfg, device="cpu")
    assert F.factors.dtype == torch.bfloat16
    assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p)
    assert torch.equal(F.factors, G.factors.to(torch.bfloat16))
    with pytest.raises(ValueError):
        blocked_lu_physical(torch.zeros(3, 5), True, cfg)


def test_from_numpy_loads_a_jax_physical_factorization():
    """A factorization made by the JAX package under the physical
    schedule crosses as numpy arrays and solves in the port: with its
    perm, which for a square matrix is its ``ipiv`` (the pivot rows)."""
    m, n = 48, 48
    A = _matrix((m, n), True)
    b = RNG.standard_normal((n, 2)).astype(np.float32)
    jc = rf.LUConfig(schedule="physical", panel_width=16, schur_precision="float32")
    G = rf.lu(jx(A, np.float32), config=jc)
    xj = np.asarray(rf.lu_solve(G, jx(b, np.float32)))
    parts = (np.asarray(G.factors), np.asarray(G.ipiv), np.asarray(G.info))
    F = rt.from_numpy(*parts, perm=np.asarray(G.p), device="cpu")
    H = rt.from_numpy(*parts, perm=parts[1], device="cpu")
    assert torch.equal(F.p, H.p) and torch.equal(F.ipiv, F.p)
    for L in (F, H):
        np.testing.assert_allclose(to_np(rt.lu_solve(L, b)), xj,
                                   atol=1e-4 * np.max(np.abs(xj)))
    assert abs(float(F.det()) / float(np.linalg.det(A.astype(np.float64))) - 1) < 1e-3
    # tall: perm carries the rows ipiv does not name, and crosses whole
    T = rt.lu(_matrix((30, 20), True), config=rt.LUConfig(
        schedule="physical", panel_width=8), device="cpu")
    R = rt.LU.from_numpy(to_np(T.factors), to_np(T.ipiv), to_np(T.info),
                         perm=to_np(T.p), device="cpu")
    assert torch.equal(R.p, T.p) and torch.equal(R.ipiv, R.p[:20])
    assert torch.equal(R.L @ R.U, T.L @ T.U)


def test_noswap_panel_layer_routes_by_device():
    A = tc(_matrix((12, 4), True), np.float32)
    P = A.clone()
    prow, used, info = panel_factor_noswap(P, torch.zeros(12, dtype=torch.int32), True)
    f, prow_p, used_p, _ = unblocked_lu_noswap(A, torch.zeros(12, dtype=torch.int32), True)
    assert torch.equal(P, f) and torch.equal(prow, prow_p) and torch.equal(used, used_p)
    # the kernel wrapper never takes a CPU tensor (no silent fallback)
    with pytest.raises(ValueError):
        panel_factor_noswap_cuda(A, torch.zeros(12, dtype=torch.int32), True)
