"""The micro-blocked panel variants of the port (``panel_variant='shadow'``
and ``'basic'``) against the JAX package: the plain version
``micro_blocked_lu`` against the two static-unroll Pallas kernels in
interpret mode, and ``lu`` + ``lu_solve`` under the same configuration in
both packages.  The Hopper kernels' own tests are in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import scipy.linalg
import torch

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.ops.panel import panel_factor_pallas
from recursivefactorization_jl_tpu.ops.unblocked import unblocked_lu as jax_unblocked_lu
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops.blocked import blocked_lu
from recursivefactorization_jl_tpu_torch.ops.panel import (
    panel_factor,
    panel_factor_basic_cuda,
    panel_factor_shadow_cuda,
    panel_route,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    micro_blocked_lu,
    unblocked_lu,
)
from recursivefactorization_jl_tpu_torch.utils.config import (
    DEFAULT_PANEL_MICRO,
    PANEL_MICRO_MAX,
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

RNG = np.random.default_rng(51)

# The JAX tests' own tolerance for these kernels (tests/test_kernels.py):
# the Pallas kernels apply the delayed update as one matmul, the port as
# an ordered sum, so the factors differ by the order of summation.
ATOL32 = 2e-5


def _matrix(shape, pivot, kind="randn", dtype=np.float32):
    if kind == "ties":
        return RNG.integers(-2, 3, shape).astype(dtype)
    A = RNG.standard_normal(shape)
    if not pivot:
        A = A + max(shape) * np.eye(*shape)
    if kind == "zero_col":
        A[:, 5] = 0
    return A.astype(dtype)


# Each case traces and compiles one statically unrolled Pallas kernel (a few
# seconds in interpret mode), so the grid of variants, shapes, micro widths
# and pivoting is covered once, not as a full product.
@pytest.mark.parametrize("variant,shape,micro,pivot", [
    ("basic", (16, 8), 4, True),
    ("shadow", (16, 8), 4, False),
    ("shadow", (32, 32), 8, True),
    ("basic", (17, 16), 16, False),
    ("basic", (40, 33), 8, True),      # ragged last block (33 = 4*8 + 1)
    ("shadow", (40, 33), 16, True),    # ragged last block (33 = 2*16 + 1)
    ("shadow", (24, 40), 16, True),    # fat: the solve against columns m..
    ("basic", (24, 40), 16, False),
])
def test_micro_blocked_matches_pallas_kernels(variant, shape, micro, pivot):
    """ipiv, perm and info exactly, factors to the JAX tests' tolerance."""
    A = _matrix(shape, pivot)
    port = micro_blocked_lu(tc(A, np.float32), pivot, micro)
    ref = panel_factor_pallas(jx(A, np.float32), pivot, interpret=True,
                              variant=variant, micro=micro)
    assert_pivots_equal(port, ref)
    assert int(port[3]) == 0
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=ATOL32)
    assert lu_residual(A, port[0], port[2]) < residual_gate(A, np.float32, pivot)


@pytest.mark.parametrize("variant,kind,pivot", [
    ("basic", "zero_col", True), ("shadow", "zero_col", False),
    ("shadow", "ties", True), ("basic", "ties", True),
])
def test_micro_blocked_zero_column_and_ties(variant, kind, pivot):
    """A zeroed column (no swap, no scale, the update still runs, info =
    +-6) and exact ties (the first row wins) as the Pallas kernels have
    them."""
    A = _matrix((20, 12), pivot, kind)
    port = micro_blocked_lu(tc(A, np.float32), pivot, 4)
    ref = panel_factor_pallas(jx(A, np.float32), pivot, interpret=True,
                              variant=variant, micro=4)
    assert_pivots_equal(port, ref)
    if kind == "zero_col":
        assert int(port[3]) == (6 if pivot else -6)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=ATOL32)


@pytest.mark.parametrize("shape,micro", [((40, 33), 8), ((24, 40), 16), ((64, 64), 32)])
@pytest.mark.parametrize("pivot", [True, False])
def test_micro_blocked_f64(shape, micro, pivot):
    """float64 against the JAX package's pure-JAX ``unblocked_lu`` and
    scipy: the static-unroll kernels take f64 in interpret mode only
    where x64 tracing allows, so the oracle is the function they equal in
    exact arithmetic."""
    A = _matrix(shape, pivot, dtype=np.float64)
    port = micro_blocked_lu(tc(A, np.float64), pivot, micro)
    ref = jax_unblocked_lu(jx(A, np.float64), pivot)
    assert_pivots_equal(port, ref)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=1e-12)
    if pivot and shape[0] >= shape[1]:
        np.testing.assert_array_equal(to_np(port[1]), scipy.linalg.lu_factor(A)[1])


def test_micro_blocked_equals_unblocked_when_one_block_spans_it():
    """micro >= min(m, n) leaves one block: no delayed update on a tall
    panel, so the result is ``unblocked_lu``'s bit for bit; a fat panel
    keeps the solve against the columns beyond m."""
    A = tc(_matrix((40, 24), True), np.float32)
    for a, b in zip(micro_blocked_lu(A, True, 24), unblocked_lu(A, True)):
        assert torch.equal(a, b)
    for a, b in zip(micro_blocked_lu(A, True, 500), unblocked_lu(A, True)):
        assert torch.equal(a, b)
    F = tc(_matrix((12, 30), True), np.float64)
    f, ipiv, perm, info = micro_blocked_lu(F, True, 64)
    g = unblocked_lu(F, True)
    assert torch.equal(ipiv, g[1])
    np.testing.assert_allclose(to_np(f), to_np(g[0]), atol=1e-13)
    with pytest.raises(ValueError):
        micro_blocked_lu(A, True, 0)
    with pytest.raises(ValueError):
        micro_blocked_lu(A.to(torch.complex64), True, 8)


def test_nan_candidate_wins_as_in_the_unblocked_kernel():
    """Deliberate difference from the static-unroll Pallas kernels, which
    clamp the pivot to row m - 1 when a candidate is NaN: the port takes
    the first NaN row, the rule of its unblocked kernel and plain
    version (ROADMAP.md Queue 3)."""
    A = _matrix((16, 8), True)
    A[9, :2] = 1e-3  # not a pivot row before step 2, so the NaN stays put
    A[9, 2] = np.nan
    _, ipiv, _, _ = micro_blocked_lu(tc(A, np.float32), True, 4)
    _, ipiv_u, _, _ = unblocked_lu(tc(A, np.float32), True)
    assert int(ipiv[2]) == int(ipiv_u[2]) == 9
    ref = panel_factor_pallas(jx(A, np.float32), True, interpret=True,
                              variant="basic", micro=4)
    assert int(ref[1][2]) == 15


def _cfgs(route, variant, blocked_variant=None, micro=4):
    kw = dict(small_threshold=24) if route == "whole" else dict(
        small_threshold=8, panel_width=8)
    kw.update(panel_variant=variant, blocked_panel_variant=blocked_variant,
              panel_micro=micro)
    port = rt.LUConfig(**kw)
    ref = rf.LUConfig(backend="pallas", tail_threshold=None,
                      schur_precision="float32", **kw)
    return port, ref


@pytest.mark.parametrize("route,variant,blocked_variant", [
    ("whole", "shadow", None), ("whole", "basic", None),
    ("blocked", "shadow", None), ("blocked", "fori3", "basic"),
])
def test_lu_and_solve_under_the_variants_match_jax(route, variant, blocked_variant):
    """``lu`` + ``lu_solve`` with the same variant configuration in both
    packages (the JAX side runs its Pallas kernels in interpret mode):
    ipiv, perm and info equal, the residual under the gate, the solutions
    together."""
    n = 24
    A = _matrix((n, n), True)
    b = RNG.standard_normal(n).astype(np.float32)
    pc, jc = _cfgs(route, variant, blocked_variant)
    assert rt.dispatch_route((n, n), torch.float32, True, pc) == route
    F = rt.lu(A, config=pc, device="cpu")
    G = rf.lu(jx(A, np.float32), config=jc)
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info),
                        (G.factors, G.ipiv, G.p, G.info))
    gate = residual_gate(A, np.float32, True)
    assert lu_residual(A, F.factors, F.p) < gate
    np.testing.assert_allclose(to_np(F.factors), np.asarray(G.factors), atol=gate)
    x = to_np(rt.lu_solve(F, b))
    xj = np.asarray(rf.lu_solve(G, jx(b, np.float32)))
    np.testing.assert_allclose(x, xj, atol=1e-3 * np.max(np.abs(xj)))


@pytest.mark.parametrize("variant", ["shadow", "basic"])
def test_variants_unpivoted_zero_column_and_f64(variant):
    n = 40
    cfg = rt.LUConfig(panel_variant=variant, panel_width=16, small_threshold=16,
                      panel_micro=8)
    A = _matrix((n, n), False, dtype=np.float64)
    F = rt.lu(A, pivot=False, config=cfg, device="cpu")
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, np.float64, False)
    b = RNG.standard_normal((n, 2))
    np.testing.assert_allclose(A @ to_np(rt.lu_solve(F, b)), b, atol=1e-10)
    Z = _matrix((n, n), True, dtype=np.float64)
    Z[:, 21] = 0
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(Z, config=cfg, device="cpu")
    assert int(rt.lu(Z, check=False, config=cfg, device="cpu").info) == 22
    P = rt.lu(_matrix((n, n), True, dtype=np.float64), config=cfg, device="cpu")
    assert torch.equal(P.p, rt.ipiv_to_perm(P.ipiv, n))


def test_blocked_variant_applies_to_the_panels_only():
    """``blocked_panel_variant`` picks the blocked schedule's panel
    kernel and leaves the whole-matrix route to ``panel_variant``."""
    A = tc(_matrix((48, 48), True), np.float32)
    micro = rt.LUConfig(panel_variant="basic", panel_width=16, small_threshold=16,
                        panel_micro=4)
    both = rt.LUConfig(blocked_panel_variant="basic", panel_width=16,
                       small_threshold=16, panel_micro=4)
    for a, b in zip(blocked_lu(A.clone(), True, micro), blocked_lu(A.clone(), True, both)):
        assert torch.equal(a, b)
    plain = blocked_lu(A.clone(), True, rt.LUConfig(panel_width=16, small_threshold=16))
    assert not torch.equal(plain[0], blocked_lu(A.clone(), True, both)[0])
    whole = rt.LUConfig(blocked_panel_variant="basic", small_threshold=64, panel_micro=4)
    W = panel_factor(A.clone(), True, whole)
    for a, b in zip(W, unblocked_lu(A, True)):
        assert torch.equal(a, b)


def test_variant_routes_and_micro_resolution():
    f32, c64 = torch.float32, torch.complex64
    for variant in ("shadow", "basic"):
        cfg = rt.LUConfig(panel_variant=variant)
        assert panel_route(64, 32, f32, cfg, "cpu") == "micro-blocked"
        assert panel_route(64, 32, torch.float64, cfg, "cuda") == f"kernel-{variant}"
        # complex panels have one kernel and ignore the variant
        assert panel_route(64, 32, c64, cfg, "cuda") == "kernel"
        assert panel_route(64, 32, c64, cfg, "cpu") == "unblocked"
        with pytest.raises(NotImplementedError):
            panel_route(64, 32, torch.float16, cfg, "cuda")
        with pytest.raises(ValueError):
            panel_route(64, 32, f32, rt.LUConfig(panel_variant=variant, backend="xla"), "cuda")
    with pytest.raises(ValueError, match="unknown panel variant"):
        panel_route(64, 32, f32, rt.LUConfig(panel_variant="fori4"), "cpu")
    with pytest.raises(ValueError, match="unknown panel variant"):
        rt.lu(np.eye(4), config=rt.LUConfig(blocked_panel_variant="wide"), device="cpu")
    assert rt.LUConfig().resolved_panel_micro() == DEFAULT_PANEL_MICRO
    assert rt.LUConfig(panel_micro=8).resolved_panel_micro() == 8
    assert rt.LUConfig(blocked_panel_variant="basic").resolved_blocked_variant() == "basic"
    assert rt.LUConfig(panel_variant="shadow").resolved_blocked_variant() == "shadow"
    for bad in (0, -4, "wide", 2.5, PANEL_MICRO_MAX + 1):
        with pytest.raises(ValueError):
            rt.LUConfig(panel_micro=bad).resolved_panel_micro()
    assert rt.LUConfig(panel_micro=PANEL_MICRO_MAX).resolved_panel_micro() == 64
    # the kernels' block limit holds on the CPU route too: one
    # configuration factors on both devices or on neither
    with pytest.raises(ValueError, match="at most 64"):
        rt.lu(_matrix((80, 80), True), device="cpu",
              config=rt.LUConfig(panel_variant="basic", panel_micro=65))
    # the complex route factors under a micro variant (its own kernel's
    # plain version, CABS1)
    Z = _matrix((24, 24), True) + 1j * _matrix((24, 24), True)
    F = rt.lu(Z.astype(np.complex64), config=rt.LUConfig(panel_variant="shadow"), device="cpu")
    G = rt.lu(Z.astype(np.complex64), device="cpu")
    assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.factors, G.factors)
    # the kernel wrappers never take a CPU tensor (no silent fallback)
    for wrapper in (panel_factor_shadow_cuda, panel_factor_basic_cuda):
        with pytest.raises(ValueError):
            wrapper(torch.zeros(8, 4), True, 4)
        with pytest.raises(ValueError):
            wrapper(torch.zeros(8, 4), True, 0)
