"""``panel_boundary_precision='bf16x3'`` in the port against the JAX package.

The knob splits the fori panel kernel's boundary matmuls into bf16 halves
(``_panel_kernel_fori``'s ``mmb``).  The port's plain version is
``micro_blocked_lu(..., 'bf16x3')``: blocks of ``panel_micro`` steps, the
block's U rows solved in f32, then the rank-``panel_micro`` update as the
split ``hh + (hl + lh)`` of ops/schur.py.  It is held to the JAX package's
interpret-mode ``fori2`` kernel under the same knob.

Tolerance of the factors (the bf16x3 class): two bf16x3 computations of one
panel whose f32 states part by an ulp round their splits differently, so
they are not bitwise equal.  The port's factors must lie within
``SPREAD`` times the knob's own effect on the same input (max |JAX bf16x3 -
JAX float32|), closer to JAX's bf16x3 than JAX's float32 is on average,
and within the JAX package's own test tolerance (``atol=2e-3``) at its own
size, n = 96.  Pivots, perm and info are equal.  The Hopper kernel's own
tests are in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.ops.panel import panel_factor_pallas
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops.panel import (
    bf16x3_plan,
    bf16x3_updates,
    offset_panel_factor,
    panel_factor,
    panel_factor_cuda,
    panel_route,
    panel_update_bf16x3_cuda,
)
from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
from recursivefactorization_jl_tpu_torch.ops.unblocked import micro_blocked_lu, unblocked_lu
from test_torch_common import (
    assert_pivots_equal,
    jx,
    lu_residual,
    residual_gate,
    tc,
    to_np,
)
from test_torch_parallel import RankPool

torch.set_num_threads(1)

BF = "bf16x3"
# the port's factors lie within SPREAD times max |JAX bf16x3 - JAX float32|
# of JAX's bf16x3 factors (measured: at most 1.9x on RandomState(7) inputs)
SPREAD = 4.0
# the JAX package's own test of the knob (tests/test_config_warmup.py:133)
JAX_TEST_ATOL, JAX_TEST_RESID = 2e-3, 5e-4


def _matrix(shape, pivot=True, seed=7):
    A = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    if not pivot:
        A = A + np.float32(max(shape)) * np.eye(*shape, dtype=np.float32)
    return A


@functools.lru_cache(maxsize=None)
def _jax_panel(shape, b, pivot, bprec, seed=7):
    """The JAX package's fori2 kernel in interpret mode (cached per module:
    each case compiles once)."""
    out = panel_factor_pallas(jx(_matrix(shape, pivot, seed), np.float32), pivot,
                              interpret=True, micro=b, variant="fori2", bprec=bprec)
    f, ipiv, perm, info = (np.asarray(x) for x in out)
    return f, ipiv, perm.ravel(), int(info)


def _port_panel(shape, b, pivot, precision=BF, seed=7):
    return micro_blocked_lu(tc(_matrix(shape, pivot, seed), np.float32), pivot, b, precision)


def _assert_bf16x3_class(port, bf, f32):
    """The factors' tolerance of the module docstring."""
    got, want, other = to_np(port), np.asarray(bf), np.asarray(f32)
    spread = np.abs(want - other)
    diff = np.abs(got - want)
    assert diff.max() <= SPREAD * spread.max() + 1e-6, (diff.max(), spread.max())
    assert diff.mean() < spread.mean() or diff.max() <= 1e-6, (diff.mean(), spread.mean())


@pytest.mark.parametrize("shape,b,pivot", [
    ((96, 96), 16, True),
    ((128, 128), 32, True),
    ((160, 64), 16, True),    # tall
    ((64, 160), 16, True),    # fat: the last block's solve against the columns m..
    ((96, 96), 16, False),    # unpivoted
    ((100, 40), 12, True),    # ragged last block
])
def test_plain_matches_jax_fori2_bf16x3(shape, b, pivot):
    """ipiv, perm and info equal, factors in the bf16x3 class, the residual
    under the gate (and under the JAX test's 5e-4 at n = 96)."""
    A = _matrix(shape, pivot)
    port = _port_panel(shape, b, pivot)
    ref = _jax_panel(shape, b, pivot, BF)
    assert_pivots_equal(port, ref)
    _assert_bf16x3_class(port[0], ref[0], _jax_panel(shape, b, pivot, "float32")[0])
    resid = lu_residual(A, port[0], port[2])
    assert resid < residual_gate(A, np.float32, pivot)
    if shape == (96, 96) and pivot:
        np.testing.assert_allclose(to_np(port[0]), ref[0], atol=JAX_TEST_ATOL)
        assert resid < JAX_TEST_RESID


@pytest.mark.parametrize("b", [80, 96, 128])
def test_plain_past_64_matches_jax_fori2_bf16x3(b):
    """Blocks past 64 steps on a 96 x 96 panel, ipiv, perm and info equal
    to the JAX package's fori2 kernel with the knob, the factors within
    the JAX test's own tolerance at this size and the residual under its
    bound.  At b = 80 one boundary (an 80-step block, then 16): the knob
    changes only the trailing 16 x 16 block, which is held to the bf16x3
    class; elsewhere the port's factors are its float32 form's bit for
    bit.  At b >= w one block, no boundary: the port's factors are
    ``unblocked_lu``'s bit for bit."""
    shape = (96, 96)
    port = _port_panel(shape, b, True)
    ref = _jax_panel(shape, b, True, BF)
    assert_pivots_equal(port, ref)
    np.testing.assert_allclose(to_np(port[0]), ref[0], atol=JAX_TEST_ATOL)
    assert lu_residual(_matrix(shape), port[0], port[2]) < JAX_TEST_RESID
    if b < 96:
        f32 = _port_panel(shape, b, True, "float32")[0]
        knob = torch.zeros(shape, dtype=torch.bool)
        knob[b:, b:] = True
        assert torch.equal(port[0][~knob], f32[~knob])
        _assert_bf16x3_class(port[0][b:, b:], ref[0][b:, b:],
                             _jax_panel(shape, b, True, "float32")[0][b:, b:])
    else:
        for x, y in zip(port, unblocked_lu(tc(_matrix(shape), np.float32), True)):
            assert torch.equal(x, y)


def _cfgs(**kw):
    """The same knob in both packages (the JAX side on its Pallas kernels in
    interpret mode, the port on the CPU)."""
    base = dict(panel_boundary_precision=BF, tail_threshold=None, schur_precision="float32")
    base.update(kw)
    return rt.LUConfig(**base), rf.LUConfig(backend="pallas", **base)


@pytest.mark.parametrize("n,b", [(96, 16), (128, 32)])
def test_lu_whole_route_matches_jax_lu(n, b):
    """``lu`` through the public entry points of both packages, fori2 on the
    whole route: ipiv, perm, info equal, factors in the bf16x3 class."""
    A = _matrix((n, n))
    pc, jc = _cfgs(panel_variant="fori2", panel_micro=b, small_threshold=256)
    assert rt.dispatch_route((n, n), torch.float32, True, pc) == "whole"
    F = rt.lu(A, config=pc, device="cpu")
    G = rf.lu(jx(A, np.float32), config=jc)
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info), (G.factors, G.ipiv, G.p, G.info))
    _assert_bf16x3_class(F.factors, G.factors, _jax_panel((n, n), b, True, "float32")[0])
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, np.float32, True)


def test_jax_default_fori3_at_its_own_test_config():
    """The JAX package's own test of the knob: n = 96, fori3, micro 16,
    outer 32, which runs fori3's two-level micro-inverse form there.  The
    port runs the single-level form (a deliberate difference, ROADMAP.md
    Queue 3), so ipiv, perm and info are held equal and the residual to the
    JAX test's bound."""
    n = 96
    A = _matrix((n, n))
    pc, jc = _cfgs(panel_variant="fori3", panel_micro=16, panel_outer=32, small_threshold=256)
    F = rt.lu(A, config=pc, device="cpu")
    G = rf.lu(jx(A, np.float32), config=jc)
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info), (G.factors, G.ipiv, G.p, G.info))
    assert lu_residual(A, F.factors, F.p) < JAX_TEST_RESID
    np.testing.assert_allclose(to_np(F.factors), np.asarray(G.factors), atol=JAX_TEST_ATOL)


def test_blocked_route_matches_jax_blocked_bf16x3():
    """The blocked schedule (64-wide panels of 16-step blocks, so the
    boundaries fall inside each panel) against the JAX package's blocked
    schedule under the same knob."""
    n = 128
    A = _matrix((n, n), seed=3)
    kw = dict(panel_variant="fori2", panel_micro=16, panel_width=64, small_threshold=32)
    pc, jc = _cfgs(**kw)
    assert rt.dispatch_route((n, n), torch.float32, True, pc) == "blocked"
    F = rt.lu(A, config=pc, device="cpu")
    G = rf.lu(jx(A, np.float32), config=jc)
    G32 = rf.lu(jx(A, np.float32), config=dataclasses.replace(jc, panel_boundary_precision="float32"))
    assert_pivots_equal((F.factors, F.ipiv, F.p, F.info), (G.factors, G.ipiv, G.p, G.info))
    _assert_bf16x3_class(F.factors, G.factors, G32.factors)
    assert lu_residual(A, F.factors, F.p) < residual_gate(A, np.float32, True)
    # each panel of the port's blocked run is the plain bf16x3 version's
    P = tc(A, np.float32)
    _, piv, _, _ = panel_factor(P[:, :64].clone(), True, pc)
    assert torch.equal(piv, micro_blocked_lu(P[:, :64], True, 16, BF)[1])


def test_lu_solve_after_a_bf16x3_factor():
    """``lu_solve`` on the bf16x3 factors: the solution against the JAX
    package's solve on its own bf16x3 factors, and ``solve`` (the fat
    [A | b] panel) against ``lu`` + ``lu_solve``."""
    n = 96
    A = _matrix((n, n))
    b = np.random.RandomState(8).standard_normal(n).astype(np.float32)
    pc, jc = _cfgs(panel_variant="fori2", panel_micro=16, small_threshold=256)
    F = rt.lu(A, config=pc, device="cpu")
    x = to_np(rt.lu_solve(F, tc(b, np.float32)))
    xj = np.asarray(rf.lu_solve(rf.lu(jx(A, np.float32), config=jc), jx(b, np.float32)))
    xd = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    assert np.linalg.norm(A.astype(np.float64) @ x - b) < 1e-3 * np.linalg.norm(b)
    np.testing.assert_allclose(x, xj, atol=1e-3 * np.abs(xd).max())
    y = to_np(rt.solve(A, b, config=pc, device="cpu"))
    np.testing.assert_allclose(y, x, atol=1e-3 * np.abs(xd).max())


def test_a_jax_config_with_the_knob_maps_and_factors():
    """``config_from_mapping(dataclasses.asdict(jax_config))`` carries the
    knob across and factors as the port's own configuration does."""
    jc = rf.LUConfig(panel_boundary_precision=BF, panel_micro=16, panel_variant="fori2")
    pc = rt.config_from_mapping(dataclasses.asdict(jc))
    assert pc.resolved_panel_boundary_precision() == BF
    A = _matrix((96, 96))
    F = rt.lu(A, config=pc, device="cpu")
    G = rt.lu(A, config=rt.LUConfig(panel_boundary_precision=BF, panel_micro=16,
                                    panel_variant="fori2"), device="cpu")
    assert torch.equal(F.factors, G.factors) and torch.equal(F.p, G.p)
    assert not torch.equal(F.factors, rt.lu(A, device="cpu").factors)


@pytest.mark.parametrize("shape,b", [((96, 96), 16), ((128, 128), 32)])
def test_the_knob_is_live(shape, b):
    """The bf16x3 factors differ from float32's, and lie closer to JAX's
    bf16x3 than JAX's float32 does, on average over the entries."""
    port = _port_panel(shape, b, True)[0]
    port32 = _port_panel(shape, b, True, "float32")[0]
    bf, f32 = _jax_panel(shape, b, True, BF)[0], _jax_panel(shape, b, True, "float32")[0]
    assert not torch.equal(port, port32)
    assert np.abs(to_np(port) - bf).mean() < np.abs(bf - f32).mean()
    assert np.abs(to_np(port32) - f32).max() < 0.1 * np.abs(bf - f32).max()


def _both(fn):
    """``fn(config)`` under float32 and under bf16x3."""
    return fn(rt.LUConfig()), fn(rt.LUConfig(panel_boundary_precision=BF))


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, rt.LU):
        _same((a.factors, a.ipiv, a.p, a.info), (b.factors, b.ipiv, b.p, b.info))
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _rng_matrix(shape, dtype, seed=11):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal(shape)
    return A.astype(dtype)


@pytest.mark.parametrize("what", [
    "float64", "complex64", "complex128", "shadow", "basic", "physical", "offset_panel",
    "batched", "batched_perm", "batched_unpivoted_loop",
])
def test_passthrough_is_bitwise_float32s(what):
    """Where the JAX package's kernels take no ``bprec``, the knob changes no
    bit: float64 and complex matrices, the micro-blocked variants, the
    physical schedule, the tensor-parallel offset panel and the batched
    functions."""
    A32 = _rng_matrix((80, 80), np.float32)
    if what in ("float64", "complex64", "complex128"):
        A = _rng_matrix((80, 80), what)
        _same(*_both(lambda c: rt.lu(A, config=c, device="cpu")))
    elif what in ("shadow", "basic", "physical"):
        kw = dict(schedule="physical") if what == "physical" else dict(panel_variant=what)
        a, b = (rt.lu(A32, config=dataclasses.replace(c, panel_micro=16, **kw), device="cpu")
                for c in (rt.LUConfig(), rt.LUConfig(panel_boundary_precision=BF)))
        _same(a, b)
    elif what == "offset_panel":
        P = tc(A32[:, :24], np.float32)
        _same(*_both(lambda c: offset_panel_factor(P.clone(), 8, True, c)))
    elif what in ("batched", "batched_perm"):
        fn = rt.batched_lu_factor if what == "batched" else rt.batched_lu_factor_perm
        B = _rng_matrix((5, 48, 48), np.float32)
        _same(*_both(lambda c: fn(B, config=c, device="cpu")))
    else:
        # unpivoted under backend='xla' (on the card: the loop of lu_factor_p,
        # tests/test_torch_cuda.py; on the CPU: the plain batched version)
        B = _rng_matrix((2, 40, 40), np.float32) + 40 * np.eye(40, dtype=np.float32)
        _same(*_both(lambda c: rt.batched_lu_factor(
            B, pivot=False, config=dataclasses.replace(c, backend="xla"), device="cpu")))


@pytest.fixture(scope="module")
def one_rank():
    pool = RankPool(1)
    yield pool
    pool.close()


def test_tp_lu_at_one_rank_ignores_the_knob(one_rank):
    """``tp_lu_factor_p`` at one rank (a gloo world of one) under the knob is
    its float32 run bit for bit: its panel step, the offset kernel, takes no
    ``bprec`` in the JAX package either."""
    A = _rng_matrix((64, 64), np.float32, seed=5)
    a = one_rank.run("tp_factor", A=A, w=16)
    b = one_rank.run("tp_factor", A=A, w=16, config={"panel_boundary_precision": BF})
    for k in ("F", "ipiv", "perm", "info"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_matrices_take_the_split_on_their_float32_promotion(dtype):
    """Half matrices reach the panel promoted to float32 (the promote
    route), so the knob applies: the factors are the bf16x3 run of the
    promotion rounded back, with its ipiv, perm and info; the JAX package's
    promote route gives the same pivots."""
    n = 64
    A = torch.as_tensor(_matrix((n, n))).to(dtype)
    pc, jc = _cfgs(panel_variant="fori2", panel_micro=16, small_threshold=256)
    F = rt.lu(A, config=pc, device="cpu")
    G = rt.lu(A.float(), config=pc, device="cpu")
    assert F.factors.dtype == dtype
    assert torch.equal(F.factors, G.factors.to(dtype))
    assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p) and int(F.info) == int(G.info)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    J = rf.lu(jnp.asarray(A.float().numpy(), dtype=jdt), config=jc)
    np.testing.assert_array_equal(to_np(F.ipiv), np.asarray(J.ipiv))


@pytest.mark.parametrize("shape,micro", [((40, 24), 8), ((33, 33), 32), ((24, 40), 16)])
@pytest.mark.parametrize("pivot", [True, False])
def test_the_float32_path_is_unchanged(shape, micro, pivot):
    """``micro_blocked_lu``'s default is its float32 form bit for bit, and
    ``'auto'`` / ``'float32'`` route a float32 fori panel to the unblocked
    plain version as before."""
    A = tc(_matrix(shape, pivot), np.float32)
    _same(micro_blocked_lu(A, pivot, micro), micro_blocked_lu(A, pivot, micro, "float32"))
    for knob in ("auto", "float32"):
        cfg = rt.LUConfig(panel_boundary_precision=knob)
        assert panel_route(*shape, torch.float32, cfg, "cpu") == "unblocked"
        P = A.clone()
        out = panel_factor(P, pivot, cfg)
        _same(out[1:], unblocked_lu(A, pivot)[1:])
        assert torch.equal(P, unblocked_lu(A, pivot)[0])


def _serial_boundaries(m, w, b):
    """(rows, cols, nb) of each block boundary with rows below the block and
    columns right of it, worked out afresh."""
    b = min(b, m, w)
    steps = min(m, w)
    if b >= w:
        return []
    out = []
    for k0 in range(0, steps, b):
        nb = min(b, steps - k0)
        if m - k0 - nb > 0 and w - k0 - nb > 0:
            out.append((m - k0 - nb, w - k0 - nb, nb))
    return out


@pytest.mark.parametrize("m,w,b", [(1536, 512, 32), (4096, 512, 32), (8192, 512, 32),
                                   (1000, 100, 20), (64, 200, 16), (100, 40, 7), (33, 33, 1),
                                   (200, 96, 64), (700, 48, 64), (1, 5, 8), (5, 1, 8),
                                   (96, 97, 32), (97, 96, 32), (4096, 512, 65),
                                   (4096, 512, 128), (1536, 512, 256), (28672, 512, 32),
                                   (300, 700, 200), (1536, 512, 512), (1536, 512, 5000)])
def test_bf16x3_update_launches_per_boundary(m, w, b):
    """``bf16x3_updates`` lists the launches csrc/panel_cluster.cuh's
    `run_cluster` issues: one per block boundary with rows below the block
    and columns right of it, on all of them; that is every block but the
    last, and none where one block takes the panel."""
    got = bf16x3_updates(m, w, b)
    assert got == _serial_boundaries(m, w, b)
    bb, steps = min(b, m, w), min(m, w)
    assert len(got) == (0 if bb >= w else -(-steps // bb) - 1)


def test_bf16x3_update_launches_per_lu():
    """Per ``lu`` under the knob (512-wide panels of 32-step blocks): 45 /
    120 / 240 update launches at n = 1536 / 4096 / 8192, one per block
    boundary; the launches chip_smoke.py phase 3g counts on the card."""
    cfg = rt.LUConfig()
    w, b = cfg.resolved_panel_width(), cfg.resolved_panel_micro()
    for n, want in ((1536, 45), (4096, 120), (8192, 240)):
        panels = [(n - s, min(w, n - s)) for s in range(0, n, w)]
        assert sum(len(bf16x3_updates(pm, pw, b)) for pm, pw in panels) == want


def test_bf16x3_update_options_refused_before_the_card():
    """A bad update kernel raises ValueError before any tensor reaches a
    kernel, and counts no launch."""
    T = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="_update"):
        panel_factor_cuda(T, True, precision=BF, _update="wgmma")
    for bad in ("plain", None, (64, 32)):
        with pytest.raises(ValueError, match="_update"):
            panel_update_bf16x3_cuda(T, T, T, _update=bad)
    assert panel_factor_cuda.counts.bf16x3_launches == 0
    assert panel_update_bf16x3_cuda.counts.launches == 0


def test_panel_routes_under_the_knob():
    cfg = rt.LUConfig(panel_boundary_precision=BF)
    assert panel_route(64, 32, torch.float32, cfg, "cpu") == "micro-blocked-bf16x3"
    assert panel_route(64, 32, torch.float32, cfg, "cuda") == "kernel-bf16x3"
    for v in ("fori", "fori2", "fori3"):
        c = dataclasses.replace(cfg, panel_variant=v)
        assert panel_route(64, 32, torch.float32, c, "cuda") == "kernel-bf16x3"
    for dt, want in ((torch.float64, "kernel"), (torch.complex64, "kernel"),
                     (torch.complex128, "kernel")):
        assert panel_route(64, 32, dt, cfg, "cuda") == want
        assert panel_route(64, 32, dt, cfg, "cpu") == "unblocked"
    assert panel_route(64, 32, torch.float32, dataclasses.replace(cfg, panel_variant="shadow"),
                       "cuda") == "kernel-shadow"
    with pytest.raises(NotImplementedError):  # half panels reach the card promoted only
        panel_route(64, 32, torch.float16, cfg, "cuda")


def test_the_split_turns_an_inf_into_nan_as_the_jax_split_does():
    """An inf in U makes its low half NaN (inf - inf), so the bf16x3 update
    writes NaN where the float32 update writes +-inf; an inf in L (a
    multiplier) makes its row NaN.  On a panel: every NaN of the port's
    bf16x3 factors is NaN in the JAX package's too (whose masked sums
    spread NaN further, a deliberate difference of ROADMAP.md Queue 3)."""
    L = torch.tensor([[1.0, 2.0], [float("inf"), 0.5]])
    U = torch.tensor([[1.0, 3.0, 0.5], [2.0, -1.0, 4.0]])
    C = torch.zeros(2, 3)
    out = C - schur_product(L, U, BF)
    out32 = C - schur_product(L, U, "float32")
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1]).all())
    assert bool(torch.isinf(out32[1]).all())
    # unpivoted, so row 7 is U's last row of the first 8-step block and its
    # inf reaches the update alone
    A = _matrix((40, 24), pivot=False)
    A[7, 20] = np.inf
    port = to_np(micro_blocked_lu(tc(A, np.float32), False, 8, BF)[0])
    port32 = to_np(micro_blocked_lu(tc(A, np.float32), False, 8)[0])
    assert np.isnan(port[8, 20]) and port32[8, 20] == -np.inf
    ref = np.asarray(panel_factor_pallas(jx(A, np.float32), False, interpret=True, micro=8,
                                         variant="fori2", bprec=BF)[0])
    assert np.isnan(ref[np.isnan(port)]).all()


def test_invalid_values_raise():
    A = np.eye(8, dtype=np.float32)
    for bad in ("bf16", "float64", "BF16X3", None):
        with pytest.raises(ValueError):
            rt.lu(A, config=rt.LUConfig(panel_boundary_precision=bad), device="cpu")
        with pytest.raises(ValueError):
            panel_route(8, 8, torch.float32, rt.LUConfig(panel_boundary_precision=bad), "cpu")
    T = tc(A, np.float32)
    with pytest.raises(ValueError):
        micro_blocked_lu(T, True, 4, "bf16")
    with pytest.raises(ValueError):
        micro_blocked_lu(T.double(), True, 4, BF)
    # the knob takes any block width (a block past 64 steps, on the CPU and
    # on the card), as the JAX package does
    F = rt.lu(A, config=rt.LUConfig(panel_boundary_precision=BF, panel_micro=65), device="cpu")
    assert torch.equal(F.factors, unblocked_lu(T, True)[0]) and int(F.info) == 0
    # the kernel wrappers never take a CPU tensor (no silent fallback)
    with pytest.raises(ValueError):
        panel_factor_cuda(T, True, precision=BF)
    with pytest.raises(ValueError):
        panel_factor_cuda(T, True, precision="bf16")
    with pytest.raises(ValueError):
        panel_factor_cuda(T, True, block=-1, precision=BF)  # no grid route
    with pytest.raises(ValueError):
        panel_update_bf16x3_cuda(T, T, T)
    for bad in (dict(block=-1), dict(block=True), dict(_chain="cluster")):
        with pytest.raises(ValueError):
            bf16x3_plan(64, 32, **bad)
    with pytest.raises(ValueError, match="_chain"):
        panel_factor_cuda(T, True, precision=BF, _chain="wide")
    with pytest.raises(ValueError, match="_chain"):  # the float32 form has no grid chain
        panel_factor_cuda(T, True, _chain="grid")
    assert panel_factor_cuda.counts.bf16x3_launches == 0
    assert panel_update_bf16x3_cuda.counts.launches == 0
