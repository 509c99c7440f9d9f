"""The port's panel layer (ops/panel.py) and blocked schedule
(ops/blocked.py) against the JAX package: its fori3 Pallas panel kernel in
interpret mode and its blocked schedule with the Pallas backend forced
(interpret mode on the CPU).  The Hopper kernel's own tests are in
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import scipy.linalg
import torch

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.ops.panel import panel_factor_pallas
import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops import _counts, _kernels, blocked
from recursivefactorization_jl_tpu_torch.ops.blocked import _offset_info, blocked_lu
from recursivefactorization_jl_tpu_torch.ops.panel import (
    panel_factor,
    panel_factor_cuda,
    panel_route,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import unblocked_lu
from plan_rules import LOOKAHEAD_PER_CALL, lookahead_panels
from test_torch_common import (
    assert_pivots_equal,
    jx,
    lu_residual,
    residual_gate,
    tc,
    to_np,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(31)
CPU = rt.LUConfig(panel_width=32, small_threshold=32)


def _matrix(shape, pivot, zero_col=None, dtype=np.float32):
    A = RNG.standard_normal(shape)
    if not pivot:
        A = A + max(shape) * np.eye(*shape)
    if zero_col is not None:
        A[:, zero_col] = 0
    return A.astype(dtype)


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape,zero_col", [((128, 64), None), ((96, 96), 40)])
def test_panel_matches_jax_fori3(pivot, shape, zero_col):
    """The CPU route of ``panel_factor`` against the TPU kernel it ports
    (``_panel_kernel_fori`` as fori3, interpret mode): ipiv, perm and info
    exactly; factors to the residual gate's scale, since fori3 applies
    micro-block updates as matmuls and rounds in another order."""
    A = _matrix(shape, pivot, zero_col)
    P = tc(A, np.float32)
    port = panel_factor(P, pivot, rt.LUConfig())
    assert port[0] is P  # factored in place
    ref = panel_factor_pallas(jx(A, np.float32), pivot, interpret=True,
                              variant="fori3", micro=32, outer=256, unroll=2)
    assert_pivots_equal(port, ref)
    if zero_col is not None:
        assert int(port[3]) == (zero_col + 1 if pivot else -(zero_col + 1))
    gate = residual_gate(A, np.float32, pivot)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    assert lu_residual(A, port[0], port[2]) < gate


@pytest.mark.parametrize("pivot,tail", [(True, None), (False, None), (True, 64)])
def test_blocked_matches_jax_blocked(pivot, tail):
    """Blocked schedule, 32-wide panels, n=96 (3 panels; with the tail
    one panel then a 64-wide whole-block call), against the JAX blocked
    schedule with the same widths and its Pallas panels in interpret
    mode."""
    n = 96
    A = _matrix((n, n), pivot)
    port = blocked_lu(tc(A, np.float32), pivot,
                      dataclasses.replace(CPU, tail_threshold=tail))
    jcfg = rf.LUConfig(backend="pallas", panel_width=32, small_threshold=32,
                       tail_threshold=tail, schur_precision="float32")
    ref = rf.lu_factor_p(jx(A, np.float32), pivot, config=jcfg)
    assert_pivots_equal(port, ref)
    gate = residual_gate(A, np.float32, pivot)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    assert lu_residual(A, port[0], port[2]) < gate


@pytest.mark.parametrize("n", [96, 160])
@pytest.mark.parametrize("pivot,tail", [(True, None), (False, None), (True, 64)])
def test_lookahead_schedule_matches_jax_blocked(n, pivot, tail):
    """The split schedule (each look-ahead panel's strip, then its trailing
    block), 32-wide panels, against the JAX blocked schedule with the same
    widths: at n = 96 panel 0 splits and the last two keep the whole
    order (with the tail, taken at column 32, none splits); at n = 160
    panels 0-2 split, or with the tail (taken at column 96) panels 0-1, the
    panel before the tail keeping the whole order."""
    A = _matrix((n, n), pivot)
    cfg = dataclasses.replace(CPU, tail_threshold=tail)
    _counts.reset_counts()
    port = blocked_lu(tc(A, np.float32), pivot, cfg)
    assert blocked_lu.counts.lookahead_panels == lookahead_panels(n, 32, pivot, tail)
    assert lookahead_panels(n, 32, pivot, tail) == {96: 1, 160: 3}[n] - (tail is not None)
    jcfg = rf.LUConfig(backend="pallas", panel_width=32, small_threshold=32,
                       tail_threshold=tail, schur_precision="float32")
    ref = rf.lu_factor_p(jx(A, np.float32), pivot, config=jcfg)
    assert_pivots_equal(port, ref)
    gate = residual_gate(A, np.float32, pivot)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    assert lu_residual(A, port[0], port[2]) < gate


@pytest.mark.parametrize("n,w", [(16, 16), (32, 16), (48, 16), (49, 16), (100, 16),
                                 (200, 32), (130, 48), (96, 96), (97, 32)])
@pytest.mark.parametrize("pivot,tail", [(True, None), (False, None), (True, 40),
                                        (False, 40), (True, 64)])
def test_lookahead_panels_follow_the_rule(n, w, pivot, tail):
    """``lookahead_panels`` counts, per call, what tests/plan_rules.py's rule
    says over n, w, pivoting and the tail (a pivot-free call never takes
    the tail); ``reset_counts`` zeroes it, and a second call adds as many."""
    A = _matrix((n, n), pivot, dtype=np.float64)
    cfg = rt.LUConfig(panel_width=w, small_threshold=8, tail_threshold=tail)
    _counts.reset_counts()
    assert blocked_lu.counts.lookahead_panels == 0
    f, _, perm, _ = blocked_lu(tc(A, np.float64), pivot, cfg)
    want = lookahead_panels(n, w, pivot, tail)
    assert blocked_lu.counts.lookahead_panels == want
    blocked_lu(tc(A, np.float64), pivot, cfg)
    assert blocked_lu.counts.lookahead_panels == 2 * want
    assert lu_residual(A, f, perm) < residual_gate(A, np.float64, pivot)


def test_lookahead_counts_in_the_cells_keys():
    """The pinned per-call counts of the benchmark cells' keys (w 512, no
    tail) are the rule's; the batched cell runs no blocked schedule."""
    for (kind, n), want in LOOKAHEAD_PER_CALL.items():
        got = 0 if kind.startswith("batched") else lookahead_panels(
            n, pivot=not kind.startswith("rbt"))
        assert got == want, (kind, n)


@pytest.mark.parametrize("pivot", [False, True])
def test_the_strip_and_the_trailing_block_are_substituted_apart(pivot, monkeypatch):
    """With and without pivoting each look-ahead panel substitutes L11 into
    its strip (the next panel's w columns) and then into its trailing
    block, apart; the last two panels into all their columns at once.  The
    factors are those of the unsplit order to the residual gate's scale,
    the pivots and info the same."""
    n, w = 160, 32
    A = _matrix((n, n), pivot)
    shapes = []
    substitute = blocked.substitute

    def spy(T, B, **kw):
        shapes.append(tuple(B.shape))
        return substitute(T, B, **kw)

    monkeypatch.setattr(blocked, "substitute", spy)
    split = blocked_lu(tc(A, np.float32), pivot, CPU)
    assert shapes == [(w, w), (w, n - 2 * w), (w, w), (w, n - 3 * w), (w, w), (w, n - 4 * w),
                      (w, w)]
    monkeypatch.setattr(blocked, "lookahead", lambda *a: False)
    shapes.clear()
    whole = blocked_lu(tc(A, np.float32), pivot, CPU)
    assert shapes == [(w, n - w), (w, n - 2 * w), (w, n - 3 * w), (w, n - 4 * w)]
    gate = residual_gate(A, np.float32, pivot)
    np.testing.assert_allclose(to_np(split[0]), to_np(whole[0]), atol=gate)
    for a, b in zip(split[1:], whole[1:]):
        assert torch.equal(a, b)


def test_the_trailing_schur_update_runs_in_row_chunks(monkeypatch):
    """The trailing block's Schur update goes in row chunks of at most
    ``TRAILING_TILES`` 128 x 128 tiles; at one tile a chunk is 128 rows, and
    the factors are those of one chunk to the residual gate's scale."""
    n = 400
    A = _matrix((n, n), True, dtype=np.float64)
    cfg = rt.LUConfig(panel_width=64, small_threshold=64)
    whole = blocked_lu(tc(A, np.float64), True, cfg)
    rows = []
    schur = blocked.schur_update_

    def spy(C, L, U, prec):
        rows.append(C.shape[0])
        return schur(C, L, U, prec)

    monkeypatch.setattr(blocked, "schur_update_", spy)
    monkeypatch.setattr(blocked, "TRAILING_TILES", 1)
    chunked = blocked_lu(tc(A, np.float64), True, cfg)
    # each look-ahead panel at s: its strip's update, then 128-row chunks of n - s - 64 rows
    want = []
    for s in range(0, n, 64):
        m = n - s - 64
        if m <= 0:
            break
        want.append(m)
        if s + 128 < n:
            want += [min(128, m - i) for i in range(0, m, 128)]
    assert rows == want
    gate = residual_gate(A, np.float64, True)
    np.testing.assert_allclose(to_np(chunked[0]), to_np(whole[0]), atol=gate)
    for a, b in zip(chunked[1:], whole[1:]):
        assert torch.equal(a, b)


def test_blocked_fat_matches_jax():
    """Fat wrapper: factor the left square block, permute and solve the
    remaining columns."""
    A = _matrix((64, 100), True)
    port = blocked_lu(tc(A, np.float32), True, CPU)
    jcfg = rf.LUConfig(backend="pallas", panel_width=32, small_threshold=32,
                       tail_threshold=None, schur_precision="float32")
    ref = rf.lu_factor_p(jx(A, np.float32), True, config=jcfg)
    assert_pivots_equal(port, ref)
    gate = residual_gate(A, np.float32, True)
    np.testing.assert_allclose(to_np(port[0]), np.asarray(ref[0]), atol=gate)
    assert lu_residual(A, port[0], port[2]) < gate


@pytest.mark.parametrize("shape", [(150, 150), (200, 120), (90, 140)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_ipiv_matches_scipy(shape, dtype):
    A = _matrix(shape, True, dtype=dtype)
    f, ipiv, perm, info = blocked_lu(tc(A, dtype), True, CPU)
    np.testing.assert_array_equal(to_np(ipiv), scipy.linalg.lu_factor(A)[1])
    assert int(info) == 0
    assert lu_residual(A, f, perm) < residual_gate(A, dtype, True)


@pytest.mark.parametrize("pivot", [True, False])
def test_sparse_and_dense_laswp_agree(pivot, monkeypatch):
    """Both laswp branches give bitwise-identical factorizations."""
    A = _matrix((160, 160), pivot, dtype=np.float64)
    dense = blocked_lu(tc(A, np.float64), pivot, CPU)
    monkeypatch.setattr(blocked, "SPARSE_LASWP_MIN_BYTES", 0)
    sparse = blocked_lu(tc(A, np.float64), pivot, CPU)
    for d, s in zip(dense, sparse):
        assert torch.equal(d, s)
    tail = dataclasses.replace(CPU, tail_threshold=64)
    sparse_tail = blocked_lu(tc(A, np.float64), pivot, tail)
    assert lu_residual(A, sparse_tail[0], sparse_tail[2]) < residual_gate(
        A, np.float64, pivot)


@pytest.mark.parametrize("pivot", [True, False])
def test_zero_pivot_info_across_panels(pivot):
    """A zeroed column in the third panel: info is offset sign-aware by
    the panel start, and the first zero pivot wins."""
    A = _matrix((112, 112), pivot, zero_col=70, dtype=np.float64)
    A[:, 90] = 0
    f, ipiv, perm, info = blocked_lu(tc(A, np.float64), pivot, CPU)
    assert int(info) == (71 if pivot else -71)
    ref = unblocked_lu(tc(A, np.float64), pivot)
    np.testing.assert_array_equal(to_np(ipiv), to_np(ref[1]))
    assert int(ref[3]) == int(info)


def test_offset_info():
    z = torch.tensor(0, dtype=torch.int32)
    assert int(_offset_info(z, torch.tensor(3, dtype=torch.int32), 64)) == 67
    assert int(_offset_info(z, torch.tensor(-3, dtype=torch.int32), 64)) == -67
    assert int(_offset_info(z, z, 64)) == 0
    first = torch.tensor(5, dtype=torch.int32)
    assert int(_offset_info(first, torch.tensor(2, dtype=torch.int32), 64)) == 5


def test_panel_route_and_wrapper_errors():
    cfg = rt.LUConfig()
    assert panel_route(64, 32, torch.float32, cfg, "cpu") == "unblocked"
    assert panel_route(64, 32, torch.float64, cfg, "cuda") == "kernel"
    with pytest.raises(NotImplementedError):
        panel_route(64, 32, torch.float16, cfg, "cuda")
    assert panel_route(64, 32, torch.float32,
                       rt.LUConfig(panel_variant="shadow"), "cpu") == "micro-blocked"
    assert panel_route(64, 32, torch.float32,
                       rt.LUConfig(panel_variant="basic"), "cuda") == "kernel-basic"
    # the blocked schedule's variant is applied by blocked_lu, not here
    assert panel_route(64, 32, torch.float32,
                       rt.LUConfig(blocked_panel_variant="basic"), "cuda") == "kernel"
    with pytest.raises(ValueError):
        panel_route(64, 32, torch.float32, rt.LUConfig(backend="xla"), "cuda")
    # the boundary knob factors (the bf16x3 form's plain version on the
    # CPU); an unknown value raises
    P = torch.zeros(8, 4)
    assert panel_factor(P, True, rt.LUConfig(panel_boundary_precision="bf16x3"))[0] is P
    with pytest.raises(ValueError):
        panel_factor(torch.zeros(8, 4), True,
                     rt.LUConfig(panel_boundary_precision="bf16"))
    # the kernel wrapper never takes a CPU tensor (no silent fallback)
    with pytest.raises(ValueError):
        panel_factor_cuda(torch.zeros(8, 4), True)


def test_fori_variants_compute_the_same():
    A = tc(_matrix((40, 24), True), np.float32)
    outs = [panel_factor(A.clone(), True, rt.LUConfig(panel_variant=v))
            for v in ("fori", "fori2", "fori3")]
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.nvcc_path()


def test_library_name_follows_source_hash(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setitem(_kernels.SOURCES, "probe", src)
    first = _kernels.library_path("probe")
    src.write_text("// b\n")
    second = _kernels.library_path("probe")
    assert second != first
    assert first.parent == _kernels.BUILD_DIR
    # the headers the sources include are part of the name too
    header = tmp_path / "common.cuh"
    header.write_bytes(_kernels.HEADERS[0].read_bytes())
    monkeypatch.setattr(_kernels, "HEADERS", (header,) + _kernels.HEADERS[1:])
    assert _kernels.library_path("probe") == second
    header.write_text("// changed\n")
    assert _kernels.library_path("probe") != second
