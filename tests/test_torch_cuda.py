"""The port's Hopper kernels and main paths on a CUDA card.

Every test here carries the ``cuda`` marker and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.models import butterfly as rbt_mod
from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
from recursivefactorization_jl_tpu_torch.ops.blocked import blocked_lu
from recursivefactorization_jl_tpu_torch.ops.butterfly import butterfly_mul_cuda
from recursivefactorization_jl_tpu_torch.ops.panel import (
    bf16x3_plan,
    bf16x3_update_plan,
    bf16x3_updates,
    micro_max_cuda,
    micro_plan,
    noswap_plan,
    offset_panel_factor,
    offset_panel_factor_c64_cuda,
    offset_panel_factor_cuda,
    panel_factor_basic_cuda,
    panel_factor_c64_cuda,
    panel_factor_cuda,
    panel_factor_noswap_cuda,
    panel_factor_shadow_cuda,
    panel_plan,
    panel_update_bf16x3_cuda,
    reset_counts,
)
from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    micro_blocked_lu,
    offset_panel_lu,
    offset_panel_lu_cabs1,
    unblocked_lu,
    unblocked_lu_cabs1,
    unblocked_lu_noswap,
)
from recursivefactorization_jl_tpu_torch.utils import graphs, profiling, warmup
from recursivefactorization_jl_tpu_torch.utils.config import PANEL_MICRO_MAX
from lookahead_cases import KINDS, lookahead_panel, next_block_panel
from plan_rules import AUTO_PLANS, CARRIED_PER_CALL, LOOKAHEAD_PER_CALL, WIDTH, carried_blocks

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def need_cuda():
    """Skip unless a CUDA card is present (decided at run time, never at
    collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _same_bits_nan(x, y):
    """Bitwise equal, NaN for NaN (a NaN's sign and payload are not
    compared: in f64 the card passes on an operand's NaN, which the plain
    version's torch ops and a kernel may pick differently)."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(_bits(x.masked_fill(nx, 0)),
                                               _bits(y.masked_fill(ny, 0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (300, 64), (64, 200), (513, 513)])
def test_kernel_bitwise_equals_plain(dtype, pivot, shape):
    """Pivots, perm and info exactly, factors bitwise: both round every
    product and difference once."""
    need_cuda()
    g = torch.Generator().manual_seed(7)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    if not pivot:
        A += max(shape) * torch.eye(*shape, dtype=dtype, device="cuda")
    A[:, min(shape) // 2] = 0  # a zero pivot inside the factored steps
    f, piv, perm, info = unblocked_lu(A, pivot)
    P = A.clone()
    before = panel_factor_cuda.counts.launches
    kpiv, kperm, kinfo = panel_factor_cuda(P, pivot)
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.launches == before + 1
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert int(kinfo) == int(info) != 0
    assert torch.equal(_bits(P), _bits(f))


def test_kernel_in_place_on_a_strided_panel():
    need_cuda()
    g = torch.Generator().manual_seed(8)
    A = torch.randn(256, 256, generator=g).cuda()
    ref = A.clone()
    view = A[64:, 64:192]
    piv, perm, info = panel_factor_cuda(view, True)
    f, piv_p, perm_p, _ = unblocked_lu(ref[64:, 64:192], True)
    torch.cuda.synchronize()
    assert torch.equal(view, f) and torch.equal(piv, piv_p)
    # columns outside the panel are untouched
    assert torch.equal(A[:, :64], ref[:, :64]) and torch.equal(A[:, 192:], ref[:, 192:])


# every block width b and cluster size C of csrc/panel_lu.cu's cluster
# route on a (300, 100) panel (ragged last blocks), one slab for the whole
# panel (b = w: 100 columns, and 12), and a taller (1200, 100) panel
_PLANS = [(dt, (300, 100), b, C) for dt in (torch.float32, torch.float64)
          for b in (8, 16, 32, 64) for C in (1, 2, 4, 8, 16)]
_PLANS += [(dt, (300, 100), 100, C) for dt in (torch.float32, torch.float64)
           for C in (2, 4, 8, 16)]
_PLANS += [(dt, (300, 12), 12, C) for dt in (torch.float32, torch.float64)
           for C in (1, 2, 4, 8, 16)]
_PLANS += [(dt, (1200, 100), 8, C) for dt in (torch.float32, torch.float64) for C in (1, 2)]


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype,shape,block,cluster", _PLANS)
def test_kernel_plans_bitwise_equal_plain(dtype, shape, pivot, block, cluster):
    need_cuda()
    m, w = shape
    g = torch.Generator().manual_seed(17)
    A = torch.randn(m, w, generator=g, dtype=dtype)
    if not pivot:
        A += m * torch.eye(m, w, dtype=dtype)
    A[:, 7] = 0
    A = A.cuda()
    f, piv, perm, info = unblocked_lu(A, pivot)
    plan = panel_plan(m, w, dtype, block=block, cluster=cluster)
    assert plan["route"] == "cluster" and (plan["block"], plan["cluster"]) == (block, cluster)
    P = A.clone()
    g0 = panel_factor_cuda.counts.grid_route_launches
    kpiv, kperm, kinfo = panel_factor_cuda(P, pivot, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.grid_route_launches == g0
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert int(kinfo) == int(info) == (8 if pivot else -8)
    assert torch.equal(_bits(P), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,block,cluster", [
    ((20, 100), 16, 1), ((12, 100), 16, 4),   # fewer live rows than b
    ((7, 3), 8, 1), ((64, 200), 64, 2), ((128, 128), 0, 0), ((512, 512), 0, 0),
])
def test_kernel_short_fat_and_whole_panels(dtype, shape, block, cluster):
    need_cuda()
    g = torch.Generator().manual_seed(18)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    f, piv, perm, info = unblocked_lu(A, True)
    P = A.clone()
    kpiv, kperm, kinfo = panel_factor_cuda(P, True, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    assert torch.equal(_bits(P), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block,cluster", [(0, 0), (8, 4), (32, 16), (64, 2)])
def test_kernel_plans_on_a_column_block(dtype, block, cluster):
    """lda > w: a column block of a row-major matrix, as the blocked
    schedule hands it over; everything outside the block untouched."""
    need_cuda()
    g = torch.Generator().manual_seed(19)
    M = torch.randn(700, 700, generator=g, dtype=dtype).cuda()
    ref = M.clone()
    view = M[128:, 128:256]
    f, piv, perm, info = unblocked_lu(ref[128:, 128:256], True)
    kpiv, kperm, kinfo = panel_factor_cuda(view, True, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(_bits(view), _bits(f)) and torch.equal(kpiv, piv)
    assert torch.equal(kperm, perm)
    rest = torch.ones_like(M, dtype=torch.bool)
    rest[128:, 128:256] = False
    assert torch.equal(M[rest], ref[rest])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_grid_route_for_tall_panels(dtype):
    """A panel too tall for a cluster of 16 at b = 8 takes the grid route
    (counted apart); so does block=-1.  Both stay bitwise."""
    need_cuda()
    g = torch.Generator().manual_seed(20)
    for shape, block in (((100000, 8) if dtype == torch.float32 else (60000, 16), 0),
                         ((900, 40), -1)):
        A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
        assert panel_plan(*shape, dtype, block=block)["route"] == "grid"
        f, piv, perm, info = unblocked_lu(A, True)
        P = A.clone()
        g0 = panel_factor_cuda.counts.grid_route_launches
        kpiv, kperm, kinfo = panel_factor_cuda(P, True, block=block)
        torch.cuda.synchronize()
        assert panel_factor_cuda.counts.grid_route_launches == g0 + 1
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
        assert torch.equal(_bits(P), _bits(f))


def test_kernel_plans_refused_where_they_do_not_fit():
    need_cuda()
    for bad in (lambda: panel_plan(5000, 512, torch.float64, block=512, cluster=1),
                lambda: panel_plan(300, 1000, torch.float32, block=1000, cluster=16),
                lambda: panel_plan(200000, 8, torch.float32, block=8, cluster=16),
                lambda: panel_plan(300, 100, torch.float32, block=24, cluster=2),
                lambda: panel_plan(300, 100, torch.float32, block=32, cluster=3),
                lambda: panel_plan(300, 100, torch.float32, block=32)):
        with pytest.raises(RuntimeError):
            bad()


def test_kernel_rejects_bad_panels():
    need_cuda()
    with pytest.raises(ValueError):
        panel_factor_cuda(torch.zeros(8, 4, device="cuda", dtype=torch.float16), True)
    with pytest.raises(ValueError):
        panel_factor_cuda(torch.zeros(8, 4, device="cuda").T, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,w", [(300, 64), (700, 256)])
def test_lu_on_the_card_matches_the_cpu_route(dtype, n, w):
    """The blocked schedule on the card (kernel panels) and on the CPU
    (plain panels): the same pivots; both factorizations under the
    residual gate."""
    need_cuda()
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n))
    cfg = rt.LUConfig(panel_width=w, small_threshold=w)
    G = rt.lu(torch.tensor(A, dtype=dtype), config=cfg)
    C = rt.lu(torch.tensor(A, dtype=dtype), config=cfg, device="cpu")
    assert G.factors.is_cuda
    assert torch.equal(G.ipiv.cpu(), C.ipiv) and torch.equal(G.p.cpu(), C.p)
    eps = torch.finfo(dtype).eps
    gate = 20 * n * eps * float(np.abs(A).max())
    for F in (G, C):
        LU = F.L.double() @ F.U.double()
        r = float((LU.cpu() - torch.tensor(A)[F.p.cpu().long()]).abs().max())
        assert r < gate
    b = torch.tensor(rng.standard_normal(n), dtype=dtype)
    x = rt.lu_solve(G, b).cpu().double()
    assert float((torch.tensor(A) @ x - b.double()).abs().max()) < 1e3 * gate


def test_solve_and_inplace_on_the_card():
    need_cuda()
    rng = np.random.default_rng(4)
    A = torch.tensor(rng.standard_normal((600, 600)), dtype=torch.float32, device="cuda")
    b = torch.tensor(rng.standard_normal(600), dtype=torch.float32, device="cuda")
    x = rt.solve(A, b)
    assert x.is_cuda
    assert float((A.double() @ x.double() - b.double()).abs().max()) < 1e-2
    B = A.clone()
    F = rt.lu_inplace(B)
    assert F.factors is B
    A[:, 5] = 0
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(A)


# ---------------------------------------------------------------------------
# the complex panel kernel and the complex / half paths
# ---------------------------------------------------------------------------


def _cbits(t):
    return _bits(torch.view_as_real(t).contiguous())


def _crandn(shape, g, dtype):
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    return torch.complex(torch.randn(*shape, generator=g, dtype=real),
                         torch.randn(*shape, generator=g, dtype=real))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (300, 64), (64, 200), (257, 257)])
def test_c64_kernel_bitwise_equals_plain(dtype, pivot, shape):
    """Pivots, perm and info exactly, factors bitwise: both round every
    product, sum, difference and quotient once, in the same order."""
    need_cuda()
    g = torch.Generator().manual_seed(21)
    A = _crandn(shape, g, dtype).cuda()
    if not pivot:
        A += max(shape) * torch.eye(*shape, dtype=dtype, device="cuda")
    A[:, min(shape) // 2] = 0  # a zero pivot inside the factored steps
    f, piv, perm, info = unblocked_lu_cabs1(A, pivot)
    P = A.clone()
    before = panel_factor_c64_cuda.counts.launches
    kpiv, kperm, kinfo = panel_factor_c64_cuda(P, pivot)
    torch.cuda.synchronize()
    assert panel_factor_c64_cuda.counts.launches == before + 1
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert int(kinfo) == int(info) != 0
    assert torch.equal(_cbits(P), _cbits(f))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_c64_kernel_ties_and_nan_candidates(dtype):
    """Exact CABS1 ties take the first row; a NaN candidate makes the
    pivot row m - 1 (the maximum is NaN and equals no candidate)."""
    need_cuda()
    g = torch.Generator().manual_seed(22)
    m, w = 200, 96
    T = torch.complex(torch.randint(-2, 3, (m, w), generator=g).double(),
                      torch.randint(-2, 3, (m, w), generator=g).double()).to(dtype).cuda()
    N = _crandn((m, w), g, dtype).cuda()
    N[50, 10] = complex(float("nan"), 1.0)
    for A in (T, N):
        f, piv, perm, info = unblocked_lu_cabs1(A, True)
        P = A.clone()
        kpiv, kperm, kinfo = panel_factor_c64_cuda(P, True)
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
        assert int(kinfo) == int(info)
        assert torch.equal(_cbits(P), _cbits(f))
    assert bool((kpiv[10:] == m - 1).all())


# every block width b and cluster size C of the complex kernel's cluster
# route (csrc/panel_cluster.cuh with a complex element) on a (300, 100)
# panel, and one slab for the whole panel (b = w); complex128 at b = 64 on
# one CTA needs 300 x 64 x 16 bytes of slab, more than a CTA has
_CPLANS = [(dt, b, C) for dt in (torch.complex64, torch.complex128)
           for b in (8, 16, 32, 64) for C in (1, 2, 4, 8, 16)
           if (dt, b, C) != (torch.complex128, 64, 1)]
_CPLANS += [(dt, 100, C) for dt in (torch.complex64, torch.complex128) for C in (4, 8, 16)]


@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype,block,cluster", _CPLANS)
def test_c64_kernel_cluster_plans_bitwise_equal_plain(dtype, block, cluster, pivot):
    """The cluster route keeps the plain version's bits on every plan, a
    zeroed column included (no swap, no scale, info 8)."""
    need_cuda()
    m, w = 300, 100
    g = torch.Generator().manual_seed(24)
    A = _crandn((m, w), g, dtype)
    if not pivot:
        A += m * torch.eye(m, w, dtype=dtype)
    A[:, 7] = 0
    A = A.cuda()
    f, piv, perm, info = unblocked_lu_cabs1(A, pivot)
    plan = panel_plan(m, w, dtype, block=block, cluster=cluster)
    assert plan["route"] == "cluster" and (plan["block"], plan["cluster"]) == (block, cluster)
    P = A.clone()
    g0 = panel_factor_c64_cuda.counts.grid_route_launches
    kpiv, kperm, kinfo = panel_factor_c64_cuda(P, pivot, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert panel_factor_c64_cuda.counts.grid_route_launches == g0
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert int(kinfo) == int(info) == (8 if pivot else -8)
    assert torch.equal(_cbits(P), _cbits(f))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("where", ["re", "im", "last_row", "ties"])
@pytest.mark.parametrize("block,cluster", [(8, 1), (16, 16), (32, 4), (0, 0)])
def test_c64_kernel_cluster_route_nan_and_ties(dtype, where, block, cluster):
    """A NaN among a step's candidates (in re, in im, or in row m - 1
    itself) makes every later pivot row m - 1 on the cluster route too;
    exact CABS1 ties take the first row."""
    need_cuda()
    m, w = 300, 64
    g = torch.Generator().manual_seed(25)
    if where == "ties":
        A = torch.complex(torch.randint(-2, 3, (m, w), generator=g).double(),
                          torch.randint(-2, 3, (m, w), generator=g).double()).to(dtype)
    else:
        A = _crandn((m, w), g, dtype)
        row = m - 1 if where == "last_row" else 150
        A[row, 10] = complex(1.0, float("nan")) if where == "im" else complex(float("nan"), 1.0)
    A = A.cuda()
    f, piv, perm, info = unblocked_lu_cabs1(A, True)
    P = A.clone()
    kpiv, kperm, kinfo = panel_factor_c64_cuda(P, True, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    assert _same_bits_nan(torch.view_as_real(P), torch.view_as_real(f))
    if where != "ties":
        assert bool((kpiv[10:] == m - 1).all()) and bool((kpiv[:10] != m - 1).all())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_c64_kernel_grid_route_forced_and_for_tall_panels(dtype):
    """block=-1 forces the grid route (the PR 3 design); a panel too tall
    for a cluster of 16 at b = 8 takes it by itself.  Both count apart and
    stay bitwise."""
    need_cuda()
    g = torch.Generator().manual_seed(26)
    tall = (60000, 8) if dtype == torch.complex64 else (30000, 8)
    for shape, block in ((tall, 0), ((900, 40), -1)):
        A = _crandn(shape, g, dtype).cuda()
        assert panel_plan(*shape, dtype, block=block)["route"] == "grid"
        f, piv, perm, info = unblocked_lu_cabs1(A, True)
        P = A.clone()
        g0 = panel_factor_c64_cuda.counts.grid_route_launches
        kpiv, kperm, kinfo = panel_factor_c64_cuda(P, True, block=block)
        torch.cuda.synchronize()
        assert panel_factor_c64_cuda.counts.grid_route_launches == g0 + 1
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
        assert torch.equal(_cbits(P), _cbits(f))
    # the offset form plans the live rows; an offset beyond m - w is refused
    assert panel_plan(900, 40, dtype, ofs=0, block=-1)["route"] == "grid"
    with pytest.raises(RuntimeError):
        panel_plan(900, 40, dtype, ofs=861)
    with pytest.raises(RuntimeError):
        panel_plan(5000, 512, dtype, block=512, cluster=1)
    if dtype == torch.complex128:
        with pytest.raises(RuntimeError):
            panel_plan(300, 100, dtype, block=64, cluster=1)


def test_c64_kernel_in_place_on_a_strided_panel():
    need_cuda()
    g = torch.Generator().manual_seed(23)
    A = _crandn((256, 256), g, torch.complex64).cuda()
    ref = A.clone()
    view = A[64:, 64:192]
    piv, perm, info = panel_factor_c64_cuda(view, True)
    f, piv_p, perm_p, _ = unblocked_lu_cabs1(ref[64:, 64:192], True)
    torch.cuda.synchronize()
    assert torch.equal(view, f) and torch.equal(piv, piv_p) and torch.equal(perm, perm_p)
    # columns outside the panel are untouched
    assert torch.equal(A[:, :64], ref[:, :64]) and torch.equal(A[:, 192:], ref[:, 192:])
    assert torch.equal(A[:64], ref[:64])


def test_c64_kernel_rejects_bad_panels():
    need_cuda()
    z = torch.zeros(8, 4, device="cuda", dtype=torch.complex64)
    for bad in (torch.zeros(8, 4, device="cuda"), z.T, z.conj(), z[None],
                z[:, :0], torch.zeros(8, 4, dtype=torch.complex64)):
        with pytest.raises(ValueError):
            panel_factor_c64_cuda(bad, True)
    with pytest.raises(ValueError):
        panel_factor_cuda(z, True)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,w", [(300, 64), (700, 256)])
def test_complex_lu_on_the_card_matches_the_cpu_route(dtype, n, w):
    """The blocked schedule on the card (kernel panels) and on the CPU
    (plain panels) pivot by CABS1 alike: the same pivots, both under the
    residual gate; N/T/H solves on the card."""
    need_cuda()
    rng = np.random.default_rng(24)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    cfg = rt.LUConfig(panel_width=w, small_threshold=w)
    At = torch.tensor(A, dtype=dtype)
    before = panel_factor_c64_cuda.counts.launches
    G = rt.lu(At, config=cfg)
    assert panel_factor_c64_cuda.counts.launches == before + -(-n // w)
    C = rt.lu(At, config=cfg, device="cpu")
    assert G.factors.is_cuda and G.factors.dtype == dtype
    assert torch.equal(G.ipiv.cpu(), C.ipiv) and torch.equal(G.p.cpu(), C.p)
    eps = torch.finfo(dtype).eps
    gate = 20 * n * eps * float(np.abs(A).max())
    Ad = torch.tensor(A)
    for F in (G, C):
        LU = F.L.to(torch.complex128) @ F.U.to(torch.complex128)
        assert float((LU.cpu() - Ad[F.p.cpu().long()]).abs().max()) < gate
    b = torch.tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n), dtype=dtype)
    for trans, op in ((0, Ad), (1, Ad.T), (2, Ad.conj().T)):
        x = rt.lu_solve(G, b, trans=trans).cpu().to(torch.complex128)
        assert float((op @ x - b.to(torch.complex128)).abs().max()) < 1e3 * gate
    x = rt.solve(At, b).cpu().to(torch.complex128)
    assert float((Ad @ x - b.to(torch.complex128)).abs().max()) < 1e3 * gate
    At[:, 5] = 0
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(At, config=cfg)
    assert int(rt.lu(At, check=False, config=cfg).info) == 6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_promotes_through_the_f32_kernel_on_the_card(dtype):
    need_cuda()
    rng = np.random.default_rng(25)
    n = 600
    A = torch.tensor(rng.standard_normal((n, n)) + n * np.eye(n)).to(dtype)
    before = panel_factor_cuda.counts.launches
    F = rt.lu(A)
    assert panel_factor_cuda.counts.launches == before + 2
    G = rt.lu(A.float())
    assert F.factors.dtype == dtype and F.factors.is_cuda
    assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.factors, G.factors.to(dtype))
    C = rt.lu(A, device="cpu")
    assert torch.equal(F.ipiv.cpu(), C.ipiv)
    b = torch.tensor(rng.standard_normal(n)).to(dtype)
    x = rt.lu_solve(F, b)
    assert x.dtype == dtype
    r = (A.double().cuda() @ x.double() - b.double().cuda()).abs().max()
    assert float(r) < 20 * n * torch.finfo(dtype).eps


def test_batched_complex_and_half_on_the_card():
    """Complex batches take the library routes, half batches the f32
    kernels after promotion."""
    need_cuda()
    rng = np.random.default_rng(26)
    B, n = 50, 32
    A = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    bk.reset_lu_launches()
    bk.reset_solve_launches()
    At, bt = torch.tensor(A, dtype=torch.complex64), torch.tensor(b, dtype=torch.complex64)
    for pivot in (True, False):
        M = At + (0 if pivot else n) * torch.eye(n)
        f, perm, info = rt.batched_lu_factor_perm(M, pivot)
        assert f.is_cuda and int((info != 0).sum()) == 0
        for trans in (0, 1, 2):
            x = rt.batched_lu_solve_perm(f, perm, bt, pivot, trans=trans).cpu()
            op = M if trans == 0 else (M.mT if trans == 1 else M.mT.conj())
            r = torch.bmm(op, x[:, :, None])[:, :, 0] - bt
            assert float(r.abs().max()) < 1e-2
    assert bk.batched_lu_cuda.launches == bk.batched_solve_cuda.launches == 0
    H = torch.tensor(A.real + n * np.eye(n)).to(torch.bfloat16)
    hb = torch.tensor(b.real).to(torch.bfloat16)
    f, ipiv, info = rt.batched_lu_factor(H)
    x = rt.batched_lu_solve(f, ipiv, hb)
    assert f.dtype == x.dtype == torch.bfloat16
    assert bk.batched_lu_cuda.launches == 1 and bk.batched_solve_cuda.launches == 1
    f32, ipiv32, _ = rt.batched_lu_factor(H.float())
    assert torch.equal(ipiv, ipiv32) and torch.equal(f, f32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the batched kernels: swap, noswap, solve
# ---------------------------------------------------------------------------


def _batch(seed, B, m, n, dtype, pivot, ties=False):
    g = torch.Generator().manual_seed(seed)
    if ties:
        return torch.randint(-2, 3, (B, m, n), generator=g).to(dtype).cuda()
    A = torch.randn(B, m, n, generator=g, dtype=dtype)
    if not pivot:
        A += max(m, n) * torch.eye(m, n, dtype=dtype)
    A[B // 2, :, min(m, n) // 2] = 0  # a zero pivot in one matrix of the batch
    return A.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(3, 1, 1), (37, 7, 3), (37, 16, 16), (101, 64, 64),
                                   (5, 128, 128), (9, 40, 96), (9, 300, 24),
                                   # the routes' boundaries (warp: m, n <= 32)
                                   (5, 31, 31), (5, 32, 32), (5, 33, 33), (3, 32, 40),
                                   (3, 40, 32), (5, 20, 32),
                                   # batches that are not a multiple of the warp
                                   # route's 4 or 8 matrices per block
                                   (1, 16, 16), (3, 32, 32), (1001, 16, 16),
                                   (1001, 32, 32)])
def test_batched_swap_kernel_bitwise_equals_plain(dtype, pivot, shape):
    need_cuda()
    B, m, n = shape
    A = _batch(11, B, m, n, dtype, pivot)
    keep = A.clone()
    f, ipiv, perm, info = bk.batched_lu_plain(A, pivot, True)
    before = bk.batched_lu_cuda.launches
    on_route = bk.batched_lu_cuda.route_launches[bk.lu_route(m, n)]
    kf, kipiv, kperm, kinfo = bk.batched_lu_cuda(A, pivot, True)
    torch.cuda.synchronize()
    assert bk.batched_lu_cuda.launches == before + 1
    assert bk.batched_lu_cuda.route_launches[bk.lu_route(m, n)] == on_route + 1
    assert torch.equal(A, keep)  # the input is read, not written
    assert torch.equal(kipiv, ipiv) and torch.equal(kperm, perm)
    assert torch.equal(kperm, rt.batched_ipiv_to_perm(kipiv, m))
    assert torch.equal(kinfo, info)
    want = torch.zeros(B, dtype=torch.int32)
    want[B // 2] = (min(m, n) // 2 + 1) * (1 if pivot else -1)
    assert torch.equal(kinfo.cpu(), want)
    assert torch.equal(_bits(kf), _bits(f))
    assert bk.batched_lu_cuda(A, pivot, False)[2] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["warp", "block", "tile"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 16, 16), (1001, 32, 32), (5, 20, 32),
                                   (5, 33, 33), (3, 40, 32), (7, 128, 128), (3, 128, 20)])
def test_batched_swap_routes_launch_once_and_equal_plain(dtype, route, shape):
    """Every route that takes a shape (forced by ``route=``) gives the plain
    version's bits with one launch of its own kernel; a route that does
    not take the shape raises and launches nothing."""
    need_cuda()
    B, m, n = shape
    A = _batch(18, B, m, n, dtype, True)
    bk.reset_lu_launches()
    if route == "warp" and max(m, n) > 32 or route == "block" and max(m, n) > 128:
        with pytest.raises(ValueError):
            bk.batched_lu_cuda(A, True, True, route=route)
        assert bk.batched_lu_cuda.launches == 0
        return
    f, ipiv, perm, info = bk.batched_lu_plain(A, True, True)
    kf, kipiv, kperm, kinfo = bk.batched_lu_cuda(A, True, True, route=route)
    torch.cuda.synchronize()
    assert bk.batched_lu_cuda.launches == 1
    assert bk.batched_lu_cuda.route_launches == {r: int(r == route) for r in bk.LU_ROUTES}
    assert torch.equal(kipiv, ipiv) and torch.equal(kperm, perm) and torch.equal(kinfo, info)
    assert torch.equal(_bits(kf), _bits(f))
    plan = bk.lu_plan(m, n, dtype, route)
    assert plan["route"] == route and plan["smem"] == bk.lu_smem_bytes(m, n, dtype.itemsize, route)
    if route == "warp":
        assert plan["local_bytes"] == 0  # the rows stay in registers


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 8, 8), (9, 16, 16), (9, 32, 32), (9, 33, 33),
                                   (9, 64, 64), (9, 128, 128), (9, 300, 24)])
def test_batched_swap_inf_and_nan_in_a_pivot_row(dtype, shape):
    """A pivot row carrying inf and NaN spreads them through the trailing
    block (later candidates are inf or NaN, and a NaN makes row m - 1
    win): every route keeps ipiv, perm, info and the bits of the plain
    version."""
    need_cuda()
    B, m, n = shape
    A = _batch(19, B, m, n, dtype, True).cpu()
    for i in range(0, B, 2):
        r = (3 * i) % m
        A[i, r, 0] = 1e3
        A[i, r, 1 % n] = float("inf")
        A[i, r, 2 % n] = float("nan")
    A = A.cuda()
    f, ipiv, perm, info = bk.batched_lu_plain(A, True, True)
    kf, kipiv, kperm, kinfo = bk.batched_lu_cuda(A, True, True)
    assert torch.equal(kipiv, ipiv) and torch.equal(kperm, perm) and torch.equal(kinfo, info)
    assert _same_bits_nan(kf, f)
    assert bool(torch.isnan(kf).any())  # the case reaches NaN factors


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 64, 128])
def test_batched_kernels_on_exact_ties(dtype, n):
    need_cuda()
    A = _batch(12, 23, n, n, dtype, True, ties=True)
    f, ipiv, perm, info = bk.batched_lu_plain(A, True, True)
    kf, kipiv, kperm, kinfo = bk.batched_lu_cuda(A, True, True)
    assert torch.equal(kipiv, ipiv) and torch.equal(kperm, perm) and torch.equal(kinfo, info)
    assert torch.equal(_bits(kf), _bits(f))
    f, perm, info = bk.batched_lu_noswap_plain(A, True)
    kf, kperm, kinfo = bk.batched_lu_noswap_cuda(A, True)
    assert torch.equal(kperm, perm) and torch.equal(kinfo, info)
    assert torch.equal(_bits(kf), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape", [(3, 1, 1), (37, 16, 16), (101, 64, 64), (5, 128, 128)])
def test_batched_noswap_kernel_bitwise_equals_plain(dtype, pivot, shape):
    need_cuda()
    B, n, _ = shape
    A = _batch(13, B, n, n, dtype, pivot)
    f, perm, info = bk.batched_lu_noswap_plain(A, pivot)
    before = bk.batched_lu_noswap_cuda.launches
    kf, kperm, kinfo = bk.batched_lu_noswap_cuda(A, pivot)
    torch.cuda.synchronize()
    assert bk.batched_lu_noswap_cuda.launches == before + 1
    assert torch.equal(kperm, perm) and torch.equal(kinfo, info)
    assert int(kinfo[B // 2]) != 0 and int((kinfo != 0).sum()) == 1
    assert torch.equal(_bits(kf), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nrhs", [None, 1, 5])
@pytest.mark.parametrize("shape", [(3, 1), (37, 16), (101, 64), (5, 128)])
def test_batched_solve_kernel_bitwise_equals_plain(dtype, nrhs, shape):
    need_cuda()
    B, n = shape
    g = torch.Generator().manual_seed(14)
    A = torch.randn(B, n, n, generator=g, dtype=dtype).cuda()
    b = torch.randn((B, n) if nrhs is None else (B, n, nrhs), generator=g, dtype=dtype).cuda()
    f, ipiv, perm, info = bk.batched_lu_cuda(A, True, True)
    assert int((info != 0).sum()) == 0
    x = bk.batched_solve_plain(f, b)
    before = bk.batched_solve_cuda.launches
    kx = bk.batched_solve_cuda(f, b)
    torch.cuda.synchronize()
    assert bk.batched_solve_cuda.launches == before + 1
    assert kx.shape == b.shape
    assert torch.equal(_bits(kx.contiguous()), _bits(x.contiguous()))
    # the row order applied inside the kernel: by perm, or by the ipiv swaps
    xp = bk.batched_solve_plain(f, b, perm=perm)
    for kw in ({"perm": perm}, {"ipiv": ipiv}, {"perm": perm.long()}):
        kx = bk.batched_solve_cuda(f, b, **kw)
        assert torch.equal(_bits(kx.contiguous()), _bits(xp.contiguous()))
    rel = (torch.bmm(A, xp.reshape(B, n, -1)) - b.reshape(B, n, -1)).abs().max()
    assert float(rel) < (1e-1 if dtype == torch.float32 else 1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 8, 15, 16, 17, 31, 32])
def test_batched_solve_routes_bitwise_equal_plain(dtype, n):
    """The solve's warp route (the shape's own at n <= 32), forced: no row
    order, perm or ipiv, a vector, one and five right-hand sides, a zero on
    U's diagonal in one matrix (inf / NaN there only), a batch that is not a
    multiple of the matrices per block; one launch on the route per call."""
    need_cuda()
    g = torch.Generator().manual_seed(27)
    B = 37
    A = torch.randn(B, n, n, generator=g, dtype=dtype).cuda()
    f, ipiv, perm, info = bk.batched_lu_cuda(A, True, True)
    f[B // 2, n // 2, n // 2] = 0
    route = bk.solve_route(n, 1)
    assert route == "warp"
    for nrhs in (None, 1, 5):
        b = torch.randn((B, n) if nrhs is None else (B, n, nrhs), generator=g,
                        dtype=dtype).cuda()
        x = bk.batched_solve_plain(f, b)
        xp = bk.batched_solve_plain(f, b, perm=perm)
        for kw, want in (({}, x), ({"perm": perm}, xp), ({"ipiv": ipiv}, xp)):
            before = dict(bk.batched_solve_cuda.route_launches)
            kx = bk.batched_solve_cuda(f, b, route=route, **kw)
            torch.cuda.synchronize()
            after = bk.batched_solve_cuda.route_launches
            assert after[route] == before[route] + 1
            assert sum(after.values()) == sum(before.values()) + 1
            assert kx.shape == b.shape
            assert _same_bits_nan(kx.contiguous(), want.contiguous())
            finite = torch.isfinite(kx.reshape(B, -1)).all(dim=1)
            assert not bool(finite[B // 2]) and int(finite.sum()) == B - 1


def test_batched_solve_warp_route_on_the_public_path():
    """The public solves at n = 16 launch the warp route, at n = 64 and
    128 the wide route; the warp route refuses n > 32, the wide route
    n <= 32."""
    need_cuda()
    g = torch.Generator().manual_seed(28)
    for n, route in ((16, "warp"), (64, "wide"), (128, "wide")):
        A = torch.randn(500, n, n, generator=g).cuda()
        b = torch.randn(500, n, generator=g).cuda()
        f, perm, _ = rt.batched_lu_factor_perm(A)
        bk.reset_solve_launches()
        x = rt.batched_lu_solve_perm(f, perm, b)
        torch.cuda.synchronize()
        assert bk.batched_solve_cuda.route_launches == {r: int(r == route)
                                                        for r in bk.SOLVE_ROUTES}
        assert torch.equal(_bits(x), _bits(bk.batched_solve_plain(f, b, perm=perm)))
    with pytest.raises(ValueError):
        bk.batched_solve_cuda(torch.zeros(4, 33, 33, device="cuda"),
                              torch.zeros(4, 33, device="cuda"), route="warp")
    with pytest.raises(ValueError):
        bk.batched_solve_cuda(torch.zeros(4, 32, 32, device="cuda"),
                              torch.zeros(4, 32, device="cuda"), route="wide")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 8, 16, 17, 31, 32, 33, 64, 127, 128])
def test_batched_noswap_routes_bitwise_equal_plain(dtype, n):
    """The noswap kernel on the route its shape names (warp at n <= 32,
    block beyond) and, at n <= 32, forced onto the block route: batches of 1,
    37 and 1001, pivot on and off, exact ties, a zeroed column, a NaN
    candidate after row n - 1 won the first step (the NaN rule picks it
    again): factors (NaN for NaN), perm and info equal to the plain version's,
    one launch on the route per call."""
    need_cuda()
    own = bk.noswap_route(n)
    assert own == ("warp" if n <= 32 else "block")
    g = torch.Generator().manual_seed(29)
    for B in (1, 37, 1001):
        cases = []
        for pivot in (True, False):
            X = torch.randn(B, n, n, generator=g, dtype=dtype)
            if not pivot:
                X += n * torch.eye(n, dtype=dtype)
            X[B // 2, :, n // 2] = 0  # a zero pivot in one matrix
            cases.append(("zero_col", pivot, X))
        cases.append(("ties", True, torch.randint(-2, 3, (B, n, n), generator=g).to(dtype)))
        if n > 1:
            N = torch.randn(B, n, n, generator=g, dtype=dtype)
            N[::2, n - 1, 0] = 1e3
            N[::2, 0, 1] = float("nan")
            cases.append(("nan", True, N))
        for name, pivot, X in cases:
            A = X.cuda()
            f, perm, info = bk.batched_lu_noswap_plain(A, pivot)
            if name == "nan":
                assert (perm[::2, :2] == n - 1).all()
            if name == "zero_col":
                assert int(info[B // 2]) == (n // 2 + 1) * (1 if pivot else -1)
            for route in dict.fromkeys((own, "block")):
                bk.reset_noswap_launches()
                kf, kperm, kinfo = bk.batched_lu_noswap_cuda(A, pivot, route=route)
                torch.cuda.synchronize()
                assert bk.batched_lu_noswap_cuda.route_launches == {
                    r: int(r == route) for r in bk.NOSWAP_ROUTES}, (name, route)
                assert torch.equal(kperm, perm) and torch.equal(kinfo, info), (name, route)
                assert _same_bits_nan(kf, f), (name, route, B)
    with pytest.raises(ValueError):
        bk.batched_lu_noswap_cuda(torch.zeros(4, 33, 33, device="cuda"), route="warp")
    plan = bk.lu_plan(n, n, dtype, own, swap=False)
    assert plan["route"] == own and plan["smem"] == bk.noswap_smem_bytes(n, dtype.itemsize)
    if own == "warp":
        assert plan["local_bytes"] == 0  # the rows stay in registers


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [33, 48, 64, 96, 128])
def test_batched_solve_wide_route_bitwise_equals_plain(dtype, n):
    """The solve's wide route (the shape's own at 32 < n <= 128), forced:
    no row order, perm or ipiv, one right-hand side as a vector and as a
    column, five (one full and one partial pass of four), a zero on U's
    diagonal in one matrix (inf / NaN there only), batches of 1, 37 and
    1001 (not a multiple of the matrices per block): bitwise equal to the
    plain version NaN for NaN, one launch on the route per call."""
    need_cuda()
    assert bk.solve_route(n, 1) == "wide"
    g = torch.Generator().manual_seed(30)
    for B in (1, 37, 1001):
        A = torch.randn(B, n, n, generator=g, dtype=dtype).cuda()
        f, ipiv, perm, info = bk.batched_lu_cuda(A, True, True)
        sing = B // 2
        f[sing, n // 2, n // 2] = 0
        for nrhs in (None, 1, 5):
            b = torch.randn((B, n) if nrhs is None else (B, n, nrhs), generator=g,
                            dtype=dtype).cuda()
            x = bk.batched_solve_plain(f, b)
            xp = bk.batched_solve_plain(f, b, perm=perm)
            for kw, want in (({}, x), ({"perm": perm}, xp), ({"ipiv": ipiv}, xp)):
                bk.reset_solve_launches()
                kx = bk.batched_solve_cuda(f, b, route="wide", **kw)
                torch.cuda.synchronize()
                assert bk.batched_solve_cuda.route_launches == {
                    r: int(r == "wide") for r in bk.SOLVE_ROUTES}
                assert kx.shape == b.shape
                assert _same_bits_nan(kx.contiguous(), want.contiguous()), (kw, B)
                finite = torch.isfinite(kx.reshape(B, -1)).all(dim=1)
                assert not bool(finite[sing]) and int(finite.sum()) == B - 1
    plan = bk.solve_plan(n, 1, dtype)
    assert plan["route"] == "wide" and plan["per_block"] == bk.wide_group(n, dtype.itemsize)
    assert plan["smem"] == bk.solve_smem_bytes(n, 1, dtype.itemsize)


def test_batched_kernels_copy_strided_input_and_reject_the_rest():
    """A strided batch is copied (not refused); f16, n = 129, 2-D, CPU
    and non-square (noswap, solve) inputs raise ValueError."""
    need_cuda()
    g = torch.Generator().manual_seed(15)
    S = torch.randn(9, 24, 48, generator=g).cuda()[:, :, ::2]
    assert not S.is_contiguous()
    assert torch.equal(bk.batched_lu_cuda(S)[0], bk.batched_lu_plain(S)[0])
    assert torch.equal(bk.batched_lu_noswap_cuda(S)[0], bk.batched_lu_noswap_plain(S)[0])
    f = bk.batched_lu_cuda(S)[0]
    bT = torch.randn(24, 9, generator=g).cuda().T
    assert torch.equal(bk.batched_solve_cuda(f, bT), bk.batched_solve_plain(f, bT))
    for bad in (torch.zeros(4, 8, 8, device="cuda", dtype=torch.float16),
                torch.zeros(4, 129, 129, device="cuda"),
                torch.zeros(8, 8, device="cuda"),
                torch.zeros(4, 8, 8)):
        with pytest.raises(ValueError):
            bk.batched_lu_cuda(bad)
        with pytest.raises(ValueError):
            bk.batched_lu_noswap_cuda(bad)
    with pytest.raises(ValueError):
        bk.batched_lu_noswap_cuda(torch.zeros(4, 8, 9, device="cuda"))
    with pytest.raises(ValueError):
        bk.batched_solve_cuda(torch.zeros(4, 8, 9, device="cuda"), torch.zeros(4, 8, device="cuda"))
    with pytest.raises(ValueError):
        bk.batched_solve_cuda(torch.zeros(4, 129, 129, device="cuda"),
                              torch.zeros(4, 129, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_public_path_on_the_card(dtype):
    """The four public functions launch the kernels (one launch per call)
    and agree with the CPU route: the same pivots, factors bitwise."""
    need_cuda()
    rng = np.random.default_rng(16)
    B, n = 200, 48
    A = rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n, 2))
    At = torch.tensor(A, dtype=dtype)
    bt = torch.tensor(b, dtype=dtype)
    bk.reset_lu_launches()
    bk.reset_solve_launches()
    f, perm, info = rt.batched_lu_factor_perm(At)
    x = rt.batched_lu_solve_perm(f, perm, bt)
    f2, ipiv, _ = rt.batched_lu_factor(At)
    x2 = rt.batched_lu_solve(f2, ipiv, bt[:, :, 0])
    assert f.is_cuda and x.is_cuda
    assert bk.batched_lu_cuda.launches == 2 and bk.batched_solve_cuda.launches == 2
    cf, cperm, cinfo = rt.batched_lu_factor_perm(At, device="cpu")
    assert torch.equal(perm.cpu(), cperm) and torch.equal(info.cpu(), cinfo)
    assert torch.equal(_bits(f.cpu()), _bits(cf))
    assert torch.equal(rt.batched_ipiv_to_perm(ipiv, n), perm)
    r = np.einsum("bij,bjk->bik", A, x.cpu().double().numpy()) - b
    assert float(np.abs(r).max()) < (1e-2 if dtype == torch.float32 else 1e-9)
    assert torch.equal(x2, x[:, :, 0])
    xt = rt.batched_lu_solve_perm(f, perm, bt[:, :, 0], trans="T")  # library route
    rt_ = np.einsum("bji,bj->bi", A, xt.cpu().double().numpy()) - b[:, :, 0]
    assert float(np.abs(rt_).max()) < (1e-2 if dtype == torch.float32 else 1e-9)


def test_batched_library_routes_on_the_card():
    """n = 129 is past the kernels: pivoted batches go to batched
    torch.linalg.lu_factor_ex, unpivoted ones loop lu_factor_p, solves run
    batched triangular solves; no batched kernel launches."""
    need_cuda()
    rng = np.random.default_rng(17)
    B, n = 3, 129
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    At = torch.tensor(A, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    bk.reset_lu_launches()
    bk.reset_noswap_launches()
    bk.reset_solve_launches()
    for pivot in (True, False):
        f, perm, info = rt.batched_lu_factor_perm(At, pivot)
        x = rt.batched_lu_solve_perm(f, perm, b, pivot)
        assert int((info != 0).sum()) == 0
        r = np.einsum("bij,bj->bi", A, x.cpu().double().numpy()) - b.double().numpy()
        assert float(np.abs(r).max()) < 1e-3
    assert bk.batched_lu_cuda.launches == bk.batched_solve_cuda.launches == 0
    with pytest.raises(ValueError):
        rt.batched_lu_factor(At, config=rt.LUConfig(backend="pallas"))


# ---------------------------------------------------------------------------
# the micro-blocked kernels (shadow, basic), the no-swap kernel, and the
# paths over them: panel variants, the physical schedule, RBT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape,micro", [
    ((1, 1), 4), ((7, 3), 2), ((300, 64), 16), ((300, 70), 32), ((64, 200), 16),
    ((513, 513), 64), ((40, 33), 8), ((200, 24), 32),
])
def test_micro_kernels_bitwise_equal_plain_and_each_other(dtype, pivot, shape, micro):
    """Pivots, perm and info exactly, factors bitwise, for the staged and
    the in-place kernel: the delayed update sums in one fixed order in all
    three.  Ragged last blocks, a fat panel, one block spanning the panel."""
    need_cuda()
    g = torch.Generator().manual_seed(31)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    if not pivot:
        A += max(shape) * torch.eye(*shape, dtype=dtype, device="cuda")
    A[:, min(shape) // 2] = 0  # a zero pivot inside the factored steps
    f, piv, perm, info = micro_blocked_lu(A, pivot, micro)
    for wrapper in (panel_factor_shadow_cuda, panel_factor_basic_cuda):
        P = A.clone()
        before = wrapper.counts.launches
        kpiv, kperm, kinfo = wrapper(P, pivot, micro)
        torch.cuda.synchronize()
        assert wrapper.counts.launches == before + 1
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
        assert int(kinfo) == int(info) != 0
        assert torch.equal(_bits(P), _bits(f))


def test_micro_kernels_on_ties_strided_panels_and_bad_arguments():
    need_cuda()
    g = torch.Generator().manual_seed(32)
    T = torch.randint(-2, 3, (200, 96), generator=g).float().cuda()
    f, piv, perm, info = micro_blocked_lu(T, True, 16)
    for wrapper in (panel_factor_shadow_cuda, panel_factor_basic_cuda):
        P = T.clone()
        kpiv, kperm, kinfo = wrapper(P, True, 16)
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
        assert int(kinfo) == int(info) and torch.equal(_bits(P), _bits(f))
        # in place on a column block of a larger matrix
        A = torch.randn(256, 256, generator=g).cuda()
        ref = A.clone()
        view = A[64:, 64:192]
        vpiv, _, _ = wrapper(view, True, 32)
        vf, vpiv_p, _, _ = micro_blocked_lu(ref[64:, 64:192], True, 32)
        assert torch.equal(view, vf) and torch.equal(vpiv, vpiv_p)
        assert torch.equal(A[:, :64], ref[:, :64]) and torch.equal(A[:, 192:], ref[:, 192:])
        assert torch.equal(A[:64], ref[:64])
        for bad, micro in ((torch.zeros(8, 4, device="cuda", dtype=torch.float16), 4),
                           (torch.zeros(8, 4, device="cuda").T, 4),
                           (torch.zeros(8, 4, device="cuda", dtype=torch.complex64), 4),
                           (torch.zeros(8, 4, device="cuda"), 0)):
            with pytest.raises(ValueError):
                wrapper(bad, True, micro)
        # past 64 steps: the cluster route takes it (the grid route does not)
        W = torch.randn(200, 100, generator=g).cuda()
        wf, wpiv, _, _ = micro_blocked_lu(W, True, 65)
        P = W.clone()
        assert torch.equal(wrapper(P, True, 65)[0], wpiv) and torch.equal(P, wf)
        with pytest.raises(ValueError):
            wrapper(W.clone(), True, 65, block=-1)
    # a micro beyond the panel is cut to it: one block, the unblocked result
    S = torch.randn(40, 24, generator=g).cuda()
    want = unblocked_lu(S, True)
    for wrapper in (panel_factor_shadow_cuda, panel_factor_basic_cuda):
        P = S.clone()
        spiv, sperm, _ = wrapper(P, True, 500)
        assert torch.equal(P, want[0]) and torch.equal(spiv, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape,taken", [
    ((1, 1), 0), ((7, 3), 2), ((300, 64), 0), ((300, 64), 150), ((513, 200), 300),
    ((256, 256), 0),
])
def test_noswap_kernel_bitwise_equals_plain(dtype, pivot, shape, taken):
    """prow, used and info exactly, factors bitwise, from an empty mask
    and from one with ``taken`` rows spread over the panel; the rows taken
    before stay untouched."""
    need_cuda()
    g = torch.Generator().manual_seed(33)
    m, w = shape
    A = torch.randn(m, w, generator=g, dtype=dtype).cuda()
    A[:, w // 2] = 0
    used0 = torch.zeros(m, dtype=torch.int32)
    used0[torch.randperm(m, generator=g)[:taken]] = 1
    used0 = used0.cuda()
    f, prow, used, info = unblocked_lu_noswap(A, used0, pivot)
    P = A.clone()
    before = panel_factor_noswap_cuda.counts.launches
    kprow, kused, kinfo = panel_factor_noswap_cuda(P, used0, pivot)
    torch.cuda.synchronize()
    assert panel_factor_noswap_cuda.counts.launches == before + 1
    assert torch.equal(kprow, prow) and torch.equal(kused, used)
    assert int(kinfo) == int(info) != 0
    assert torch.equal(_bits(P), _bits(f))
    assert torch.equal(P[used0.bool()], A[used0.bool()])
    assert int(kused.sum()) == taken + min(m, w)


def test_noswap_kernel_ties_exhausted_rows_and_bad_arguments():
    need_cuda()
    g = torch.Generator().manual_seed(34)
    T = torch.randint(-2, 3, (200, 96), generator=g).double().cuda()
    zero = torch.zeros(200, dtype=torch.int32, device="cuda")
    f, prow, used, info = unblocked_lu_noswap(T, zero, True)
    P = T.clone()
    kprow, kused, kinfo = panel_factor_noswap_cuda(P, zero, True)
    assert torch.equal(kprow, prow) and torch.equal(kused, used)
    assert int(kinfo) == int(info) and torch.equal(_bits(P), _bits(f))
    # a bool mask is taken; two rows free for four steps: -1 and no change
    E = torch.randn(6, 4, generator=g).cuda()
    few = torch.tensor([1, 1, 1, 0, 0, 1], dtype=torch.bool, device="cuda")
    f, prow, used, info = unblocked_lu_noswap(E, few, True)
    P = E.clone()
    kprow, kused, kinfo = panel_factor_noswap_cuda(P, few, True)
    assert torch.equal(kprow, prow) and kprow[2:].tolist() == [-1, -1]
    assert torch.equal(kused, used) and torch.equal(_bits(P), _bits(f))
    for panel, mask in ((torch.zeros(8, 4, device="cuda", dtype=torch.float16), zero[:8]),
                        (torch.zeros(8, 4, device="cuda").T, zero[:4]),
                        (torch.zeros(8, 4, device="cuda"), zero[:7]),
                        (torch.zeros(8, 4, device="cuda"), zero[:8].float()),
                        (torch.zeros(8, 4, device="cuda"), zero[:8].cpu())):
        with pytest.raises(ValueError):
            panel_factor_noswap_cuda(panel, mask, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("micro", [1, 8, 12, 32, 64])
@pytest.mark.parametrize("shape", [(700, 130), (130, 300)])
def test_micro_kernels_on_both_routes(shape, micro, dtype):
    """The cluster route (blocks of exactly ``micro`` steps, both variants
    the same kernel) and the grid route forced with ``block=-1`` (each
    variant its own kernel): the plain version's bits on both, one launch
    each, the grid route counted apart; a tall panel and a fat one."""
    need_cuda()
    g = torch.Generator().manual_seed(38)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    A[:, 9] = 0
    mc = min(micro, *shape)
    f, piv, perm, info = micro_blocked_lu(A, True, mc)
    for wrapper, variant in ((panel_factor_shadow_cuda, "shadow"),
                             (panel_factor_basic_cuda, "basic")):
        for block in (0, -1):
            assert micro_plan(*shape, dtype, micro, variant, block=block)["route"] == \
                ("cluster" if block == 0 else "grid")
            P = A.clone()
            before = (wrapper.counts.launches, wrapper.counts.grid_route_launches)
            kpiv, kperm, kinfo = wrapper(P, True, micro, block=block)
            torch.cuda.synchronize()
            assert (wrapper.counts.launches, wrapper.counts.grid_route_launches) == \
                (before[0] + 1, before[1] + (block < 0))
            assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
            assert int(kinfo) == int(info) == 10 and torch.equal(_bits(P), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1536, 512), (700, 300), (300, 700)])
@pytest.mark.parametrize("micro", [65, 128, 256, "w"])
def test_micro_kernels_past_64_bitwise_equal_plain(shape, micro, dtype):
    """Blocks past the grid route's 64 steps on the cluster route (the
    delayed kernels staging them in chunks), both variants, and every
    block's chain forced onto the grid: the plain version's bits, one
    launch each, the grid chain's blocks counted (micro = w: one block)."""
    need_cuda()
    g = torch.Generator().manual_seed(40)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    A[:, 9] = 0
    mc = min(shape[1] if micro == "w" else micro, *shape)
    f, piv, perm, info = micro_blocked_lu(A, True, mc)
    blocks = -(-min(shape) // mc)
    for wrapper, variant in ((panel_factor_shadow_cuda, "shadow"),
                             (panel_factor_basic_cuda, "basic")):
        for chain in ("auto", "grid"):
            plan = micro_plan(*shape, dtype, mc, variant, _chain=chain)
            assert plan["route"] == "cluster" and plan["blocks"] == blocks
            if chain == "grid":
                assert plan["grid_blocks"] == blocks
            P = A.clone()
            c = wrapper.counts
            before = (c.launches, c.grid_route_launches, c.grid_block_launches)
            kpiv, kperm, kinfo = wrapper(P, True, mc, _chain=chain)
            torch.cuda.synchronize()
            assert (c.launches, c.grid_route_launches, c.grid_block_launches) \
                == (before[0] + 1, before[1], before[2] + plan["grid_blocks"])
            assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
            assert int(kinfo) == int(info) == 10 and torch.equal(_bits(P), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,micro", [((30000, 256), 128), ((28000, 600), 600)])
def test_micro_kernels_past_64_on_panels_too_tall_for_a_cluster(shape, micro, dtype):
    """Past 64 steps a panel too tall for a cluster keeps the cluster
    route with its leading blocks' chains on the grid (a 600-wide block:
    past the widest slab, so on the grid whatever the height): the plain
    version's bits, no grid-route launch."""
    need_cuda()
    g = torch.Generator().manual_seed(41)
    A = torch.randn(*shape, generator=g, dtype=dtype).cuda()
    f, piv, perm, info = micro_blocked_lu(A, True, micro)
    plan = micro_plan(*shape, dtype, micro)
    assert plan["route"] == "cluster" and plan["grid_blocks"] >= 1
    P = A.clone()
    before = (panel_factor_basic_cuda.counts.grid_route_launches,
              panel_factor_basic_cuda.counts.grid_block_launches)
    kpiv, kperm, kinfo = panel_factor_basic_cuda(P, True, micro)
    torch.cuda.synchronize()
    assert (panel_factor_basic_cuda.counts.grid_route_launches,
            panel_factor_basic_cuda.counts.grid_block_launches) == \
        (before[0], before[1] + plan["grid_blocks"])
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    assert torch.equal(_bits(P), _bits(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("taken", [0, 333, 995])
def test_noswap_kernel_on_both_routes_and_plans(dtype, taken):
    """The cluster route with the live count given, with none (the plan
    sized for m), with explicit block widths and cluster sizes, and the
    grid route forced: the plain version's bits (NaN for NaN) on each,
    grid launches counted apart; 995 rows taken leave 5 for 64 steps."""
    need_cuda()
    g = torch.Generator().manual_seed(39)
    m, w = 1000, 64
    A = torch.randn(m, w, generator=g, dtype=dtype)
    A[m // 3, 2] = A[m // 2, 2] = float("nan")
    A = A.cuda()
    used0 = torch.zeros(m, dtype=torch.int32)
    used0[torch.randperm(m, generator=g)[:taken]] = 1
    used0 = used0.cuda()
    f, prow, used, info = unblocked_lu_noswap(A, used0, True)
    live = m - taken
    for kw in ({"live": live}, {}, {"live": live, "block": 8, "cluster": 1},
               {"live": live, "block": 32, "cluster": 4}, {"block": -1}):
        plan = noswap_plan(m, w, dtype, **kw)
        assert plan["route"] == ("grid" if kw.get("block", 0) < 0 else "cluster")
        P = A.clone()
        c = panel_factor_noswap_cuda.counts
        before = (c.launches, c.grid_route_launches)
        kprow, kused, kinfo = panel_factor_noswap_cuda(P, used0, True, **kw)
        torch.cuda.synchronize()
        assert c.launches == before[0] + 1
        assert c.grid_route_launches == before[1] + (plan["route"] == "grid")
        assert torch.equal(kprow, prow) and torch.equal(kused, used)
        assert int(kinfo) == int(info) and _same_bits_nan(P, f)
        assert torch.equal(_bits(P[used0.bool()]), _bits(A[used0.bool()]))
    if taken == 995:
        assert (prow[5:] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", ["shadow", "basic"])
def test_variant_lu_on_the_card_matches_the_cpu_route(dtype, variant):
    """``panel_variant`` on the card (the micro-blocked kernels) and on the
    CPU (their plain version): the same pivots and bitwise the same
    panels' arithmetic up to the matmuls between them; both under the
    residual gate; ``blocked_panel_variant`` reaches the same kernel."""
    need_cuda()
    rng = np.random.default_rng(35)
    n, w = 600, 128
    A = rng.standard_normal((n, n))
    wrapper = panel_factor_shadow_cuda if variant == "shadow" else panel_factor_basic_cuda
    cfg = rt.LUConfig(panel_variant=variant, panel_width=w, small_threshold=w,
                      panel_micro=16)
    At = torch.tensor(A, dtype=dtype)
    before = (wrapper.counts.launches, panel_factor_cuda.counts.launches)
    G = rt.lu(At, config=cfg)
    assert wrapper.counts.launches == before[0] + -(-n // w)
    assert panel_factor_cuda.counts.launches == before[1]
    C = rt.lu(At, config=cfg, device="cpu")
    assert torch.equal(G.ipiv.cpu(), C.ipiv) and torch.equal(G.p.cpu(), C.p)
    gate = 20 * n * torch.finfo(dtype).eps * float(np.abs(A).max())
    for F in (G, C):
        LU = F.L.double() @ F.U.double()
        assert float((LU.cpu() - torch.tensor(A)[F.p.cpu().long()]).abs().max()) < gate
    B = rt.lu(At, config=rt.LUConfig(blocked_panel_variant=variant, panel_width=w,
                                     small_threshold=w, panel_micro=16))
    assert torch.equal(B.factors, G.factors) and torch.equal(B.ipiv, G.ipiv)
    W = rt.lu(At[:w, :w], config=cfg)  # the whole route takes panel_variant
    assert wrapper.counts.launches == before[0] + 2 * -(-n // w) + 1
    assert torch.equal(W.ipiv.cpu(), rt.lu(At[:w, :w], config=cfg, device="cpu").ipiv)
    b = torch.tensor(rng.standard_normal(n), dtype=dtype)
    x = rt.lu_solve(G, b).cpu().double()
    assert float((torch.tensor(A) @ x - b.double()).abs().max()) < 1e3 * gate


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,w", [((600, 600), 128), ((700, 500), 256)])
def test_physical_lu_on_the_card_matches_the_cpu_route(dtype, shape, w):
    """``schedule='physical'`` on the card (the no-swap kernel) and on the
    CPU (its plain version): the same prow, perm and info, both under the
    residual gate; solves and det go by perm."""
    need_cuda()
    rng = np.random.default_rng(36)
    m, n = shape
    A = rng.standard_normal(shape)
    cfg = rt.LUConfig(schedule="physical", panel_width=w)
    At = torch.tensor(A, dtype=dtype)
    before = (panel_factor_noswap_cuda.counts.launches, panel_factor_cuda.counts.launches)
    G = rt.lu(At, config=cfg)
    assert panel_factor_noswap_cuda.counts.launches == before[0] + -(-n // w)
    assert panel_factor_cuda.counts.launches == before[1]
    C = rt.lu(At, config=cfg, device="cpu")
    assert G.factors.is_cuda
    assert torch.equal(G.ipiv.cpu(), C.ipiv) and torch.equal(G.p.cpu(), C.p)
    assert torch.equal(G.ipiv, G.p[:n])
    gate = 20 * max(m, n) * torch.finfo(dtype).eps * float(np.abs(A).max())
    for F in (G, C):
        LU = F.L.double() @ F.U.double()
        assert float((LU.cpu() - torch.tensor(A)[F.p.cpu().long()]).abs().max()) < gate
    if m == n:
        b = torch.tensor(rng.standard_normal(n), dtype=dtype)
        for trans, op in ((0, A), (1, A.T)):
            x = rt.lu_solve(G, b, trans=trans).cpu().double()
            assert float((torch.tensor(op) @ x - b.double()).abs().max()) < 1e3 * gate
        sign, logabs = np.linalg.slogdet(A)
        la, sg = G.logabsdet()
        assert float(sg) == sign and abs(float(la) - logabs) < 1e-2
        At[:, 300] = 0
        with pytest.raises(rt.SingularMatrixError):
            rt.lu(At, config=cfg)
        assert int(rt.lu(At, check=False, config=cfg).info) == 301


def test_butterfly_solve_on_the_card():
    """RBT on the card: the workspace lies on the card, the pivot-free LU
    launches the panel kernel with pivot=False, and the solution agrees
    with the CPU route's."""
    need_cuda()
    rng = np.random.default_rng(37)
    n = 602
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    ws = rt.butterfly_workspace(A, b)
    assert ws.A.is_cuda and ws.uv.is_cuda and ws.A.shape == (604, 604)
    before = panel_factor_cuda.counts.launches
    x, info = rt.butterfly_solve(ws, return_info=True, refine=1)
    assert panel_factor_cuda.counts.launches == before + 2 and int(info) == 0
    assert x.is_cuda and tuple(x.shape) == (n, 2)
    assert float(np.abs(A @ x.cpu().numpy() - b).max()) < 1e-9
    xc = rt.butterfly_solve(rt.butterfly_workspace(A, b, device="cpu"), refine=1)
    assert float((x.cpu() - xc).abs().max()) < 1e-12


def test_butterfly_values_default_to_the_card():
    """``generate_butterfly_values`` follows the device rule: no device
    means the card, with the values of the CPU stream; the micro-blocked
    library's grid-route block limit is the one the wrappers check."""
    need_cuda()
    uv = rt.generate_butterfly_values(64)
    assert uv.is_cuda and uv.dtype == torch.float64
    assert torch.equal(uv.cpu(), rt.generate_butterfly_values(64, device="cpu"))
    ws = rt.butterfly_workspace(np.eye(64), np.ones(64), uv=uv)
    assert ws.uv.is_cuda and torch.equal(ws.uv, uv)
    assert micro_max_cuda() == PANEL_MICRO_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(96, 0), (132, 0), (136, 0), (1536, 0), (4096, 0),
                                      (96, 1)])
def test_butterfly_kernel_bitwise_equals_the_tensor_code(dtype, n, offset):
    """csrc/butterfly.cu against ``butterfly_mul``'s tensor code on the card,
    bit for bit: n = 96 (q = 24: 16-byte accesses), 132 (q = 33: one
    element), 136 (q = 34: two floats), 1536, 4096, and a matrix one
    element off its allocation's alignment (one element an access); the
    launch counted by (dtype, n), no tensor transform."""
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2500000000 + n + offset)
    buf = torch.rand(n * n + offset, generator=g, device="cuda", dtype=dtype) - 0.5
    A = buf[offset:].view(n, n)
    uv = rt.generate_butterfly_values(n, dtype=dtype)
    reset_counts()
    got, width = butterfly_mul_cuda(A, uv, width=True)
    want = rbt_mod._butterfly_mul_tensor(A, uv)
    torch.cuda.synchronize()
    q, vec = n // 4, 16 // A.element_size()
    expect = 1 if offset else next(v for v in (vec, 2, 1) if q % v == 0)
    assert width == expect
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(rt.butterfly_mul(A, uv)), _bits(want))
    counts = butterfly_mul_cuda.counts
    assert counts.launches == {(str(dtype)[6:], n): 2} and counts.tensor_transforms == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("shape,ofs", [((1, 1), 0), ((40, 8), 0), ((40, 8), 32),
                                       ((300, 64), 100), ((1024, 128), 896),
                                       ((513, 256), 1)])
def test_offset_kernel_bitwise_equals_plain(dtype, pivot, shape, ofs):
    """The offset kernel against ``offset_panel_lu``: global pivot rows,
    the permutation of all rows and info exactly, factors bitwise, the
    rows above the offset untouched."""
    need_cuda()
    H, w = shape
    g = torch.Generator().manual_seed(11)
    A = torch.randn(H, w, generator=g, dtype=dtype)
    if not pivot:
        A[ofs + torch.arange(w), torch.arange(w)] += H
    A[ofs:, w // 2] = 0  # a zero pivot at step w // 2
    A = A.cuda()
    f, piv, perm, info = offset_panel_lu(A, ofs, pivot)
    P = A.clone()
    before = offset_panel_factor_cuda.counts.launches
    kpiv, kperm, kinfo = offset_panel_factor_cuda(P, ofs, pivot)
    torch.cuda.synchronize()
    assert offset_panel_factor_cuda.counts.launches == before + 1
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert int(kinfo) == int(info) == (w // 2 + 1) * (1 if pivot else -1)
    assert torch.equal(_bits(P), _bits(f)) and torch.equal(_bits(P[:ofs]), _bits(A[:ofs]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("block,cluster", [(8, 1), (32, 4), (64, 16), (0, 0), (64, 2)])
def test_offset_kernel_plans_leave_the_rows_above(dtype, pivot, block, cluster):
    need_cuda()
    H, w, ofs = 600, 64, 100
    g = torch.Generator().manual_seed(21)
    A = torch.randn(H, w, generator=g, dtype=dtype)
    if not pivot:
        A[ofs + torch.arange(w), torch.arange(w)] += H
    A = A.cuda()
    f, piv, perm, info = offset_panel_lu(A, ofs, pivot)
    P = A.clone()
    kpiv, kperm, kinfo = offset_panel_factor_cuda(P, ofs, pivot, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    assert torch.equal(_bits(P), _bits(f)) and torch.equal(_bits(P[:ofs]), _bits(A[:ofs]))


def test_offset_kernel_one_cta_for_128_live_rows_and_grid_route_when_tall():
    need_cuda()
    plan = panel_plan(4096, 128, torch.float32, ofs=3968)
    assert plan["route"] == "cluster" and plan["cluster"] == 1
    g = torch.Generator().manual_seed(22)
    A = torch.randn(100000, 8, generator=g).cuda()
    assert panel_plan(100000, 8, torch.float32, ofs=10)["route"] == "grid"
    f, piv, perm, info = offset_panel_lu(A, 10, True)
    P = A.clone()
    g0 = offset_panel_factor_cuda.counts.grid_route_launches
    kpiv, kperm, kinfo = offset_panel_factor_cuda(P, 10, True)
    torch.cuda.synchronize()
    assert offset_panel_factor_cuda.counts.grid_route_launches == g0 + 1
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert torch.equal(_bits(P), _bits(f))


def test_offset_kernel_strided_nan_and_bad_arguments():
    need_cuda()
    g = torch.Generator().manual_seed(12)
    M = torch.randn(512, 512, generator=g).cuda()
    ref = M.clone()
    view = M[:, 128:256]  # row stride 512, as the tensor-parallel panels are not
    f, piv, perm, info = offset_panel_lu(ref[:, 128:256], 200, True)
    kpiv, kperm, kinfo = offset_panel_factor_cuda(view, 200, True)
    torch.cuda.synchronize()
    assert torch.equal(view, f) and torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    rest = torch.ones_like(M, dtype=torch.bool)
    rest[200:, 128:256] = False
    assert torch.equal(M[rest], ref[rest])
    # a NaN among the candidates: the first NaN row, as the plain version
    A = torch.randn(256, 64, generator=g)
    A[100 + 50, 3] = float("nan")
    A[100 + 90, 3] = float("nan")
    A = A.cuda()
    f, piv, perm, info = offset_panel_lu(A, 100, True)
    P = A.clone()
    kpiv, kperm, kinfo = offset_panel_factor_cuda(P, 100, True)
    torch.cuda.synchronize()
    assert int(kpiv[3]) == 150 and torch.equal(kpiv, piv) and torch.equal(kperm, perm)
    assert torch.equal(_bits(P), _bits(f))
    cfg = rt.LUConfig(tp_panel_backend="jax")
    for bad in (lambda: offset_panel_factor_cuda(A, 193, True),
                lambda: offset_panel_factor_cuda(A, -1, True),
                lambda: offset_panel_factor_cuda(A, True, True),
                lambda: offset_panel_factor_cuda(A.cpu(), 0, True),
                lambda: offset_panel_factor_cuda(A.half(), 0, True),
                lambda: offset_panel_factor(A.clone(), 0, True, cfg)):
        with pytest.raises(ValueError):
            bad()


def test_tp_on_the_card_in_a_world_of_one_rank():
    """The tensor-parallel path in an NCCL world of one rank: every panel
    runs the offset kernel (n / w launches, none of the whole-panel
    kernel), the pivots are the single-device blocked LU's at the same
    width, and the solve and the sharded batch work."""
    need_cuda()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
        rng = np.random.default_rng(41)
        n, w = 640, 128
        A = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device="cuda")
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device="cuda")
        k0, p0 = offset_panel_factor_cuda.counts.launches, panel_factor_cuda.counts.launches
        F = rt.tp_lu(A, mesh, "tp", w)
        torch.cuda.synchronize()
        assert offset_panel_factor_cuda.counts.launches - k0 == n // w
        assert panel_factor_cuda.counts.launches == p0
        G = rt.lu(A, config=rt.LUConfig(panel_width=w, small_threshold=0))
        assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p) and int(F.info) == 0
        r = (F.L.double() @ F.U.double() - A.double()[F.p.long()]).abs().max()
        assert float(r) < 20 * n * torch.finfo(torch.float32).eps * float(A.abs().max())
        x = rt.tp_lu_solve(F, b, mesh, "tp", w)
        assert x.is_cuda and float((A.double() @ x.double() - b.double()).abs().max()) < 1e-2
        with pytest.raises(ValueError):
            rt.tp_lu(A, mesh, "tp", w, config=rt.LUConfig(tp_panel_backend="jax"))
        Ab = torch.tensor(rng.standard_normal((6, 32, 32)), dtype=torch.float32, device="cuda")
        f, ipiv, info = rt.sharded_batched_lu_factor(Ab, mesh, "tp")
        f0, ipiv0, info0 = rt.batched_lu_factor(Ab)
        assert torch.equal(f, f0) and torch.equal(ipiv, ipiv0) and torch.equal(info, info0)
    finally:
        dist.destroy_process_group()


def _offset_complex(H, w, ofs, dtype, pivot, name, g):
    A = _crandn((H, w), g, dtype)
    if not pivot:
        A[ofs + torch.arange(w), torch.arange(w)] += H
    if name == "zero_col":
        A[ofs:, w // 2] = 0
    if name == "nan":
        A[ofs + min(10, H - ofs - 1), 3] = complex(float("nan"), 1.0)
    if name == "ties":
        real = A.real.dtype
        A = torch.complex(torch.randint(-2, 3, (H, w), generator=g).to(real),
                          torch.randint(-2, 3, (H, w), generator=g).to(real))
    return A.cuda()


def _same_cbits_nan(x, y):
    return _same_bits_nan(torch.view_as_real(x).contiguous(),
                          torch.view_as_real(y).contiguous())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("block", [0, -1])
@pytest.mark.parametrize("shape,ofs", [((1, 1), 0), ((40, 8), 32), ((300, 64), 0),
                                       ((300, 64), 100), ((1024, 128), 896),
                                       ((513, 256), 1)])
def test_offset_c64_kernel_bitwise_equals_plain(dtype, pivot, block, shape, ofs):
    """The offset form of the complex kernel on its cluster route and its
    grid route (``block=-1``) against ``offset_panel_lu_cabs1``: global
    pivot rows, the permutation of all rows, info, factors bitwise, the
    rows above the offset untouched; randn, a zeroed column, exact CABS1
    ties and (pivoted) a NaN candidate, whose step and every later one
    take row H - 1."""
    need_cuda()
    H, w = shape
    g = torch.Generator().manual_seed(13)
    names = ("randn", "zero_col") + (("ties", "nan") if pivot and w > 4 else ())
    for name in names:
        A = _offset_complex(H, w, ofs, dtype, pivot, name, g)
        f, piv, perm, info = offset_panel_lu_cabs1(A, ofs, pivot)
        P = A.clone()
        c = offset_panel_factor_c64_cuda.counts
        k0, g0 = c.launches, c.grid_route_launches
        kpiv, kperm, kinfo = offset_panel_factor_c64_cuda(P, ofs, pivot, block=block)
        torch.cuda.synchronize()
        assert c.launches == k0 + 1
        assert c.grid_route_launches - g0 == (block < 0)
        assert torch.equal(kpiv, piv) and torch.equal(kperm, perm), name
        assert int(kinfo) == int(info), name
        assert _same_cbits_nan(P, f) and torch.equal(_cbits(P[:ofs]), _cbits(A[:ofs])), name
        if name == "zero_col" and w > 1:
            assert int(kinfo) == (w // 2 + 1) * (1 if pivot else -1)
        if name == "nan":
            assert (kpiv[3:] == H - 1).all()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("block,cluster", [(8, 1), (16, 4), (32, 16), (0, 0), (64, 4)])
def test_offset_c64_kernel_plans_leave_the_rows_above(dtype, block, cluster):
    """Block widths and cluster sizes of the complex offset kernel's
    cluster route (each fits the card for both types at 500 live rows)."""
    need_cuda()
    H, w, ofs = 600, 64, 100
    g = torch.Generator().manual_seed(23)
    A = _offset_complex(H, w, ofs, dtype, True, "zero_col", g)
    f, piv, perm, info = offset_panel_lu_cabs1(A, ofs, True)
    P = A.clone()
    plan = panel_plan(H, w, dtype, ofs=ofs, block=block, cluster=cluster)
    assert plan["route"] == "cluster"
    kpiv, kperm, kinfo = offset_panel_factor_c64_cuda(P, ofs, True, block=block,
                                                      cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    assert torch.equal(_cbits(P), _cbits(f)) and torch.equal(_cbits(P[:ofs]), _cbits(A[:ofs]))


def test_offset_c64_kernel_strided_and_bad_arguments():
    need_cuda()
    g = torch.Generator().manual_seed(14)
    M = _crandn((512, 512), g, torch.complex64).cuda()
    ref = M.clone()
    view = M[:, 128:256]
    f, piv, perm, info = offset_panel_lu_cabs1(ref[:, 128:256], 200, True)
    kpiv, kperm, kinfo = offset_panel_factor_c64_cuda(view, 200, True)
    torch.cuda.synchronize()
    assert torch.equal(_cbits(view), _cbits(f)) and torch.equal(kpiv, piv)
    assert torch.equal(kperm, perm)
    rest = torch.ones(512, 512, dtype=torch.bool, device="cuda")
    rest[200:, 128:256] = False
    assert torch.equal(M[rest], ref[rest])
    A = _crandn((256, 64), g, torch.complex64).cuda()
    for bad in (lambda: offset_panel_factor_c64_cuda(A, 193, True),
                lambda: offset_panel_factor_c64_cuda(A, -1, True),
                lambda: offset_panel_factor_c64_cuda(A.cpu(), 0, True),
                lambda: offset_panel_factor_c64_cuda(A.real.contiguous(), 0, True),
                lambda: offset_panel_factor_c64_cuda(A.conj(), 0, True),
                lambda: offset_panel_factor_cuda(A, 0, True)):
        with pytest.raises(ValueError):
            bad()


def _one_rank_world():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))


def test_tp_complex_half_and_integer_on_the_card_in_a_world_of_one_rank():
    """Complex matrices run the complex offset kernel (n / w launches, no
    real offset launch), half ones the float32 offset kernel on their
    promotion, integer ones the float64 offset kernel; pivots equal the
    single-device ``lu``'s at the same width, and the solves (N, T, H)
    meet their residual gates."""
    need_cuda()
    mesh = _one_rank_world()
    try:
        rng = np.random.default_rng(42)
        n, w = 640, 128
        cfg = rt.LUConfig(panel_width=w, small_threshold=0)
        cases = [
            (torch.complex64, rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))),
            (torch.complex128, rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))),
            (torch.bfloat16, rng.standard_normal((n, n)) + n * np.eye(n)),
            (torch.float16, rng.standard_normal((n, n)) + n * np.eye(n)),
            (torch.int32, rng.integers(-100, 100, (n, n))),
        ]
        for dt, M in cases:
            A = torch.tensor(M, device="cuda").to(dt)
            cplx = dt.is_complex
            counts = (offset_panel_factor_cuda.counts.launches,
                      offset_panel_factor_c64_cuda.counts.launches)
            F = rt.tp_lu(A, mesh, "tp", w)
            torch.cuda.synchronize()
            got = (offset_panel_factor_cuda.counts.launches - counts[0],
                   offset_panel_factor_c64_cuda.counts.launches - counts[1])
            assert got == ((0, n // w) if cplx else (n // w, 0)), (dt, got)
            want = torch.float64 if dt == torch.int32 else dt
            assert F.factors.dtype == want and int(F.info) == 0
            G = rt.lu(A, config=cfg)
            assert torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p), dt
            work = F.factors.to(torch.complex128 if cplx else torch.float64)
            L = torch.tril(work, -1) + torch.eye(n, dtype=work.dtype, device="cuda")
            Aw = A.to(work.dtype)
            # the factors' own precision: half, the complex type's, float64
            eps = torch.finfo(F.factors.real.dtype if cplx else F.factors.dtype).eps
            r = float((L @ torch.triu(work) - Aw[F.p.long()]).abs().max())
            assert r < 20 * n * eps * float(Aw.abs().max()), (dt, r)
            b = torch.tensor(rng.standard_normal(n), device="cuda").to(F.factors.dtype)
            for t in ("N", "T", "H"):
                x = rt.tp_lu_solve(F, b, mesh, "tp", w, trans=t)
                op = {"N": Aw, "T": Aw.T, "H": Aw.mH}[t]
                res = float((op @ x.to(work.dtype) - b.to(work.dtype)).abs().max())
                assert x.dtype == F.factors.dtype and res < 1e-1, (dt, t, res)
    finally:
        dist.destroy_process_group()


def test_full_precision_under_the_current_tf32_api_on_the_card():
    """With ``fp32_precision = 'tf32'`` set by the caller, ``lu`` +
    ``lu_solve`` on the card run every matmul and triangular solve under
    ``'ieee'`` (no TF32 product: the residual stays under the float32 gate)
    and the caller's setting comes back."""
    need_cuda()
    from torch.overrides import TorchFunctionMode

    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    before = (mm.fp32_precision, conv.fp32_precision)
    seen = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm,
                        torch.linalg.solve_triangular):
                seen.append(mm.fp32_precision)
            return func(*args, **(kwargs or {}))

    try:
        mm.fp32_precision = "tf32"
        conv.fp32_precision = "tf32"
        g = torch.Generator().manual_seed(5)
        n = 1536
        A = torch.randn(n, n, generator=g).cuda()
        b = torch.randn(n, generator=g).cuda()
        with Watch():
            F = rt.lu(A)
            x = rt.lu_solve(F, b)
            torch.cuda.synchronize()
        assert seen and set(seen) == {"ieee"}
        assert (mm.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
        r = float((F.L.double() @ F.U.double() - A.double()[F.p.long()]).abs().max())
        assert r < 20 * n * torch.finfo(torch.float32).eps * float(A.abs().max())
        assert float((A.double() @ x.double() - b.double()).abs().max()) < 1e-2
    finally:
        mm.fp32_precision, conv.fp32_precision = before


def test_integer_matrices_run_the_float64_kernels():
    """An int32 matrix and an int32 batch factor on the float64 kernels
    (the panel kernel, the batched swap kernel and solve), bitwise as
    their float64 copies do."""
    need_cuda()
    rng = np.random.default_rng(43)
    A = torch.tensor(rng.integers(-100, 100, (1536, 1536)), dtype=torch.int32, device="cuda")
    k0 = panel_factor_cuda.counts.launches
    F = rt.lu(A)
    x = rt.lu_solve(F, torch.arange(1536, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.launches - k0 == 3
    assert F.factors.dtype == x.dtype == torch.float64
    G = rt.lu(A.double())
    assert torch.equal(F.factors, G.factors) and torch.equal(F.p, G.p)
    Ab = torch.tensor(rng.integers(-100, 100, (1000, 16, 16)), dtype=torch.int32, device="cuda")
    bb = torch.tensor(rng.integers(-100, 100, (1000, 16)), dtype=torch.int32, device="cuda")
    f, ipiv, info = rt.batched_lu_factor(Ab)
    xb = rt.batched_lu_solve(f, ipiv, bb)
    f2, ipiv2, info2 = rt.batched_lu_factor(Ab.double())
    assert f.dtype == xb.dtype == torch.float64
    assert torch.equal(f, f2) and torch.equal(ipiv, ipiv2) and torch.equal(info, info2)
    assert torch.equal(xb, rt.batched_lu_solve(f2, ipiv2, bb.double()))


def test_warmup_builds_and_runs_on_the_card(tmp_path):
    need_cuda()
    from recursivefactorization_jl_tpu_torch.utils import profiling, warmup

    warmup.warmup(((256, 256), (300, 200)), (torch.float32, torch.complex64, torch.int32))
    A = torch.randn(512, 512, device="cuda")
    best, F = profiling.timed(lambda M: rt.lu(M), A, reps=2)
    assert best > 0 and F.factors.is_cuda
    stats = profiling.marginal_time_stats(lambda M: rt.lu(M), A, k1=1, k2=3, reps=2)
    assert stats["time_s"] > 0 and stats["k2"] == 3
    with profiling.trace(str(tmp_path)):
        rt.lu(A)
    assert (tmp_path / profiling.TRACE_FILE).is_file()


# ---- the chain kernel's one-column look-ahead ------------------------------
#
# csrc/panel_cluster.cuh `panel_chain_kernel` defers most of a step's update
# behind the next candidate exchange and brings the rows that step publishes
# up to date first.  These panels put the pivots on those rows, at the
# benchmark cells' plans (f32 4096 x 512 at b 16, C 16; 8192 x 512 at b 8,
# C 16) and on the live rows of an n = 8192 lu; every result bitwise.


def _plain_for(dtype):
    return unblocked_lu_cabs1 if dtype.is_complex else unblocked_lu


def _factor_for(dtype):
    return panel_factor_c64_cuda if dtype.is_complex else panel_factor_cuda


def _check_chain(A, pivot=True, block=0, cluster=0):
    """Factor A on the card with (block, cluster); bitwise against the
    plain version, NaN for NaN.  Returns the launch's look-ahead chains."""
    m, w = A.shape
    f, piv, perm, info = _plain_for(A.dtype)(A, pivot)
    P = A.clone()
    fn = _factor_for(A.dtype)
    n0 = fn.counts.lookahead_chain_launches
    kpiv, kperm, kinfo = fn(P, pivot, block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    if A.is_complex():
        assert _same_bits_nan(torch.view_as_real(P), torch.view_as_real(f))
    else:
        assert _same_bits_nan(P, f)
    return fn.counts.lookahead_chain_launches - n0


_CELL_PLANS = [((4096, 512), 16, 16), ((8192, 512), 8, 16)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,block,cluster", _CELL_PLANS)
def test_lookahead_chain_at_the_cells_plans(shape, block, cluster, kind):
    """The cells' plans, on random panels and on pivots at the published
    rows: every winner row gk itself, winners on CTA boundaries, one row its
    CTA's candidate in many steps running.  Every chain launch takes the
    look-ahead (C = 16)."""
    need_cuda()
    m, w = shape
    A = lookahead_panel(kind, m, w, cluster)
    plan = panel_plan(m, w, torch.float32, block=block, cluster=cluster)
    assert _check_chain(A.cuda(), block=block, cluster=cluster) == plan["blocks"]
    assert plan == panel_plan(m, w, torch.float32)  # the launcher's own choice


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookahead_chain_on_the_live_rows_of_an_n8192_lu(dtype):
    """The panels of an n = 8192 lu (8192 - 512 k live rows, 512 columns) on
    their own plans: b 8 above 4096 rows, 16 at 2048-4096, 32 below (float64:
    16 at 4096 only)."""
    need_cuda()
    g = torch.Generator().manual_seed(41)
    for rows in range(8192, 0, -512):
        A = torch.randn(rows, 512, generator=g, dtype=dtype).cuda()
        plan = panel_plan(rows, 512, dtype)
        got = _check_chain(A)
        assert got == (plan["blocks"] if plan["cluster"] > 1 else 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64, torch.complex128])
def test_lookahead_chain_other_elements_at_4096(dtype, kind):
    need_cuda()
    m, w = 4096, 512
    plan = panel_plan(m, w, dtype)
    A = lookahead_panel(kind, m, w, plan["cluster"], dtype)
    assert _check_chain(A.cuda()) == plan["blocks"]


@pytest.mark.parametrize("where", ["middle", "boundary", "last_row", "published"])
def test_lookahead_chain_complex_nan_candidate(where):
    """A NaN candidate makes the pivot row m - 1, published after the
    exchange: up to date in its look-ahead column too, whether row m - 1
    took the deferred update early or not."""
    need_cuda()
    m, w = 4096, 512
    C = panel_plan(m, w, torch.complex64)["cluster"]
    A = lookahead_panel("repeat", m, w, C, torch.complex64, seed=2)
    rows = -(-m // C)
    row = {"middle": 1500, "boundary": 2 * rows - 1, "last_row": m - 1,
           "published": 3 * rows}[where]
    A[row, 20] = complex(float("nan"), 1.0)
    _check_chain(A.cuda())


def test_lookahead_counters_on_every_wrapper_and_in_an_lu(monkeypatch):
    """`.counts.lookahead_chain_launches` counts the chain launches of a C > 1
    plan on every wrapper of panel_chain_kernel, none on a C = 1 plan or on
    the grid route; in an eager lu at n = 4096 and 8192 every chain launch
    takes it."""
    need_cuda()
    g = torch.Generator().manual_seed(43)
    A = torch.randn(1536, 512, generator=g).cuda()
    cases = [
        (panel_factor_cuda, lambda P: panel_factor_cuda(P, True), panel_plan(1536, 512,
                                                                            torch.float32)),
        (panel_factor_cuda, lambda P: panel_factor_cuda(P, True, block=32, cluster=1),
         panel_plan(1536, 512, torch.float32, block=32, cluster=1)),
        (panel_factor_cuda, lambda P: panel_factor_cuda(P, True, block=-1),
         panel_plan(1536, 512, torch.float32, block=-1)),
        (panel_factor_cuda, lambda P: panel_factor_cuda(P, True, precision="bf16x3"),
         bf16x3_plan(1536, 512)),
        (offset_panel_factor_cuda, lambda P: offset_panel_factor_cuda(P, 1000, True),
         panel_plan(1536, 512, torch.float32, ofs=1000)),
        (panel_factor_shadow_cuda, lambda P: panel_factor_shadow_cuda(P, True, 32),
         micro_plan(1536, 512, torch.float32, 32)),
        (panel_factor_basic_cuda, lambda P: panel_factor_basic_cuda(P, True, 32),
         micro_plan(1536, 512, torch.float32, 32, "basic")),
    ]
    for fn, call, plan in cases:
        n0 = fn.counts.lookahead_chain_launches
        call(A.clone())
        torch.cuda.synchronize()
        want = (plan["blocks"] - plan.get("grid_blocks", 0)
                if plan["route"] == "cluster" and plan["cluster"] > 1 else 0)
        assert fn.counts.lookahead_chain_launches - n0 == want, (plan, want)
    Z = (A[:, :256] + 1j * A[:, 256:]).to(torch.complex64)
    for fn, call in ((panel_factor_c64_cuda, lambda: panel_factor_c64_cuda(Z.clone(), True)),
                     (offset_panel_factor_c64_cuda,
                      lambda: offset_panel_factor_c64_cuda(Z.clone(), 0, True))):
        n0 = fn.counts.lookahead_chain_launches
        call()
        blocks = panel_plan(1536, 256, torch.complex64)["blocks"]
        assert fn.counts.lookahead_chain_launches - n0 == blocks
    from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod

    # the lu's panels: a spy in the wrapper's place records their shapes;
    # the wrapper counts on the name it is called by, the spy
    shapes = []
    real = panel_mod.panel_factor_cuda

    def spy(P, *args, **kw):
        shapes.append(tuple(P.shape))
        return real(P, *args, **kw)

    spy.counts = panel_mod.LaunchCounts()
    monkeypatch.setattr(panel_mod, "panel_factor_cuda", spy)
    warmup.clear_caches()  # eager calls, through the wrappers
    for n in (4096, 8192):
        M = torch.randn(n, n, generator=g).cuda()
        shapes.clear()
        n0 = spy.counts.lookahead_chain_launches
        rt.lu(M, device="cuda")
        torch.cuda.synchronize()
        plans = [panel_plan(m, w, torch.float32) for m, w in shapes]
        assert shapes, "the lu called no panel kernel"
        assert all(p["route"] == "cluster" and p["cluster"] > 1 for p in plans), (shapes, plans)
        assert spy.counts.lookahead_chain_launches - n0 == sum(p["blocks"] for p in plans), shapes


# ---- the chain's exchange on per-parity mbarriers --------------------------
#
# On a cluster of C > 1 panel_chain_kernel's step waits on its CTA's mbarrier
# until the bytes that chain_exchange_bytes counts have landed (a count that
# disagrees traps).  These panels put the count where it is easiest to get
# wrong: heights that are no multiple of C x rows (at 45 rows and C = 16 one
# CTA holds no row), CTAs that run out of live rows inside a block, every b
# and C, every element type, with and without pivoting; every result bitwise.

_EXCHANGE_SHAPES = ((45, 40), (301, 100))


def _exchange_panel(m, w, dtype, pivot, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(m, w, generator=g, dtype=dtype)
    if not pivot:
        A += m * torch.eye(m, w, dtype=dtype)
    A[:, 7] = 0
    return A.cuda()


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("block", [8, 16, 32, 64])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_mbarrier_exchange_on_ragged_heights(dtype, pivot, block, cluster):
    need_cuda()
    fn = _factor_for(dtype)
    for m, w in _EXCHANGE_SHAPES:
        A = _exchange_panel(m, w, dtype, pivot, 61)
        plan = panel_plan(m, w, dtype, block=block, cluster=cluster)
        assert plan["route"] == "cluster" and plan["cluster"] == cluster, plan
        n0 = fn.counts.lookahead_chain_launches
        assert _check_chain(A, pivot, block, cluster) == plan["blocks"]
        assert fn.counts.lookahead_chain_launches - n0 == plan["blocks"]


@pytest.mark.parametrize("where", ["first", "boundary", "last_row"])
@pytest.mark.parametrize("cluster", [2, 16])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_mbarrier_exchange_complex_nan_candidate_on_a_ragged_height(dtype, cluster, where):
    """A NaN candidate (pivot row m - 1, published after the exchange behind
    a cluster barrier) on a height that is no multiple of C x rows."""
    need_cuda()
    m, w = 301, 100
    rows = -(-m // cluster)
    A = _exchange_panel(m, w, dtype, True, 62).cpu()
    row = {"first": 3, "boundary": rows - 1, "last_row": m - 1}[where]
    A[row, 20] = complex(float("nan"), 1.0)
    _check_chain(A.cuda(), True, 16, cluster)


@pytest.mark.parametrize("ofs", [0, 1000, 3968])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_mbarrier_exchange_offset_kernel(dtype, ofs):
    """The offset kernel (the panel of tp_lu) at 4096 x 128: bitwise against
    its plain version, every chain launch of a C > 1 plan on the mbarrier
    exchange (at ofs 3968, 128 live rows, one CTA: none)."""
    need_cuda()
    H, w = 4096, 128
    g = torch.Generator().manual_seed(63)
    A = torch.randn(H, w, generator=g, dtype=dtype).cuda()
    cplx = dtype.is_complex
    plain = offset_panel_lu_cabs1 if cplx else offset_panel_lu
    fn = offset_panel_factor_c64_cuda if cplx else offset_panel_factor_cuda
    f, piv, perm, info = plain(A, ofs, True)
    P = A.clone()
    n0 = fn.counts.lookahead_chain_launches
    kpiv, kperm, kinfo = fn(P, ofs, True)
    torch.cuda.synchronize()
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    if cplx:
        assert _same_bits_nan(torch.view_as_real(P), torch.view_as_real(f))
    else:
        assert _same_bits_nan(P, f)
    plan = panel_plan(H, w, dtype, ofs=ofs)
    want = plan["blocks"] if plan["cluster"] > 1 else 0
    assert fn.counts.lookahead_chain_launches - n0 == want
    assert (want == 0) == (ofs == 3968)


def test_mbarrier_exchange_counter_in_an_lu_and_on_one_cta():
    """`.counts.lookahead_chain_launches` counts every chain launch of a C > 1
    plan, each on the mbarrier exchange: in an eager lu at n = 4096, each
    panel's chain launches (the count and the launches by plan agree); none
    on a C = 1 panel."""
    need_cuda()
    g = torch.Generator().manual_seed(64)
    fn = panel_factor_cuda
    n0 = fn.counts.lookahead_chain_launches
    fn(torch.randn(1536, 512, generator=g).cuda(), True, block=32, cluster=1)
    torch.cuda.synchronize()
    assert fn.counts.lookahead_chain_launches == n0
    M = torch.randn(4096, 4096, generator=g).cuda()
    warmup.clear_caches()  # eager calls, through the wrappers
    by_plan = dict(fn.counts.chain_launches_by_plan)
    rt.lu(M, device="cuda")
    torch.cuda.synchronize()
    grown = {k: v - by_plan.get(k, 0) for k, v in fn.counts.chain_launches_by_plan.items()
             if v > by_plan.get(k, 0)}
    assert grown and all(c > 1 for _, _, c in grown)
    assert fn.counts.lookahead_chain_launches - n0 == sum(grown.values())


# ---- one block of look-ahead: the next chain takes the pass at load --------
#
# run_cluster (csrc/panel_cluster.cuh) folds block j's delayed pass in block
# j + 1's columns into chain j + 1's load and runs the rest of it on a second
# branch beside that chain.  Every cluster-route instantiation against its
# plain version (the oracle: nothing forces the old schedule), at the cells'
# plans and at ragged heights, on random panels and on pivots in the next
# block's rows; `.counts.carried_update_launches` against tests/plan_rules.py's
# mirror of the engagement rule.


def _carry_case(dtype, m, w, b, C, kind):
    if kind == "next":
        return next_block_panel(m, w, b, dtype)
    return lookahead_panel(kind, m, w, C, dtype)


def _check_carry(fn, call, A, want):
    """``call(P)`` factors a copy P of A on the card with wrapper ``fn``;
    bitwise (NaN for NaN) against ``want = (factors, piv, perm, info)``.
    Returns the launch's carried chain launches."""
    P = A.clone()
    n0 = fn.counts.carried_update_launches
    kpiv, kperm, kinfo = call(P)
    torch.cuda.synchronize()
    f, piv, perm, info = want
    assert torch.equal(kpiv, piv) and torch.equal(kperm, perm) and int(kinfo) == int(info)
    if A.is_complex():
        assert _same_bits_nan(torch.view_as_real(P), torch.view_as_real(f))
    else:
        assert _same_bits_nan(P, f)
    return fn.counts.carried_update_launches - n0


@pytest.mark.parametrize("kind", ["randn", "next"])
@pytest.mark.parametrize("m,w", [(4096, 512), (2048, 512), (301, 100), (45, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_carry_on_every_element_on_its_own_plan(dtype, m, w, kind):
    """The launcher's own plan: every chain but the panel's first takes the
    previous block's pass where the rule says so (all of them at 512
    columns), and the factors, pivots, perm and info are the plain
    version's."""
    need_cuda()
    plan = panel_plan(m, w, dtype)
    b, C = plan["block"], plan["cluster"]
    A = _carry_case(dtype, m, w, b, C, kind).cuda()
    fn = _factor_for(dtype)
    got = _check_carry(fn, lambda P: fn(P, True), A, _plain_for(dtype)(A, True))
    assert got == carried_blocks(str(dtype)[6:], m, w, b, C)
    if w == 512:
        assert got == plan["blocks"] - 1


@pytest.mark.parametrize("kind", list(KINDS) + ["next"])
@pytest.mark.parametrize("shape,block,cluster", _CELL_PLANS)
def test_carry_at_the_cells_plans(shape, block, cluster, kind):
    need_cuda()
    m, w = shape
    A = _carry_case(torch.float32, m, w, block, cluster, kind).cuda()
    got = _check_carry(panel_factor_cuda,
                       lambda P: panel_factor_cuda(P, True, block=block, cluster=cluster), A,
                       unblocked_lu(A, True))
    assert got == w // block - 1


@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
@pytest.mark.parametrize("block", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_carry_on_ragged_heights_at_every_plan(dtype, block, cluster):
    """Heights that are no multiple of C x rows, ragged last blocks, without
    pivoting too; b = 64 is past the carry's lanes and keeps the passes in
    turn."""
    need_cuda()
    for (m, w), pivot in (((301, 100), True), ((301, 100), False), ((45, 40), True)):
        A = _exchange_panel(m, w, dtype, pivot, seed=block + cluster)
        got = _check_carry(panel_factor_cuda, lambda P: panel_factor_cuda(
            P, pivot, block=block, cluster=cluster), A, unblocked_lu(A, pivot))
        assert got == carried_blocks(str(dtype)[6:], m, w, block, cluster)
        assert (got == 0) == (block >= 64 or block >= w)


@pytest.mark.parametrize("variant", ["shadow", "basic"])
@pytest.mark.parametrize("micro", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_carry_on_the_micro_blocked_kernels(dtype, micro, variant):
    """The sum-first update keeps micro_blocked_lu's order in the next
    chain's columns too."""
    need_cuda()
    fn = panel_factor_shadow_cuda if variant == "shadow" else panel_factor_basic_cuda
    for (m, w), kind in (((1536, 512), "next"), ((1536, 512), "randn"), ((301, 100), "randn")):
        plan = micro_plan(m, w, dtype, micro, variant)
        A = _carry_case(dtype, m, w, micro, plan["cluster"], kind).cuda()
        got = _check_carry(fn, lambda P: fn(P, True, micro), A, micro_blocked_lu(A, True, micro))
        assert got == carried_blocks(str(dtype)[6:], m, w, micro, plan["cluster"],
                                     form="sum_first", grid_blocks=plan["grid_blocks"])
        assert (got > 0) == (micro <= 32)


@pytest.mark.parametrize("kind", ["randn", "next"])
@pytest.mark.parametrize("ofs", [0, 1000, 3968])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_carry_on_the_offset_kernels(dtype, ofs, kind):
    """The offset form from row ofs: global pivot rows, the rows above
    untouched."""
    need_cuda()
    H, w = 4096, 128
    plan = panel_plan(H, w, dtype, ofs=ofs)
    b, C = plan["block"], plan["cluster"]
    g = torch.Generator().manual_seed(ofs + 5)
    A = torch.randn(H, w, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        A = torch.complex(A, torch.randn(H, w, generator=g, dtype=torch.float64))
    A = A.to(dtype)
    A[ofs:] = _carry_case(dtype, H - ofs, w, b, C, kind)
    A = A.cuda()
    fn = offset_panel_factor_c64_cuda if dtype.is_complex else offset_panel_factor_cuda
    plain = offset_panel_lu_cabs1 if dtype.is_complex else offset_panel_lu
    want = plain(A, ofs, True)
    got = _check_carry(fn, lambda P: fn(P, ofs, True), A, want)
    assert got == carried_blocks(str(dtype)[6:], H - ofs, w, b, C) == w // b - 1


def test_carry_counter_in_an_lu_and_zero_where_the_rule_says():
    """In an eager lu at n = 4096 and 8192 every chain but each panel's
    first takes the previous block's pass (200 and 704 a call, the cells'
    keys); none in the bf16x3 form, on grid-chain blocks or on one-block
    plans."""
    need_cuda()
    g = torch.Generator().manual_seed(71)
    A = torch.randn(1536, 512, generator=g).cuda()
    for fn, call, X in (
            (panel_factor_cuda, lambda P: panel_factor_cuda(P, True, precision="bf16x3"), A),
            (panel_factor_cuda, lambda P: panel_factor_cuda(P, True, block=64, cluster=4),
             A[:300, :64]),
            (panel_factor_shadow_cuda, lambda P: panel_factor_shadow_cuda(P, True, 32,
                                                                          _chain="grid"), A),
            (panel_factor_basic_cuda, lambda P: panel_factor_basic_cuda(P, True, 16,
                                                                        _chain="grid"), A)):
        n0 = fn.counts.carried_update_launches
        call(X.clone())
        torch.cuda.synchronize()
        assert fn.counts.carried_update_launches == n0
    # panels whose slab leaves no room for the carry beside it (past ~47 000
    # float32 rows at b 8, C 16) keep the passes in turn; below, every block
    for m in (60000, 40000):
        T = torch.randn(m, 512, generator=g).cuda()
        plan = panel_plan(m, 512, torch.float32)
        got = _check_carry(panel_factor_cuda, lambda P: panel_factor_cuda(P, True), T,
                           unblocked_lu(T, True))
        assert got == carried_blocks("float32", m, 512, plan["block"], plan["cluster"])
        assert got == (0 if m == 60000 else plan["blocks"] - 1)
    warmup.clear_caches()  # eager calls, through the wrappers
    for n in (4096, 8192):
        M = torch.randn(n, n, generator=g).cuda()
        n0 = panel_factor_cuda.counts.carried_update_launches
        rt.lu(M, device="cuda")
        torch.cuda.synchronize()
        assert panel_factor_cuda.counts.carried_update_launches - n0 == \
            CARRIED_PER_CALL[("float32", n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warmed_lu_at_4096_replays_bitwise_twenty_times(no_programs, dtype):
    """The race check between the graph's two branches (each far part beside
    the next chain): a warmed lu + lu_solve at n = 4096 replayed 20 times,
    every replay bit for bit the eager call, which carried every chain but
    each panel's first (200 / 136 a call)."""
    n = 4096
    g = torch.Generator(device="cuda").manual_seed(2147483701)
    A = torch.rand(n, n, generator=g, device="cuda", dtype=dtype) - 0.5
    b = torch.rand(n, generator=g, device="cuda", dtype=dtype) - 0.5
    n0 = panel_factor_cuda.counts.carried_update_launches
    eager = rt.lu(A, check=False)
    xe = rt.lu_solve(eager, b)
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.carried_update_launches - n0 == \
        CARRIED_PER_CALL[(str(dtype)[6:], n)]
    warmup.warmup(((n, n),), (dtype,))
    r0 = _replays()
    for _ in range(20):
        F = rt.lu(A, check=False)
        x = rt.lu_solve(F, b)
        torch.cuda.synchronize()
        assert _same_results(_lu_outputs(F), _lu_outputs(eager)) and _same_results([x], [xe])
    assert _replays() - r0 == 40


# ---- panel_boundary_precision='bf16x3' ---------------------------------------


def _split_reference(C, L, U):
    """``C - (hh + hl + lh)`` in float64 (each product of two bf16 values is
    exact there) and the sum of the three products' magnitudes."""
    def split(X):
        h = X.to(torch.bfloat16)
        return h.double(), (X - h.float()).to(torch.bfloat16).double()

    lh, ll = split(L)
    uh, ul = split(U)
    ref = C.double() - (lh @ uh + lh @ ul + ll @ uh)
    mag = lh.abs() @ uh.abs() + lh.abs() @ ul.abs() + ll.abs() @ uh.abs()
    return ref, mag


@pytest.mark.parametrize("nb", [1, 8, 16, 20, 32, 64])
@pytest.mark.parametrize("rows,cols", [(1, 1), (100, 37), (300, 200)])
def test_bf16x3_update_within_its_accumulation_bound(nb, rows, cols):
    """The tensor-core update alone against the exact sum of its three split
    products: within 2^-24 ((nb + 2) * sum |products| + |result|) everywhere
    (the bound chip_smoke.py's phase 2g prints the worst ratio to), on
    views whose row strides exceed their widths; nothing else written."""
    need_cuda()
    g = torch.Generator().manual_seed(nb * 1000 + rows)
    big = torch.randn(rows + nb + 3, cols + nb + 5, generator=g).cuda()
    C = big[nb:nb + rows, nb:nb + cols]
    L = big[nb:nb + rows, :nb]
    U = big[:nb, nb:nb + cols]
    ref, mag = _split_reference(C, L, U)
    before = big.clone()
    k0 = panel_update_bf16x3_cuda.counts.launches
    assert panel_update_bf16x3_cuda(C, L, U) is C
    torch.cuda.synchronize()
    assert panel_update_bf16x3_cuda.counts.launches == k0 + 1
    bound = 2.0 ** -24 * ((nb + 2) * mag + ref.abs())
    assert bool(((C.double() - ref).abs() <= bound).all())
    outside = torch.ones_like(big, dtype=torch.bool)
    outside[nb:nb + rows, nb:nb + cols] = False
    assert torch.equal(big[outside], before[outside])


def test_bf16x3_update_inf_and_nan_as_the_plain_version():
    """An inf in L or U makes its low half NaN: the kernel's NaN entries are
    the plain version's, and the finite ones agree to the bf16x3 class."""
    need_cuda()
    g = torch.Generator().manual_seed(3)
    L, U, C = (torch.randn(*s, generator=g).cuda() for s in ((50, 16), (16, 40), (50, 40)))
    L[3, 2] = float("inf")
    U[5, 7] = float("-inf")
    C[9, 9] = float("nan")
    plain = C - schur_product(L, U, "bf16x3")
    panel_update_bf16x3_cuda(C, L, U)
    assert torch.equal(torch.isnan(C), torch.isnan(plain))
    assert int(torch.isnan(C).sum()) == 40 + 50 - 1 + 1  # row 3, column 7, C[9, 9]
    assert float((C - plain).nan_to_num(0).abs().max()) < 1e-5


# (rows, cols, pad): C, L and U are views of one matrix of row stride
# 64 + cols + pad; with a row stride and nb that are multiples of 4 every
# operand lies on 16 bytes (the panel's case), pad 3 puts rows off them;
# the shapes take each of the plan's four tiles (64 or 128 rows, 16 or 32
# columns)
_UPDATE_LAYOUTS = [(1, 1, 0), (1, 300, 0), (300, 1, 3), (33, 4065, 3), (4065, 33, 3),
                   (1000, 300, 0), (1000, 300, 3), (2049, 96, 0), (4065, 17, 0)]


def _update_views(X, rows, cols, nb):
    return X[64:, 64:64 + cols], X[64:, 64 - nb:64], X[64 - nb:64, 64:64 + cols]


@pytest.mark.parametrize("nb", [1, 8, 16, 20, 32, 64])
@pytest.mark.parametrize("rows,cols,pad", _UPDATE_LAYOUTS)
def test_bf16x3_tiled_update_bitwise_equals_the_simple_kernel(nb, rows, cols, pad):
    """The tiled update runs the simple kernel's products in the simple
    kernel's order: bit for bit its result, ragged, on 16-byte rows and off
    them; nothing outside C written; each launch counted, the simple
    kernel's apart."""
    need_cuda()
    g = torch.Generator().manual_seed(7 * nb + rows + cols)
    big = torch.randn(rows + 64, 64 + cols + pad, generator=g).cuda()
    simple, X = big.clone(), big.clone()
    c = panel_update_bf16x3_cuda.counts
    k0, s0 = c.launches, c.simple_launches
    panel_update_bf16x3_cuda(*_update_views(simple, rows, cols, nb), _update="simple")
    panel_update_bf16x3_cuda(*_update_views(X, rows, cols, nb))
    torch.cuda.synchronize()
    assert torch.equal(_bits(X), _bits(simple))
    outside = torch.ones_like(big, dtype=torch.bool)
    outside[64:, 64:64 + cols] = False
    assert torch.equal(X[outside], big[outside])
    assert panel_update_bf16x3_cuda.counts.launches == k0 + 2
    assert panel_update_bf16x3_cuda.counts.simple_launches == s0 + 1


def test_bf16x3_tiled_update_inf_and_nan_as_the_simple_kernel():
    """An inf in L or U (its low half NaN) and a NaN in C: the tiled
    kernel's NaN entries are the plain version's, and its bits the simple
    kernel's."""
    need_cuda()
    g = torch.Generator().manual_seed(5)
    L, U, C = (torch.randn(*s, generator=g).cuda() for s in ((130, 32), (32, 70), (130, 70)))
    L[3, 2] = float("inf")
    U[5, 7] = float("-inf")
    C[99, 9] = float("nan")
    plain = C - schur_product(L, U, "bf16x3")
    S = C.clone()
    panel_update_bf16x3_cuda(C, L, U)
    panel_update_bf16x3_cuda(S, L, U, _update="simple")
    assert torch.equal(torch.isnan(C), torch.isnan(plain))
    assert torch.equal(_bits(C), _bits(S))


@pytest.mark.parametrize("rows,cols,nb,want", [
    (1504, 480, 32, (64, 32, 32, (24, 15))),    # the 1536 panel's first boundary
    (1504, 32, 32, (64, 16, 32, (24, 2))),      # its last
    (4064, 480, 32, (128, 32, 32, (32, 15))),
    (8160, 32, 32, (128, 16, 32, (64, 2))),
    (2048, 33, 1, (64, 32, 16, (32, 2))),
    (2049, 1, 17, (128, 16, 32, (17, 1))),
    (1, 1, 48, (64, 16, 48, (1, 1))),
    (63, 4065, 64, (64, 32, 64, (1, 128))),
])
def test_bf16x3_update_plan(rows, cols, nb, want):
    """The tiled update's tile (csrc/panel_cluster.cuh `tile_plan`): 16
    columns for at most 32, else 32; 128 rows past 2048, else 64; K padded
    to 16; a warp per 16 tile rows."""
    need_cuda()
    tm, tn, kp, grid = want
    assert bf16x3_update_plan(rows, cols, nb) == dict(tm=tm, tn=tn, kp=kp, grid=grid,
                                                      threads=2 * tm)


@pytest.mark.parametrize("shape,b,kind", [
    ((1536, 512), 32, "randn"),
    ((4096, 512), 32, "ties"),
    ((1000, 100), 20, "randn"),            # ragged last block
    ((64, 200), 16, "randn"),              # fat: columns past the last step
    ((100, 40), 7, "nan"),
    ((300, 64), 16, "unpivoted"),
    ((33, 33), 1, "randn"),
    ((513, 513), 32, "zero_col"),
    ((200, 96), 64, "randn"),              # two blocks: one boundary
])
def test_bf16x3_tiled_panel_bitwise_equals_the_simple_update(shape, b, kind):
    """A bf16x3 panel on the tiled update kernel is bit for bit the panel
    on the simple one (factors, piv, perm, info), with the launches
    bf16x3_updates lists, counted apart where forced onto the simple
    kernel."""
    need_cuda()
    g = torch.Generator().manual_seed(sum(shape) + b)
    A = torch.randn(*shape, generator=g)
    if kind == "ties":
        A = torch.randint(-2, 3, shape, generator=g).float()
    if kind == "zero_col":
        A[:, 100] = 0
    if kind == "nan":
        A[30, 9] = float("nan")
    if kind == "unpivoted":
        A += max(shape) * torch.eye(*shape)
    A = A.cuda()
    pivot = kind != "unpivoted"
    want = len(bf16x3_updates(*shape, b))
    outs = {}
    for upd in ("tiled", "simple"):
        P = A.clone()
        u0 = panel_factor_cuda.counts.bf16x3_update_launches
        s0 = panel_factor_cuda.counts.bf16x3_simple_update_launches
        got = panel_factor_cuda(P, pivot, block=b, precision="bf16x3", _update=upd)
        torch.cuda.synchronize()
        assert panel_factor_cuda.counts.bf16x3_update_launches - u0 == want
        assert panel_factor_cuda.counts.bf16x3_simple_update_launches - s0 == (
            want if upd == "simple" else 0)
        outs[upd] = (P, *got)
    for x, y in zip(outs["tiled"], outs["simple"]):
        assert torch.equal(_bits(x), _bits(y))


def test_bf16x3_update_kernel_refusals():
    need_cuda()
    P = torch.randn(64, 64, device="cuda")
    with pytest.raises(ValueError):
        panel_factor_cuda(P, True, block=16, precision="bf16x3", _update="wgmma")
    C, L, U = torch.zeros(8, 8, device="cuda"), torch.zeros(8, 4, device="cuda"), \
        torch.zeros(4, 8, device="cuda")
    for bad in ("plain", None, (64, 32)):
        with pytest.raises(ValueError):
            panel_update_bf16x3_cuda(C, L, U, _update=bad)


def _first_choice_gap(A, pa, pb):
    """Two pivot sequences of one panel part at step k: eliminate k steps in
    float64 with the pivots they share; the two candidates' gap relative
    to the column's maximum."""
    k = int((pa != pb).nonzero()[0])
    M = A.double().clone()
    for j in range(k):
        pj = int(pa[j])
        M[[j, pj]] = M[[pj, j]]
        M[j + 1:, j] /= M[j, j]
        M[j + 1:, j + 1:] -= torch.outer(M[j + 1:, j], M[j, j + 1:])
    c = M[:, k].abs()
    return float((c[int(pa[k])] - c[int(pb[k])]).abs() / c[k:].max())


def _panel_residual(A, f, perm):
    m, w = A.shape
    k = min(m, w)
    L = torch.tril(f[:, :k].double(), -1) + torch.eye(m, k, dtype=torch.float64, device=f.device)
    return float((L @ torch.triu(f[:k].double()) - A.double()[perm.long()]).abs().max())


# the two candidates of a step where the kernel's and the plain version's
# pivots part must tie to this (a bf16's precision, relative to the column)
BF16X3_TIE = 2.0 ** -8


def _check_bf16x3_panel(A, out, ref, ref32, pivot):
    """The kernel's bf16x3 panel against ``micro_blocked_lu(..., 'bf16x3')``
    on the card: info equal; ipiv equal, or parting at a tie; with equal
    pivots perm equal, NaN where the plain version has NaN and the factors
    within twice the knob's own effect on the same input (max |plain
    bf16x3 - plain float32|); the residual under the gate."""
    P, piv, perm, info = out
    f, rpiv, rperm, rinfo = ref
    assert int(info) == int(rinfo)
    finite = bool(torch.isfinite(A).all())
    if not torch.equal(piv, rpiv):
        assert finite and _first_choice_gap(A, piv, rpiv) <= BF16X3_TIE
    else:
        assert torch.equal(perm, rperm)
        assert torch.equal(torch.isnan(P), torch.isnan(f))
        spread = float((f - ref32).nan_to_num(0).abs().max())
        diff = float((P - f).nan_to_num(0).abs().max())
        assert diff <= 2 * spread + 2.0 ** -20 * float(f.nan_to_num(0).abs().max()), (diff, spread)
    if finite:
        m, w = A.shape
        gate = 20 * max(m, w) * torch.finfo(torch.float32).eps * float(A.abs().max())
        assert _panel_residual(A, P, perm) < (gate if pivot else 10 * gate ** 0.5)


@pytest.mark.parametrize("shape,b,pivot,kind", [
    ((300, 64), 16, True, "randn"),
    ((300, 64), 16, False, "randn"),
    ((64, 200), 16, True, "randn"),        # fat
    ((1000, 100), 20, True, "ties"),       # ragged last block
    ((513, 513), 32, True, "zero_col"),
    ((100, 40), 7, True, "nan"),
    ((1536, 512), 32, True, "randn"),
    ((4096, 512), 32, True, "randn"),
    ((4096, 256), 64, False, "randn"),
    ((1, 5), 8, True, "randn"),
    ((33, 33), 1, True, "randn"),
])
def test_bf16x3_panel_matches_plain(shape, b, pivot, kind):
    need_cuda()
    g = torch.Generator().manual_seed(sum(shape) + b)
    A = torch.randn(*shape, generator=g)
    if kind == "ties":
        A = torch.randint(-2, 3, shape, generator=g).float()
    A = A.cuda()
    if kind == "zero_col":
        A[:, 100] = 0
    if kind == "nan":
        A[30, 9] = float("nan")
    if not pivot:
        A += max(shape) * torch.eye(*shape, device="cuda")
    P = A.clone()
    c = panel_factor_cuda.counts
    k0, u0 = c.bf16x3_launches, c.bf16x3_update_launches
    out = (P, *panel_factor_cuda(P, pivot, block=b, precision="bf16x3"))
    torch.cuda.synchronize()
    m, w = shape
    bb = min(b, m, w)
    steps = min(m, w)
    # one update per block with rows below it and columns right of it
    want = sum(1 for k0_ in range(0, steps, bb)
               if m - k0_ - min(bb, steps - k0_) > 0 and w - k0_ - min(bb, steps - k0_) > 0
               and bb < w)
    assert panel_factor_cuda.counts.bf16x3_launches == k0 + 1
    assert panel_factor_cuda.counts.bf16x3_update_launches - u0 == want
    ref = micro_blocked_lu(A, pivot, b, "bf16x3")
    ref32 = micro_blocked_lu(A, pivot, b)[0]
    _check_bf16x3_panel(A, out, ref, ref32, pivot)


def test_bf16x3_one_block_is_the_float32_kernel():
    """A block that spans the panel leaves no boundary: the bf16x3 form is
    then the float32 kernel's result bit for bit, with no update launch."""
    need_cuda()
    A = torch.randn(700, 48, generator=torch.Generator().manual_seed(2)).cuda()
    P, Q = A.clone(), A.clone()
    u0 = panel_factor_cuda.counts.bf16x3_update_launches
    a = panel_factor_cuda(P, True, block=64, precision="bf16x3")
    b = panel_factor_cuda(Q, True)
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.bf16x3_update_launches == u0
    assert torch.equal(P, Q) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert bf16x3_plan(700, 48, 64)["blocks"] == 1


def test_bf16x3_panel_too_tall_for_a_cluster_factors():
    """A 40 000 x 512 panel (too tall for a cluster at 32-step blocks: every
    block's chain on the grid) and ``lu`` of a 40 000 x 512 matrix (its
    whole route: the same panel) under the knob, against
    ``micro_blocked_lu(..., 'bf16x3')`` on the card: info equal, ipiv equal
    or parting at a tie, factors in the class, the residual gate; the grid
    chain's blocks counted, no grid-route launch."""
    need_cuda()
    m, w, b = 40000, 512, 32
    plan = bf16x3_plan(m, w, b)
    assert plan["route"] == "cluster" and plan["grid_blocks"] == plan["blocks"] == 16
    assert bf16x3_plan(24000, w, b)["grid_blocks"] == 0
    assert bf16x3_plan(m, w, 8)["grid_blocks"] == 0
    A = torch.randn(m, w, generator=torch.Generator().manual_seed(4)).cuda()
    ref = micro_blocked_lu(A, True, b, "bf16x3")
    ref32 = micro_blocked_lu(A, True, b)[0]
    P = A.clone()
    c = panel_factor_cuda.counts
    k0 = (c.grid_block_launches, c.grid_route_launches)
    out = (P, *panel_factor_cuda(P, True, block=b, precision="bf16x3"))
    torch.cuda.synchronize()
    assert (c.grid_block_launches, c.grid_route_launches) == (k0[0] + 16, k0[1])
    _check_bf16x3_panel(A, out, ref, ref32, True)
    F = rt.lu(A, config=rt.LUConfig(panel_boundary_precision="bf16x3"))
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.grid_block_launches == k0[0] + 32
    _check_bf16x3_panel(A, (F.factors, F.ipiv, F.p, F.info), ref, ref32, True)


@pytest.mark.parametrize("shape,b", [((1536, 512), 32), ((4096, 512), 32), ((1000, 100), 20),
                                     ((64, 200), 16), ((513, 513), 64), ((1536, 512), 128),
                                     ((700, 300), 300)])
def test_bf16x3_grid_chain_bitwise_equals_the_cluster_chain(shape, b):
    """Every block's chain forced onto the grid on panels that fit a
    cluster: factors, piv, perm and info bit for bit the cluster chain's,
    with as many update launches; the grid chain's blocks counted."""
    need_cuda()
    g = torch.Generator().manual_seed(sum(shape) + b)
    A = torch.randn(*shape, generator=g)
    A[:, 7] = 0
    A = A.cuda()
    plan = bf16x3_plan(*shape, b)
    outs = {}
    for chain in ("auto", "grid"):
        P = A.clone()
        c = panel_factor_cuda.counts
        k0 = (c.grid_block_launches, c.bf16x3_update_launches)
        got = panel_factor_cuda(P, True, block=b, precision="bf16x3", _chain=chain)
        torch.cuda.synchronize()
        outs[chain] = (P, *got)
        assert c.grid_block_launches - k0[0] == \
            (plan["blocks"] if chain == "grid" else plan["grid_blocks"])
        assert c.bf16x3_update_launches - k0[1] == len(bf16x3_updates(*shape, b))
    for x, y in zip(outs["auto"], outs["grid"]):
        assert torch.equal(_bits(x), _bits(y))
    assert int(outs["auto"][3]) == 8


@pytest.mark.parametrize("nb", [65, 80, 128, 256])
@pytest.mark.parametrize("rows,cols,pad", [(1000, 300, 0), (1000, 300, 3), (4065, 33, 0)])
def test_bf16x3_update_past_64_steps(nb, rows, cols, pad):
    """The update through K in chunks of 64: the tiled kernel bit for bit
    the simple one, both within the class of the plain split."""
    need_cuda()
    g = torch.Generator().manual_seed(nb + rows + cols + pad)
    big = torch.randn(rows + nb, nb + cols + pad, generator=g).cuda()

    def views(X):
        return X[nb:, nb:nb + cols], X[nb:, :nb], X[:nb, nb:nb + cols]

    simple, tiled = big.clone(), big.clone()
    panel_update_bf16x3_cuda(*views(simple), _update="simple")
    panel_update_bf16x3_cuda(*views(tiled))
    torch.cuda.synchronize()
    assert torch.equal(_bits(tiled), _bits(simple))
    C, L, U = views(big)
    plain = C - schur_product(L, U, "bf16x3")
    assert float((views(tiled)[0] - plain).abs().max()) < 1e-4 * nb
    assert bf16x3_update_plan(rows, cols, nb)["kp"] == 64


@pytest.mark.parametrize("schur", ["float32", "bf16x3"])
def test_bf16x3_lu_and_solve_on_the_card(schur):
    """``lu`` + ``lu_solve`` under the knob at n = 1536 (three 512-wide
    panels of 32-step blocks): the residual gate, info, every panel on the
    bf16x3 form (15 update launches each), the pivots of the CPU's plain
    route on the same input (or a tie at the first step they part)."""
    need_cuda()
    n = 1536
    g = torch.Generator().manual_seed(12)
    A = torch.randn(n, n, generator=g)
    b = torch.randn(n, generator=g)
    cfg = rt.LUConfig(panel_boundary_precision="bf16x3", schur_precision=schur)
    c = panel_factor_cuda.counts
    k0, u0 = c.bf16x3_launches, c.bf16x3_update_launches
    F = rt.lu(A.cuda(), config=cfg)
    x = rt.lu_solve(F, b.cuda())
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.bf16x3_launches - k0 == 3
    assert panel_factor_cuda.counts.bf16x3_update_launches - u0 == 45
    assert int(F.info) == 0
    Ad = A.double().cuda()
    gate = 20 * n * torch.finfo(torch.float32).eps * float(A.abs().max())
    assert float((F.L.double() @ F.U.double() - Ad[F.p.long()]).abs().max()) < gate
    # normwise backward error of the solve (float32 gives ~1e-7 here)
    xd = x.double()
    assert float((Ad @ xd - b.double().cuda()).norm() / (Ad.norm() * xd.norm())) < 1e-4
    G = rt.lu(A, config=cfg, device="cpu")
    if not torch.equal(F.ipiv.cpu(), G.ipiv):
        k = int((F.ipiv.cpu() != G.ipiv).nonzero()[0])
        assert _first_choice_gap(A[:, :k + 1].cuda(), F.ipiv[:k + 1], G.ipiv[:k + 1].cuda()) \
            <= BF16X3_TIE


def test_bf16x3_knob_leaves_the_batched_library_loop_in_float32():
    """An unpivoted batch the batched kernel does not take runs a loop of
    ``lu_factor_p`` on the card; the knob does not reach it (the batched
    functions ignore it, as the JAX package's lane kernel does)."""
    need_cuda()
    g = torch.Generator().manual_seed(6)
    B = (torch.randn(2, 300, 300, generator=g) + 300 * torch.eye(300)).cuda()
    k0 = panel_factor_cuda.counts.bf16x3_launches
    a = rt.batched_lu_factor(B, pivot=False,
                             config=rt.LUConfig(panel_boundary_precision="bf16x3"))
    b = rt.batched_lu_factor(B, pivot=False)
    torch.cuda.synchronize()
    assert panel_factor_cuda.counts.bf16x3_launches == k0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the compiled entry points (utils/graphs.py): replays of captured programs
# ---------------------------------------------------------------------------


@pytest.fixture
def no_programs():
    """A card and an empty program cache, emptied again afterwards."""
    need_cuda()
    warmup.clear_caches()
    yield
    warmup.clear_caches()


def _replays():
    return sum(p.replays for p in graphs.programs().values())


def _card_matrix(shape, dtype, seed, shift=True):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(*shape, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        A = torch.complex(A, torch.randn(*shape, generator=g, dtype=torch.float64))
    if shift and len(shape) > 1:
        A = A + shape[-1] * torch.eye(shape[-2], shape[-1], dtype=A.dtype)
    return A.to(dtype).cuda()


def _same_results(xs, ys):
    """Each pair bitwise equal, NaN for NaN (any float, complex or
    integer type)."""
    def same(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not (x.is_floating_point() or x.is_complex()):
            return torch.equal(x, y)
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]
        nx, ny = torch.isnan(x), torch.isnan(y)
        return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0).view(ints),
                                                   y.masked_fill(ny, 0).view(ints))
    return all(same(x, y) for x, y in zip(xs, ys))


def _lu_outputs(F):
    return (F.factors, F.ipiv, F.p, F.info)


@pytest.mark.parametrize("dtype,fields", [
    (torch.float32, {}), (torch.float64, {}), (torch.complex64, {}), (torch.bfloat16, {}),
    (torch.int32, {}), (torch.float32, {"schedule": "physical"}),
    (torch.float32, {"panel_boundary_precision": "bf16x3"}),
    (torch.float32, {"panel_variant": "shadow"}),
])
def test_warmed_lu_and_lu_solve_replay_bitwise_equal_eager(no_programs, dtype, fields):
    """``warmup`` captures the factor and the vector solve of its key; the
    replays give the eager call's bits, a second input gives its own
    result, and a key that was not warmed runs eagerly."""
    n, cfg = 700, rt.LUConfig(**fields)
    A, A2 = (_card_matrix((n, n), dtype, s, shift=False) for s in (1, 2))
    eager = rt.lu(A, check=False, config=cfg)
    b = _card_matrix((n,), eager.factors.dtype, 3)
    xe = rt.lu_solve(eager, b)
    eager2 = rt.lu(A2, check=False, config=cfg)
    warmup.warmup(((n, n),), (dtype,), config=cfg)
    assert [k[0] for k in graphs.programs()] == ["lu_factor", "lu_solve"]
    r0 = _replays()
    F = rt.lu(A, check=False, config=cfg)
    x = rt.lu_solve(F, b)
    F2 = rt.lu(A2, check=False, config=cfg)
    assert _replays() - r0 == 3
    assert _same_results(_lu_outputs(F), _lu_outputs(eager)) and _same_results([x], [xe])
    assert _same_results(_lu_outputs(F2), _lu_outputs(eager2))
    assert not torch.equal(F2.factors, F.factors)
    # not warmed: another shape, another config, a matrix right-hand side
    rt.lu(A[:-1, :-1], check=False, config=cfg)
    rt.lu(A, check=False, config=rt.LUConfig(trsm_block=64, **fields))
    rt.lu_solve(F, torch.stack([b, b], 1))
    assert _replays() - r0 == 3 and len(graphs.programs()) == 2


def test_warmed_zeroed_column_checks_the_copied_info(no_programs):
    A = _card_matrix((600, 600), torch.float32, 4)
    A[:, 123] = 0
    warmup.warmup(((600, 600),), (torch.float32,))
    r0 = _replays()
    with pytest.raises(rt.SingularMatrixError):
        rt.lu(A)
    F = rt.lu(A, check=False)
    assert int(F.info) == 124 and _replays() - r0 == 2


@pytest.mark.parametrize("dtype", sorted(AUTO_PLANS))
def test_the_launchers_auto_plans_are_the_pinned_ones(dtype):
    """The compiled launcher's own (b, C) at 512 columns is tests/plan_rules.py's
    table, which a CPU test holds the header's rules to."""
    need_cuda()
    for m, want in AUTO_PLANS[dtype].items():
        plan = panel_plan(m, WIDTH, getattr(torch, dtype))
        assert plan["route"] == "cluster" and (plan["block"], plan["cluster"]) == want, (m, plan)


def test_warmed_float64_lu_at_4096_replays_bitwise_on_the_float64_rule(no_programs):
    """The float64 cell's shape: lu + lu_solve at n = 4096 after ``warmup``
    replay bit for bit the eager calls, and every chain launch the panels
    made (eagerly and while the programs were captured) was on a plan of
    the float64 rule at the live heights 4096 .. 512."""
    from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod

    n, dtype = 4096, torch.float64
    g = torch.Generator(device="cuda").manual_seed(2147483659)
    A = torch.rand(n, n, generator=g, device="cuda", dtype=dtype) - 0.5
    b = torch.rand(n, generator=g, device="cuda", dtype=dtype) - 0.5
    wrapper = panel_mod.panel_factor_cuda
    panel_mod.reset_counts()
    n0 = wrapper.counts.lookahead_chain_launches
    eager = rt.lu(A, check=False)
    xe = rt.lu_solve(eager, b)
    eager_counts = dict(wrapper.counts.chain_launches_by_plan)
    warmup.warmup(((n, n),), (dtype,))
    r0 = _replays()
    F = rt.lu(A, check=False)
    x = rt.lu_solve(F, b)
    torch.cuda.synchronize()
    assert _replays() - r0 == 2
    assert _same_results(_lu_outputs(F), _lu_outputs(eager)) and _same_results([x], [xe])
    heights = range(n, 0, -WIDTH)
    rule = {("float64",) + AUTO_PLANS["float64"][m] for m in heights}
    counts = wrapper.counts.chain_launches_by_plan
    assert eager_counts and set(counts) <= rule, counts
    # one chain launch per block of every panel, each on its own plan
    per_call = sum(-(-WIDTH // AUTO_PLANS["float64"][m][0]) for m in heights)
    assert sum(eager_counts.values()) == per_call
    assert sum(counts.values()) % per_call == 0
    assert wrapper.counts.lookahead_chain_launches - n0 == sum(counts.values())  # C > 1 everywhere


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
@pytest.mark.parametrize("trans", [0, 1, 2])
def test_captured_solves_replay_bitwise_equal_eager(no_programs, dtype, trans):
    """``lu_solve`` (N / T / H, a matrix right-hand side), ``lu_solve_refined``
    and the fused ``solve``, each captured per its key."""
    n = 640
    A = _card_matrix((n, n), dtype, 5, shift=False)
    F = rt.lu(A, check=False)
    B, B2 = (_card_matrix((n, 3), dtype, s) for s in (6, 7))
    calls = [lambda B: rt.lu_solve(F, B, trans),
             lambda B: rt.lu_solve_refined(F, A, B[:, 0], iters=2, trans=trans),
             lambda B: rt.solve(A, B, trans=trans, check=False)]
    eager = [[c(B), c(B2)] for c in calls]
    with graphs.capturing():
        for c in calls:
            c(B)
    kinds = sorted(k[0] for k in graphs.programs())
    assert kinds == sorted(["lu_solve", "lu_solve_refined", "solve" if trans == 0 else "lu_factor"])
    r0 = _replays()
    for c, (e, e2) in zip(calls, eager):
        assert _same_results([c(B)], [e]) and _same_results([c(B2)], [e2])
    assert _replays() - r0 == 6 + (2 if trans else 0)  # a transposed solve is lu + lu_solve


@pytest.mark.parametrize("n", [16, 64])
def test_captured_batched_pairs_replay_bitwise_equal_eager(no_programs, n):
    A, A2 = (_card_matrix((1000, n, n), torch.float32, s, shift=False) for s in (8, 9))
    b = _card_matrix((1000, n), torch.float32, 10)

    def pairs(A):
        f, perm, info = rt.batched_lu_factor_perm(A)
        x = rt.batched_lu_solve_perm(f, perm, b)
        g, ipiv, ginfo = rt.batched_lu_factor(A)
        y = rt.batched_lu_solve(g, ipiv, b)
        return f, perm, info, x, g, ipiv, ginfo, y

    eager, eager2 = pairs(A), pairs(A2)
    launches = (bk.batched_lu_cuda.launches, bk.batched_solve_cuda.launches)
    with graphs.capturing():
        pairs(A)
    assert len(graphs.programs()) == 4
    r0 = _replays()
    assert _same_results(pairs(A), eager) and _same_results(pairs(A2), eager2)
    assert _replays() - r0 == 8
    # the warm runs and the captures went through the wrappers, the replays do not
    assert bk.batched_lu_cuda.launches - launches[0] == 4
    assert bk.batched_solve_cuda.launches - launches[1] == 4


def test_clearing_the_programs_frees_their_memory(no_programs):
    A = _card_matrix((1024, 1024), torch.float32, 11)
    warmup.warmup(((1024, 1024),), (torch.float32,))  # the capture stream's workspaces
    warmup.clear_caches()
    r0 = torch.cuda.memory_reserved()
    warmup.warmup(((1024, 1024),), (torch.float32,))
    torch.cuda.empty_cache()
    r1 = torch.cuda.memory_reserved()
    warmup.clear_caches()
    r2 = torch.cuda.memory_reserved()
    assert r1 - r0 >= A.numel() * A.element_size()  # the static input and factors at least
    assert r2 <= r0
    F = rt.lu(A, check=False)  # eager again
    assert graphs.programs() == {} and int(F.info) == 0


def test_a_capture_that_fails_names_its_key(no_programs):
    """A program that synchronises cannot be captured: ``capture`` raises
    with the key and the CUDA error, and caches nothing."""
    A = torch.eye(8, device="cuda")
    with pytest.raises(RuntimeError, match="could not capture the program of .*sync_probe"):
        graphs.capture("sync_probe", lambda A: A * float(A.sum()), (A,), ())
    assert graphs.programs() == {}


# the rest of the compiled entry points: lu_inplace / donate=True, the RBT
# solver, and tp_* and the sharded batch over an NCCL group


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
def test_captured_lu_inplace_replays_bitwise_equal_eager(no_programs, dtype):
    """``lu_inplace`` / ``lu_factor(donate=True)``: the ``lu_factor_donated``
    program factors its copy, a replay copies the factors back into the
    caller's tensor, which stays ``factors``; a zeroed column raises
    through the copied info."""
    n = 700
    A, A2 = (_card_matrix((n, n), dtype, s, shift=False) for s in (21, 22))
    eager = [rt.lu_inplace(M.clone(), check=False) for M in (A, A2)]
    with graphs.capturing():
        rt.lu_inplace(A.clone(), check=False)
    assert [k[0] for k in graphs.programs()] == ["lu_factor_donated"]
    r0 = _replays()
    for M, e in zip((A, A2), eager):
        T = M.clone()
        F = rt.lu_inplace(T, check=False)
        assert F.factors is T and _same_results(_lu_outputs(F), _lu_outputs(e))
    T = A2.clone()
    factors, ipiv, perm, info = rt.lu_factor_p(T, donate=True)
    assert factors is T and _same_results((factors, ipiv, perm, info), _lu_outputs(eager[1]))
    Z = A.clone()
    Z[:, 123] = 0
    with pytest.raises(rt.SingularMatrixError):
        rt.lu_inplace(Z)
    assert _replays() - r0 == 4 and len(graphs.programs()) == 1


def _wilkinson(n, dtype):
    W = torch.eye(n, dtype=torch.float64) - torch.tril(torch.ones(n, n, dtype=torch.float64), -1)
    W[:, -1] = 1
    return W.to(dtype).cuda()


@pytest.mark.parametrize("dtype,refine", [(torch.float64, 0), (torch.float64, 2),
                                          (torch.float32, 2)])
@pytest.mark.parametrize("nrhs", [None, 3])
def test_captured_rbt_replays_bitwise_equal_eager(no_programs, dtype, refine, nrhs):
    """``butterfly_workspace`` (its values held as the program's
    constant), ``butterfly_solve`` and ``UV`` at n = 201 (padded to 204):
    replays bit for bit the eager calls on two inputs; n = 202 pads alike
    and replays the same solve program."""
    n = 201
    A = _wilkinson(n, dtype) if dtype == torch.float64 else _card_matrix((n, n), dtype, 23)
    A2 = _card_matrix((n, n), dtype, 24)
    shape = (n,) if nrhs is None else (n, nrhs)
    b, b2 = (_card_matrix(shape, dtype, s) for s in (25, 26))

    def run(A, b):
        ws = rt.butterfly_workspace(A, b)
        x, info = rt.butterfly_solve(ws, refine=refine, return_info=True)
        return (ws.A, ws.b, ws.uv, x, info) + tuple(ws.UV())

    eager = [run(A, b), run(A2, b2)]
    B3, b3 = _card_matrix((202, 202), dtype, 27), _card_matrix((202,) + shape[1:], dtype, 28)
    ws3 = rt.butterfly_workspace(B3, b3)
    x3 = rt.butterfly_solve(ws3, refine=refine)
    with graphs.capturing():
        run(A, b)
    kinds = sorted(k[0] for k in graphs.programs())
    assert kinds == ["butterfly_solve", "butterfly_workspace", "materialize_uv"]
    held = [p for k, p in graphs.programs().items() if k[0] == "butterfly_workspace"][0]
    assert len(held.constants) == 1 and torch.equal(held.constants[0], eager[0][2])
    r0 = _replays()
    assert _same_results(run(A, b), eager[0]) and _same_results(run(A2, b2), eager[1])
    assert _same_results([rt.butterfly_solve(ws3, refine=refine)], [x3])
    assert _replays() - r0 == 7 and len(graphs.programs()) == 3
    if dtype == torch.float64 and nrhs is None:
        r = (A.double() @ eager[0][3][:n].double() - b.double()).abs().max()
        assert float(r) <= 1e-10


def _uniform_system(n, dtype, seed):
    """HPL's matrix and right-hand side on the card: uniform on [-0.5, 0.5)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand(n, n, generator=g, device="cuda", dtype=dtype) - 0.5
    return A, torch.rand(n, generator=g, device="cuda", dtype=dtype) - 0.5


def _rbt_call(A, b, refine):
    ws = rt.butterfly_workspace(A, b)
    F = rt.butterfly_factor(ws)
    return ws, F, rt.butterfly_factor_solve(F, ws.b, refine=refine)


def test_warmed_rbt_factor_and_solve_at_4096_replay_bitwise_equal_eager(no_programs):
    """The benchmark's RBT call at n = 4096 in float32 (workspace, factor,
    solve with one refinement step): captured by ``graphs.capturing()``,
    three programs, each replay bit for bit the eager call on two
    matrices, and the eager call bit for bit ``butterfly_solve``."""
    n = 4096
    systems = [_uniform_system(n, torch.float32, s) for s in (2500000101, 2500000102)]
    eager = []
    for A, b in systems:
        ws, F, x = _rbt_call(A, b, 1)
        eager.append((F.factors, F.ipiv, F.info, x))
        xs, info = rt.butterfly_solve(ws, refine=1, return_info=True)
        assert _same_results([xs, info], [x, F.info])
    with graphs.capturing():
        _rbt_call(*systems[0], 1)
    assert sorted(k[0] for k in graphs.programs()) == [
        "butterfly_factor", "butterfly_factor_solve", "butterfly_workspace"]
    r0 = _replays()
    for _ in range(2):
        for (A, b), want in zip(systems, eager):
            _, F, x = _rbt_call(A, b, 1)
            assert _same_results([F.factors, F.ipiv, F.info, x], want)
    assert _replays() - r0 == 12
    assert int(eager[0][2]) == 0 and torch.equal(
        eager[0][1], torch.arange(n, dtype=eager[0][1].dtype, device="cuda"))


def test_the_pivot_free_rbt_factor_at_4096_carries_as_the_pivoted_one_does(no_programs):
    """The pivot-free factor of the RBT cell's key (float32, n = 4096) takes
    the look-ahead and the mbarrier exchange on every chain launch and the
    carry on every chain but each panel's first, as the pivoted key does
    (``CARRIED_PER_CALL``); its transform is one kernel launch."""
    A, b = _uniform_system(4096, torch.float32, 2500000201)
    ws = rt.butterfly_workspace(A, b)
    reset_counts()
    rt.butterfly_factor(ws)
    torch.cuda.synchronize()
    c = panel_factor_cuda.counts
    chains = sum(c.chain_launches_by_plan.values())
    assert c.launches == 8 and chains > 0 and c.grid_route_launches == 0
    assert c.lookahead_chain_launches == chains
    assert c.carried_update_launches == CARRIED_PER_CALL[("float32", 4096)]
    assert butterfly_mul_cuda.counts.launches == {("float32", 4096): 1}


def _scaled_residual(L, U, A):
    """max |L U - A| / (n eps max(|L| |U|)) in float64: xGET01's form
    against |L||U|, which a pivot-free factorization's growth does not
    inflate (the gate is 20)."""
    L, U = L.double(), U.double()
    eps = torch.finfo(A.dtype).eps
    r = (L @ U - A.double()).abs().max()
    return float(r / (A.shape[0] * eps * (L.abs() @ U.abs()).max()))


@pytest.mark.parametrize("dtype,n", [(torch.float32, 4096), (torch.float32, 8192),
                                     (torch.float64, 4096)])
def test_lookahead_lu_replays_bitwise_twenty_times(no_programs, dtype, n):
    """The race check of the blocked schedule's look-ahead (each panel's
    trailing block on a side stream beside the next panel's kernels): the
    eager lu of a cell's key splits ``LOOKAHEAD_PER_CALL`` panels and meets
    the residual gate; after ``warmup`` 20 replays are bit for bit the eager
    call."""
    A, _ = _uniform_system(n, dtype, 2626000000 + n)
    reset_counts()
    eager = rt.lu(A, check=False)
    torch.cuda.synchronize()
    assert blocked_lu.counts.lookahead_panels == LOOKAHEAD_PER_CALL[(str(dtype)[6:], n)]
    assert int(eager.info) == 0
    assert _scaled_residual(eager.L, eager.U, A[eager.p.long()]) < 20
    warmup.warmup(((n, n),), (dtype,), solve=False)
    r0 = _replays()
    for _ in range(20):
        F = rt.lu(A, check=False)
        torch.cuda.synchronize()
        assert _same_results(_lu_outputs(F), _lu_outputs(eager))
    assert _replays() - r0 == 20


def test_lookahead_rbt_factor_replays_bitwise_twenty_times(no_programs):
    """The same for RBT's pivot-free ``butterfly_factor`` at the cell's key
    (float32, n = 4096): the strip and the trailing block substituted apart,
    6 look-ahead panels a call, the factors of the transformed matrix under
    the residual gate, 20 replays bit for bit the eager call."""
    n = 4096
    A, b = _uniform_system(n, torch.float32, 2626004097)
    ws = rt.butterfly_workspace(A, b)
    reset_counts()
    eager = rt.butterfly_factor(ws)
    torch.cuda.synchronize()
    assert blocked_lu.counts.lookahead_panels == LOOKAHEAD_PER_CALL[("rbt_float32", n)]
    assert int(eager.info) == 0
    f = eager.factors
    L = torch.tril(f, -1) + torch.eye(n, dtype=f.dtype, device=f.device)
    assert _scaled_residual(L, torch.triu(f), rbt_mod.butterfly_mul(ws.A, ws.uv)) < 20
    with graphs.capturing():
        rt.butterfly_factor(ws)
    r0 = _replays()
    for _ in range(20):
        F = rt.butterfly_factor(ws)
        torch.cuda.synchronize()
        assert _same_results([F.factors, F.ipiv, F.info], [eager.factors, eager.ipiv, eager.info])
    assert _replays() - r0 == 20


def test_lookahead_side_stream_is_each_threads_own(no_programs, monkeypatch):
    """One thread captures the f32 lu key at 2048 while another runs eager
    lu calls at 1536 on the same card: the capture stops at its first fork
    to the side stream, inside the capture, until the other thread's two
    calls are done.  Each thread has a side stream of its own, so both
    finish, the eager calls are bit for bit the single-threaded call, and
    the program's replays are bit for bit its key's eager call."""
    import threading

    from recursivefactorization_jl_tpu_torch.ops import blocked as blocked_mod

    A, _ = _uniform_system(2048, torch.float32, 2626002048)
    B, _ = _uniform_system(1536, torch.float32, 2626011536)
    want_a = _lu_outputs(rt.lu(A, check=False))
    want_b = _lu_outputs(rt.lu(B, check=False))
    torch.cuda.synchronize()
    forked, eager_done = threading.Event(), threading.Event()
    fork = blocked_mod._fork

    def fork_then_wait(M):
        ctx = fork(M)  # the side stream has joined the capture
        if torch.cuda.is_current_stream_capturing() and not forked.is_set():
            forked.set()
            assert eager_done.wait(300)
        return ctx

    monkeypatch.setattr(blocked_mod, "_fork", fork_then_wait)
    errors, got_b = [], []

    def capture():
        try:
            with graphs.capturing():
                rt.lu(A, check=False)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            forked.set()

    def eager():
        try:
            assert forked.wait(300)
            for _ in range(2):
                got_b.append(_lu_outputs(rt.lu(B, check=False)))
            torch.cuda.current_stream().synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            eager_done.set()

    threads = [threading.Thread(target=capture), threading.Thread(target=eager)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got_b) == 2 and all(_same_results(g, want_b) for g in got_b)
    r0 = _replays()
    for _ in range(3):
        F = rt.lu(A, check=False)
        torch.cuda.synchronize()
        assert _same_results(_lu_outputs(F), want_a)
    assert _replays() - r0 == 3


def test_lookahead_panels_in_the_short_and_batched_keys(no_programs):
    """The bypass cells: one look-ahead panel in the f32 lu at 1536 (panel 0
    of three), none in the batched factor of 64 x 64 systems."""
    A, _ = _uniform_system(1536, torch.float32, 2626001536)
    reset_counts()
    rt.lu(A, check=False)
    torch.cuda.synchronize()
    assert blocked_lu.counts.lookahead_panels == LOOKAHEAD_PER_CALL[("float32", 1536)]
    reset_counts()
    rt.batched_lu_factor(_card_matrix((100, 64, 64), torch.float32, 45))
    torch.cuda.synchronize()
    assert blocked_lu.counts.lookahead_panels == LOOKAHEAD_PER_CALL[("batched_float32", 64)]


class _GroupMesh:
    """A one-dimension mesh over a given group (``axis_group`` asks only
    ``get_group``)."""

    def __init__(self, group):
        self.group = group

    def get_group(self, axis):
        return self.group


def test_captured_tp_and_sharded_replay_bitwise_equal_eager(no_programs):
    """In an NCCL world of one rank: ``tp_lu`` + ``tp_lu_solve`` N / T / H
    (f32 and complex64) and the sharded pair, captured per rank and
    group, replay the eager calls' bits on two inputs; a gloo group asked
    to capture raises with its backend named."""
    mesh = _one_rank_world()
    try:
        n, w = 640, 128
        for dtype in (torch.float32, torch.complex64):
            A, A2 = (_card_matrix((n, n), dtype, s, shift=False) for s in (31, 32))
            b = _card_matrix((n, 2), dtype, 33)

            def run(A):
                F = rt.tp_lu(A, mesh, "tp", w)
                return _lu_outputs(F) + tuple(rt.tp_lu_solve(F, b, mesh, "tp", w, trans=t)
                                              for t in ("N", "T", "H"))

            eager = [run(A), run(A2)]
            before = set(graphs.programs())
            with graphs.capturing():
                run(A)
            new = sorted(k[0] for k in graphs.programs() if k not in before)
            assert new == ["tp_lu_factor", "tp_lu_solve", "tp_lu_solve", "tp_lu_solve"]
            r0 = _replays()
            assert _same_results(run(A), eager[0]) and _same_results(run(A2), eager[1])
            assert _replays() - r0 == 8
        Ab, Ab2 = (_card_matrix((6, 32, 32), torch.float32, s, shift=False) for s in (34, 35))
        bb = _card_matrix((6, 32), torch.float32, 36)

        def pair(A):
            f, ipiv, info = rt.sharded_batched_lu_factor(A, mesh, "tp")
            return f, ipiv, info, rt.sharded_batched_lu_solve(f, ipiv, bb, mesh, "tp")

        eager = [pair(Ab), pair(Ab2)]
        with graphs.capturing():
            pair(Ab)
        r0 = _replays()
        assert _same_results(pair(Ab), eager[0]) and _same_results(pair(Ab2), eager[1])
        assert _replays() - r0 == 4
        gloo = _GroupMesh(dist.new_group([0], backend="gloo"))
        with graphs.capturing(), pytest.raises(RuntimeError, match="tp_lu_factor.*'gloo'"):
            rt.tp_lu(A, gloo, "tp", w)
        F = rt.tp_lu(A, gloo, "tp", w)  # eager outside capturing()
        assert int(F.info) == 0
    finally:
        warmup.clear_caches()
        dist.destroy_process_group()


def test_clearing_frees_the_new_programs(no_programs):
    A = _card_matrix((1024, 1024), torch.float32, 37)
    b = _card_matrix((1024,), torch.float32, 38)

    def capture_all():
        with graphs.capturing():
            rt.lu_inplace(A.clone(), check=False)
            rt.butterfly_solve(rt.butterfly_workspace(A, b))

    capture_all()  # the capture stream's workspaces
    warmup.clear_caches()
    r0 = torch.cuda.memory_reserved()
    capture_all()
    assert len(graphs.programs()) == 3
    torch.cuda.empty_cache()
    r1 = torch.cuda.memory_reserved()
    warmup.clear_caches()
    r2 = torch.cuda.memory_reserved()
    assert r1 - r0 >= 2 * A.numel() * A.element_size() and r2 <= r0
    assert graphs.programs() == {} and int(rt.lu_inplace(A.clone()).info) == 0


# spans (utils/profiling.py): device spans inside replays, counters


def _subtree(spans, top):
    """The names of ``top``'s descendants, depth first in id order."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = []

    def walk(sid):
        for c in sorted(kids.get(sid, []), key=lambda s: s.id):
            out.append(c.name)
            walk(c.id)
    walk(top.id)
    return out


def _calls(spans, kind):
    return [s for s in spans if s.parent is None and s.name == kind]


def _child(spans, parent, name):
    (c,) = [s for s in spans if s.parent == parent.id and s.name == name]
    return c


def test_a_key_captured_while_recording_replays_its_spans(no_programs):
    """A program captured while recording reports, per replay, the spans of
    its eager call (as children of ``graphs.replay``, on the device's clock,
    inside the replay's own device span); one captured while not recording
    reports none.  ``graphs.stats`` counts the captures, replays and eager
    calls."""
    n, cfg = 1100, rt.LUConfig(panel_width=256)
    A = _card_matrix((n, n), torch.float32, 41, shift=False)
    b = _card_matrix((n,), torch.float32, 42)
    before = graphs.stats()
    with profiling.recording() as rec:
        F = rt.lu(A, check=False, config=cfg)
        rt.lu_solve(F, b)
    eager = rec.collect()
    after_eager = graphs.stats()
    assert after_eager["eager"] - before["eager"] == 2
    (ef,), (es,) = _calls(eager, "lu_factor"), _calls(eager, "lu_solve")
    want_f = _subtree(eager, _child(eager, ef, "graphs.eager"))
    want_s = _subtree(eager, _child(eager, es, "graphs.eager"))
    assert want_f[0] == "lu.clone" and want_f.count("blocked.panel") == 5
    assert want_s == ["solve.permute", "solve.forward", "solve.backward"]
    assert all(s.clock == "host+device" for s in eager)

    with profiling.recording() as rec:
        warmup.warmup(((n, n),), (torch.float32,), config=cfg)
        rec.collect()
        r0 = graphs.stats()
        for _ in range(3):
            F = rt.lu(A, check=False, config=cfg)
            rt.lu_solve(F, b)
    spans = rec.collect()
    stats = graphs.stats()
    assert stats["captures"] - after_eager["captures"] == 2
    assert stats["replays"] - r0["replays"] == 6 and stats["eager"] == r0["eager"]
    for kind, want in (("lu_factor", want_f), ("lu_solve", want_s)):
        calls = _calls(spans, kind)
        assert len(calls) == 3
        for c in calls:
            assert [x.name for x in spans if x.parent == c.id] == [
                "graphs.copy_in", "graphs.replay", "graphs.copy_out"]
            replay = _child(spans, c, "graphs.replay")
            assert _subtree(spans, replay) == want
            inner = [x for x in spans if x.parent == replay.id]
            assert all(x.clock == "device" and x.call == c.call for x in inner)
            lo, hi = replay.device_ms
            assert all(lo - 1e-3 <= x.device_ms[0] <= x.device_ms[1] <= hi + 1e-3 for x in inner)
            assert c.device_ms[0] == 0.0 and c.device_ms[1] >= hi

    # captured while not recording: no span nodes, the same bits
    warmup.clear_caches()
    warmup.warmup(((n, n),), (torch.float32,), config=cfg)
    assert all(p.spans == () for p in graphs.programs().values())
    with profiling.recording() as rec:
        F2 = rt.lu(A, check=False, config=cfg)
    spans = rec.collect()
    (c,) = _calls(spans, "lu_factor")
    assert _subtree(spans, _child(spans, c, "graphs.replay")) == []
    assert _same_results(_lu_outputs(F2), _lu_outputs(F))


def test_captured_batched_pairs_replay_their_spans(no_programs):
    A = _card_matrix((1000, 64, 64), torch.float32, 43, shift=False)
    b = _card_matrix((1000, 64), torch.float32, 44)
    with profiling.recording() as rec:
        with graphs.capturing():
            f, ipiv, _ = rt.batched_lu_factor(A)
            rt.batched_lu_solve(f, ipiv, b)
        rec.collect()
        for _ in range(2):
            f, ipiv, _ = rt.batched_lu_factor(A)
            rt.batched_lu_solve(f, ipiv, b)
    spans = rec.collect()
    for kind, inner in (("batched_lu_factor", "batched.factor"),
                        ("batched_lu_solve", "batched.solve")):
        calls = _calls(spans, kind)
        assert len(calls) == 2
        for c in calls:
            assert _subtree(spans, _child(spans, c, "graphs.replay")) == [inner]
