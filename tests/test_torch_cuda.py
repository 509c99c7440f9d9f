"""The port's Hopper kernels and main paths on a CUDA card.

Every test here carries the ``cuda`` marker and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
from recursivefactorization_jl_tpu_torch.ops.panel import (
    micro_max_cuda,
    panel_factor_basic_cuda,
    panel_factor_c64_cuda,
    panel_factor_cuda,
    panel_factor_noswap_cuda,
    panel_factor_shadow_cuda,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    micro_blocked_lu,
    unblocked_lu,
    unblocked_lu_cabs1,
    unblocked_lu_noswap,
)
from recursivefactorization_jl_tpu_torch.utils.config import PANEL_MICRO_MAX

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def need_cuda():
    """Skip unless a CUDA card is present (decided at run time, never at
    collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


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
    before = panel_factor_cuda.launches
    kpiv, kperm, kinfo = panel_factor_cuda(P, pivot)
    torch.cuda.synchronize()
    assert panel_factor_cuda.launches == before + 1
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
    before = panel_factor_c64_cuda.launches
    kpiv, kperm, kinfo = panel_factor_c64_cuda(P, pivot)
    torch.cuda.synchronize()
    assert panel_factor_c64_cuda.launches == before + 1
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
    before = panel_factor_c64_cuda.launches
    G = rt.lu(At, config=cfg)
    assert panel_factor_c64_cuda.launches == before + -(-n // w)
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
    before = panel_factor_cuda.launches
    F = rt.lu(A)
    assert panel_factor_cuda.launches == before + 2
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
    for w in (bk.batched_lu_cuda, bk.batched_solve_cuda):
        w.launches = 0
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
                                   (5, 128, 128), (9, 40, 96), (9, 300, 24)])
def test_batched_swap_kernel_bitwise_equals_plain(dtype, pivot, shape):
    need_cuda()
    B, m, n = shape
    A = _batch(11, B, m, n, dtype, pivot)
    keep = A.clone()
    f, ipiv, perm, info = bk.batched_lu_plain(A, pivot, True)
    before = bk.batched_lu_cuda.launches
    kf, kipiv, kperm, kinfo = bk.batched_lu_cuda(A, pivot, True)
    torch.cuda.synchronize()
    assert bk.batched_lu_cuda.launches == before + 1
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
    for w in (bk.batched_lu_cuda, bk.batched_solve_cuda):
        w.launches = 0
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
    for w in (bk.batched_lu_cuda, bk.batched_lu_noswap_cuda, bk.batched_solve_cuda):
        w.launches = 0
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
        before = wrapper.launches
        kpiv, kperm, kinfo = wrapper(P, pivot, micro)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
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
                           (torch.zeros(200, 100, device="cuda"), 65),
                           (torch.zeros(8, 4, device="cuda"), 0)):
            with pytest.raises(ValueError):
                wrapper(bad, True, micro)
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
    before = panel_factor_noswap_cuda.launches
    kprow, kused, kinfo = panel_factor_noswap_cuda(P, used0, pivot)
    torch.cuda.synchronize()
    assert panel_factor_noswap_cuda.launches == before + 1
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
    before = (wrapper.launches, panel_factor_cuda.launches)
    G = rt.lu(At, config=cfg)
    assert wrapper.launches == before[0] + -(-n // w)
    assert panel_factor_cuda.launches == before[1]
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
    assert wrapper.launches == before[0] + 2 * -(-n // w) + 1
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
    before = (panel_factor_noswap_cuda.launches, panel_factor_cuda.launches)
    G = rt.lu(At, config=cfg)
    assert panel_factor_noswap_cuda.launches == before[0] + -(-n // w)
    assert panel_factor_cuda.launches == before[1]
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
    before = panel_factor_cuda.launches
    x, info = rt.butterfly_solve(ws, return_info=True, refine=1)
    assert panel_factor_cuda.launches == before + 2 and int(info) == 0
    assert x.is_cuda and tuple(x.shape) == (n, 2)
    assert float(np.abs(A @ x.cpu().numpy() - b).max()) < 1e-9
    xc = rt.butterfly_solve(rt.butterfly_workspace(A, b, device="cpu"), refine=1)
    assert float((x.cpu() - xc).abs().max()) < 1e-12


def test_butterfly_values_default_to_the_card():
    """``generate_butterfly_values`` follows the device rule: no device
    means the card, with the values of the CPU stream; the micro-blocked
    library's block limit is the one the configuration checks."""
    need_cuda()
    uv = rt.generate_butterfly_values(64)
    assert uv.is_cuda and uv.dtype == torch.float64
    assert torch.equal(uv.cpu(), rt.generate_butterfly_values(64, device="cpu"))
    ws = rt.butterfly_workspace(np.eye(64), np.ones(64), uv=uv)
    assert ws.uv.is_cuda and torch.equal(ws.uv, uv)
    assert micro_max_cuda() == PANEL_MICRO_MAX
