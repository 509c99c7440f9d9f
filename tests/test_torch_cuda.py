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
    panel_factor_c64_cuda,
    panel_factor_cuda,
)
from recursivefactorization_jl_tpu_torch.ops.unblocked import (
    unblocked_lu,
    unblocked_lu_cabs1,
)

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
