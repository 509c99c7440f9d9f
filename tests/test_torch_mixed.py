"""The port's mixed-precision solver (models/mixed.py, LAPACK's DSGESV) on the
CPU: against the plain reference of the benchmark
(``bench_port/references/mixed_lu.py``) on seeded HPL matrices, against
scipy's float64 solve, LAPACK's fallback codes, the tensor twins of the two
kernels of ``csrc/mixed_refine.cu`` against plain float64 loops in the same
order, programs that read nothing on the host, counts and spans; and the
repair of ``lu_solve_refined`` with float32 factors of a float64 matrix.
Marked ``cuda``: each kernel bit for bit its twin on the card, and a warmed
call (the ``mixed_lu`` program replayed) bit for bit the eager one.  Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mixed.py
"""

import importlib.util
import math
from pathlib import Path

import pytest
import scipy.linalg
import torch

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.models import mixed as mixed_mod
from recursivefactorization_jl_tpu_torch.ops import _counts
from recursivefactorization_jl_tpu_torch.ops import mixed_refine as mr
from recursivefactorization_jl_tpu_torch.utils import graphs, profiling
from recursivefactorization_jl_tpu_torch.utils import warmup as rt_warmup

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_mixed_lu_reference", REPO / "bench_port" / "references" / "mixed_lu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()
EPS64 = 2.0 ** -53


def hpl(n, seed, k=None):
    """HPL's matrix and right-hand side: entries uniform on [-0.5, 0.5)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.rand(n, n, generator=g, dtype=torch.float64) - 0.5
    b = torch.rand(n if k is None else (n, k), generator=g, dtype=torch.float64) - 0.5
    return A, b


def lapack_ratio(A, x, b):
    """The largest column's max|b - A x| / (max|x| ||A||_inf eps sqrt(n)):
    LAPACK's stopping test passes at 1 or below."""
    X, B = (x[:, None], b[:, None]) if x.dim() == 1 else (x, b)
    cte = A.abs().sum(1).max() * EPS64 * math.sqrt(A.shape[0])
    return float(((B - A @ X).abs().amax(0) / (X.abs().amax(0) * cte)).max())


def hpl_residual(A, x, b):
    """HPL's scaled residual in float64's unit roundoff."""
    n = A.shape[0]
    return float((A @ x - b).abs().max()
                 / (EPS64 * (A.abs().sum(1).max() * x.abs().max() + b.abs().max()) * n))


def solve(A, b, **kw):
    return rt.mixed_lu_solve(rt.mixed_lu(A, device="cpu"), b, return_iter=True, **kw)


def ratios(factors, ipiv, A, b, steps):
    """LAPACK's test ratio after 0..steps refinement steps from these
    factors, by the reference's loop."""
    n = A.shape[0]
    perm, _ = REF._DENSE._perm_from_ipiv(ipiv.long().numpy()[None], n)
    perm = torch.as_tensor(perm[0])
    B, out = b[:, None], []
    x = REF._apply(factors, perm, B)
    for _ in range(steps + 1):
        out.append(lapack_ratio(A, x, B))
        x = x + REF._apply(factors, perm, B - A @ x)
    return out


# (n, seed) where the port's and the reference's ITER part by one step: the
# two float32 factorizations round differently (the port's blocked schedule
# and panel kernels, the reference's 32-column panels), and at the smaller
# ITER the test's ratio, by the same loop from each one's factors, lies
# above 1 from one and below 1 from the other (11.7 / 0.43 and 12.8 / 0.50)
STRADDLES = {(96, 5), (128, 8)}


@pytest.mark.parametrize("n,seed", [(64, 1), (96, 2), (96, 5), (128, 3), (128, 8), (160, 1),
                                    (200, 2), (256, 1), (256, 4)])
def test_mixed_port_matches_the_plain_reference_on_hpl_matrices(n, seed):
    A, b = hpl(n, seed)
    F = rt.mixed_lu(A, device="cpu")
    x, it = rt.mixed_lu_solve(F, b, return_iter=True)
    f, ipiv, info = REF.lu_factor(A)
    xr, itr = REF.solve(f, ipiv, info, b, A)
    assert torch.equal(F.ipiv, ipiv) and int(F.info) == int(info) == 0
    plain = rt.lu(A.float(), device="cpu")
    assert torch.equal(F.factors.view(torch.int32), plain.factors.view(torch.int32))
    assert torch.equal(F.perm, plain.p) and F.factors.dtype == torch.float32
    assert it >= 0 and itr >= 0
    if (n, seed) in STRADDLES:
        lo = min(it, itr)
        port, refs = ratios(F.factors, F.ipiv, A, b, lo)[lo], ratios(f, ipiv, A, b, lo)[lo]
        assert abs(it - itr) == 1 and min(port, refs) <= 1 < max(port, refs), (it, itr, port, refs)
    else:
        assert it == itr, (it, itr)
    assert lapack_ratio(A, x, b) <= 1 and hpl_residual(A, x, b) <= 16
    assert (x - xr).abs().max() <= 1e-6 * xr.abs().max()


@pytest.mark.parametrize("n", [1, 2, 33, 150, 256])
def test_mixed_solution_meets_lapacks_test_and_agrees_with_scipys_dgesv(n):
    """x meets DSGESV's stopping test and HPL's float64 gate, and lies within
    float64's reach of scipy's dgesv: n eps kappa_inf(A) ||x||, with kappa
    the exact condition number, the classic bound of a backward-stable
    solution with room for the sums' order."""
    A, b = hpl(n, 100 + n)
    x, it = solve(A, b)
    assert it >= 0
    assert lapack_ratio(A, x, b) <= 1 and hpl_residual(A, x, b) <= 16
    xs = torch.as_tensor(scipy.linalg.solve(A.numpy(), b.numpy()))
    kappa = float(torch.linalg.cond(A, p=float("inf")))
    assert (x - xs).abs().max() <= max(n, 4) * EPS64 * kappa * xs.abs().max()


def _singular_in_float32(n=64, seed=5):
    """A nonsingular float64 matrix whose column 5 rounds to zeros in
    float32 (entries below half float32's least subnormal): single(A) is
    exactly singular, and SGETRF stops at the zero pivot of step 5."""
    A, b = hpl(n, seed)
    A[:, 5] *= 1e-46
    assert not A[:, 5].float().any() and A[:, 5].all()
    return A, b


def _ill_conditioned(n=96, kappa=1e12, seed=1):
    """U diag(s) V^T with singular values from 1 to 1 / kappa: the float32
    factors cannot refine it (kappa eps32 >> 1)."""
    g = torch.Generator().manual_seed(seed)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    V, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    s = torch.logspace(0, -math.log10(kappa), n, dtype=torch.float64)
    return U @ torch.diag(s) @ V.T, torch.rand(n, generator=g, dtype=torch.float64) - 0.5


def _fallback_case(case):
    if case == "entry_past_float32":
        A, b = hpl(48, 7)
        A[5, 9] = 1e39
        return A, b, -2
    if case == "rhs_past_float32":
        A, b = hpl(48, 8)
        b[11] = -4e38
        return A, b, -2
    if case == "singular_in_float32":
        return (*_singular_in_float32(), -3)
    return (*_ill_conditioned(), -31)


@pytest.mark.parametrize("case", ["entry_past_float32", "rhs_past_float32", "singular_in_float32",
                                  "ill_conditioned"])
def test_mixed_fallback_codes_are_lapacks(case):
    """ITER -2 / -3 / -31 where DSGESV gives them, the reference's too; x is
    then the float64 LU solve (HPL's gate in float64), the float64
    factorization is kept on the factorization and A stays as it was."""
    A, b, code = _fallback_case(case)
    A0 = A.clone()
    F = rt.mixed_lu(A, device="cpu")
    _counts.reset_counts()
    x, it = rt.mixed_lu_solve(F, b, return_iter=True)
    assert it == code
    f, ipiv, info = REF.lu_factor(A)
    assert REF.solve(f, ipiv, info, b, A)[1] == code
    assert torch.equal(A, A0)
    assert hpl_residual(A, x, b) <= 16
    assert F.fallback is not None and F.fallback.factors.dtype == torch.float64
    assert torch.equal(x, rt.lu_solve(rt.lu(A, device="cpu", check=False), b))
    kept = F.fallback
    x2, it2 = rt.mixed_lu_solve(F, b, return_iter=True)
    assert F.fallback is kept and it2 == code and torch.equal(x, x2)
    counts = rt.mixed_lu_solve.counts
    assert counts.fallbacks == {code: 2} and counts.iters == {code: 2} and counts.calls == 2
    if code == -3:
        assert int(F.info) == int(info) == 6  # the zero pivot of the float32 factors


def test_mixed_lu_leaves_a_unchanged_and_holds_it():
    A, b = hpl(128, 9)
    A0 = A.clone()
    F = rt.mixed_lu(A, device="cpu")
    rt.mixed_lu_solve(F, b)
    assert torch.equal(A, A0) and F.A is A
    assert math.isclose(float(F.anrm), float(A.abs().sum(1).max()), rel_tol=1e-14)
    assert int(F.overflow) == 0


@pytest.mark.parametrize("k", [1, 3])
def test_mixed_matrix_right_hand_side(k):
    """A matrix right-hand side: every column held to the test, and the
    steps those of the slowest column's vector solve."""
    A, B = hpl(100, 11, k=k)
    F = rt.mixed_lu(A, device="cpu")
    X, it = rt.mixed_lu_solve(F, B, return_iter=True)
    assert X.shape == (100, k) and it >= 0
    assert lapack_ratio(A, X, B) <= 1 and hpl_residual(A, X, B) <= 16
    its = [rt.mixed_lu_solve(F, B[:, c], return_iter=True)[1] for c in range(k)]
    assert abs(it - max(its)) <= 1


def test_mixed_itermax_zero_falls_back_unless_the_first_solve_passes():
    A, b = hpl(80, 3)
    x, it = solve(A, b, itermax=0)
    assert it == -1 and hpl_residual(A, x, b) <= 16
    assert solve(torch.eye(6, dtype=torch.float64), torch.arange(6.0, dtype=torch.float64),
                 itermax=0)[1] == 0


# ---- the twins against plain loops in the kernels' order -------------------


def _plain_rows(n, term):
    """Each row's sum of ``term(i, j)`` as a block of mr.THREADS threads adds
    it: thread t over columns t, t + T, ..., then the tree s_t += s_{t+h}
    (Python floats are IEEE doubles: one rounding per product and sum)."""
    T = mr.THREADS
    out = []
    for i in range(n):
        part = []
        for t in range(T):
            s = 0.0
            for j in range(t, n, T):
                s = s + term(i, j)
            part.append(s)
        h = T // 2
        while h >= 1:
            part = [part[t] + part[t + h] for t in range(h)]
            h //= 2
        out.append(part[0])
    return out


@pytest.mark.parametrize("n", [1, 5, 300, 520])
def test_mixed_narrow_twin_is_a_plain_loop_in_the_kernels_order(n):
    A, _ = hpl(n, n)
    A[0, 0] = 3.0e38  # in float32's range; 4e38 would overflow
    A[-1, -1] = -1e-310  # a subnormal
    sa, anrm, overflow = mr.narrow_tensor(A)
    a = A.tolist()
    rows = _plain_rows(n, lambda i, j: abs(a[i][j]))
    assert float(anrm) == max(rows) and int(overflow) == 0
    assert torch.equal(sa, A.float())
    A[n // 2, 0] = -4e38
    assert int(mr.narrow_tensor(A)[2]) == 1


@pytest.mark.parametrize("n,k", [(3, 1), (300, 1), (520, 2)])
def test_mixed_residual_twin_is_a_plain_loop_in_the_kernels_order(n, k):
    A, b = hpl(n, 3 * n, k=k)
    x = torch.randn(n, k, generator=torch.Generator().manual_seed(n), dtype=torch.float64) * 7
    anrm = A.abs().sum(1).max()
    status = torch.zeros(2, dtype=torch.int32)
    r, sr = mr.residual_tensor(A, x, b, anrm, status, True, 30)
    a, xs, bs = A.tolist(), x.tolist(), b.tolist()
    for c in range(k):
        rows = _plain_rows(n, lambda i, j: a[i][j] * xs[j][c])
        plain = torch.tensor([bs[i][c] - rows[i] for i in range(n)], dtype=torch.float64)
        assert torch.equal(r[:, c], plain)
    assert torch.equal(sr, r.float())
    # a random x is far from the solution: one step taken, not converged
    assert status.tolist() == [0, 1]


def test_mixed_residual_twin_writes_the_test_as_lapack_orders_it():
    """Converged first; else -(itermax + 1) at itermax steps; else -2 where
    single(r) overflows; a state that is not 0 is left as it is."""
    A = torch.eye(4, dtype=torch.float64)
    x = torch.ones(4, 1, dtype=torch.float64)
    anrm = torch.tensor(1.0, dtype=torch.float64)

    def run(b, status, step, itermax=30):
        status = torch.tensor(status, dtype=torch.int32)
        mr.residual_tensor(A, x, b, anrm, status, step, itermax)
        return status.tolist()

    exact, off, huge = x.clone(), x + 0.5, x + 5e38
    assert run(exact, [0, 0], False) == [1, 0]
    assert run(exact, [0, 2], True) == [1, 3]
    assert run(off, [0, 2], True) == [0, 3]
    assert run(off, [0, 29], True) == [-31, 30]
    assert run(off, [0, 0], False, itermax=0) == [-1, 0]
    assert run(huge, [0, 4], True) == [-2, 5]
    assert run(huge, [0, 29], True) == [-31, 30]
    for frozen in ([1, 3], [-2, 4], [-3, 0], [-31, 30]):
        assert run(off, frozen, True) == frozen


# ---- programs, counts, spans -------------------------------------------------


def test_mixed_solves_read_nothing_on_the_host_but_the_checks(monkeypatch):
    """The narrowing, the first solve and a step run with every host read of
    a tensor refused: the status read between passes is the only sync."""
    A, b = hpl(70, 2)
    F = rt.mixed_lu(A, device="cpu")
    B = b[:, None].contiguous()
    tensors = (F.factors, F.perm, A, B, F.anrm)

    def refuse(*a, **k):
        raise AssertionError("a host read inside a solve")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    mr.narrow_tensor(A)
    x, sr, status = mixed_mod._first(*tensors, F.overflow, F.info, 30)
    mixed_mod._step(*tensors, x, sr, status, 30)


def test_mixed_counts_and_spans():
    _counts.reset_counts()
    assert rt.mixed_lu_solve.counts == mixed_mod.MixedCounts()
    A, b = hpl(90, 4)
    with profiling.recording() as rec:
        x, it = solve(A, b)
    counts = rt.mixed_lu_solve.counts
    assert counts.calls == 1 and counts.steps == it and counts.host_checks == it + 1
    assert counts.iters == {it: 1} and counts.fallbacks == {}
    assert counts.kernel_launches == {}
    assert counts.twin_passes == {"mixed_narrow_kernel": 1, "mixed_residual_kernel": it + 1}
    names = [s.name for s in rec.collect()]
    for name in ("mixed_lu", "mixed.narrow", "mixed.factor", "mixed.solve", "mixed.residual",
                 "mixed.check"):
        assert name in names, name
    # a pass a step, a check a pass, none past the test's first pass
    for name in ("mixed.check", "mixed.residual", "mixed.solve"):
        assert names.count(name) == it + 1, name
    assert "mixed.fallback" not in names
    A, b, _ = _fallback_case("entry_past_float32")
    with profiling.recording() as rec:
        solve(A, b)
    assert "mixed.fallback" in [s.name for s in rec.collect()]
    _counts.reset_counts()
    assert rt.mixed_lu_solve.counts == mixed_mod.MixedCounts()


def test_span_breakdown_reads_the_mixed_counts_flat():
    import importlib
    import sys

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    sb = importlib.import_module("span_breakdown")
    _counts.reset_counts()
    A, b, _ = _fallback_case("entry_past_float32")
    solve(A, b)
    _, it = solve(*hpl(60, 1))
    assert sb.mixed_counts() == {"calls": 2, "steps": it, "host_checks": it + 2, "iter.-2": 1,
                                 f"iter.{it}": 1, "fallback.-2": 1}


def test_mixed_refuses_other_types_and_shapes():
    A, b = hpl(16, 1)
    with pytest.raises(TypeError, match="float64"):
        rt.mixed_lu(A.float(), device="cpu")
    with pytest.raises(TypeError, match="ZCGESV"):
        rt.mixed_lu(A.to(torch.complex128), device="cpu")
    with pytest.raises(ValueError, match="square"):
        rt.mixed_lu(A[:, :8], device="cpu")
    F = rt.mixed_lu(A, device="cpu")
    with pytest.raises(TypeError, match="float64"):
        rt.mixed_lu_solve(F, b.float())
    with pytest.raises(ValueError, match="right-hand side"):
        rt.mixed_lu_solve(F, b[:8])
    with pytest.raises(ValueError, match="itermax"):
        rt.mixed_lu_solve(F, b, itermax=-1)
    empty = rt.mixed_lu(torch.zeros(0, 0, dtype=torch.float64), device="cpu")
    assert rt.mixed_lu_solve(empty, torch.zeros(0, dtype=torch.float64), return_iter=True)[1] == 0


def test_mixed_warmup_on_the_cpu_captures_nothing():
    """A shape is warmed by its first call inside ``graphs.capturing()``; on
    the CPU that runs the plain versions and captures nothing."""
    before = graphs.stats()["captures"]
    A, b = hpl(24, 3)
    with graphs.capturing():
        x, it = rt.mixed_lu_solve(rt.mixed_lu(A, device="cpu"), b, return_iter=True)
    assert graphs.stats()["captures"] == before and graphs.programs() == {}
    assert it >= 0 and lapack_ratio(A, x, b) <= 1


@pytest.mark.parametrize("k", [None, 2])
def test_lu_solve_refined_takes_float32_factors_of_a_float64_matrix(k):
    """float32 factors and a float64 A: x and the residual in float64, each
    correction solved in float32 (it raised a dtype error before); the
    fixed-step form of the mixed solver reaches its accuracy."""
    A, b = hpl(96, 21, k=k)
    F = rt.lu(A.float(), device="cpu")
    x = rt.lu_solve_refined(F, A, b, iters=4)
    assert x.dtype == torch.float64 and x.shape == b.shape
    assert lapack_ratio(A, x, b) <= 1
    same = rt.lu_solve_refined(F, A.float(), b.float(), iters=2)
    assert same.dtype == torch.float32


# ---- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mixed-precision kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 1000, 4096])
def test_mixed_narrow_kernel_is_its_twin_on_the_card(n):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.rand(n, n, generator=g, device=dev, dtype=torch.float64) - 0.5
    A[0, -1] = 3.0e38
    got, want = mr.narrow_cuda(A), mr.narrow_tensor(A)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    A[-1, 0] = 4e38
    assert int(mr.narrow_cuda(A)[2]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1, 1), (257, 1), (1000, 3), (4096, 1)])
@pytest.mark.parametrize("start", [[0, 0], [0, 29], [1, 2], [-3, 0]])
def test_mixed_residual_kernel_is_its_twin_on_the_card(n, k, start):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n + k)
    A = torch.rand(n, n, generator=g, device=dev, dtype=torch.float64) - 0.5
    b = torch.rand(n, k, generator=g, device=dev, dtype=torch.float64) - 0.5
    x = torch.linalg.solve(A, b) + 1e-9 * torch.rand(n, k, generator=g, device=dev,
                                                      dtype=torch.float64)
    anrm = A.abs().sum(1).max()
    for xx in (x, torch.linalg.solve(A, b)):
        s1 = torch.tensor(start, dtype=torch.int32, device=dev)
        s2 = s1.clone()
        r1, sr1 = mr.residual_cuda(A, xx, b, anrm, s1, True, 30)
        r2, sr2 = mr.residual_tensor(A, xx, b, anrm, s2, True, 30)
        torch.cuda.synchronize()
        assert torch.equal(_bits(r1), _bits(r2)) and torch.equal(_bits(sr1), _bits(sr2))
        assert s1.tolist() == s2.tolist(), (s1, s2)


@pytest.mark.cuda
def test_mixed_kernel_wrappers_count_their_own_launches():
    """A direct call of either wrapper counts, as the solver's calls do;
    the twins count nothing."""
    dev = _card()
    A = torch.rand(300, 300, dtype=torch.float64, device=dev) - 0.5
    x = torch.rand(300, 1, dtype=torch.float64, device=dev)
    status = torch.zeros(2, dtype=torch.int32, device=dev)
    _counts.reset_counts()
    mr.narrow_cuda(A)
    mr.narrow_tensor(A)
    for _ in range(2):
        mr.residual_cuda(A, x, x, A.abs().sum(1).max(), status, True, 30)
    assert (mr.narrow_cuda.counts.launches, mr.residual_cuda.counts.launches) == (1, 2)
    assert rt.mixed_lu_solve.counts.kernel_launches == {"mixed_narrow_kernel": 1,
                                                        "mixed_residual_kernel": 2}
    _counts.reset_counts()
    assert rt.mixed_lu_solve.counts.kernel_launches == {}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_mixed_warmed_call_is_the_eager_call_bit_for_bit_on_the_card(n):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7 * n)
    A = torch.rand(n, n, generator=g, device=dev, dtype=torch.float64) - 0.5
    b = torch.rand(n, generator=g, device=dev, dtype=torch.float64) - 0.5
    A0 = A.clone()
    rt_warmup.clear_caches()
    _counts.reset_counts()
    F = rt.mixed_lu(A)
    x, it = rt.mixed_lu_solve(F, b, return_iter=True)
    assert rt.mixed_lu_solve.counts.kernel_launches == {"mixed_narrow_kernel": 1,
                                                        "mixed_residual_kernel": it + 1}
    plain = rt.lu(A.float())
    assert torch.equal(_bits(F.factors), _bits(plain.factors)) and torch.equal(F.ipiv, plain.ipiv)
    try:
        with graphs.capturing():
            rt.mixed_lu_solve(rt.mixed_lu(torch.eye(n, dtype=torch.float64, device=dev)),
                              torch.zeros(n, dtype=torch.float64, device=dev))
        assert "mixed_lu" in {k[0] for k in graphs.programs()}
        for _ in range(3):
            G = rt.mixed_lu(A)
            y, it2 = rt.mixed_lu_solve(G, b, return_iter=True)
            assert it2 == it and torch.equal(_bits(y), _bits(x))
            assert torch.equal(_bits(G.factors), _bits(F.factors))
    finally:
        rt_warmup.clear_caches()
    assert torch.equal(A, A0) and it >= 0
    assert lapack_ratio(A.cpu(), x.cpu(), b.cpu()) <= 1
