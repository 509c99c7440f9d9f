"""The port's distributed layer against the JAX package, on the CPU.

``tp_lu_factor`` / ``tp_lu_factor_p`` / ``tp_lu`` / ``tp_lu_solve``
(parallel/blockcyclic.py) and the sharded batched functions run in pools
of spawned gloo ranks, D = 1, 2 and 4, started once for the module; the
rank body is tests/torch_dist_worker.py, which imports torch and the port
only.  The JAX reference runs here, on the suite's 8-device CPU mesh, and
inputs and results cross as numpy arrays.  Every rank must return the
same result.

Tolerances: ipiv, perm and info exactly.  float64 factors within 1e-10 of
the JAX package's (the Schur sums may round in another order); float32
factors under the residual gate ``20 * n * eps * max|A|``.  Solutions
within ``1e-10 * max|x|`` of the JAX solve's in float64.  The canaries
count the port's own ``broadcast`` and ``all_reduce`` calls.
"""

import multiprocessing
import queue
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import recursivefactorization_jl_tpu as rf
import recursivefactorization_jl_tpu_torch as rt
import torch_dist_worker
from recursivefactorization_jl_tpu.parallel import (
    sharded_batched_lu_factor,
    sharded_batched_lu_solve,
)
from recursivefactorization_jl_tpu.parallel.blockcyclic import tp_lu_factor_p
from test_torch_common import lu_residual, residual_gate

torch.set_num_threads(1)

N, W = 256, 32
TIMEOUT = 120  # seconds a pool waits for its ranks


def mesh_1d(name, D):
    return Mesh(np.array(jax.devices()[:D]), (name,))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` spawned gloo ranks serving torch_dist_worker's tasks."""

    def __init__(self, world):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [
            ctx.Process(target=torch_dist_worker.serve,
                        args=(r, world, port, self.inboxes[r], self.outbox), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def run(self, task, **kwargs):
        """The task's result, which every rank must return alike."""
        for box in self.inboxes:
            box.put((task, kwargs))
        try:
            got = sorted((self.outbox.get(timeout=TIMEOUT) for _ in self.procs),
                         key=lambda r: r[0])
        except queue.Empty:
            raise AssertionError(f"{task}: a rank did not answer in {TIMEOUT} s") from None
        errors = [r[2] for r in got if r[1] != "ok"]
        assert not errors, errors[0]
        first = got[0][2]
        for r in got[1:]:
            assert_same(r[2], first)
        return first

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pools():
    started = {D: RankPool(D) for D in (1, 2, 4)}
    yield started
    for pool in started.values():
        pool.close()


def randn(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def np_all(xs):
    return tuple(np.asarray(x) for x in xs)


@pytest.fixture(scope="module")
def f64_case():
    """f64 n=256, w=32: the JAX package's tp factorization on 4 devices."""
    A = randn(1, (N, N))
    res = rf.tp_lu(jnp.asarray(A), mesh_1d("tp", 4), "tp", panel_width=W)
    F, ipiv, perm, info = np_all(tp_lu_factor_p(jnp.asarray(A), mesh_1d("tp", 4), "tp", W))
    return dict(A=A, res=res, F=F, ipiv=ipiv, perm=perm, info=int(info))


def assert_factorization(port, ref, tol=1e-10):
    np.testing.assert_array_equal(port["ipiv"], ref["ipiv"], err_msg="ipiv")
    np.testing.assert_array_equal(port["perm"], ref["perm"], err_msg="perm")
    assert port["info"] == ref["info"]
    np.testing.assert_allclose(port["F"], ref["F"], rtol=0, atol=tol)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_tp_factor_f64_matches_jax(pools, f64_case, D):
    port = pools[D].run("tp_factor", A=f64_case["A"], w=W)
    assert_factorization(port, f64_case)
    assert port["info"] == 0


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_tp_factor_f32_matches_both_jax_backends(pools, backend):
    """float32 against the JAX package's pure-JAX panel and its Pallas
    offset kernel (interpret mode): pivots, perm and info exactly, the
    factors under the residual gate."""
    A = randn(2, (N, N), np.float32)
    cfg = dict(tp_panel_backend=backend)
    if backend == "pallas":
        cfg["panel_micro"] = 16
    F, ipiv, perm, info = np_all(tp_lu_factor_p(
        jnp.asarray(A), mesh_1d("tp", 4), "tp", W, config=rf.LUConfig(**cfg)))
    port = pools[4].run("tp_factor", A=A, w=W, config=dict(tp_panel_backend=backend))
    np.testing.assert_array_equal(port["ipiv"], ipiv)
    np.testing.assert_array_equal(port["perm"], perm)
    assert port["info"] == int(info) == 0
    assert lu_residual(A, port["F"], port["perm"]) < residual_gate(A, np.float32, True)


@pytest.mark.parametrize("D", [2, 4])
def test_tp_factor_padding_and_singular_column(pools, D):
    """n = 200 pads to 256 inside; column 77 zero gives info 78."""
    A = randn(3, (200, 200))
    A[:, 77] = 0.0
    ref = dict(zip(("F", "ipiv", "perm", "info"), np_all(tp_lu_factor_p(
        jnp.asarray(A), mesh_1d("tp", 2), "tp", W))))
    ref["info"] = int(ref["info"])
    port = pools[D].run("tp_factor", A=A, w=W)
    assert port["F"].shape == (200, 200) and port["perm"].shape == (256,)
    assert_factorization(port, ref)
    assert port["info"] == 78


@pytest.fixture(scope="module")
def nopivot_case():
    """pivot=False on randn + n*I: the JAX package on a 1-device mesh."""
    A = randn(4, (N, N)) + N * np.eye(N)
    mesh = mesh_1d("tp", 1)
    res = rf.tp_lu(jnp.asarray(A), mesh, "tp", panel_width=W, pivot=False)
    F, ipiv, perm, info = np_all(tp_lu_factor_p(jnp.asarray(A), mesh, "tp", W, pivot=False))
    return dict(A=A, res=res, mesh=mesh, F=F, ipiv=ipiv, perm=perm, info=int(info))


@pytest.mark.parametrize("D", [1, 4])
def test_tp_factor_without_pivoting(pools, nopivot_case, D):
    port = pools[D].run("tp_factor", A=nopivot_case["A"], w=W, pivot=False)
    assert_factorization(port, nopivot_case)
    np.testing.assert_array_equal(port["perm"], np.arange(N))


def assert_solution(x, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("trans", ["N", "T", "H"])
def test_tp_solve_matches_jax(pools, f64_case, trans):
    b = randn(5, N)
    xj = rf.tp_lu_solve(f64_case["res"], jnp.asarray(b), mesh_1d("tp", 4), "tp", W,
                        trans=trans)
    port = pools[2].run("tp_solve", A=f64_case["A"], w=W, rhs=[(b, trans)])
    assert_solution(port["x"][0], xj)
    A = f64_case["A"]
    op = A if trans == "N" else A.T
    assert np.abs(op @ port["x"][0] - b).max() < 1e-9


def test_tp_solve_matrix_rhs(pools, f64_case):
    B = randn(6, (N, 3))
    xj = rf.tp_lu_solve(f64_case["res"], jnp.asarray(B), mesh_1d("tp", 4), "tp", W)
    port = pools[4].run("tp_solve", A=f64_case["A"], w=W, rhs=[(B, "N")])
    assert port["x"][0].shape == (N, 3)
    assert_solution(port["x"][0], xj)


def test_tp_solve_without_pivoting(pools, nopivot_case):
    b = randn(7, N)
    xj = rf.tp_lu_solve(nopivot_case["res"], jnp.asarray(b), nopivot_case["mesh"], "tp", W)
    port = pools[1].run("tp_solve", A=nopivot_case["A"], w=W, rhs=[(b, 0)], pivot=False)
    assert_solution(port["x"][0], xj)


def test_tp_solve_of_a_single_device_factorization(pools):
    """An ``lu`` made on one device distributes the same way; n = 200
    pads inside the solve, and the rhs is a matrix."""
    A = randn(8, (200, 200))
    B = randn(9, (200, 2))
    xj = rf.tp_lu_solve(rf.lu(jnp.asarray(A)), jnp.asarray(B), mesh_1d("tp", 4), "tp", W)
    port = pools[4].run("tp_solve", A=A, w=W, rhs=[(B, "N")], single_device=True)
    assert_solution(port["x"][0], xj)
    assert np.abs(A @ port["x"][0] - B).max() < 1e-10


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_batched_matches_jax(pools, D):
    A = randn(10, (8, 16, 16))
    b = randn(11, (8, 16))
    mesh = mesh_1d("dp", 4)
    f, ipiv, info = sharded_batched_lu_factor(jnp.asarray(A), mesh, "dp")
    x = np.asarray(sharded_batched_lu_solve(f, ipiv, jnp.asarray(b), mesh, "dp"))
    port = pools[D].run("sharded", A=A, b=b)
    np.testing.assert_array_equal(port["ipiv"], np.asarray(ipiv))
    np.testing.assert_array_equal(port["info"], np.asarray(info))
    np.testing.assert_allclose(port["f"], np.asarray(f), rtol=0, atol=1e-13)
    np.testing.assert_allclose(port["x"], x, rtol=0, atol=1e-12 * np.abs(x).max())
    # one all_reduce per output: factors, ipiv, info, then the solutions
    assert [c[0] for c in port["calls"]] == ["all_reduce"] * 4


def tp_calls(pools, D, dtype=np.float32):
    A = randn(12, (N, N), dtype)
    return pools[D].run("tp_factor", A=A, w=W)["calls"]


def test_tp_collective_count_canary(pools):
    """One broadcast per panel and one all_reduce (the factors' gather) per
    factorization, whatever the number of ranks: a change that adds
    per-panel collectives shows here."""
    counts = {}
    for D in (1, 2, 4):
        kinds = [c[0] for c in tp_calls(pools, D)]
        counts[D] = (kinds.count("broadcast"), kinds.count("all_reduce"), len(kinds))
        assert kinds[-1] == "all_reduce"
    assert counts[1] == counts[2] == counts[4] == (N // W, 1, N // W + 1), counts


def test_tp_collective_payload_canary(pools):
    """Every broadcast carries one (H, w) panel with H <= N, H the height
    of its stage (N - j0*w for a stage starting at panel j0); in all about
    half the 4*N^2 bytes a full-height schedule would send."""
    calls = tp_calls(pools, 4)
    panels = [c for c in calls if c[0] == "broadcast"]
    heights = []
    for _, shape, dtype in panels:
        assert dtype == "torch.float32" and shape[1] == W and shape[0] <= N, (shape, dtype)
        heights.append(shape[0])
    nb, stages = N // W, 4
    want = [N - (nb * t // stages) * W for t in range(stages) for _ in range(nb // stages)]
    assert heights == want
    total = 4 * W * sum(heights)
    assert N * N <= total <= 4 * N * N, total
    assert calls[-1][0] == "all_reduce" and np.prod(calls[-1][1]) == 4 * N * N


def test_tp_solve_collective_canary(pools, f64_case):
    """A solve makes 2 * nb broadcasts of one (N, k) update and nothing
    else."""
    B = randn(13, (N, 2))
    calls = pools[2].run("tp_solve", A=f64_case["A"], w=W, rhs=[(B, "N"), (B[:, 0], "T")])["calls"]
    for k, solve_calls in zip((2, 1), calls):
        assert solve_calls == [("broadcast", (N, k), "torch.float64")] * (2 * N // W)


def test_tp_and_sharded_refuse_what_is_not_ported(pools):
    """The refusals that stand (not square, rhs rows, a batch that does not
    split, an unknown panel backend); complex, half and integer matrices,
    which were refused until their port, now factor: complex in their own
    type, half rounded back from float32, integer as float64."""
    got = pools[2].run("raises")
    assert got["raised"] == {
        "complex": None,
        "half": None,
        "integer": None,
        "not_square": "ValueError",
        "rhs_rows": "ValueError",
        "complex_solve": None,
        "batch_split": "ValueError",
        "tp_backend": "ValueError",
    }, got["raised"]
    assert got["results"] == {
        "complex": {"dtype": "torch.complex128", "info": 0},
        "half": {"dtype": "torch.float16", "info": 0},
        "integer": {"dtype": "torch.float64", "info": 0},
        "complex_solve": {"dtype": "torch.complex64", "info": None},
    }, got["results"]


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA: without a card the call raises before it
    touches the mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    A = np.eye(64)
    F = rt.lu(A, device="cpu")
    for call in (lambda: rt.tp_lu_factor(A, None), lambda: rt.tp_lu(A, None),
                 lambda: rt.tp_lu_solve(F, A[0], None),
                 lambda: rt.sharded_batched_lu_factor(A[None], None),
                 lambda: rt.sharded_batched_lu_solve(A[None], np.zeros((1, 64)), A[:1], None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
