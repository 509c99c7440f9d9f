"""What decides ``correct`` in the DSGESV cell ``dsgesv_f64.replay_n4096``, and
the readers of its refinement's metrics: the port and the plain reference in
its place come out correct; the TF32 control (by the factors' numbers), a
solve that skipped its refinement (float32 digits), one that stopped a step
short of LAPACK's test or at a test with N in place of sqrt(N), factors
rounded to TF32, one entry of x off and the state returned unchanged come
out not correct;
the entry and the reference refine as the configuration says.  On the CPU,
the cell cut to n = 128 and 96; marked ``cuda``, the solve's faults at the
cell's n = 4096 on the card."""

import json
import math
import subprocess
import sys
import textwrap

import pytest
import torch

import recursivefactorization_jl_tpu_torch as rt
from bench_port import control, harness, mixed_work, rbt_work, record, work
from recursivefactorization_jl_tpu_torch.models import mixed as mixed_mod
from recursivefactorization_jl_tpu_torch.ops import _counts

CELL = "dsgesv_f64.replay_n4096"
REF = harness.load_module(harness.BENCH_DIR / "references" / "mixed_lu.py")
ENTRY = harness.load_module(harness.BENCH_DIR / "entries" / "dsgesv_solve.py")
CONFIG = json.loads((harness.BENCH_DIR / "configs" / "dsgesv_f64.json").read_text())
SIZES = {"n128": dict(n=128, pool=2), "n96": dict(n=96, pool=2)}


def run(size, entry=None, seed=2147483659):
    return harness.run_cell(CELL, seed, 0.2, False, device="cpu", overrides=SIZES[size],
                            entry=entry)


@pytest.mark.parametrize("size", list(SIZES))
def test_the_mixed_port_comes_out_correct(size):
    _counts.reset_counts()
    result, compared = run(size)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == set(harness.metric_names(
        harness.load_spec(CELL)["bench"], CELL, False))
    # every call refined to LAPACK's test, none fell back
    iters = rt.mixed_lu_solve.counts.iters
    assert iters and min(iters) >= 1


@pytest.mark.parametrize("size", list(SIZES))
def test_the_dsgesv_reference_in_the_ports_place_comes_out_correct(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=False))
    assert result["correct"], compared


@pytest.mark.parametrize("size", list(SIZES))
def test_the_dsgesv_tf32_control_comes_out_not_correct_by_its_factors(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=True))
    assert not result["correct"] and result["failed"] > 0
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


def _misstopped(F, b, fault):
    """The port's own passes (models/mixed.py) on the vector b, stopped
    where DSGESV would not stop: ``one_step_short``, the iterate before the
    one that passes LAPACK's test; ``n_scaled_test``, the first iterate that
    passes the test with N in place of sqrt(N)."""
    B = b[:, None].contiguous()
    tensors = (F.factors, F.perm, F.A, B, F.anrm)
    x, sr, status = mixed_mod._first(*tensors, F.overflow, F.info, ENTRY.ITERMAX)
    loose = F.anrm * REF.EPS * F.n
    xs = [x]
    while int(status[0]) == 0:
        if fault == "n_scaled_test" and bool((B - F.A @ x).abs().max() <= x.abs().max() * loose):
            break
        x, sr = mixed_mod._step(*tensors, x, sr, status, ENTRY.ITERMAX)
        xs.append(x)
    assert int(status[0]) in (0, 1), "the broken ports refine; they do not fall back"
    return (xs[-2] if fault == "one_step_short" and len(xs) > 1 else xs[-1])[:, 0]


class Broken:
    """The port's calls with one fault planted where the answer is made."""

    def __init__(self, fault):
        self.fault = fault

    def warm(self, A, b, device):
        ENTRY.warm(A, b, device)

    def release(self):
        ENTRY.release()

    def call(self, A, b, device):
        dev = ENTRY._device(device)
        if self.fault == "steps_skipped":
            # the float32 solve of single(b), widened, returned unrefined
            F = rt.lu(A.float(), check=False, device=dev)
            return F.factors, F.ipiv, F.info, rt.lu_solve(F, b.float()).double()
        if self.fault == "tf32_factors":
            # factors at TF32 precision, refined in float64 as the port does
            F = rt.mixed_lu(A, device=dev)
            F.factors = REF._DENSE.round_tf32(F.factors)
            return F.factors, F.ipiv, F.info, rt.mixed_lu_solve(F, b, itermax=ENTRY.ITERMAX)
        if self.fault in ("one_step_short", "n_scaled_test"):
            F = rt.mixed_lu(A, device=dev)
            return F.factors, F.ipiv, F.info, _misstopped(F, b, self.fault)
        factors, ipiv, info, x = ENTRY.call(A, b, device)
        if self.fault == "state_unchanged":
            ipiv = torch.arange(A.shape[-1], dtype=ipiv.dtype, device=ipiv.device)
            return A.float(), ipiv, torch.zeros_like(info), b.clone()
        x = x.clone()  # answer_altered: one entry of the solution off by its largest entry
        x[0] += x.abs().amax()
        return factors, ipiv, info, x


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("fault", ["steps_skipped", "answer_altered"])
def test_each_fault_of_the_mixed_solve_comes_out_not_correct_by_both_solve_numbers(fault, size):
    result, compared = run(size, Broken(fault))
    assert not result["correct"] and result["failed"] > 0
    for key in ("solve_residual", "solve_backward_error"):
        assert compared[key]["value"] > compared[key]["limit"], (key, compared)


@pytest.mark.parametrize("size", list(SIZES))
def test_a_solve_stopped_one_step_short_of_lapacks_test_comes_out_not_correct(size):
    result, compared = run(size, Broken("one_step_short"))
    assert not result["correct"] and result["failed"] > 0
    assert compared["solve_residual"]["value"] > compared["solve_residual"]["limit"], compared


def test_a_solve_stopped_by_an_n_scaled_test_breaks_the_promise_at_its_n():
    """The limit is the promise at the cell's N = 4096 (HPL's residual at
    most 1/sqrt(N)).  Cut to n = 256, on the second matrix of seed 77's pool
    the test with N in place of sqrt(N) stops a step before LAPACK's: its x
    reads past 1/sqrt(256) and past the limit, where the port's x meets
    both."""
    spec = harness.load_spec(CELL)
    cpu = torch.device("cpu")
    pool = harness.Pool(harness.Traffic({**spec["cell"], "n": 256, "pool": 2}, 77),
                        spec["config"], cpu)
    A, b = pool.inputs(1)
    limit = CONFIG["check"]["limits"]["solve_residual"]
    got = {}
    for name, entry in (("port", ENTRY), ("broken", Broken("n_scaled_test"))):
        factors, ipiv, info, x = entry.call(A, b, cpu)
        got[name] = REF.judge(A, b, factors, ipiv, info, x, CONFIG["check"]["measures"],
                              torch.float64)["solve_residual"]
    assert got["broken"] > 1 / math.sqrt(256) > limit >= got["port"], got


@pytest.mark.parametrize("size", list(SIZES))
def test_tf32_factors_refined_in_float64_come_out_not_correct_by_their_residual(size):
    result, compared = run(size, Broken("tf32_factors"))
    assert not result["correct"]
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


def test_the_state_unchanged_comes_out_not_correct():
    result, compared = run("n96", Broken("state_unchanged"))
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["steps_skipped", "answer_altered"])
def test_each_fault_of_the_mixed_solve_comes_out_not_correct_on_the_card(fault):
    """At the cell's n = 4096."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, compared = harness.run_cell(CELL, 2147483659, 1.0, False, device="cuda",
                                        entry=Broken(fault))
    assert not result["correct"], compared
    for key in ("solve_residual", "solve_backward_error"):
        assert compared[key]["value"] > compared[key]["limit"], (key, compared)


@pytest.mark.cuda
def test_a_solve_stopped_one_step_short_comes_out_not_correct_on_the_card():
    """At the cell's n = 4096, by HPL's residual: the iterate before the one
    that passes LAPACK's test reads past 1/sqrt(N)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, compared = harness.run_cell(CELL, 2147483659, 1.0, False, device="cuda",
                                        entry=Broken("one_step_short"))
    assert not result["correct"], compared
    assert compared["solve_residual"]["value"] > compared["solve_residual"]["limit"], compared


@pytest.mark.cuda
def test_a_solve_stopped_by_an_n_scaled_test_comes_out_not_correct_on_the_card():
    """At the cell's n = 4096, every matrix of a pool: the port reads HPL's
    residual within the limit on each, the test with N in place of sqrt(N)
    past it on at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec, dev = harness.load_spec(CELL), torch.device("cuda")
    pool = harness.Pool(harness.Traffic(spec["cell"], 2710200002), spec["config"], dev)
    ENTRY.warm(*pool.inputs(0), dev)
    got = {"port": [], "broken": []}
    try:
        for slot in range(spec["cell"]["pool"]):
            A, b = pool.inputs(slot)
            for name, entry in (("port", ENTRY), ("broken", Broken("n_scaled_test"))):
                factors, ipiv, info, x = entry.call(A, b, dev)
                got[name].append(REF.judge(A, b, factors, ipiv, info, x,
                                           CONFIG["check"]["measures"],
                                           torch.float64)["solve_residual"])
    finally:
        ENTRY.release()
    limit = CONFIG["check"]["limits"]["solve_residual"]
    assert max(got["port"]) <= limit < max(got["broken"]), got


def test_the_dsgesv_entry_and_reference_refine_as_the_configuration_says():
    assert isinstance(CONFIG["itermax"], int)
    assert ENTRY.ITERMAX == REF.ITERMAX == CONFIG["itermax"] == 30
    g = torch.Generator().manual_seed(4)
    A = torch.rand(40, 40, generator=g, dtype=torch.float64) - 0.5
    b = torch.rand(40, generator=g, dtype=torch.float64) - 0.5
    f, ipiv, info = REF.lu_factor(A)
    assert f.dtype == torch.float32 and f.mixed_matrix is A and f.mixed_tf32 is False
    x, it = REF.solve(f, ipiv, info, b, A)
    assert it >= 1 and torch.equal(REF.lu_solve(f, ipiv, b), x)
    assert REF.solve(f, ipiv, info, b, A, itermax=0)[1] == -1
    with pytest.raises(ValueError, match="mixed_matrix"):
        REF.lu_solve(f.clone(), ipiv, b)


def test_the_dsgesv_reference_keeps_tf32_off_and_loads_nothing_of_the_port():
    code = textwrap.dedent(f"""
        import importlib.util, json, sys, torch
        spec = importlib.util.spec_from_file_location(
            "ref", {str(harness.BENCH_DIR / "references" / "mixed_lu.py")!r})
        ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
        matmul = torch.backends.cuda.matmul
        seen = []
        real = ref._DENSE._matmul
        def spy(*a, **k):
            seen.append(matmul.fp32_precision)
            return real(*a, **k)
        ref._DENSE._matmul = spy
        matmul.fp32_precision = "tf32"
        A = torch.rand(12, 12, dtype=torch.float64) - 0.5
        b = torch.rand(12, dtype=torch.float64) - 0.5
        f, ipiv, info = ref.lu_factor(A, tf32=True)
        ref.judge(A, b, f, ipiv, info, ref.lu_solve(f, ipiv, b),
                  {{"factor": "lapack_dget01", "solve": "hpl"}}, torch.float64)
        print(json.dumps({{"seen": sorted(set(seen)), "after": matmul.fp32_precision,
                          "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.BENCH_DIR / "references")
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["seen"] == ["ieee"] and got["after"] == "tf32"
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "recursivefactorization_jl_tpu",
                                      "recursivefactorization_jl_tpu_torch", "bench_port"}


def test_the_dsgesv_judge_reads_float64_factors_in_float64s_roundoff():
    """A program that returned its fallback's float64 factors is held to A
    in float64's unit roundoff.  Its x, a float64 LU solve, meets LAPACK's
    test at this n: HPL's residual at most 1/sqrt(48), where the cell's
    limit is that bound at N = 4096."""
    g = torch.Generator().manual_seed(9)
    A = torch.rand(48, 48, generator=g, dtype=torch.float64) - 0.5
    b = torch.rand(48, generator=g, dtype=torch.float64) - 0.5
    F = rt.lu(A, device="cpu")
    x = rt.lu_solve(F, b)
    measures = CONFIG["check"]["measures"]
    got = REF.judge(A, b, F.factors, F.ipiv, F.info, x, measures, torch.float64)
    limits = CONFIG["check"]["limits"]
    assert all(got[k] <= limits[k] for k in limits if k != "solve_residual"), got
    assert got["solve_residual"] <= 1 / math.sqrt(48), got
    rounded = REF.judge(A, b, F.factors.float().double(), F.ipiv, F.info, x, measures,
                        torch.float64)
    assert rounded["factor_residual"] > limits["factor_residual"]


@pytest.mark.parametrize("n", [1, 96, 4096, 8192])
def test_the_mixed_passes_least_bytes(n):
    assert rbt_work.order_from_hpl_flops(work.hpl_flops(n)) == n
    assert mixed_work.narrow_bytes(n) == 12 * n * n + 12
    assert mixed_work.residual_bytes(n) == 8 * n * n + 28 * n + 16
    assert mixed_work.residual_flops(n) == 2 * n * n + n


def _run(ops, calls=4, n=4096):
    card = next(iter(work.PEAKS))
    return record.Run("float64", card, 0.0, 1.0, [], [1.0] * calls, [0.1] * calls,
                      work.hpl_flops(n) * calls, work.call_bytes(n, None, "float64") * calls,
                      ops=ops, traced=True)


def test_the_mixed_readers_read_their_kernels_and_nothing_else():
    """Four calls, each one narrowing (70 us) and three residual passes
    (50 us) beside other kernels; a program without the kernels (the
    parent's) reads nothing."""
    read = {name: harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read
            for name in ("mixed_ms", "mixed_passes", "mixed_narrow_roofline",
                         "mixed_residual_roofline")}
    nk = "mixed_narrow_kernel(double const*, float*, unsigned long long*, int*, int)"
    rk = "mixed_residual_kernel(double const*, double const*, double const*, double const*)"
    ops = []
    for c in range(4):
        t = c * 1_000_000
        ops.append(record.DeviceOp("kernel", nk, t, t + 70_000))
        ops += [record.DeviceOp("kernel", rk, t + 100_000 * (i + 1), t + 100_000 * (i + 1)
                                + 50_000) for i in range(3)]
    others = [record.DeviceOp("kernel", "panel_chain_kernel", 5, 90_000),
              record.DeviceOp("kernel", "elementwise_kernel", 0, 10)]
    run = _run(ops + others)
    assert read["mixed_ms"](run) == pytest.approx(0.07 + 3 * 0.05)
    assert read["mixed_passes"](run) == 3
    bw = work.PEAKS[run.device_kind]["bytes_per_s"]
    assert read["mixed_narrow_roofline"](run) == pytest.approx(
        100 * mixed_work.narrow_bytes(4096) / bw / 70e-6)
    assert read["mixed_residual_roofline"](run) == pytest.approx(
        100 * mixed_work.residual_bytes(4096) / bw / 50e-6)
    assert 0 < read["mixed_residual_roofline"](run) <= 100
    for bare in (_run(others), _run([])):
        assert all(r(bare) is None for r in read.values())
