"""What decides ``correct`` in the float64 cell ``lu_f64.replay_n4096``: its
reference factors as LAPACK does and keeps TF32 off; the port and the
reference in its place come out correct; the float32-update control, a
float32 factorization whose solution was refined in float64 to HPL's
threshold (HPL-MxP's way), the state returned unchanged and an altered
answer come out not correct.  On the CPU, the cell cut to n = 128 and 96."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from bench_port import control, harness

CELL = "lu_f64.replay_n4096"
REF = harness.load_module(harness.BENCH_DIR / "references" / "dense_lu_f64.py")
REF32 = harness.load_module(harness.BENCH_DIR / "references" / "dense_lu.py")
SIZES = {"n128": dict(n=128, pool=2), "n96": dict(n=96, pool=2)}


def run(size, entry=None, seed=2147483659):
    return harness.run_cell(CELL, seed, 0.2, False, device="cpu", overrides=SIZES[size],
                            entry=entry)


@pytest.mark.parametrize("batch", [None, 5])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_reference_pivots_as_lapack_does(seed, batch):
    g = torch.Generator().manual_seed(seed)
    shape = (90, 90) if batch is None else (batch, 90, 90)
    A = torch.rand(shape, generator=g, dtype=torch.float64) - 0.5
    f, ipiv, info = REF.lu_factor(A)
    lf, lpiv = torch.linalg.lu_factor(A)
    assert f.dtype == torch.float64
    assert torch.equal(ipiv.long(), lpiv.long() - 1)
    assert torch.allclose(f, lf, rtol=0, atol=1e-12)
    assert int(info.abs().max()) == 0


def test_the_control_rounds_every_update_product_to_float32():
    A = torch.rand(6, 64, 64, generator=torch.Generator().manual_seed(3),
                   dtype=torch.float64) - 0.5
    b = torch.rand(6, 64, generator=torch.Generator().manual_seed(4), dtype=torch.float64) - 0.5
    measures = {"factor": "lapack_dget01", "solve": "hpl"}
    out = REF.lu_factor(A)
    sound = REF.judge(A, b, *out, REF.lu_solve(out[0], out[1], b), measures, torch.float64)
    low_out = REF.lu_factor(A, tf32=True)
    low = REF.judge(A, b, *low_out, REF.lu_solve(low_out[0], low_out[1], b), measures,
                    torch.float64)
    assert low_out[0].dtype == torch.float64
    assert torch.equal(low_out[1], out[1])  # the same pivots on these matrices
    assert sound["factor_residual"] < 1 and sound["solve_residual"] < 1
    # float32 products: some 2^29 times float64's unit roundoff, over n
    assert low["factor_residual"] > 1e5 * sound["factor_residual"]
    assert low["solve_backward_error"] > 1e5 * sound["solve_backward_error"]


@pytest.mark.parametrize("legacy", [True, False], ids=["allow_tf32", "fp32_precision"])
def test_the_reference_keeps_tf32_off_while_it_runs_and_restores_the_callers_setting(legacy):
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {str(harness.ROOT)!r})
        from bench_port import harness
        ref = harness.load_module(harness.BENCH_DIR / "references" / "dense_lu_f64.py")
        matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        seen = []
        real = ref._product
        def spy(*a, **k):
            seen.append([matmul.allow_tf32, cudnn.allow_tf32] if {legacy} else
                        [matmul.fp32_precision, cudnn.conv.fp32_precision])
            return real(*a, **k)
        ref._product = spy
        if {legacy}:
            matmul.allow_tf32 = cudnn.allow_tf32 = True
        else:
            matmul.fp32_precision = cudnn.conv.fp32_precision = "tf32"
        ref.lu_factor(torch.rand(40, 40, dtype=torch.float64), tf32=True)
        after = ([matmul.allow_tf32, cudnn.allow_tf32] if {legacy} else
                 [matmul.fp32_precision, cudnn.conv.fp32_precision])
        print(json.dumps({{"seen": seen, "after": after}}))
    """)
    # a child process: the settings are the process's, and PyTorch refuses
    # to read the legacy flags once the current API was set
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    off = [False, False] if legacy else ["ieee", "ieee"]
    on = [True, True] if legacy else ["tf32", "tf32"]
    assert got["seen"] and all(s == off for s in got["seen"])
    assert got["after"] == on


@pytest.mark.parametrize("size", list(SIZES))
def test_the_port_comes_out_correct(size):
    result, compared = run(size)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == set(harness.metric_names(
        harness.load_spec(CELL)["bench"], CELL, False))


@pytest.mark.parametrize("size", list(SIZES))
def test_the_plain_reference_in_the_ports_place_comes_out_correct(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=False))
    assert result["correct"], compared


@pytest.mark.parametrize("size", list(SIZES))
def test_the_float32_update_control_comes_out_not_correct_by_factor_residual(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=True))
    assert not result["correct"] and result["failed"] > 0
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


class Refined:
    """HPL-MxP's way in the port's place: the factors of float32 LU, and the
    solution refined in float64 (float64 residuals, float32 corrections)
    until HPL's scaled residual is below its threshold."""

    def __init__(self):
        self.limit = json.loads((harness.BENCH_DIR / "configs" / "lu_f64.json").read_text())[
            "check"]["limits"]["solve_residual"]

    def warm(self, A, b, device):
        pass

    def release(self):
        pass

    def call(self, A, b, device):
        f, ipiv, info = REF32.lu_factor(A.float())
        x = REF32.lu_solve(f, ipiv, b.float()).double()
        eps, n = torch.finfo(torch.float64).eps / 2, A.shape[-1]
        for _ in range(20):
            r = b - A @ x
            scaled = r.abs().max() / (eps * (A.abs().sum(1).max() * x.abs().max()
                                             + b.abs().max()) * n)
            if scaled < self.limit / 4:
                break
            x = x + REF32.lu_solve(f, ipiv, r.float()).double()
        return f.double(), ipiv, info, x


@pytest.mark.parametrize("size", list(SIZES))
def test_a_float32_factorization_refined_in_float64_comes_out_not_correct(size):
    result, compared = run(size, Refined())
    # the solve passes both its numbers: only the factors' own residual,
    # in float64's eps, tells it apart
    for k in ("solve_residual", "solve_backward_error"):
        assert compared[k]["value"] <= compared[k]["limit"], compared
    assert not result["correct"] and result["failed"] > 0
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


class Broken:
    """The port's calls with one fault planted where the answer is made."""

    def __init__(self, fault):
        self.entry = harness.load_module(harness.BENCH_DIR / "entries" / "lu_solve.py")
        self.fault = fault

    def warm(self, A, b, device):
        self.entry.warm(A, b, device)

    def release(self):
        self.entry.release()

    def call(self, A, b, device):
        factors, ipiv, info, x = self.entry.call(A, b, device)
        if self.fault == "state_unchanged":
            # the step hands back its input as if it were the answer
            ipiv = torch.arange(A.shape[-1], dtype=ipiv.dtype)
            return A.clone(), ipiv, torch.zeros_like(info), b.clone()
        # answer_altered: one entry of the solution off by its largest entry
        x = x.clone()
        x[0] += x.abs().amax()
        return factors, ipiv, info, x


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_each_fault_comes_out_not_correct(fault, size):
    result, compared = run(size, Broken(fault))
    assert not result["correct"], compared
    assert result["failed"] > 0


def test_the_reference_loads_nothing_of_the_port_nor_the_benchmark():
    code = textwrap.dedent(f"""
        import importlib.util, json, sys, torch
        spec = importlib.util.spec_from_file_location(
            "ref", {str(harness.BENCH_DIR / "references" / "dense_lu_f64.py")!r})
        ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
        A = torch.rand(12, 12, dtype=torch.float64) - 0.5
        b = torch.rand(12, dtype=torch.float64) - 0.5
        f, ipiv, info = ref.lu_factor(A, tf32=True)
        ref.judge(A, b, f, ipiv, info, ref.lu_solve(f, ipiv, b),
                  {{"factor": "lapack_dget01", "solve": "hpl"}}, torch.float64)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.BENCH_DIR / "references")
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "recursivefactorization_jl_tpu",
                        "recursivefactorization_jl_tpu_torch", "bench_port"}
