"""What decides ``correct`` in the RBT cell ``rbt_f32.replay_n4096``, and the
readers of its transform's metrics: the port and the plain reference in its
place come out correct; the TF32 control, a factorization with a row
swapped, the state returned unchanged, an altered answer, a solve that
skipped its refinement step and a solve from TF32-rounded factors come out
not correct; the reference's butterfly values are the port's; the entry
and the reference refine as the configuration says.  On the CPU, the cell
cut to n = 128 and 96; marked ``cuda``, the solve's faults at the cell's
n = 4096 on the card.

HPL's residual (``solve_residual``, limit 2000) refuses only a solution of
no digits at n = 4096: RBT's own refined solutions there read up to ~50
(PERF.md §2).  The solve is held by ``solve_backward_error``, which the
reference reads as the distance of x from the exact refined solve of the
port's own factors (``rbt_lu.refined_steps``): a skipped step, a solve in
a lower precision and an altered entry read 1 or more, the port well
under its limit."""

import dataclasses
import json
import subprocess
import sys
import textwrap

import pytest
import torch

import recursivefactorization_jl_tpu_torch as rt
from bench_port import control, harness, rbt_work, record, work

CELL = "rbt_f32.replay_n4096"
REF = harness.load_module(harness.BENCH_DIR / "references" / "rbt_lu.py")
ENTRY = harness.load_module(harness.BENCH_DIR / "entries" / "rbt_solve.py")
CONFIG = json.loads((harness.BENCH_DIR / "configs" / "rbt_f32.json").read_text())
SIZES = {"n128": dict(n=128, pool=2), "n96": dict(n=96, pool=2)}


def run(size, entry=None, seed=2147483659):
    return harness.run_cell(CELL, seed, 0.2, False, device="cpu", overrides=SIZES[size],
                            entry=entry)


@pytest.mark.parametrize("size", list(SIZES))
def test_the_port_comes_out_correct(size):
    result, compared = run(size)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert compared["pivots_out_of_range"]["value"] == 0
    assert set(result["metrics"]) == set(harness.metric_names(
        harness.load_spec(CELL)["bench"], CELL, False))


@pytest.mark.parametrize("size", list(SIZES))
def test_the_plain_reference_in_the_ports_place_comes_out_correct(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=False))
    assert result["correct"], compared


@pytest.mark.parametrize("size", list(SIZES))
def test_the_tf32_control_comes_out_not_correct(size):
    result, compared = run(size, control.reference_entry(CELL, tf32=True))
    assert not result["correct"] and result["failed"] > 0
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


class Broken:
    """The port's calls with one fault planted where the answer is made."""

    def __init__(self, fault):
        self.fault = fault

    def warm(self, A, b, device):
        ENTRY.warm(A, b, device)

    def release(self):
        ENTRY.release()

    def call(self, A, b, device):
        if self.fault in ("refine_skipped", "tf32_solve"):
            ws = rt.butterfly_workspace(A, b, device=ENTRY._device(device))
            F = rt.butterfly_factor(ws)
            if self.fault == "refine_skipped":
                # the solve returns before its refinement step
                x = rt.butterfly_factor_solve(F, ws.b, refine=ENTRY.REFINE - 1)
            else:
                # the solve's operands at TF32 precision: the factors rounded
                S = dataclasses.replace(F, factors=REF._DENSE.round_tf32(F.factors))
                x = rt.butterfly_factor_solve(S, ws.b, refine=ENTRY.REFINE)
            return F.factors, F.ipiv, F.info, x
        factors, ipiv, info, x = ENTRY.call(A, b, device)
        if self.fault == "row_swapped":
            # a factorization that moved row 0 below row 1: ipiv says so
            factors, ipiv = factors.clone(), ipiv.clone()
            factors[[0, 1]] = factors[[1, 0]]
            ipiv[0] = 1
        elif self.fault == "state_unchanged":
            # the step hands back its input as if it were the answer
            ipiv = torch.arange(A.shape[-1], dtype=ipiv.dtype, device=ipiv.device)
            return A.clone(), ipiv, torch.zeros_like(info), b.clone()
        else:  # answer_altered: one entry of the solution off by its largest entry
            x = x.clone()
            x[0] += x.abs().amax()
        return factors, ipiv, info, x


@pytest.mark.parametrize("size", list(SIZES))
def test_a_factorization_with_a_row_swapped_comes_out_not_correct_by_its_pivots(size):
    result, compared = run(size, Broken("row_swapped"))
    assert not result["correct"] and result["failed"] > 0
    assert compared["pivots_out_of_range"]["value"] > 0


@pytest.mark.parametrize("fault,size", [("state_unchanged", "n128"), ("state_unchanged", "n96"),
                                        ("answer_altered", "n96")])
def test_each_fault_comes_out_not_correct(fault, size):
    result, compared = run(size, Broken(fault))
    assert not result["correct"], compared
    assert result["failed"] > 0


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("fault", ["answer_altered", "refine_skipped", "tf32_solve"])
def test_each_fault_of_the_solve_comes_out_not_correct_by_its_refined_solve(fault, size):
    result, compared = run(size, Broken(fault))
    assert not result["correct"] and result["failed"] > 0
    held = compared["solve_backward_error"]
    assert held["value"] > held["limit"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["answer_altered", "refine_skipped", "tf32_solve"])
def test_each_fault_of_the_solve_comes_out_not_correct_on_the_card(fault):
    """At the cell's n = 4096, where HPL's residual tells none of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, compared = harness.run_cell(CELL, 2147483659, 1.0, False, device="cuda",
                                        entry=Broken(fault))
    held = compared["solve_backward_error"]
    assert not result["correct"] and held["value"] > held["limit"], compared


def _with_a_zero_pivot(k, schur, m=64):
    """(A, factors) of a breakdown at step k: the packed L and U of the
    steps before it with a zero pivot, entries past the pivot drawn at
    random (what a program leaves there is its own), and the matrix A whose
    transform has them as its leading factors, the Schur complement's
    entry at the pivot ``schur`` (0: a true zero pivot) and a column below
    it that is not zero."""
    g = torch.Generator().manual_seed(k)
    L = torch.tril(torch.rand(m, m, generator=g, dtype=torch.float64) - 0.5, -1)
    L += torch.eye(m, dtype=torch.float64)
    U = torch.triu(torch.rand(m, m, generator=g, dtype=torch.float64) - 0.5)
    U += 2 * torch.eye(m, dtype=torch.float64)
    S = torch.zeros(m, m, dtype=torch.float64)
    S[k:, k:] = torch.rand(m - k, m - k, generator=g, dtype=torch.float64) - 0.5
    S[k, k] = schur
    U[k:, k:] = 0
    L[k:, k:] = torch.eye(m - k, dtype=torch.float64)
    Ub, Vb = REF.butterflies(REF.butterfly_values(m, torch.float32, "cpu").double())
    A = torch.linalg.solve(Ub.T, torch.linalg.solve(Vb.T, (L @ (U + S)).T).T)  # U^-T A~ V^-1
    F = torch.tril(L, -1) + U
    F[k + 1:, k:] = 5 * torch.rand(m - k - 1, m - k, generator=g, dtype=torch.float64)
    F[k, k + 1:] = torch.rand(m - k - 1, generator=g, dtype=torch.float64)
    return A, F


@pytest.mark.parametrize("k", [1, 20, 63])
def test_a_zero_pivot_is_held_to_the_steps_before_it(k):
    """Without pivoting A~ may meet an exact zero pivot (a float32 HPL
    matrix at n = 4096 did: PERF.md §2); the program reports it in info and
    promises no solution.  The factors' residual then reads the columns
    before the pivot and the pivot's down to it, which refuses a zero put
    where A~'s pivot is not zero."""
    measures = CONFIG["check"]["measures"]
    limits = CONFIG["check"]["limits"]
    b = torch.rand(64, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    x = torch.full((64,), float("nan"), dtype=torch.float64)
    ipiv = torch.arange(64, dtype=torch.int32)
    A, F = _with_a_zero_pivot(k, 0.0)
    got = REF.judge(A, b, F, ipiv, torch.tensor(-(k + 1)), x, measures, torch.float32)
    assert all(got[key] <= limits[key] for key in limits), got
    A, F = _with_a_zero_pivot(k, 0.3)
    got = REF.judge(A, b, F, ipiv, torch.tensor(-(k + 1)), x, measures, torch.float32)
    assert got["factor_residual"] > limits["factor_residual"] and got["info_mismatch"] == 0
    got = REF.judge(A, b, F, ipiv, torch.tensor(0), x, measures, torch.float32)
    assert got["info_mismatch"] == 1


@pytest.mark.cuda
def test_the_seed_whose_matrix_meets_a_zero_pivot_comes_out_correct_on_the_card():
    """Seed 2525600001's fourth matrix meets an exact zero pivot at step
    1590 of the pivot-free LU in float32 (the H100, PERF.md §2): the port
    reports it in info, and the run is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = 2525600001
    result, compared = harness.run_cell(CELL, seed, 1.0, False, device="cuda")
    assert result["correct"], compared
    pool = harness.Pool(harness.Traffic(harness.load_spec(CELL)["cell"], seed),
                        CONFIG, torch.device("cuda"))
    factors, _, info, _ = ENTRY.call(*pool.inputs(3), torch.device("cuda"))
    first = int((torch.diagonal(factors) == 0).int().argmax()) + 1
    assert int(info) == -first < 0
    ENTRY.release()


@pytest.mark.parametrize("n", [128, 96, 130])
def test_the_references_values_are_the_ports(n):
    """The reference draws the butterfly values by the port's documented
    recipe: bit for bit the workspace's, at padded sizes too; its dense
    transform agrees with the port's radix code to float32's level."""
    A = torch.rand(n, n, generator=torch.Generator().manual_seed(n)) - 0.5
    ws = rt.butterfly_workspace(A, torch.zeros(n), device="cpu")
    uv = REF.butterfly_values(REF.padded(n), torch.float32, "cpu")
    assert torch.equal(uv, ws.uv)
    assert torch.equal(uv, rt.generate_butterfly_values(REF.padded(n), dtype=torch.float32,
                                                        device="cpu"))
    port = rt.butterfly_mul(ws.A, ws.uv)
    assert (REF.transformed(A) - port).abs().max() <= 8 * torch.finfo(torch.float32).eps


def test_the_entry_and_the_reference_refine_as_the_configuration_says():
    assert isinstance(CONFIG["refine"], int)
    assert ENTRY.REFINE == REF.REFINE == CONFIG["refine"] >= 1
    A = torch.rand(40, 40, generator=torch.Generator().manual_seed(4)) - 0.5
    b = torch.rand(40, generator=torch.Generator().manual_seed(5)) - 0.5
    f, ipiv, _ = REF.lu_factor(A)
    assert f.rbt_matrix is A and f.rbt_tf32 is False
    refined = REF.lu_solve(f, ipiv, b)
    assert torch.equal(refined, REF.solve(f, b, A, refine=CONFIG["refine"]))
    plain = REF.solve(f, b, refine=0)
    assert (A @ refined - b).abs().max() < (A @ plain - b).abs().max()
    # factors that lost their matrix are refused, not solved unrefined
    with pytest.raises(ValueError, match="rbt_matrix"):
        REF.lu_solve(f.clone(), ipiv, b)
    with pytest.raises(ValueError, match="needs the matrix"):
        REF.solve(f, b, refine=1)


def test_the_reference_keeps_tf32_off_and_loads_nothing_of_the_port():
    code = textwrap.dedent(f"""
        import importlib.util, json, sys, torch
        spec = importlib.util.spec_from_file_location(
            "ref", {str(harness.BENCH_DIR / "references" / "rbt_lu.py")!r})
        ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
        matmul = torch.backends.cuda.matmul
        seen = []
        real = ref._DENSE._matmul
        def spy(*a, **k):
            seen.append(matmul.fp32_precision)
            return real(*a, **k)
        ref._DENSE._matmul = spy
        matmul.fp32_precision = "tf32"
        A = torch.rand(12, 12) - 0.5
        b = torch.rand(12) - 0.5
        f, ipiv, info = ref.lu_factor(A, tf32=True)
        ref.judge(A, b, f, ipiv, info, ref.lu_solve(f, ipiv, b),
                  {{"factor": "genp_backward", "solve": "hpl", "refinement": "refined_steps"}},
                  torch.float32)
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


@pytest.mark.parametrize("n", [1, 96, 130, 1536, 4096, 8192])
def test_the_order_comes_back_from_hpls_count(n):
    assert rbt_work.order_from_hpl_flops(work.hpl_flops(n)) == n
    with pytest.raises(ValueError):
        rbt_work.order_from_hpl_flops(work.hpl_flops(n) + 1)
    m = n + (-n) % 4
    assert rbt_work.transform_bytes(n, "float32") == 4 * (2 * m * m + 4 * m)
    assert rbt_work.transform_flops(n) == 8 * m * m


def _run(ops, calls=4, n=4096):
    card = next(iter(work.PEAKS))
    return record.Run("float32", card, 0.0, 1.0, [], [1.0] * calls, [0.1] * calls,
                      work.hpl_flops(n) * calls, work.call_bytes(n) * calls, ops=ops,
                      traced=True)


def test_the_transform_readers_read_the_kernel_and_nothing_else():
    """Four calls with a 60 us transform each beside other kernels: 0.06 ms a
    call, and the share of 128 MiB + 64 KiB at 3.35 TB/s in 60 us; a
    program without the kernel (the parent's tensor code) reads nothing."""
    ms = harness.load_module(harness.BENCH_DIR / "metrics" / "rbt_transform_ms.py")
    roof = harness.load_module(harness.BENCH_DIR / "metrics" / "rbt_transform_roofline.py")
    k = "void butterfly_depth2_kernel<float, 4>(float const*, float*, float const*, int)"
    ops = [record.DeviceOp("kernel", k, 1000 * i, 1000 * i + 60_000) for i in range(0, 400, 100)]
    ops += [record.DeviceOp("kernel", "panel_chain_kernel", 5, 90_000),
            record.DeviceOp("kernel", "elementwise_kernel", 0, 10)]
    run = _run(ops)
    assert ms.read(run) == pytest.approx(0.06)
    least = (4 * (2 * 4096 ** 2 + 4 * 4096)) / work.PEAKS[run.device_kind]["bytes_per_s"]
    assert roof.read(run) == pytest.approx(100 * least / 60e-6)
    assert 0 < roof.read(run) <= 100
    bare = _run(ops[4:])
    assert ms.read(bare) is None and roof.read(bare) is None
    assert ms.read(_run([])) is None and roof.read(_run([])) is None
    unknown = _run(ops)
    unknown.device_kind = "a card work.PEAKS does not hold"
    assert ms.read(unknown) == pytest.approx(0.06) and roof.read(unknown) is None
