"""What decides ``correct``: the reference is right, the control (the
reference in TF32 in the port's place) and each fault a cell can have come
out as not correct, and the port's own runs come out as correct; all on the
CPU at sizes a test run holds, through the harness with its look for a chip
skipped."""

import pytest
import torch

from bench_port import control, harness

REF = harness.load_module(harness.BENCH_DIR / "references" / "dense_lu.py")
# each cell cut to a size the CPU runs in a moment (the port's plain versions)
SMALL = {
    "lu_f32.replay_n4096": dict(n=128, pool=2),
    "batched_f32.replay_n64": dict(n=64, batch=24, pool=2),
}
# the same cells at a second size, the batched one at the warp routes' n = 16
OTHER = {
    "lu_f32.replay_n4096": dict(n=96, pool=2),
    "batched_f32.replay_n64": dict(n=16, batch=24, pool=3),
}
BATCHED = [c for c in SMALL if c.startswith("batched")]
MEASURES = [{"factor": "lapack_dget01", "solve": "hpl"},
            {"factor": "magma_getrf", "solve": "magma_gesv"}]


def run(cell, entry=None, seed=11, trace=False, other=False):
    return harness.run_cell(cell, seed, 0.2, trace, device="cpu",
                            overrides=(OTHER if other else SMALL)[cell], entry=entry)


@pytest.mark.parametrize("batch", [None, 7])
def test_the_reference_factors_as_lapack_does(batch):
    g = torch.Generator().manual_seed(1)
    shape = (70, 70) if batch is None else (batch, 70, 70)
    A = torch.rand(shape, generator=g, dtype=torch.float64) - 0.5
    b = torch.rand(shape[:-1], generator=g, dtype=torch.float64) - 0.5
    f, ipiv, info = REF.lu_factor(A)
    lf, lpiv = torch.linalg.lu_factor(A)
    assert torch.equal(ipiv.long(), lpiv.long() - 1)
    assert torch.allclose(f, lf, rtol=0, atol=1e-12)
    assert int(info.abs().max()) == 0
    x = REF.lu_solve(f, ipiv, b)
    assert torch.allclose(x, torch.linalg.solve(A, b[..., None])[..., 0], atol=1e-9)


def test_the_reference_reports_a_zero_pivot():
    A = torch.rand(3, 16, 16, dtype=torch.float64) - 0.5
    A[1, :, 5] = 0
    f, ipiv, info = REF.lu_factor(A)
    assert info.tolist() == [0, 6, 0]
    b = torch.ones(3, 16, dtype=torch.float64)
    got = REF.judge(A, b, f, ipiv, info, torch.zeros(3, 16, dtype=torch.float64),
                    MEASURES[1], torch.float32)
    assert got["info_mismatch"] == 0
    info[2] = 4
    got = REF.judge(A, b, f, ipiv, info, torch.zeros(3, 16, dtype=torch.float64),
                    MEASURES[1], torch.float32)
    assert got["info_mismatch"] == 1


@pytest.mark.parametrize("measures", MEASURES, ids=lambda m: m["factor"])
def test_judge_reads_float32_factors_as_sound_and_tf32_ones_as_not(measures):
    A = torch.rand(8, 96, 96, generator=torch.Generator().manual_seed(2)) - 0.5
    b = torch.rand(8, 96, generator=torch.Generator().manual_seed(3)) - 0.5
    out = REF.lu_factor(A)
    sound = REF.judge(A, b, *out, REF.lu_solve(out[0], out[1], b), measures, torch.float32)
    out = REF.lu_factor(A, tf32=True)
    low = REF.judge(A, b, *out, REF.lu_solve(out[0], out[1], b), measures, torch.float32)
    assert sound["factor_residual"] < 1 and sound["solve_residual"] < 1
    assert sound["max_abs_l"] <= 1 and sound["pivots_out_of_range"] == 0
    assert low["factor_residual"] > 100 * sound["factor_residual"]
    assert low["solve_backward_error"] > 100 * sound["solve_backward_error"]


def test_round_tf32_keeps_ten_mantissa_bits():
    # the last kept bit is 2^-10 in [1, 2) and 2^-9 in [2, 4); halves round away
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -10,
                      -3.0 - 2 ** -11])
    assert REF.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                          -3.0 - 2 ** -9, -3.0]


@pytest.mark.parametrize("other", [False, True], ids=["small", "other_size"])
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_port_comes_out_correct(cell, other):
    result, compared = run(cell, other=other)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == set(harness.metric_names(
        harness.load_spec(cell)["bench"], cell, False))


@pytest.mark.parametrize("other", [False, True], ids=["small", "other_size"])
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_comes_out_not_correct(cell, other):
    result, compared = run(cell, control.reference_entry(cell, tf32=True), other=other)
    assert not result["correct"]
    assert compared["factor_residual"]["value"] > compared["factor_residual"]["limit"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_plain_reference_in_the_ports_place_comes_out_correct(cell):
    result, compared = run(cell, control.reference_entry(cell, tf32=False))
    assert result["correct"], compared


class Broken:
    """The port's calls with one fault planted where the answer is made."""

    def __init__(self, cell, fault):
        self.entry = harness.load_module(
            harness.BENCH_DIR / "entries" / f"{harness.load_spec(cell)['cell']['entry']}.py")
        self.fault = fault

    def warm(self, A, b, device):
        self.entry.warm(A, b, device)

    def release(self):
        self.entry.release()

    def call(self, A, b, device):
        factors, ipiv, info, x = self.entry.call(A, b, device)
        if self.fault == "state_unchanged":
            # the step hands back its input as if it were the answer
            n = A.shape[-1]
            ipiv = torch.arange(n, dtype=ipiv.dtype).expand_as(ipiv).clone()
            return A.clone(), ipiv, torch.zeros_like(info), b.clone()
        if self.fault == "half_batch_left_out":
            # the second half of the systems never factored nor solved
            h = A.shape[0] // 2
            factors, x = factors.clone(), x.clone()
            factors[h:], x[h:] = A[h:], b[h:]
            return factors, ipiv, info, x
        if self.fault == "answer_altered":
            # one entry of the solution off by the solution's largest entry
            x = x.clone()
            x[..., 0] += x.abs().amax(dim=-1)
            return factors, ipiv, info, x
        raise ValueError(self.fault)


FAULTS = [(c, f) for c in SMALL for f in ("state_unchanged", "answer_altered")] + [
    (c, "half_batch_left_out") for c in BATCHED]


@pytest.mark.parametrize("other", [False, True], ids=["small", "other_size"])
@pytest.mark.parametrize("cell, fault", FAULTS)
def test_each_fault_comes_out_not_correct(cell, fault, other):
    result, compared = run(cell, Broken(cell, fault), other=other)
    assert not result["correct"], compared
    assert result["failed"] > 0


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_traced_run_judges_the_same_way(cell):
    result, _ = run(cell, trace=True)
    assert result["correct"]
    assert "breakdown" in result and "busy_s" in result["device"]
    broken, _ = run(cell, Broken(cell, "answer_altered"), trace=True)
    assert not broken["correct"]
