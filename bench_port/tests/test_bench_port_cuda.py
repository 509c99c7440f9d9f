"""The benchmark on the card: each cell runs, short, through run.py, comes
out correct and prints the contract's last line; the control comes out
not correct.  Marked ``cuda``; skips without a card.

    python -m pytest bench_port/tests -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from bench_port import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(script, *args):
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / script), *args],
                         capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    _need_card()
    line = _run("run.py", "--workload", cell, "--seed", "2147483659", "--seconds", "2",
                "--trace", str(trace))[-1]
    assert line["correct"] and line["attempted"] > 0
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    assert set(line["metrics"]) <= set(harness.metric_names(BENCH, cell, bool(trace)))
    assert list(line)[-1] == "compared"
    if trace:
        assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_on_the_card(cell):
    _need_card()
    for line in _run("control.py", "--workload", cell, "--side", "control", "--seeds", "1",
                     "--seconds", "1"):
        assert not line["correct"]
