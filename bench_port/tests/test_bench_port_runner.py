"""The runner's own rules: no result without the cards, none from a folder
that holds only the benchmark, and a failing result from the watchdog."""

import json
import shutil
import subprocess
import sys
import textwrap

from bench_port import harness

RUN = harness.BENCH_DIR / "run.py"
ARGS = ["--workload", "batched_f32.replay_n64", "--seed", "2147483700", "--seconds", "1"]


def test_no_card_no_result():
    # the tests run where torch sees no CUDA card
    out = subprocess.run([sys.executable, str(RUN), *ARGS], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode not in (0, None) and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_folder_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "bench_port/run.py", *ARGS], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_watchdog_prints_a_failing_result_and_exits():
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(harness.BENCH_DIR)!r})
        import run
        run.start_watchdog(0.5, "lu_f32.replay_n4096", 7, {{"platform": "gpu"}})
        time.sleep(30)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 3
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False and list(line)[-1] == "compared"
    assert "watchdog" in out.stderr
