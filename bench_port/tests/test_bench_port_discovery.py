"""A cell added as a file of its own and an entry of BENCHMARK.json is found
and run by the harness, with no other file edited."""

import json
import shutil
import subprocess
import sys
import textwrap

from bench_port import harness


def test_a_new_cell_file_is_found_without_other_edits(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(copy): p.read_bytes() for p in (copy / "bench_port").rglob("*")
              if p.is_file()}
    cell = {"config": "lu_f32", "traffic": "replay_n40", "chips": 1, "entry": "lu_solve",
            "n": 40, "batch": None, "pool": 2, "sample": 2,
            "trace_seconds": 1, "why": "a cell added by data alone"}
    (copy / "bench_port" / "workloads" / "lu_f32.replay_n40.json").write_text(json.dumps(cell))
    bench["workloads"].append({k: cell[k] for k in ("config", "traffic", "chips", "why")}
                              | {"name": "lu_f32.replay_n40"})
    for m in bench["end_to_end"]:
        if m["name"] == "gflops":
            m["workloads"].append("lu_f32.replay_n40")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(copy)!r}, {str(harness.ROOT)!r}]
        from bench_port import harness
        assert harness.BENCH_DIR.parent == __import__("pathlib").Path({str(copy)!r})
        result, compared = harness.run_cell("lu_f32.replay_n40", 5, 0.2, False, device="cpu")
        print(json.dumps(result))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=copy)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"gflops", "setup_s"}
    after = {p.relative_to(copy): p.read_bytes() for p in (copy / "bench_port").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
