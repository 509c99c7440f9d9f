"""Every file of the benchmark's folders loads and agrees with
BENCHMARK.json, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from bench_port import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_the_contracts_keys_and_names():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = harness.metric_names(BENCH, cell, trace=False)
    per_layer = harness.metric_names(BENCH, cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for name in per_layer:
        assert PER_LAYER[name]["moves"] in e2e


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_agrees(config):
    path = ROOT / config["file"]
    assert path.parent == harness.BENCH_DIR / "configs" and path.stem == config["name"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert config["source"].startswith("https://")
    assert "assumed" in data
    assert (harness.BENCH_DIR / "references" / f"{data['reference']}.py").is_file()
    limits = data["check"]["limits"]
    assert set(limits) == {"solve_residual", "solve_backward_error", "factor_residual",
                           "max_abs_l", "pivots_out_of_range", "info_mismatch"}
    assert set(data["check"]["why"]) == set(limits)
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file_agrees(cell):
    data = json.loads((harness.BENCH_DIR / "workloads" / f"{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == cell[key]
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert (harness.BENCH_DIR / "entries" / f"{data['entry']}.py").is_file()
    config = json.loads((harness.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
    if "batch" in config:
        assert data["batch"] == config["batch"]
    assert data["pool"] >= 1 and data["sample"] >= 1 and data["trace_seconds"] > 0
    assert isinstance(data["n"], int) and data["n"] > 0


def test_every_metric_file_has_an_entry_and_every_entry_a_file():
    files = {p.stem for p in (harness.BENCH_DIR / "metrics").glob("*.py")}
    assert files == set(E2E) | set(PER_LAYER)


@pytest.mark.parametrize("name", sorted(set(E2E) | set(PER_LAYER)))
def test_metric_file_agrees(name):
    module = harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")
    entry = E2E.get(name) or PER_LAYER[name]
    assert (module.UNIT, module.BETTER, module.SOURCE) == (
        entry["unit"], entry["better"], entry["source"])
    if name in PER_LAYER:
        assert (module.LAYER, module.MOVES) == (entry["layer"], entry["moves"])
        assert entry["moves"] in E2E
        for cell in entry.get("workloads", []):
            assert cell in CELLS and entry["moves"] in harness.metric_names(BENCH, cell, False)
    assert callable(module.read)


def test_layers_are_named_as_perf_md_lists_them():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
    for m in PER_LAYER.values():
        if name_is_roofline(m["name"]):
            assert m["unit"] == "%"


def name_is_roofline(name):
    return name.endswith("_roofline") or "mfu" in name

