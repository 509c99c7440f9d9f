"""One run of one cell of the port's benchmark.

Everything is found by name: the cell in ``BENCHMARK.json`` and in
``workloads/<cell>.json``, its configuration in ``configs/<config>.json``,
the port's calls in ``entries/<entry>.py``, the configuration's plain
reference in ``references/<reference>.py`` and each metric's reader in
``metrics/<metric>.py``.  A run:

1. makes the seeded pool of inputs on the device and warms the cell's
   shape (the port captures its programs) -- the set-up, timed from
   process start;
2. runs the closed loop: one caller, a synchronise after every call, until
   ``seconds`` have passed (``--trace 1``: the cell's ``trace_seconds`` at
   most, under ``torch.profiler`` with CUDA activity);
3. reads the memory peak, frees the port's programs, and judges a sample
   of the calls, drawn from the seed, with the reference (``correct``);
4. asks each of the cell's metrics for its number.
"""

from __future__ import annotations

import importlib.util
import json
import random
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import record, work
from .traffic import Pool, Traffic, derive

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# a traced run writes its whole breakdown here (a few KB; bench_port/.gitignore)
TRACES = BENCH_DIR / "traces"
PROFILER_WINDOWS = 3  # traced windows tried while the profiler records no device work


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's own folders, by file (names may hold
    dots, such as ``metrics/host_issue_ms.replay.py``)."""
    rel = path.resolve().relative_to(BENCH_DIR)
    name = "bench_port._" + re.sub(r"\W", "_", str(rel.with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_spec(workload: str) -> dict:
    """The cell's entries: ``bench`` (BENCHMARK.json), ``cell`` (its file)
    and ``config`` (its configuration's file)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if not any(w["name"] == workload for w in bench["workloads"]):
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    cell = load_json(BENCH_DIR / "workloads" / f"{workload}.json")
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    return {"bench": bench, "cell": cell, "config": config}


def metric_names(bench: dict, workload: str, trace: bool) -> List[str]:
    """The metrics a cell reports: end-to-end ones (``--trace 0``) that list
    it or list no cells; per-layer ones (``--trace 1``) that list it, or
    list no cells and move an end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


class Sampler:
    """The calls whose results are judged: ``k`` drawn uniformly from all
    the window's calls by reservoir sampling from the seed, and the last
    call."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(derive(seed, "sample"))
        self.kept: list = []
        self.seen = 0
        self.last = None

    def offer(self, i: int, slot: int, out) -> None:
        item = (i, slot, out)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1
        self.last = item

    def samples(self) -> list:
        items = {it[0]: it for it in self.kept}
        if self.last is not None:
            items[self.last[0]] = self.last
        return [items[i] for i in sorted(items)]


def _window(entry, traffic, pool, seconds, device, sampler, dtype, kind, trace):
    cuda = device.type == "cuda"
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    calls, call_ms, issue_ms = [], [], []
    flops = work.hpl_flops(traffic.n, traffic.batch)
    nbytes = work.call_bytes(traffic.n, traffic.batch, dtype)
    start = time.perf_counter()
    i = 0
    try:
        while True:
            slot = traffic.next()
            A, b = pool.inputs(slot)
            w0 = time.time_ns()
            if cuda:
                ev0.record()
            h0 = time.perf_counter()
            out = entry.call(A, b, device)
            h1 = time.perf_counter()
            w1 = time.time_ns()
            if cuda:
                ev1.record()
                torch.cuda.synchronize(device)
            h2 = time.perf_counter()
            calls.append(record.Call(w0, w1, time.time_ns()))
            call_ms.append(ev0.elapsed_time(ev1) if cuda else (h2 - h0) * 1e3)
            issue_ms.append((h1 - h0) * 1e3)
            sampler.offer(i, slot, out)
            i += 1
            if h2 - start >= seconds:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    run = record.Run(dtype, kind, 0.0, h2 - start, calls, call_ms, issue_ms, flops * i,
                     nbytes * i, traced=trace)
    if prof is not None:
        run.ops = record.device_ops(prof)
    return run


def _judge(ref, config, pool, samples, dtype) -> Tuple[Dict[str, dict], int]:
    """The worst reading of each compared number over the sampled calls,
    beside its limit, and how many sampled calls broke a limit."""
    check = config["check"]
    limits = check["limits"]
    worst: Dict[str, float] = {}
    failed = 0
    for _, slot, (factors, ipiv, info, x) in samples:
        A, b = pool.inputs(slot)
        got = ref.judge(A, b, factors, ipiv, info, x, check["measures"], dtype)
        failed += any(not got[k] <= limits[k] for k in limits)
        for k in limits:
            worst[k] = got[k] if k not in worst else ref._worse(worst[k], got[k])
    return {k: {"value": worst.get(k, float("nan")), "limit": limits[k]} for k in limits}, failed


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: Optional[float] = None, overrides: Optional[dict] = None,
             entry=None) -> Tuple[dict, Dict[str, dict]]:
    """One run: returns the result's line (without ``compared``) and the
    compared numbers beside their limits.  ``overrides`` replace keys of
    the cell's file and ``entry`` the port's calls (tests shrink a cell
    and break its timed path with them)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(workload)
    cell = {**spec["cell"], **(overrides or {})}
    config = spec["config"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dtype = config["dtype"]
    entry = entry or load_module(BENCH_DIR / "entries" / f"{cell['entry']}.py")
    ref = load_module(BENCH_DIR / "references" / f"{config['reference']}.py")

    traffic = Traffic(cell, seed)
    pool = Pool(traffic, config, device)
    entry.warm(*pool.inputs(0), device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    window_s = min(seconds, cell["trace_seconds"]) if trace else seconds
    sampler = Sampler(int(cell["sample"]), seed)
    for _ in range(PROFILER_WINDOWS if trace and cuda else 1):
        run = _window(entry, traffic, pool, window_s, device, sampler, dtype, kind, trace)
        if run.ops or not (trace and cuda):
            break
        print("the profiler recorded no device work; tracing another window", file=sys.stderr)
    run.setup_s = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    compared, failed = _judge(ref, config, pool, sampler.samples(), getattr(torch, dtype))

    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["bench"]["end_to_end"] + spec["bench"]["per_layer"]}
    for name in metric_names(spec["bench"], workload, trace):
        value = load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"workload": workload, "seed": seed,
              "correct": run.n_calls > 0 and all(c["value"] <= c["limit"] for c in compared.values()),
              "attempted": run.n_calls, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=run.busy_s, window_s=run.window_s, power_limit=power_limit() if cuda else None)
        result["breakdown"] = record.breakdown(run)
        if cuda:
            _write_totals(workload, seed, run)
    return result, compared


def _write_totals(workload: str, seed: int, run: record.Run) -> None:
    """Every device operation and idle gap of the traced window, summed by
    name: ``traces/<workload>.<seed>.json``."""
    by_op, by_gap = record.totals(run)
    TRACES.mkdir(exist_ok=True)
    with open(TRACES / f"{workload}.{seed}.json", "w") as f:
        json.dump({"workload": workload, "seed": seed, "calls": run.n_calls,
                   "window_s": run.window_s, "busy_s": run.busy_s,
                   "device_ops": by_op, "idle_gaps": by_gap}, f, indent=0)
