"""Where a benchmark cell's calls spend their time, by the port's spans.

    python3 span_breakdown.py [--cells a,b] [--seed N] [--seconds S] [--out DIR]

For each cell of ``BENCHMARK.json`` (default: all), with the benchmark's
own pool, entry and closed loop (``bench_port/harness.py``), one process:

1. ``off``: the programs captured with the span recorder off; an untraced
   window of ``--seconds`` (``gflops``), then a window of the cell's
   ``trace_seconds`` under ``torch.profiler`` (CUDA activity) read by the
   benchmark's own metric readers;
2. ``host``: the programs of 1 with the recorder on (host spans, and the
   device times of the copies and replays as wholes): a window of
   ``--seconds`` (the launch of a graph without span nodes);
3. ``on``: the recorder on before the warm-up, so the captured programs
   hold the spans' timing events; a window of ``--seconds`` without the
   profiler (the spans: device and host ms per call by name, ``gflops``
   with tracing on), then a profiler window with the spans still on (the
   same readers, and each idle gap put down to the innermost host span
   open at its midpoint, ``profiling.idle_by_span``), then one with CPU
   activity too (each gap put down to the span that launched the
   operation ending it, ``idle_by_launch``);
4. ``launched``: the programs freed, three eager calls under the profiler
   with CPU activity too: each device operation put down to the span
   open on the host when it was launched (``launched_by_span``), and the
   panel chain launches of those calls by plan (dtype, b, C), from the
   port's ``.counts.chain_launches_by_plan``: which rule of the chain's
   plan the cell took; and per call the chain launches that took the
   look-ahead and the mbarrier exchange (``.counts.lookahead_chain_launches``)
   and those that took the previous block's delayed pass at load while its
   far part ran beside them (``.counts.carried_update_launches``); the
   blocked schedule's panels whose trailing block ran beside the next
   panel (``blocked_lu.counts.lookahead_panels``, per call); in the
   RBT cell also the butterfly transform's launches by (dtype, n) and its
   tensor-code transforms per call (``butterfly_mul_cuda.counts``); in the
   DSGESV cell the mixed solver's counts per call
   (``mixed_lu_solve.counts``: calls, refinement steps, host reads of the
   status, kernel launches by kernel, ITER and fallbacks by code);
5. ``off`` again: recaptured with the recorder off, one more untraced
   window (the two ``off`` windows bracket the others).

The profiler window of 1 also gives ``chain_gaps``: from one panel's last
``panel_chain_kernel`` to the next panel's first, by panel boundary
(median over the window's whole calls; the chains of a call split by the
panels' plans), the median gap between two chains of one panel and the chains'
device ms per call; the spans of 3 give
``trailing``: ``blocked.trailing``'s device ms per call and the share of
it that overlapped a ``blocked.panel`` span (the next panel's kernels).

Prints one JSON line per cell and writes it, with every span total, to
``<out>/<cell>.<seed>.json``.  Needs the card unless ``--device cpu`` (then
the CPU runs the port's plain versions at ``--n``: host spans only, no
profiler window).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bench_port import harness, record  # noqa: E402
from bench_port.traffic import Pool, Traffic  # noqa: E402
from recursivefactorization_jl_tpu_torch import LUConfig  # noqa: E402
from recursivefactorization_jl_tpu_torch.ops import blocked  # noqa: E402
from recursivefactorization_jl_tpu_torch.ops import panel as panel_mod  # noqa: E402
from recursivefactorization_jl_tpu_torch.models.mixed import mixed_lu_solve  # noqa: E402
from recursivefactorization_jl_tpu_torch.ops.butterfly import butterfly_mul_cuda  # noqa: E402
from recursivefactorization_jl_tpu_torch.utils import graphs, profiling  # noqa: E402

READERS = ("copy_ms", "outside_panel_ms", "panel_ms", "batched_kernel_ms",
           "host_issue_ms.replay", "device_idle_pct.replay", "mixed_ms", "mixed_passes",
           "mixed_narrow_roofline", "mixed_residual_roofline")
# idle gaps shorter than this are counted, not listed one by one
GAP_NS = 50_000
STEPS = ("blocked.schur", "blocked.trsm", "blocked.laswp")
RBT_STEPS = ("rbt.transform", "rbt.factor", "rbt.apply", "rbt.refine")
MIXED_STEPS = ("mixed.narrow", "mixed.factor", "mixed.solve", "mixed.residual")
# the program kinds of each entry's call
KINDS = {"lu_solve": ("lu_factor", "lu_solve"),
         "batched_solve": ("batched_lu_factor", "batched_lu_solve"),
         "rbt_solve": ("butterfly_workspace", "butterfly_factor", "butterfly_factor_solve"),
         "dsgesv_solve": ("mixed_lu",)}
# the port's wrappers of the kernels that run panel_chain_kernel
CHAIN_WRAPPERS = ("panel_factor_cuda", "offset_panel_factor_cuda", "panel_factor_c64_cuda",
                  "offset_panel_factor_c64_cuda", "panel_factor_shadow_cuda",
                  "panel_factor_basic_cuda")


def chain_launches() -> dict:
    """The panel chain launches so far by plan, ``"<dtype>_b<b>_C<C>"``,
    summed over the wrappers of ``panel_chain_kernel``."""
    out = {}
    for name in CHAIN_WRAPPERS:
        for (dtype, b, c), k in getattr(panel_mod, name).counts.chain_launches_by_plan.items():
            key = f"{dtype}_b{b}_C{c}"
            out[key] = out.get(key, 0) + k
    return out


def chain_count(attr) -> int:
    """A chain launch count (``lookahead_chain_launches``,
    ``carried_update_launches``) summed over the wrappers of
    ``panel_chain_kernel``."""
    return sum(getattr(getattr(panel_mod, name).counts, attr) for name in CHAIN_WRAPPERS)


COUNTERS = ("lookahead_chain_launches", "carried_update_launches")


def lookahead_panels():
    """The blocked schedule's look-ahead panels so far (None where the
    port has no such count)."""
    counts = getattr(blocked.blocked_lu, "counts", None)
    return getattr(counts, "lookahead_panels", None)


CHAIN = "panel_chain_kernel"


def chain_sizes(n, dtype, device) -> list:
    """The chain launches of each panel of a blocked lu at order n, by the
    panels' plans at the default panel width."""
    w = LUConfig().resolved_panel_width()
    dt = getattr(torch, dtype)
    return [panel_mod.panel_plan(n - s, min(w, n - s), dt, device=device)["blocks"]
            for s in range(0, n, w)]


def chain_gaps(run, sizes) -> dict:
    """From each panel's last ``panel_chain_kernel`` to the next panel's
    first in a traced window: the median µs at each panel boundary and
    over all of them, the median µs between two chains of one panel, the
    median ms from a call's first chain to its last (``span_ms``), and the
    chains' device ms per call.  Each chain goes to the call whose
    host window (its start to the end of its synchronise) holds its
    midpoint; a call's chains are split into panels of ``sizes``, and a
    call whose chains the profiler did not all record is left out.  None
    but the counts where no call is whole."""
    chain = sorted((op for op in run.ops if op.kind == "kernel" and CHAIN in op.name),
                   key=lambda op: op.start_ns)
    per_call = sum(sizes)
    ends = [sum(sizes[: i + 1]) for i in range(len(sizes) - 1)]
    by_boundary = [[] for _ in ends]
    within, spans, whole, k = [], [], 0, 0
    for call in run.calls:
        ops = []
        while k < len(chain) and (chain[k].start_ns + chain[k].end_ns) // 2 < call.done_ns:
            if (chain[k].start_ns + chain[k].end_ns) // 2 >= call.start_ns:
                ops.append(chain[k])
            k += 1
        if len(ops) != per_call:
            continue
        whole += 1
        spans.append((ops[-1].end_ns - ops[0].start_ns) * 1e-6)
        gaps = [(b.start_ns - a.end_ns) * 1e-3 for a, b in zip(ops, ops[1:])]
        for i, e in enumerate(ends):
            by_boundary[i].append(gaps[e - 1])
        within += [g for e, g in enumerate(gaps, 1) if e not in ends]
    out = {"chains": len(chain), "calls": len(run.calls), "whole_calls": whole}
    if not whole:
        return out
    every = [g for gaps in by_boundary for g in gaps]
    out.update(median_us=statistics.median(every) if every else None,
               by_boundary_us=[statistics.median(g) for g in by_boundary],
               within_panel_us=statistics.median(within) if within else None,
               span_ms=statistics.median(spans),
               chain_ms_per_call=sum(op.seconds for op in chain) * 1e3 / len(run.calls))
    return out


def trailing_overlap(spans, calls) -> dict:
    """``blocked.trailing``'s device ms per call and the ms of it that
    overlapped a ``blocked.panel`` span of the same parent."""
    panels = {}
    for sp in spans:
        if sp.name == "blocked.panel" and sp.device_ms:
            panels.setdefault(sp.parent, []).append(sp.device_ms)
    total = beside = 0.0
    for sp in spans:
        if sp.name != "blocked.trailing" or not sp.device_ms:
            continue
        t0, t1 = sp.device_ms
        total += t1 - t0
        beside += sum(max(0.0, min(t1, p1) - max(t0, p0))
                      for p0, p1 in panels.get(sp.parent, ()))
    return {"ms_per_call": total / calls, "beside_panel_ms_per_call": beside / calls,
            "beside_share": beside / total if total else None}


def transform_counts() -> dict:
    """The butterfly transform's counts so far: launches by
    ``"<dtype>_n<n>"`` and ``tensor_transforms``."""
    counts = butterfly_mul_cuda.counts
    out = {f"{dtype}_n{n}": k for (dtype, n), k in counts.launches.items()}
    out["tensor_transforms"] = counts.tensor_transforms
    return out


def mixed_counts() -> dict:
    """The mixed solver's counts so far, flat: ``calls``, ``steps``,
    ``host_checks``, ``launches.<kernel>``, ``iter.<ITER>`` and
    ``fallback.<code>``."""
    counts = mixed_lu_solve.counts
    out = {"calls": counts.calls, "steps": counts.steps, "host_checks": counts.host_checks}
    out.update({f"launches.{k}": v for k, v in counts.kernel_launches.items()})
    out.update({f"iter.{k}": v for k, v in counts.iters.items()})
    out.update({f"fallback.{k}": v for k, v in counts.fallbacks.items()})
    return out


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def window(entry, traffic, pool, seconds, device, dtype, kind, trace, seed):
    sampler = harness.Sampler(1, seed)
    for _ in range(harness.PROFILER_WINDOWS if trace else 1):
        run = harness._window(entry, traffic, pool, seconds, device, sampler, dtype, kind, trace)
        if run.ops or not trace:
            return run
    return run


def readings(run) -> dict:
    out = {}
    for name in READERS:
        value = harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run)
        if value is not None:
            out[name] = value
    if run.ops:
        out["busy_ms"] = 1e3 * run.busy_s / run.n_calls
    return out


def gflops(run) -> float:
    return run.flops / run.window_s / 1e9


def per_call(totals: dict, calls: int) -> dict:
    return {name: ms / calls for name, (_, ms) in sorted(totals.items())}


def replay_children(spans, kind):
    """Device ms per call of the spans inside the replays of ``kind``'s
    program, by name (the program's steps)."""
    roots = {s.id for s in spans if s.parent is None and s.name == kind}
    replays = {s.id for s in spans if s.parent in roots and s.name == "graphs.replay"}
    inside, frontier = [], replays
    while frontier:
        layer = [s for s in spans if s.parent in frontier]
        inside += layer
        frontier = {s.id for s in layer}
    return inside


def clock_drift(device, seconds=3.0, cpu=False) -> dict:
    """How the profiler's device timestamps move against ``time.time_ns()``
    through one profiling session of ``seconds``: a small fill every ~5 ms,
    each issued on an idle card.  On one clock a fill starts a few µs
    after it is issued all through the session; the fitted slope of (start
    - issue) over the session's time, in ppm, says how fast the two drift
    apart.  ``cpu``: CPU activity recorded too."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.empty(1 << 16, device=device)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    issued = []
    with profile(activities=acts) as prof:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            issued.append(time.time_ns())
            x.fill_(1.0)
            torch.cuda.synchronize(device)
            time.sleep(0.005)
    ops = sorted((op for op in record.device_ops(prof) if op.kind == "kernel"),
                 key=lambda op: op.start_ns)
    if len(ops) != len(issued):
        return {"fills": len(issued), "ops": len(ops)}
    t = [(i - issued[0]) * 1e-9 for i in issued]
    lead = [(op.start_ns - i) * 1e-3 for op, i in zip(ops, issued)]
    slope = statistics.linear_regression(t, lead).slope  # µs per s = ppm
    return {"fills": len(ops), "lead_us_first_last": [lead[0], lead[-1]],
            "lead_us_min_max": [min(lead), max(lead)], "drift_ppm": slope}


def launches(prof) -> tuple:
    """A profile's device operations with the host time (``time.time_ns()``)
    of the runtime call that launched each, matched by correlation id (None
    where the profile holds no such call; a replayed graph's operations
    have its launch)."""
    launched, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), int(e.start_ns())
        if "CUDA" in str(e.device_type()):
            if name in record.SYNC_NAMES:
                continue
            kind = ("memcpy" if name.startswith("Memcpy")
                    else "memset" if name.startswith("Memset") else "kernel")
            ops.append((record.DeviceOp(kind, name, start, start + int(e.duration_ns())),
                        e.correlation_id()))
        elif e.correlation_id() and name.startswith("cu"):
            corr = e.correlation_id()
            # an id seen twice names no launch
            launched[corr] = None if corr in launched else (start, name)
    out = []
    for op, corr in ops:
        got = launched.get(corr)
        out.append((op, None if got is None else got[0], None if got is None else got[1]))
    return sorted(out, key=lambda x: x[0].start_ns)


def _where(host, kind_of, t):
    if t is None:
        return "(launch not seen)"
    inner = host.innermost(t)
    if inner is None:
        return profiling.OUTSIDE
    root = kind_of[inner.call]
    return root if inner.name == root else f"{root}:{inner.name}"


def launched_by_span(entry, traffic, pool, device, calls=3) -> dict:
    """Eager calls (the cell's programs freed) under ``torch.profiler``
    with CPU and CUDA activity and the recorder on: each device operation
    put down to the innermost span open on the host when it was launched,
    named after its call's kind (``lu_solve:solve.forward``).  A replay
    runs the eager call's operations in the same order, so this is where
    a replay's time goes too, with no device clock to line up.  Returns
    ms per call: {"by_span": {span: {"panel"|"copy"|"other": ms}},
    "top_ops": {operation: {span: ms}}}, the chain launches per call by plan
    ("chains"), the chain launch counters per call ("counters") and the
    butterfly transform's counts per call ("transforms") and the mixed
    solver's ("mixed"); the counters hold the blocked schedule's
    ``lookahead_panels`` too (None where the port has no such count)."""
    from torch.profiler import ProfilerActivity, profile

    metrics = harness.BENCH_DIR / "metrics"
    is_panel = harness.load_module(metrics / "panel_ms.py").is_panel
    is_copy = harness.load_module(metrics / "copy_ms.py").is_copy
    entry.call(*pool.inputs(traffic.next()), device)
    torch.cuda.synchronize(device)
    chains0 = chain_launches()
    counts0 = {c: chain_count(c) for c in COUNTERS}
    ahead0 = lookahead_panels()
    transforms0 = transform_counts()
    mixed0 = mixed_counts()
    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                entry.call(*pool.inputs(traffic.next()), device)
                torch.cuda.synchronize(device)
    spans = rec.collect()
    kind_of = {sp.call: sp.name for sp in spans if sp.parent is None}
    host = profiling.HostSpans(spans)
    by_span, by_op = {}, {}
    for op, t, _ in launches(prof):
        where = _where(host, kind_of, t)
        cat = "panel" if is_panel(op) else "copy" if is_copy(op) else "other"
        by_span.setdefault(where, {"panel": 0.0, "copy": 0.0, "other": 0.0})[cat] += (
            op.seconds * 1e3 / calls)
        short = record.short_name(op.name, 60)
        by_op.setdefault(short, {}).setdefault(where, 0.0)
        by_op[short][where] += op.seconds * 1e3 / calls
    top = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:12]
    chains = {k: (v - chains0.get(k, 0)) / calls for k, v in chain_launches().items()
              if v > chains0.get(k, 0)}
    counters = {c: (chain_count(c) - counts0[c]) / calls for c in COUNTERS}
    ahead = lookahead_panels()
    counters["lookahead_panels"] = None if ahead is None else (ahead - ahead0) / calls
    transforms = {k: (v - transforms0.get(k, 0)) / calls for k, v in transform_counts().items()}
    mixed = {k: (v - mixed0.get(k, 0)) / calls for k, v in mixed_counts().items()}
    return {"by_span": dict(sorted(by_span.items())), "top_ops": dict(top), "chains": chains,
            "counters": counters, "transforms": transforms, "mixed": mixed}


def idle_by_launch(prof, spans, calls) -> dict:
    """The device idle gaps of a profile with CPU activity, put down to host
    spans two ways, ms per call:

    * ``by_launch``: to the innermost span open when the host launched the
      operation that ends the gap (the card waited for that launch); no
      device timestamp is compared with the host clock;
    * ``by_midpoint``: to the innermost span open at the gap's midpoint,
      after moving the device timestamps onto the host clock by
      ``offset_us``: the median (start - launch) of the operations launched
      directly (not by a graph) that end a gap over 50 µs, the clocks'
      offset plus the launch latency (the profiler's device clock sits a
      different distance from ``time.time_ns()`` in each process)."""
    kind_of = {sp.call: sp.name for sp in spans if sp.parent is None}
    host = profiling.HostSpans(spans)
    gaps, end, n_ops, leads = [], None, 0, []
    for op, t, api in launches(prof):
        n_ops += 1
        if end is not None and op.start_ns > end:
            gaps.append((end, op.start_ns, t))
            if t is not None and op.start_ns - end > 50_000 and api != "cudaGraphLaunch":
                leads.append(op.start_ns - t)  # a direct launch onto an idle card
        end = op.end_ns if end is None else max(end, op.end_ns)
    offset = statistics.median(leads) if leads else 0
    by_launch, by_mid = {}, {}
    for g0, g1, t in gaps:
        for out, where in ((by_launch, _where(host, kind_of, t)),
                           (by_mid, _where(host, kind_of, (g0 + g1) // 2 - offset))):
            entry = out.setdefault(where, [0, 0.0])
            entry[0] += 1
            entry[1] += (g1 - g0) * 1e-6 / calls
    inside = lambda d: sum(v for k, (_, v) in d.items()  # noqa: E731
                           if k not in (profiling.OUTSIDE, "(launch not seen)"))
    return {"ops": n_ops, "offset_us": offset * 1e-3, "offset_samples": len(leads),
            "by_launch": dict(sorted(by_launch.items())), "in_port_ms_by_launch": inside(by_launch),
            "by_midpoint": dict(sorted(by_mid.items())), "in_port_ms_by_midpoint": inside(by_mid)}


def run_cell(cell_name, seed, seconds, device, n=None):
    spec = harness.load_spec(cell_name)
    cell = dict(spec["cell"])
    if n is not None:
        cell.update(n=n, pool=2, batch=min(cell["batch"], 16) if cell.get("batch") else None)
    config = spec["config"]
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dtype = config["dtype"]
    entry = harness.load_module(harness.BENCH_DIR / "entries" / f"{cell['entry']}.py")
    traffic = Traffic(cell, seed)
    pool = Pool(traffic, config, device)
    trace_s = min(seconds, cell["trace_seconds"])
    kinds = KINDS[cell["entry"]]
    out = {"cell": cell_name, "seed": seed, "card": card_line() if cuda else "cpu",
           "seconds": seconds, "trace_seconds": trace_s}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # 1. off
    chains0 = chain_launches()
    entry.warm(*pool.inputs(0), device)
    sync()
    # the warm-up's eager calls and captures: one chain launch per block
    out["chain_launches_by_plan_warm"] = {k: v - chains0.get(k, 0)
                                          for k, v in chain_launches().items()
                                          if v > chains0.get(k, 0)}
    off = window(entry, traffic, pool, seconds, device, dtype, kind, False, seed)
    out["gflops_off"] = gflops(off)
    if cuda:
        traced = window(entry, traffic, pool, trace_s, device, dtype, kind, True, seed)
        out["traced_off"] = readings(traced)
        if cell["entry"] in ("lu_solve", "rbt_solve", "dsgesv_solve"):
            # DSGESV factors single(A): its chains are float32's
            chain_dtype = "float32" if cell["entry"] == "dsgesv_solve" else dtype
            out["chain_gaps"] = chain_gaps(traced, chain_sizes(cell["n"], chain_dtype, device))
    entry.release()

    # 2. the recorder on, the programs captured before it was: host spans
    # and the device times of the copies and replays as a whole
    entry.warm(*pool.inputs(0), device)
    sync()
    with profiling.recording() as rec:
        host = window(entry, traffic, pool, seconds, device, dtype, kind, False, seed)
        plain = rec.collect()
    entry.release()
    out["gflops_host_spans"] = gflops(host)
    launch_ms = [(s.host_ns[1] - s.host_ns[0]) * 1e-6 for s in plain
                 if s.name == "graphs.replay" and s.host_ns]
    out["replay_launch_ms_plain_graph"] = statistics.median(launch_ms) if launch_ms else None

    # 3. on
    stats0 = graphs.stats()
    with profiling.recording() as rec:
        entry.warm(*pool.inputs(0), device)
        sync()
        rec.collect()
        on = window(entry, traffic, pool, seconds, device, dtype, kind, False, seed)
        spans = rec.collect()
        traced_on = (window(entry, traffic, pool, trace_s, device, dtype, kind, True, seed)
                     if cuda else None)
        spans_tr = rec.collect()
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                both = window(entry, traffic, pool, trace_s, device, dtype, kind, False, seed)
            out["idle_by_launch"] = idle_by_launch(prof, rec.collect(), both.n_calls)
    out["gflops_on"] = gflops(on)
    out["counters"] = {k: v - stats0[k] for k, v in graphs.stats().items()}
    calls = on.n_calls
    out["calls_on"] = calls
    out["device_ms_per_call"] = per_call(profiling.span_totals(spans, "device"), calls)
    out["host_ms_per_call"] = per_call(profiling.span_totals(spans, "host"), calls)
    replay_host = [(s.host_ns[1] - s.host_ns[0]) * 1e-6 for s in spans
                   if s.name == "graphs.replay" and s.host_ns]
    dev = out["device_ms_per_call"]
    derived = {
        "replay_launch_ms": statistics.median(replay_host) if replay_host else None,
        "replay_launch_ms_per_call": sum(replay_host) / calls if replay_host else None,
        "replay_copy_ms": dev.get("graphs.copy_in", 0.0) + dev.get("graphs.copy_out", 0.0),
        "top_level_ms": sum(dev.get(k, 0.0) for k in
                            ("graphs.copy_in", "graphs.replay", "graphs.copy_out")),
    }
    for k in kinds:
        inside = replay_children(spans, k)
        derived[f"{k}.program_steps"] = per_call(profiling.span_totals(inside), calls)
        derived[f"{k}.replay_ms"] = sum(
            s.device_ms[1] - s.device_ms[0] for s in spans if s.name == "graphs.replay"
            and s.device_ms and any(r.id == s.parent and r.name == k for r in spans
                                    if r.parent is None)) / calls
    if cell["entry"] == "lu_solve":
        steps = derived["lu_factor.program_steps"]
        for name in STEPS:
            derived[name.split(".")[1] + "_ms"] = steps.get(name, 0.0)
        derived["solve_ms"] = derived["lu_solve.replay_ms"]
    if cell["entry"] == "rbt_solve":
        steps = {**derived["butterfly_factor.program_steps"],
                 **derived["butterfly_factor_solve.program_steps"]}
        for name in RBT_STEPS:
            derived[name.replace(".", "_") + "_ms"] = steps.get(name, 0.0)
    if cell["entry"] == "dsgesv_solve":
        # narrowing and factor inside the mixed_lu program; the solves, the
        # residual passes, the host's reads of the status and the fallbacks
        # outside it (eager)
        steps = {**dev, **derived["mixed_lu.program_steps"]}
        for name in MIXED_STEPS:
            derived[name.replace(".", "_") + "_ms"] = steps.get(name, 0.0)
        for name in ("mixed.check", "mixed.fallback"):
            derived[name.replace(".", "_") + "_host_ms"] = out["host_ms_per_call"].get(name, 0.0)
    out["derived"] = derived
    out["trailing"] = trailing_overlap(spans, calls)

    if traced_on is not None:
        out["traced_on"] = readings(traced_on)
        gaps = record.idle_gaps(traced_on.ops)
        big = [(s, e) for s, e, _ in gaps if e - s > GAP_NS]
        small = [(s, e) for s, e, _ in gaps if e - s <= GAP_NS]
        by_big = profiling.idle_by_span(big, spans_tr)
        by_all = profiling.idle_by_span([(s, e) for s, e, _ in gaps], spans_tr)
        n_tr = traced_on.n_calls
        out["idle_by_span"] = {k: [c, 1e3 * v / n_tr] for k, (c, v) in sorted(by_big.items())}
        out["idle_small_gaps"] = [len(small), 1e3 * sum(e - s for s, e in small) * 1e-9 / n_tr]
        out["idle_in_port_ms"] = 1e3 * sum(v for k, (_, v) in by_all.items()
                                           if k != profiling.OUTSIDE) / n_tr
        out["idle_outside_port_ms"] = 1e3 * by_all.get(profiling.OUTSIDE, [0, 0.0])[1] / n_tr
        busy = out["traced_on"].get("busy_ms")
        t = out["traced_on"]
        out["checks"] = {
            "top_level_over_busy": derived["top_level_ms"] / busy if busy else None,
            "replay_copy_le_copy_ms": derived["replay_copy_ms"] <= t.get("copy_ms", 0.0),
            "replay_launch_lt_host_issue": (derived["replay_launch_ms_per_call"] or 0)
            < t.get("host_issue_ms.replay", 0.0),
        }
        if cell["entry"] == "lu_solve" and t.get("outside_panel_ms"):
            four = sum(derived[k] for k in ("schur_ms", "trsm_ms", "laswp_ms", "solve_ms"))
            out["checks"]["steps_over_outside_panel"] = four / t["outside_panel_ms"]
    entry.release()

    # 4. launched
    if cuda:
        launched = launched_by_span(entry, traffic, pool, device)
        out["launched_ms_by_span"] = launched["by_span"]
        out["launched_top_ops"] = launched["top_ops"]
        out["chain_launches_per_call_by_plan"] = launched["chains"]
        out["chain_counters_per_call"] = launched["counters"]
        out["transform_counts_per_call"] = launched["transforms"]
        out["mixed_counts_per_call"] = launched["mixed"]
        if cell["entry"] == "lu_solve":
            by = launched["by_span"]
            steps = sum(sum(by.get(f"lu_factor:{k}", {}).values()) for k in STEPS)
            solve = sum(sum(v.values()) for k, v in by.items()
                        if k == "lu_solve" or k.startswith("lu_solve:"))
            rest = sum(v["other"] for k, v in by.items() if k in {f"lu_factor:{s}" for s in STEPS}
                       or k == "lu_solve" or k.startswith("lu_solve:"))
            other = sum(v["other"] for v in by.values())
            out["launched_steps_ms"] = {"schur+trsm+laswp": steps, "lu_solve": solve,
                                        "their operations outside panels and copies": rest,
                                        "all operations outside panels and copies": other}

    # 5. off again
    entry.warm(*pool.inputs(0), device)
    sync()
    out["gflops_off2"] = gflops(window(entry, traffic, pool, seconds, device, dtype, kind,
                                       False, seed))
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    out["all_spans_device_ms_per_call"] = out.pop("device_ms_per_call")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default="")
    parser.add_argument("--seed", type=int, default=1900000001)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=None, help="a smaller order (CPU rehearsal)")
    parser.add_argument("--out", default=str(ROOT / "build" / "spans"),
                        help="directory of the JSON files (default: build/spans)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cells = args.cells.split(",") if args.cells else [w["name"] for w in bench["workloads"]]
    os.makedirs(args.out, exist_ok=True)
    if device.type == "cuda":
        clock = {"cuda": clock_drift(device), "cpu+cuda": clock_drift(device, cpu=True)}
        print(json.dumps({"clock": clock}), flush=True)
    for i, cell in enumerate(cells):
        t0 = time.perf_counter()
        got = run_cell(cell, args.seed + i, args.seconds, device, args.n)
        got["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(args.out, f"{cell}.{got['seed']}.json"), "w") as f:
            json.dump(got, f, indent=1)
        got.pop("all_spans_device_ms_per_call")
        got.pop("host_ms_per_call")
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
