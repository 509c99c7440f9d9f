#!/usr/bin/env python3
"""Time the panel kernels of two checkouts of this repo in turns on one CUDA
card.

    python3 compare_panel_trees.py OLD NEW [--rounds 7] [--routes] [--chain] [--out FILE]

OLD and NEW are the roots of two checkouts (for example the parent commit,
unpacked with ``git archive`` into a gitignored directory, and ``.``).  The
package has one name in both, so each tree runs in a process of its own, in
the order OLD, NEW, NEW, OLD; each builds its csrc/panel_lu.cu,
csrc/panel_lu_c64.cu and csrc/panel_lu_micro.cu into its own
``build/kernels/``.  A process times every case of ``CASES`` (the float32,
float64, complex64, micro-blocked, bf16x3 and offset panels on their default
plans) by CUDA events around each call, the input restored before each
call outside the pair, and prints one JSON line of medians over ``rounds``
rounds of 5 calls.  The parent then prints, per case, both readings of each
tree and NEW / OLD of the slower reading of each.

``--chain`` also traces one call of every case on each tree (the phase
trace of the chain kernel, ``rf_*_set_trace``) and prints, per case, the
median device time of a chain step (clock64() from one step's start to the
next's within a launch, at the SM clock the trace's %globaltimer gives) and
the chain kernels' time per step and the median gap from one block's last
%globaltimer stamp to the next block's first (what runs between two
chains), in the eager call and in the replay of the same call captured in a
CUDA graph (as the benchmark's cells run it), both trees side by side.  The
stamps per
step are read from the tree's csrc/panel_cluster.cuh, so trees with
different phase traces compare; where a tree has the chain kernel's 9
stamps it also prints the median of each phase (``PHASES``, each named by
the stamp that ends it: reduced, published, the deferred share done, data
in, agreed, swapped, looked ahead), the exchange (reduced to data in, warp
0) and the share of warp 1's deferred update that the exchange hid.

``--routes`` (NEW only) also times the tall micro panels of ``ROUTE_CASES``
on their default route (the grid-barrier kernel ``panel_lu_micro_kernel``
at micro <= 64) beside every block's chain on the grid block chain
(``_chain='grid'``), in turns within one process, and checks that the two
give the same bits.  Prints the card's name and power limit; ``--out``
writes every line to FILE too.  Exits non-zero if a worker fails or two
routes disagree.
"""

import json
import os
import subprocess
import sys
import time

# (name, wrapper, dtype, (m, w), positional args after the panel, keywords);
# "offset" wrappers take (ofs, pivot), the others (pivot[, micro])
CASES = (
    ("f32 1536x512", "panel_factor_cuda", "float32", (1536, 512), (True,), {}),
    ("f32 4096x512", "panel_factor_cuda", "float32", (4096, 512), (True,), {}),
    ("f32 8192x512", "panel_factor_cuda", "float32", (8192, 512), (True,), {}),
    ("f64 1536x512", "panel_factor_cuda", "float64", (1536, 512), (True,), {}),
    ("f64 4096x512", "panel_factor_cuda", "float64", (4096, 512), (True,), {}),
    ("c64 1536x512", "panel_factor_c64_cuda", "complex64", (1536, 512), (True,), {}),
    ("c64 4096x512", "panel_factor_c64_cuda", "complex64", (4096, 512), (True,), {}),
    ("c128 1536x512", "panel_factor_c64_cuda", "complex128", (1536, 512), (True,), {}),
    ("c128 4096x512", "panel_factor_c64_cuda", "complex128", (4096, 512), (True,), {}),
    ("shadow f32 1536x512 micro 32", "panel_factor_shadow_cuda", "float32", (1536, 512),
     (True, 32), {}),
    ("shadow f32 4096x512 micro 32", "panel_factor_shadow_cuda", "float32", (4096, 512),
     (True, 32), {}),
    ("basic f32 1536x512 micro 32", "panel_factor_basic_cuda", "float32", (1536, 512),
     (True, 32), {}),
    ("shadow f32 4096x512 micro 8", "panel_factor_shadow_cuda", "float32", (4096, 512),
     (True, 8), {}),
    ("shadow f32 4096x512 micro 64", "panel_factor_shadow_cuda", "float32", (4096, 512),
     (True, 64), {}),
    ("shadow f64 1536x512 micro 32", "panel_factor_shadow_cuda", "float64", (1536, 512),
     (True, 32), {}),
    ("bf16x3 1536x512 b 32", "panel_factor_cuda", "float32", (1536, 512), (True,),
     {"block": 32, "precision": "bf16x3"}),
    ("bf16x3 4096x512 b 32", "panel_factor_cuda", "float32", (4096, 512), (True,),
     {"block": 32, "precision": "bf16x3"}),
    ("offset f32 4096x128 ofs 0", "offset_panel_factor_cuda", "float32", (4096, 128),
     (0, True), {}),
    ("offset f32 4096x128 ofs 1000", "offset_panel_factor_cuda", "float32", (4096, 128),
     (1000, True), {}),
)
# (name, wrapper, dtype, (m, w), micro): panels too tall for a cluster
ROUTE_CASES = (
    ("shadow f32 30000x256 micro 32", "panel_factor_shadow_cuda", "float32", (30000, 256), 32),
    ("basic f32 30000x256 micro 32", "panel_factor_basic_cuda", "float32", (30000, 256), 32),
    ("shadow f32 30000x256 micro 64", "panel_factor_shadow_cuda", "float32", (30000, 256), 64),
    ("shadow f32 28672x512 micro 32", "panel_factor_shadow_cuda", "float32", (28672, 512), 32),
    ("shadow f64 30000x256 micro 32", "panel_factor_shadow_cuda", "float64", (30000, 256), 32),
)
CALLS = 5


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_calls(fn, A, rounds):
    """Median ms of ``fn(Q)`` over ``rounds`` x CALLS calls, Q restored from
    A before each call, outside the timed pair of events."""
    import torch

    Q = A.clone()
    for _ in range(2):
        Q.copy_(A)
        fn(Q)
    torch.cuda.synchronize()
    ms = []
    for _ in range(rounds):
        ev = []
        for _ in range(CALLS):
            Q.copy_(A)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(Q)
            e1.record()
            ev.append((e0, e1))
        torch.cuda.synchronize()
        ms += [a.elapsed_time(b) for a, b in ev]
    return median(ms)


# the library and trace switch of each wrapper's chain kernel
TRACE_FN = {"panel_factor_cuda": ("panel_lu", "rf_panel_lu_set_trace"),
            "offset_panel_factor_cuda": ("panel_lu", "rf_panel_lu_set_trace"),
            "panel_factor_c64_cuda": ("panel_lu_c64", "rf_panel_lu_c_set_trace"),
            "panel_factor_shadow_cuda": ("panel_lu_micro", "rf_panel_lu_micro_set_trace"),
            "panel_factor_basic_cuda": ("panel_lu_micro", "rf_panel_lu_micro_set_trace")}


def trace_phases():
    """Stamps per step of this tree's chain trace (csrc/panel_cluster.cuh)."""
    import re

    text = open("recursivefactorization_jl_tpu_torch/csrc/panel_cluster.cuh").read()
    found = (re.search(r"kChainTracePhases = (\d+);", text)
             or re.search(r"kTracePhases = (\d+);", text))
    return int(found.group(1))


# panel_chain_kernel's stamps: phases 0-7 from warp 0, the end of warp 1's
# deferred share at 8
PHASES = ("reduce", "publish", "deferred", "data_in", "agree", "swap", "lookahead")


def block_gap(ends):
    """Median ns from one block's last %globaltimer stamp to the next
    block's first (per block: first ns, clock, last ns, clock)."""
    gaps = ends[1:, 0] - ends[:-1, 2]
    return float(gaps.median()) if gaps.numel() else None


def chain_steps(fn, A, steps, set_trace):
    """One traced call of ``fn`` on a copy of ``A``: the median ns of a
    chain step (one step's start to the next's within a launch), the chain
    kernels' ns per step and the median gap between two chains, eagerly and
    in a captured graph's replay; with 9 stamps a step, the median ns of
    each phase, of the exchange and the hidden share of warp 1's deferred
    update."""
    import torch

    P = trace_phases()
    buf = torch.zeros(steps * P + 4 * steps, dtype=torch.int64, device=A.device)
    Q = A.clone()
    fn(Q)
    torch.cuda.synchronize()
    set_trace(buf.data_ptr())
    try:
        Q.copy_(A)
        fn(Q)
        torch.cuda.synchronize()
    finally:
        set_trace(None)
    t = buf.cpu().double()
    stamps = t[:steps * P].view(steps, P)
    st = stamps[:, 0]
    ends = t[steps * P:].view(steps, 4)
    ends = ends[ends[:, 0] != 0]
    ghz = float((ends[:, 3] - ends[:, 1]).sum() / (ends[:, 2] - ends[:, 0]).sum())
    d = st[1:] - st[:-1]
    # a step's start to the next's within one launch (clock64 counts on
    # across launches on another SM, so a launch boundary reads at random)
    d = d[(d > 0) & (d < 20 * d.median())]
    out = {"step_ns_median": float(d.median()) / ghz,
           "chain_ns_per_step": float((ends[:, 2] - ends[:, 0]).sum()) / steps,
           "gap_ns_median": block_gap(ends), "sm_ghz": ghz, "launches": int(ends.shape[0])}
    # the same call captured in a CUDA graph, traced in its replay
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(Q)
    torch.cuda.current_stream().wait_stream(side)
    set_trace(buf.data_ptr())
    try:
        with torch.cuda.graph(graph):
            fn(Q)
    finally:
        set_trace(None)
    buf.zero_()
    Q.copy_(A)
    graph.replay()
    torch.cuda.synchronize()
    ends = buf.cpu().double()[steps * P:].view(steps, 4)
    out["replay_gap_ns_median"] = block_gap(ends[ends[:, 0] != 0])
    del graph
    if P == len(PHASES) + 2:
        out["phase_ns_median"] = {name: float((stamps[:, i + 1] - stamps[:, i]).median()) / ghz
                                  for i, name in enumerate(PHASES)}
        exchange = stamps[:, 4] - stamps[:, 1]
        deferred = stamps[:, 8] - stamps[:, 1]
        hidden = torch.minimum(deferred, exchange) / deferred.clamp(min=1)
        out["exchange_ns_median"] = float(exchange.median()) / ghz
        out["hidden_share_median"] = float(hidden[1:].median())
    return out


def worker(rounds, routes, chain=False):
    """One tree's process: build, time CASES (and ROUTE_CASES), print one
    JSON line."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops import _kernels
    from recursivefactorization_jl_tpu_torch.ops import panel as P

    t0 = time.time()
    _kernels.build(["panel_lu", "panel_lu_c64", "panel_lu_micro"])
    build_s = time.time() - t0
    gen = torch.Generator().manual_seed(0)
    out = {"tree": os.getcwd(), "package": str(_kernels.PACKAGE_DIR.parent),
           "build_s": build_s, "ms": {}}
    for name, wrapper, dtype, (m, w), args, kw in CASES:
        A = torch.randn(m, w, generator=gen, dtype=getattr(torch, dtype)).cuda()
        fn = getattr(P, wrapper)
        out["ms"][name] = time_calls(lambda Q: fn(Q, *args, **kw), A, rounds)
        if chain:
            lib, switch = TRACE_FN[wrapper]
            ofs = args[0] if wrapper.startswith("offset") else 0
            out.setdefault("chain", {})[name] = chain_steps(
                lambda Q: fn(Q, *args, **kw), A, min(m - ofs, w),
                getattr(_kernels.load(lib), switch))
    if routes:
        out["routes"] = {}
        for name, wrapper, dtype, (m, w), micro in ROUTE_CASES:
            A = torch.randn(m, w, generator=gen, dtype=getattr(torch, dtype)).cuda()
            fn = getattr(P, wrapper)
            got = {}
            for chain in ("auto", "grid"):
                Q = A.clone()
                res = fn(Q, True, micro, _chain=chain)
                torch.cuda.synchronize()
                got[chain] = (Q, *res)
            same = all(torch.equal(x, y) for x, y in zip(got["auto"], got["grid"]))
            variant = "shadow" if "shadow" in wrapper else "basic"
            plan = {c: P.micro_plan(m, w, A.dtype, micro, variant, _chain=c)
                    for c in ("auto", "grid")}
            t = {c: [] for c in ("auto", "grid")}
            for _ in range(2):  # in turns: auto, grid, grid, auto
                for c in ("auto", "grid") if not t["auto"] else ("grid", "auto"):
                    t[c].append(time_calls(lambda Q: fn(Q, True, micro, _chain=c), A,
                                           max(1, rounds // 2)))
            out["routes"][name] = {
                "bitwise": bool(same), "plan": plan,
                "ms": {c: median(v) for c, v in t.items()}, "runs": t}
            del A, got
    print("RESULT " + json.dumps(out), flush=True)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv):
    if argv and argv[0] == "--worker":
        # the tree's package, not the one beside this script (sys.path[0])
        sys.path.insert(0, os.getcwd())
        worker(int(argv[1]), argv[2] == "1", argv[3] == "1")
        return 0
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--chain", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    log = open(a.out, "w") if a.out else None

    def say(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if log:
            print(line, file=log, flush=True)

    say({"card": card_line()})
    res = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        tree = os.path.abspath(getattr(a, which))
        routes = a.routes and which == "new" and not res["new"]
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                            str(a.rounds), "1" if routes else "0", "1" if a.chain else "0"],
                           cwd=tree, capture_output=True, text=True, timeout=1200)
        got = [ln[7:] for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not got:
            say({"worker": which, "tree": tree, "rc": p.returncode,
                 "stderr": p.stderr[-4000:]})
            return 1
        r = json.loads(got[-1])
        if os.path.realpath(r["package"]) != os.path.realpath(tree):
            say({"worker": which, "tree": tree, "imported": r["package"]})
            return 1
        res[which].append(r)
        say({"worker": which, **r})
    ok = True
    for name, *_ in CASES:
        o = median([r["ms"][name] for r in res["old"]])
        n = median([r["ms"][name] for r in res["new"]])
        say({"case": name, "old_ms": [r["ms"][name] for r in res["old"]],
             "new_ms": [r["ms"][name] for r in res["new"]], "new_over_old": n / o})
        if a.chain:
            step = {w: [r["chain"][name]["step_ns_median"] for r in res[w]] for w in res}
            per = {w: [r["chain"][name]["chain_ns_per_step"] for r in res[w]] for w in res}
            gap = {w: [r["chain"][name]["gap_ns_median"] for r in res[w]] for w in res}
            rgap = {w: [r["chain"][name]["replay_gap_ns_median"] for r in res[w]] for w in res}
            say({"chain_case": name, "old_step_ns": step["old"], "new_step_ns": step["new"],
                 "step_new_over_old": median(step["new"]) / median(step["old"]),
                 "old_chain_ns_per_step": per["old"], "new_chain_ns_per_step": per["new"],
                 "chain_new_over_old": median(per["new"]) / median(per["old"]),
                 "old_gap_ns": gap["old"], "new_gap_ns": gap["new"],
                 "old_replay_gap_ns": rgap["old"], "new_replay_gap_ns": rgap["new"]})
            for w in res:  # the phases of each tree, by turn
                runs = [r["chain"][name] for r in res[w] if "phase_ns_median" in r["chain"][name]]
                if runs:
                    say({"chain_phases": name, "tree": w,
                         "phase_ns_median": [r["phase_ns_median"] for r in runs],
                         "exchange_ns_median": [r["exchange_ns_median"] for r in runs],
                         "hidden_share_median": [r["hidden_share_median"] for r in runs]})
    for r in res["new"]:
        for name, v in r.get("routes", {}).items():
            say({"route_case": name, "bitwise": v["bitwise"], "auto_ms": v["ms"]["auto"],
                 "grid_chain_ms": v["ms"]["grid"],
                 "grid_chain_over_auto": v["ms"]["grid"] / v["ms"]["auto"],
                 "auto_route": v["plan"]["auto"]["route"],
                 "grid_blocks": v["plan"]["grid"]["grid_blocks"]})
            ok = ok and v["bitwise"]
    say({"card": card_line(), "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
