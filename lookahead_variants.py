"""The blocked schedule's look-ahead under each control, in turns on one card.

    python3 lookahead_variants.py [--variants parent,none,t116,t64,t32,carve32,inverse]
        [--cells a,b] [--seed N] [--seconds S] [--trace-seconds S] [--rounds R]
        [--out FILE]

A variant sets attributes of ``ops/blocked.py`` in this process, so that all
of them run in one process, in turns (in the order given in even rounds,
reversed in odd ones), each with the benchmark's own pool, entry and closed
loop (``bench_port/harness.py``) and programs captured anew:

* ``parent``: the schedule without look-ahead, as it was before it: no split
  (``lookahead`` always False), the pivoted path's TRSM by L11's inverse, the
  Schur update as a product, then a subtraction;
* ``none``: look-ahead, the trailing Schur update in one product (no
  control);
* ``t<K>``: look-ahead, the trailing Schur update in row chunks of at most
  K tiles (``TRAILING_TILES``; ``t64`` is the schedule as it stands);
* ``carve<K>``: look-ahead in one product, with cuBLAS's SM carve-out K
  (``torch._C._set_sm_carveout_experimental``) around the trailing block's
  work; first the time of one float32 GEMM of the trailing block's shape at
  n = 8192 under carve-outs 0 / 16 / 32 / 66 (does the carve-out reach it);
* ``inverse``: ``t64`` with the pivoted path's TRSM, strip and trailing
  block, by L11's inverse in place of substitution.

One JSON line per cell, variant and round, printed and appended to
``--out``: ``gflops``, the median and p95 call ms of an untraced window of
``--seconds``, and from a traced window of ``--trace-seconds``
(``span_breakdown.chain_gaps``) the median gap between two panels' chains,
by panel boundary, within a panel, and the chains' device ms per call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

import span_breakdown as sb
from bench_port import harness
from bench_port.traffic import Pool, Traffic
from recursivefactorization_jl_tpu_torch.ops import _kernels, blocked
from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
from recursivefactorization_jl_tpu_torch.ops.trsm import unit_lower_inverse

ROOT = Path(__file__).resolve().parent
DEFAULT = (blocked.lookahead, blocked.TRAILING_TILES, blocked.substitute,
           blocked.schur_update_, blocked._fork)
ONE_PRODUCT = 1 << 30  # tiles: the trailing update in one chunk


def _by_inverse(L, B, upper=False, unit=True):
    """The pivoted path's TRSM as it was before substitution."""
    assert not upper and unit
    return unit_lower_inverse(L) @ B


def _product_then_subtract(C, A, B, precision="float32"):
    return C.sub_(schur_product(A, B, precision).to(C.dtype))


def _carved(k):
    def fork(A):
        @contextlib.contextmanager
        def ctx():
            saved = torch._C._get_sm_carveout_experimental()
            torch._C._set_sm_carveout_experimental(k)
            try:
                with DEFAULT[4](A):
                    yield
            finally:
                torch._C._set_sm_carveout_experimental(saved)
        return ctx()
    return fork


def set_variant(name, pivoted):
    """Set ``ops/blocked.py`` to the variant ``name`` (``pivoted``: the
    cell's lu pivots, so the TRSM variants apply)."""
    (blocked.lookahead, blocked.TRAILING_TILES, blocked.substitute,
     blocked.schur_update_, blocked._fork) = DEFAULT
    if name == "parent":
        blocked.lookahead = lambda *a: False
        blocked.schur_update_ = _product_then_subtract
        if pivoted:
            blocked.substitute = _by_inverse
    elif name == "none":
        blocked.TRAILING_TILES = ONE_PRODUCT
    elif name.startswith("t"):
        blocked.TRAILING_TILES = int(name[1:])
    elif name.startswith("carve"):
        blocked.TRAILING_TILES = ONE_PRODUCT
        blocked._fork = _carved(int(name[5:]))
    elif name == "inverse":
        if pivoted:
            blocked.substitute = _by_inverse
    else:
        raise ValueError(f"unknown variant {name!r}")


def carveout_reach(device, reps=20) -> dict:
    """ms of one float32 GEMM (7680 x 512) @ (512 x 7168) by carve-out."""
    a = torch.randn(7680, 512, device=device)
    b = torch.randn(512, 7168, device=device)
    saved = torch._C._get_sm_carveout_experimental()
    out = {}
    try:
        for k in (0, 16, 32, 66):
            torch._C._set_sm_carveout_experimental(k)
            for _ in range(3):
                a @ b
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(reps):
                a @ b
            e1.record()
            torch.cuda.synchronize(device)
            out[str(k)] = e0.elapsed_time(e1) / reps
    finally:
        torch._C._set_sm_carveout_experimental(saved)
    return out


def run_variant(cell_name, name, seed, seconds, trace_s, device) -> dict:
    spec = harness.load_spec(cell_name)
    cell, config = spec["cell"], spec["config"]
    dtype = config["dtype"]
    set_variant(name, cell["entry"] == "lu_solve")
    entry = harness.load_module(harness.BENCH_DIR / "entries" / f"{cell['entry']}.py")
    traffic = Traffic(cell, seed)
    pool = Pool(traffic, config, device)
    kind = torch.cuda.get_device_name(device)
    try:
        entry.warm(*pool.inputs(0), device)
        torch.cuda.synchronize(device)
        run = sb.window(entry, traffic, pool, seconds, device, dtype, kind, False, seed)
        traced = sb.window(entry, traffic, pool, trace_s, device, dtype, kind, True, seed)
        gaps = sb.chain_gaps(traced, sb.chain_sizes(cell["n"], dtype, device))
    finally:
        entry.release()
        set_variant("t64", False)
        del pool
        torch.cuda.empty_cache()
    ms = sorted(run.call_ms)
    return {"cell": cell_name, "variant": name, "seed": seed, "gflops": sb.gflops(run),
            "median_ms": statistics.median(ms), "p95_ms": ms[int(0.95 * (len(ms) - 1))],
            "calls": run.n_calls, **{k: gaps.get(k) for k in (
                "median_us", "by_boundary_us", "within_panel_us", "span_ms",
                "chain_ms_per_call", "whole_calls")}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="parent,none,t116,t64,t32,carve32,inverse")
    parser.add_argument("--cells", default="lu_f32.replay_n8192,lu_f32.replay_n4096,"
                        "lu_f64.replay_n4096,rbt_f32.replay_n4096")
    parser.add_argument("--seed", type=int, default=2626200001)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--trace-seconds", type=float, default=1.5)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "lookahead_variants.jsonl"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    variants = args.variants.split(",")
    for name in variants:  # refuse a misspelt variant before the first window
        set_variant(name, True)
    set_variant("t64", False)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.time()
    with open(args.out, "a") as out:
        def emit(**kw):
            line = json.dumps(kw)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        emit(card=sb.card_line(), torch=torch.__version__, cuda=torch.version.cuda)
        _kernels.build()
        emit(build_s=time.time() - t0)
        if any(v.startswith("carve") for v in variants):
            emit(carveout_gemm_ms=carveout_reach(device))
        for cell in args.cells.split(","):
            for r in range(args.rounds):
                for name in variants if r % 2 == 0 else variants[::-1]:
                    emit(**run_variant(cell, name, args.seed + r, args.seconds,
                                       args.trace_seconds, device))
        emit(done=True, wall_s=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
