"""Run one cell of the port's benchmark once and print its result's line.

    python3 bench_port/run.py --workload lu_f32.replay_n4096 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout that holds the port
(``recursivefactorization_jl_tpu_torch``), on a machine with the CUDA
cards the cell asks for.  Without them it exits with code 2 and prints no
result; so it does when a module of JAX or of the JAX package is loaded
once the window has closed.  The last lines on standard error are the
numbers compared for ``correct``, each beside its limit; the last line on
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``; ``compared``
last).  A watchdog prints a failing result and exits with code 3 when a
run has not ended in time.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules whose top-level name may not be loaded in the process that prints
# the result: JAX, its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "recursivefactorization_jl_tpu")
# seconds a run may take before the watchdog ends it: a warm checkout, and
# one whose kernels are still to be built (the first run compiles)
WATCHDOG_S = 330
WATCHDOG_BUILD_S = 1150


def forbidden_modules():
    """Top-level names of loaded modules that are forbidden, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def start_watchdog(seconds, workload, seed, device):
    def fire():
        line = {"workload": workload, "seed": seed, "correct": False, "attempted": 0,
                "failed": 0, "metrics": {}, "device": device,
                "compared": {"run_seconds": {"value": seconds, "limit": seconds}}}
        sys.stderr.write(f"watchdog: the run had not ended after {seconds} s\n"
                         f"run_seconds {seconds} limit {seconds}\n")
        sys.stderr.flush()
        sys.stdout.write(json.dumps(line) + "\n")
        sys.stdout.flush()
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import harness

    spec = harness.load_spec(args.workload)
    chips = next(w["chips"] for w in spec["bench"]["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from recursivefactorization_jl_tpu_torch.ops import _kernels

    built = all(_kernels.library_path(name).exists() for name in _kernels.SOURCES)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": 0}
    watchdog = start_watchdog(WATCHDOG_S if built else WATCHDOG_BUILD_S,
                              args.workload, args.seed, device)

    result, compared = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), device="cuda", t0=T0)
    found = forbidden_modules()
    if found:
        watchdog.cancel()
        print(f"forbidden modules loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 2
    watchdog.cancel()
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])  # NaN and inf are not JSON numbers
    sys.stderr.flush()
    result["compared"] = compared
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
