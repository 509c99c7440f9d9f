"""Readings that the limits of ``correct`` are set from: a cell's compared
numbers over many seeds, from the port (``--side program``), from the
plain reference put in the port's place (``--side reference``) and from
the control (``--side control``): that reference with every update's
products in TF32, the precision below the float32 the configurations
state (TF32 off).  The control has to come out as not correct.

    python3 bench_port/control.py --workload lu_f32.replay_n4096 --side control --seeds 1,2,3 --seconds 2

One JSON line per seed on standard output.  The benchmark's own runs do
not run this; it needs the cell's cards, as run.py does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class ReferenceEntry:
    """The plain reference in the port's place, with the entries' calls."""

    def __init__(self, ref, tf32: bool):
        self.ref = ref
        self.tf32 = tf32

    def call(self, A, b, device):
        factors, ipiv, info = self.ref.lu_factor(A, tf32=self.tf32)
        return factors, ipiv, info, self.ref.lu_solve(factors, ipiv, b)

    def warm(self, A, b, device):
        self.call(A, b, device)

    def release(self):
        pass


def reference_entry(workload: str, tf32: bool) -> ReferenceEntry:
    from bench_port import harness

    config = harness.load_spec(workload)["config"]
    ref = harness.load_module(harness.BENCH_DIR / "references" / f"{config['reference']}.py")
    return ReferenceEntry(ref, tf32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--side", choices=("program", "reference", "control"), required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    entry = None if args.side == "program" else reference_entry(args.workload, args.side == "control")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, compared = harness.run_cell(args.workload, seed, args.seconds, False,
                                            device="cuda", t0=t0, entry=entry)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "compared": compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
