"""mixed_passes: launches of ``mixed_residual_kernel`` per call, from the
device trace: the float64 passes over A that refinement made, LAPACK's ITER
+ 1 for a call that converged, and any masked steps.  A program without the
kernel reports nothing.
"""

from bench_port.harness import BENCH_DIR, load_module

UNIT = "passes"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "mixed-precision refinement"
MOVES = "gflops"


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    is_residual = load_module(BENCH_DIR / "metrics" / "mixed_ms.py").is_residual
    passes = sum(1 for op in run.ops if is_residual(op))
    return passes / run.n_calls if passes else None
