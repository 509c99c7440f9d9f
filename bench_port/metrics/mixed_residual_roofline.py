"""mixed_residual_roofline: ``mixed_residual_kernel``'s share of its roofline, in
%: the least time of one pass -- the larger of its operations over the
float64 peak and its least bytes over the HBM bandwidth (``mixed_work.py``,
``work.least_seconds``): the bytes -- times the kernel's launches in the
traced calls, divided by its busy time (union of its intervals) there.  A
program without the kernel reports nothing.
"""

from bench_port import mixed_work, rbt_work, work
from bench_port.harness import BENCH_DIR, load_module
from bench_port.record import busy_seconds

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "mixed-precision refinement"
MOVES = "gflops"


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    is_residual = load_module(BENCH_DIR / "metrics" / "mixed_ms.py").is_residual
    ops = [op for op in run.ops if is_residual(op)]
    busy = busy_seconds(ops)
    if busy <= 0:
        return None
    n = rbt_work.order_from_hpl_flops(run.flops / run.n_calls)
    least = work.least_seconds(mixed_work.residual_flops(n), mixed_work.residual_bytes(n),
                               run.device_kind, "float64")
    return None if least is None else 100.0 * len(ops) * least / busy
