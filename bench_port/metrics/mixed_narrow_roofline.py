"""mixed_narrow_roofline: ``mixed_narrow_kernel``'s share of its roofline, in
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
    is_narrow = load_module(BENCH_DIR / "metrics" / "mixed_ms.py").is_narrow
    ops = [op for op in run.ops if is_narrow(op)]
    busy = busy_seconds(ops)
    if busy <= 0:
        return None
    n = rbt_work.order_from_hpl_flops(run.flops / run.n_calls)
    least = work.least_seconds(mixed_work.narrow_flops(n), mixed_work.narrow_bytes(n),
                               run.device_kind, "float64")
    return None if least is None else 100.0 * len(ops) * least / busy
