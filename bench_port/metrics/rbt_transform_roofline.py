"""rbt_transform_roofline: the fused butterfly transform's share of its
roofline, in %: the least time of one depth-2 apply -- the larger of its
operations over the element type's peak and its least bytes (A read once,
A~ written once, the 4n values read once) over the HBM bandwidth
(``rbt_work.py``, ``work.least_seconds``): the bytes, by some twenty
times -- times the traced calls, divided by the kernel's busy time (union
of its intervals) in the same calls.  A program without that kernel
reports nothing.
"""

from bench_port import rbt_work, work
from bench_port.harness import BENCH_DIR, load_module
from bench_port.record import busy_seconds

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "RBT transform"
MOVES = "gflops"


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    is_transform = load_module(BENCH_DIR / "metrics" / "rbt_transform_ms.py").is_transform
    busy = busy_seconds(op for op in run.ops if is_transform(op))
    if busy <= 0:
        return None
    n = rbt_work.order_from_hpl_flops(run.flops / run.n_calls)
    least = work.least_seconds(rbt_work.transform_flops(n), rbt_work.transform_bytes(n, run.dtype),
                               run.device_kind, run.dtype)
    return None if least is None else 100.0 * run.n_calls * least / busy
