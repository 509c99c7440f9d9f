"""call_roofline: the whole call's share of its roofline, in %: the least
time the card needs for the calls' own work -- the larger of HPL's
operation count over the published peak of the element type and the bytes
of A and b read once and of the factors, pivots, info and x written once
over the HBM bandwidth (work.py) -- over the device's busy time (union of
the operations' intervals) in the same traced calls.  The count does not
depend on the kernels that do the work.
"""

from bench_port import work

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels, the whole call"
MOVES = "gflops"


def read(run):
    busy = run.busy_s if run.ops else 0.0
    if busy <= 0:
        return None
    least = work.least_seconds(run.flops, run.bytes, run.device_kind, run.dtype)
    return None if least is None else 100.0 * least / busy
