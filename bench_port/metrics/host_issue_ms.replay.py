"""host_issue_ms.replay: the median over the traced calls of the host's
time from the call to its return, before the synchronise, in ms: for a
replay, the copies in, one graph launch per call and the clones out.
"""

from bench_port.record import median

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "compiled programs"
MOVES = "gflops"


def read(run):
    return median(run.host_issue_ms) if run.traced else None
