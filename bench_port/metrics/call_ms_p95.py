"""call_ms_p95: the 95th percentile (nearest rank) of all the window's
calls' times, in ms.  A call is the factor and the solve, from the host's
call to the end of its work: CUDA events recorded on the stream before the
call and after it returns, read after the synchronise (the device's clock;
an event after a host-bound tail is stamped when the host records it).
"""

from bench_port.record import percentile

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    return percentile(run.call_ms, 95)
