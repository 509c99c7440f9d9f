"""device_idle_pct.replay: the share of the traced window, in %, in which no
kernel, copy or set runs on the device (one less the union of the
operations' intervals over the window's length).
"""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "gflops"


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
