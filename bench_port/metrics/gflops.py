"""gflops: solved systems' work over the whole window, by HPL's count
(2/3 n^3 + 3/2 n^2 per system, times the batch), in GFLOP/s, for calls that
replay the port's captured programs.  All the calls and all the time of
the window: from before the first call to the synchronise after the last.
"""

UNIT = "GFLOP/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if run.n_calls == 0 or run.window_s <= 0:
        return None
    return run.flops / run.window_s / 1e9
