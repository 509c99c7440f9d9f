"""outside_panel_ms: device busy ms per call in every operation that is
neither a panel kernel (``panel_ms``) nor a copy (``copy_ms``): the blocked
schedule's GEMMs, triangular solves and row-swap glue.  The union of those
operations' intervals: device busy time less ``panel_ms`` and ``copy_ms``
where operations do not overlap.
"""

from bench_port.harness import BENCH_DIR, load_module
from bench_port.record import busy_seconds

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "blocked schedule"
MOVES = "gflops"


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    panel = load_module(BENCH_DIR / "metrics" / "panel_ms.py").is_panel
    copy = load_module(BENCH_DIR / "metrics" / "copy_ms.py").is_copy
    s = busy_seconds(op for op in run.ops if not panel(op) and not copy(op))
    return 1e3 * s / run.n_calls if s > 0 else None
