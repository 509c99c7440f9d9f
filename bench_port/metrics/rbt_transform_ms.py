"""rbt_transform_ms: device ms per call in the fused depth-2 butterfly
transform (``butterfly_depth2_kernel`` of ``csrc/butterfly.cu``), matched
by name.  A program without that kernel reports nothing.
"""

import re

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "RBT transform"
MOVES = "gflops"

TRANSFORM_KERNEL = re.compile(r"\bbutterfly_depth2_kernel\b")


def is_transform(op):
    return op.kind == "kernel" and bool(TRANSFORM_KERNEL.search(op.name))


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    s = run.op_seconds(is_transform)
    return 1e3 * s / run.n_calls if s > 0 else None
