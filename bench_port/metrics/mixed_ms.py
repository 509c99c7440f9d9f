"""mixed_ms: device ms per call in the two float64 passes of mixed-precision
refinement, ``mixed_narrow_kernel`` and ``mixed_residual_kernel`` of
``csrc/mixed_refine.cu``, matched by name.  A program without them reports
nothing.
"""

import re

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "mixed-precision refinement"
MOVES = "gflops"

NARROW = re.compile(r"\bmixed_narrow_kernel\b")
RESIDUAL = re.compile(r"\bmixed_residual_kernel\b")


def is_narrow(op):
    return op.kind == "kernel" and bool(NARROW.search(op.name))


def is_residual(op):
    return op.kind == "kernel" and bool(RESIDUAL.search(op.name))


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    s = run.op_seconds(lambda op: is_narrow(op) or is_residual(op))
    return 1e3 * s / run.n_calls if s > 0 else None
