"""copy_ms: device ms per call in copies: memcpy and memset records and
kernels whose name holds ``copy_kernel`` or ``BatchedCopy`` (elementwise and
concatenating copies).  In a replay these are the copies into the
program's static inputs and the clones of its outputs, with the program's
own copies (``lu``'s copy of A) beside them.
"""

import re

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "compiled programs"
MOVES = "gflops"

COPY_KERNEL = re.compile(r"copy_kernel|BatchedCopy")


def is_copy(op):
    return op.kind in ("memcpy", "memset") or bool(COPY_KERNEL.search(op.name))


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    s = run.op_seconds(is_copy)
    return 1e3 * s / run.n_calls if s > 0 else None
