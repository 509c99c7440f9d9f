"""batched_kernel_ms: device ms per call in the batched kernels, those that
``csrc/batched_lu.cu`` and ``csrc/batched_solve.cu`` define (every route
of the factor, swap and noswap, and of the solve), matched by name.
"""

import re

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "batched kernels"
MOVES = "gflops"

BATCHED_KERNELS = re.compile(
    r"\b(batched_lu_warp_kernel|batched_lu_block_kernel|batched_lu_block_noswap_kernel"
    r"|batched_lu_swap_kernel|batched_lu_noswap_kernel"
    r"|batched_solve_warp_kernel|batched_solve_wide_kernel|batched_solve_kernel)\b")


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    s = run.op_seconds(lambda op: op.kind == "kernel" and bool(BATCHED_KERNELS.search(op.name)))
    return 1e3 * s / run.n_calls if s > 0 else None
