"""panel_ms: device ms per call in the panel kernels, those that
``csrc/panel_lu.cu``, ``panel_lu_c64.cu``, ``panel_lu_micro.cu``,
``panel_lu_noswap.cu`` and ``panel_cluster.cuh`` define (the chain, the
delayed swap/solve and update passes, the grid routes), matched by name.
"""

import re

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "panel kernels"
MOVES = "gflops"

PANEL_KERNELS = re.compile(
    r"\b(panel_chain_kernel|panel_swap_solve_kernel|panel_update_kernel"
    r"|panel_update_bf16x3_kernel|panel_update_bf16x3_tiled_kernel|panel_grid_chain_kernel"
    r"|panel_lu_kernel|panel_lu_c_kernel|panel_lu_micro_kernel|panel_lu_noswap_kernel"
    r"|noswap_chain_kernel|noswap_solve_kernel|noswap_update_kernel)\b")


def is_panel(op):
    return op.kind == "kernel" and bool(PANEL_KERNELS.search(op.name))


def read(run):
    if not run.ops or run.n_calls == 0:
        return None
    s = run.op_seconds(is_panel)
    return 1e3 * s / run.n_calls if s > 0 else None
