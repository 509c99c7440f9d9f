#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernels-vs-plain only
    python3 chip_smoke.py --bf16x3   # build + phases 2g and 4g only
    python3 chip_smoke.py --graph    # build + phase 3h only
    python3 chip_smoke.py --plans    # build + the float64 b x C sweep only
    python3 chip_smoke.py --mixed    # build + the mixed-precision (DSGESV) phase only
    python3 chip_smoke.py --profile  # every phase + a device-time breakdown
    python3 chip_smoke.py --sweep    # every phase + the panel routing sweep
    python3 chip_smoke.py --log F    # also write the phase lines to file F

Phases, JSON lines each:

1. env      card name and power limit (nvidia-smi), torch/CUDA versions,
            the kernels' build seconds, build directory and ptxas resource
            lines; then ``warmup``: utils.warmup.warmup at 1536 x 1536
            float32 after the build, timed;
2. kernel   the Hopper panel kernel against its plain PyTorch version on
            the main path's panel shapes, f32/f64, pivot on/off, a zeroed
            column and exact ties: ipiv, perm and info equal, factors
            bitwise equal (both round every product and difference once);
            then every block width b and cluster size C of its cluster
            route (and one slab for the whole panel) on a 1000 x 100
            panel, ragged, tied, NaN and unpivoted panels, a whole 512 x
            512, a fat 64 x 200, a column block of a 4096 x 4096 matrix,
            8192 x 512, and panels too tall for a cluster (the grid route,
            counted apart);
3. main     ``lu`` + ``lu_solve`` of the port at n=1536 (the entry
            matrix randn + n*I, plain randn, a zeroed column) and n=4096
            (randn): residual gate ||LU - A[p]||_max < 20*n*eps*max|A|,
            info, SingularMatrixError under check, the kernel's launch
            count, and no TF32 in any product; the entry matrix again with
            PyTorch's current TF32 API set to 'tf32' by the caller (no TF32
            product, the setting restored); an int32 matrix of n=1536
            (the generic route: float64 factors and solution on the float64
            panel kernel, pivots, perm, info and factors equal to those of
            its float64 copy);
4. timing   CUDA-event times: the panel kernel per panel shape in turns beside
            the ``shadow`` kernel and torch.linalg.lu_factor_ex, factor
            and factor+solve at 1536/4096 beside the library (+ lu_solve);
            with ``--sweep`` the width/route/tail sweep behind the routing
            defaults of utils/config.py;
5. kernels  one line for every kernel function and route (launches,
            error, times, bound, library time); before it, ``mixed``:
            ``mixed_lu`` + ``mixed_lu_solve`` (LAPACK's DSGESV) at n = 4096
            and 8192, ITER, the route, both kernels of
            csrc/mixed_refine.cu bit for bit their twins, LAPACK's test and
            HPL's residual in float64, the kernels' ms beside their bounds,
            and the call's replay ms in turns beside ``lu`` in float64 and
            ``torch.linalg.solve`` (also alone with ``--mixed``, which then
            prints a ``kernels`` line of the two mixed kernels only).

The batched small-matrix path adds, in the same order:

2b. batched_kernel  the swap kernel on each shape's own route (warp,
            block or tile, ops/batched_kernel.py lu_route) and on the tile
            route, the noswap kernel on its own route (warp or block,
            noswap_route) and (n <= 32) on the block route, against their
            plain versions: f32/f64, n = 16/64/128, the routes' boundaries
            (1, 8, 17, 31, 32, 33, 127, 32 x 40, 40 x 32, 20 x 32), tall
            and wide shapes, batches of 1, 3, 37, 1000 and 1001, pivot on/off,
            zeroed columns, exact ties, inf and NaN in a pivot row, a NaN
            candidate after row m - 1 won the first step (the noswap mode picks
            it again): ipiv, perm, info equal, one launch on the route, factors
            and solutions bitwise equal (NaN for NaN); the solve kernel on its
            shape's route (warp at n <= 32, wide up to 128): n = 1, 8, 15, 16,
            17, 31, 32, 33, 48, 64, 96, 127, 128, batches of 1, 3, 37, 1000 and
            1001, no row order, perm or ipiv, a vector, one and five right-hand
            sides, a zero on U's diagonal: solutions bitwise equal NaN for NaN,
            one launch on the route; forced routes that do not take the shape
            raise;
3b. batched the four public functions at B = 10 000, n = 16 (warp
            routes), 64 and 128 (block routes, the solve's wide route),
            f32, plus the noswap kernel as its caller reaches it, and a
            tall batch of 1000 x 300 x 24 (tile route): every output held
            against the plain versions on the same inputs (ipiv, perm, info
            equal, factors and solutions bitwise equal: the error the
            ``kernels`` line reports), residual gate per matrix, ipiv equal
            to torch.linalg.lu_factor_ex's (f64: everywhere; f32: in all
            but at most 10 matrices, each a near tie of the two candidates
            at its first differing step), info exact on zeroed columns, one
            launch per call on the shape's route (swap, noswap and solve),
            no TF32 on the library-route solve;
4b. timing  the swap kernel on its own route and on the tile route, the
            noswap kernel and the solve on their own routes, and
            factor+solve at n = 8/16/24/32/48/64/96/128, B = 10 000, in
            turns beside torch.linalg.lu_factor_ex and lu_solve; f64 at
            n = 64 (factor, noswap, the solve with 1 and 8 right-hand
            sides) and the solve at n = 128; the tall batch (device times;
            eight right-hand sides at n = 16, 32 and 64); the plain
            versions once; per route and kernel the plan (threads, matrices
            per block, shared memory, registers, local memory, resident
            blocks per SM and what caps them, waves) and at n = 16/32/64/
            128 a step's phases from the trace build (csrc/batched_lu.cu
            compiled with -DRF_BATCHED_TRACE), swap and noswap; the
            register routes' ptxas lines.
            ``--batched`` runs phases 1, 2b and 4b alone.

The complex and half-precision path adds:

2c. kernel  the complex panel kernel (csrc/panel_lu_c64.cu) against its
            plain version on the real and imaginary planes, on its cluster
            route: every block width b and cluster size C on a ragged
            1000 x 100 panel, complex64 and complex128, the main path's
            panel shapes, a whole 512 x 512 matrix, a ragged tall and a
            fat panel, a column block, pivot on/off, a zeroed column,
            exact CABS1 ties, NaN in re, in im and at row m - 1 (every
            later pivot row m - 1); on its grid route forced and on
            panels too tall for a cluster: ipiv, perm and info equal,
            factors bitwise equal, the route counted;
3c. main    ``lu`` + ``lu_solve`` (N, T, H) on complex64 at n=1536 (the
            entry matrix, plain randn, a zeroed column) and n=4096, on
            complex128 at 1536, and on bfloat16/float16 at 1536 through
            the promote route: the residual gate with the type's eps,
            info, SingularMatrixError under check, launch counts, no TF32
            product, pivots against torch.linalg.lu_factor_ex (where they
            part, the two candidates of the first differing step must tie
            to n*eps in a complex128 elimination), half pivots equal to
            the float32 run's;
4c. timing  the complex kernel per panel shape on both routes in turns
            beside the library, a step's phases from the chain trace,
            complex64 factor and factor+solve at 1536/4096 and complex128
            at 1536 in turns beside the library; ``--sweep`` adds the
            complex b x C sweep behind the complex entries of plan_for.

The opt-in schedules and the RBT solver add:

2d. kernel  the micro-blocked kernels (csrc/panel_lu_micro.cu) against
            ``micro_blocked_lu`` and each other, on their cluster route
            (blocks of micro steps, one kernel for ``shadow`` and
            ``basic``) and forced onto their grid routes (the staged and
            in-place grid-barrier kernels), and the no-swap kernel
            (csrc/panel_lu_noswap.cu) against ``unblocked_lu_noswap`` on
            its cluster route (sized by the live count, or for m without
            one) and its grid route forced: the main path's panels (the
            no-swap one also with half the rows taken by earlier panels),
            a whole 512 x 512, a ragged tall and (micro kernels) a fat
            panel: f32/f64, pivot on/off, a zeroed column, exact ties,
            NaN candidates, scattered masks, 38 rows left for 130 steps
            (prow -1), micro 12/16/32: ipiv / prow, perm / used and info
            equal, factors bitwise equal (NaN for NaN), the route counted;
            every plan (micro 8/12/16/32/64 x C; b 8/16/32/64/one block x
            C under a mask) on a 1000 x 100 panel; micro 65/128/256/512 on
            the main path's panels in f32 and f64, on the cluster route
            and with every block's chain forced onto the grid (the grid
            block chain, counted); a live count too small
            for the mask, in a child process: the launch must fail; the
            same on column blocks of a 1536 x 1536 matrix (row stride n,
            as the blocked schedules hand them over), the no-swap
            kernel's second block under the mask its first one returned;
3d. main    ``lu`` + ``lu_solve`` under ``schedule='physical'`` at n=1536
            (entry matrix, randn, zeroed column) and 4096, f64 at 1536,
            and under ``panel_variant='shadow'`` / ``'basic'`` at 1536
            and 4096: residual gate, info, launch counts per kernel and
            none on a grid route, no TF32 product, the permutation
            against the default route's
            (equal, or the two candidates of the first differing step tie
            to n*eps in an f64 elimination).  ``butterfly_solve`` on a
            Wilkinson matrix of n=800 in f64 (||Ax - b|| <= 1e-10) and on
            randn + n*I at n=1536 in f32 with refine 0 and 2 beside the
            pivoted ``lu_solve``; the panel kernel's launches with
            pivot=False; the benchmark's RBT problem (HPL's uniform matrix,
            n=4096 f32) through ``butterfly_factor`` /
            ``butterfly_factor_solve`` (refine 0 / 1 / 2: HPL's residual
            under 16 after one step, bit for bit ``butterfly_solve``), the
            fused transform's launches, its output bit for bit its tensor
            code's, and its device time beside the tensor code's and its
            bound (the ``kernels`` line's ``butterfly_depth2_kernel``);
4d. timing  the micro-blocked and no-swap kernels per panel shape on their
            cluster and (forced) grid routes in turns beside
            csrc/panel_lu.cu and torch.linalg.lu_factor_ex, the micro
            route at micro 8/16/64, the no-swap kernel with half the rows
            taken, their plain versions once, a step's phases from their
            chain traces; factor and factor+solve at 1536/4096 for the
            default route, ``physical``, ``shadow``, ``basic`` and the
            library in turns; RBT beside the pivoted solve; ``--sweep``
            adds micro 8/16/32/64 x panel width.

The tensor-parallel layer (parallel/blockcyclic.py, the sharded batched
functions) and its offset kernel add:

2e. kernel  the offset kernel (csrc/panel_lu.cu, ``kOffset``) against
            ``offset_panel_lu``: f32/f64, pivot on/off, (4096, 128) at
            offsets 0, 1000 and 3968, randn, a zeroed column and NaN
            candidates, and a column block of a wider matrix (row stride
            > w), block widths and cluster sizes at offset 1000, one CTA
            for the 128 live rows, panels too tall for a cluster: piv,
            perm and info equal, factors bitwise equal, the rows above the
            offset untouched;
3e. tp      in an NCCL world of one rank: ``tp_lu`` + ``tp_lu_solve``
            (N, T, H) at n=4096 (f32, w=128 and 512), n=1536 (f64),
            ``pivot=False`` on randn + n*I, a zeroed column 700 (info 701),
            complex64 at n=4096 and complex128 at 1536 (the complex offset
            kernel), bfloat16 / float16 at 1536 (promoted) and int32 at 1536
            (float64), and the sharded batched functions at 10 000 x 64 x
            64: residual gate, info, n/w launches of the type's offset
            kernel per factor and none of the other panel kernels, the
            factors' and solutions' type, pivots equal to ``lu(config=
            LUConfig(panel_width=w))``'s or parting at a step whose two
            candidates tie to n*eps (CABS1 for complex), the batch equal to
            the unsharded one;
3f. tp_ranks two gloo ranks spawned on the one card, n=2048, w=128, in
            float32 and complex64: the ranks agree bitwise, float32 pivots
            against the one-rank run's under the same gate, residual gate,
            n/w launches of the type's offset kernel (a check of the path,
            not a scaling number);
2f. kernel  the offset form of the complex kernel (csrc/panel_lu_c64.cu)
            against ``offset_panel_lu_cabs1`` on its cluster route and
            forced onto its grid route: complex64 (4096, 128) and
            complex128 (1536, 128) at offsets 0, 1000 and H - w, randn, a
            zeroed column, a NaN candidate (every later pivot row H - 1),
            pivot on/off, a column block of a wider matrix: piv, perm and
            info equal, factors bitwise equal (NaN for NaN), the rows above
            the offset untouched, the route counted;
4e. timing  the offset kernel per panel beside ``shadow`` and
            ``lu_factor_ex`` on the live rows, the complex offset kernel on
            both routes beside ``lu_factor_ex`` on the live rows, and
            ``tp_lu_factor`` in the one-rank world beside ``lu`` at the
            same width and the library, in float32 and complex64;
            ``--sweep`` adds the panel kernel's b x C sweep per live height
            and width (f32; f64 at every height of an n = 4096 lu, 512 to
            4096 rows x 512, and 4096 x 128; complex), each plan's spread
            between three turns beside it (``plan_sweep``); ``--plans``
            runs the build and the f64 heights alone.

The boundary knob, ``panel_boundary_precision='bf16x3'`` (the tensor-core
update of csrc/panel_cluster.cuh in csrc/panel_lu.cu's bf16x3 form), adds:

2g. kernel  the update alone at nb = 1, 8, 16, 20, 32, 40, 64, 80 and 256
            on views of 1000 x 300 (row stride on 16 bytes and off them), 8192 x
            512, 33 x 4065 and 4065 x 33 against the exact float64 sum of
            its three split products: the worst ratio to 2^-24 ((nb + 2)
            sum |products| + |result|) must be at most 1, nothing outside
            C written; the tiled kernel bit for bit equal to the simple
            kernel; against its plain version (the split in torch) for the
            kernels line; an inf in L and in U: NaN where the plain version
            has NaN; then f32 panels 1536 / 4096 / 8192 x 512 in 32-step
            blocks (randn pivoted and not, a zeroed column, exact ties, a
            NaN) against ``micro_blocked_lu(..., 'bf16x3')`` on the card:
            info equal, one update per boundary, ipiv equal or parting at
            a tie within 2^-8 of the column, with equal pivots perm and
            NaN equal and the factors within twice the knob's own effect
            (plain bf16x3 - plain float32), the residual gate; each panel
            on the tiled update bit for bit the panel on the simple one;
            panels too tall for a cluster (28 672 x 64 at b 32, 100 000 x 64
            at b 8: their blocks' chains on the grid, counted against the
            plan) against the plain version the same way; every block's
            chain forced onto the grid at 1536 / 4096 x 512, bit for bit
            the cluster chain's result;
3g. main    ``lu`` + ``lu_solve`` under the knob at n = 1536 (entry
            matrix, randn, a zeroed column), 4096 and 8192 (randn), alone
            and with ``schur_precision='bf16x3'``, and at n = 28 672 (randn
            made on the card; its first four panels too tall for a cluster,
            their blocks' chains on the grid; residuals a block of rows at a
            time): residual gate beside the float32 form's scaled residual
            on the same matrix, info, no TF32 product, panel launches (all
            in the bf16x3 form, none on a grid route), update launches per
            ``lu`` (none on the simple kernel) and the grid chain's blocks
            (as the plans count them; some only at 28 672);
4g. timing  in turns: the update alone at each main-path panel's first
            boundary (tiled, simple, plain, one float32 ``addmm_``) by
            CUDA events over 20 queued calls, and by device time on the
            same operands (L2-warm) and on operands rotated over copies
            that hold twice the L2 (cold); the panel per shape in the
            bf16x3 form on the tiled and on the simple update beside the
            float32 form at the same block width, at its default plan and
            the library; the grid block chain's device time per step
            beside the cluster chain on the same blocks and the float32
            form's grid route (``panel_lu_kernel``) at 1536 / 4096 x 512
            and 28 672 x 512; the delayed kernels' device time per launch at
            nb = 64 / 128 / 256 on 4096 x 512 (micro route and bf16x3
            form); ``lu`` factor at n = 28 672 under float32 and bf16x3
            beside the library; ``lu`` factor and factor+solve at 1536 /
            4096 / 8192 under float32, bf16x3 and bf16x3 + bf16x3 Schur
            beside the library.  ``--profile`` adds ``lu`` + ``lu_solve``
            under the knob at 1536 and 4096: the updates' device time and
            launches.

The compiled entry points (utils/graphs.py: a CUDA graph per key, the
counterpart of the JAX package's jax.jit programs, filled by
utils.warmup.warmup) add:

3h. graph   for each key (float32 n = 1536: the entry matrix, randn and
            a zeroed column; float32 4096; float64 at 1536 and 4096 (the
            benchmark's float64 cell); complex64, ``schedule='physical'``
            and ``panel_boundary_precision='bf16x3'`` at 1536; the bf16x3
            form's cooperative grid block chain on a 28 672 x 64 matrix;
            the smallest (m, 512) float32
            matrix whose panel takes the cooperative grid route of
            csrc/panel_lu.cu, found from plan_for): the eager call once
            under torch.cuda.set_sync_debug_mode("error"), ``warmup`` (a
            key it cannot capture must raise naming the key; the two
            cooperative keys may be refused so, and are reported), the
            memory_reserved the programs hold, ``lu`` + ``lu_solve`` by
            replay bit for bit the eager call's (factors, ipiv, perm,
            info, x; NaN for NaN) on each input and on a second one, one
            replay per program and call, info, the residual gate,
            SingularMatrixError under check, the panel chain launches by
            plan (``.counts.chain_launches_by_plan``, zeroed before the key's
            eager calls: each on ``panel_plan``'s own plan of a live
            height); the batched perm and ipiv
            pairs at 10 000 x 16 and 10 000 x 64 captured by
            ``graphs.capturing()``; the entry step (the jitted step of
            __graft_entry__.py: factor + solve) captured as one program;
            CUDA-event ms per call in turns (eager, replay, the library's
            lu_factor_ex + lu_solve) for the pair and for the solve alone,
            and the idle share of each under torch.profiler.  Then the
            keys ``graphs.capturing()`` captures around the rest of the
            entry points (GRAPH_MORE): ``lu_inplace`` (the donated
            program: f32 1536 on the entry matrix and a zeroed column,
            info 701 and SingularMatrixError through the copied info, and
            4096; beside ``lu`` by replay), the RBT solver (a Wilkinson
            matrix of n = 801 in f64, padded to 804, and randn + n*I at
            1536 in f32, refine 0 and 2, a vector and a matrix right-hand
            side: ``butterfly_workspace`` with its values held as the
            program's constant, ``butterfly_solve``, ``UV``), ``tp_lu`` +
            ``tp_lu_solve`` N/T/H in the NCCL world of one rank (n = 4096
            f32 at w = 128 and 512, complex64 at w = 128) and the sharded
            pair there at 10 000 x 64 x 64: the eager call under the sync
            debug mode (RBT: the programs' own code, its values made
            first: their copy from the CPU generator is the one host
            operation, made outside the graph), the capture, every output
            of the replay bit for bit the eager call's on two inputs, the
            gates, ms in turns (eager, replay, library), idle shares, host
            ms, memory held; a gloo group asked to capture must raise
            naming its backend.  At the end ``utils.warmup.clear_caches``
            and the memory it frees.  The
            ``warmup`` line of phase 1 captures too; its programs are
            freed before phase 2, so that the main path runs eagerly
            through the wrappers whose launches it counts.
            ``--graph`` runs phases 1 and 3h alone (in an NCCL world of
            one rank of its own).

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises
before it, and the exit code is not 0.  Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense, outside the tensor cores for f32/f64)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12,
              "complex64": 67e12, "complex128": 34e12}
PEAK_BYTES = 3.35e12
SOURCE = "recursivefactorization_jl_tpu_torch/csrc/panel_lu.cu"
REPLACES = "recursivefactorization_jl_tpu/ops/panel.py:411"
SOURCE_C64 = "recursivefactorization_jl_tpu_torch/csrc/panel_lu_c64.cu"
REPLACES_C64 = "recursivefactorization_jl_tpu/ops/panel.py:1030"
# the complex offset form carries complex tp_lu, where the JAX package runs
# its pure-JAX offset panel (no TPU kernel of its own)
REPLACES_C64_OFFSET = "recursivefactorization_jl_tpu/parallel/blockcyclic.py:72"
NEW_PANEL_KERNELS = {
    # each on its cluster route (the main path's) and, "_grid", on its grid
    # route (the grid-barrier kernels: panels too tall for a cluster, or
    # block=-1)
    "panel_lu_micro_shadow": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_micro.cu",
                              "recursivefactorization_jl_tpu/ops/panel.py:266"),
    "panel_lu_micro_basic": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_micro.cu",
                             "recursivefactorization_jl_tpu/ops/panel.py:161"),
    "panel_lu_noswap": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_noswap.cu",
                        "recursivefactorization_jl_tpu/ops/panel.py:742"),
}
NEW_PANEL_KERNELS.update({f"{k}_grid": v for k, v in list(NEW_PANEL_KERNELS.items())})
# a child process that launches the no-swap kernel with a live count too
# small for its mask: the chain kernel traps (which ends that process's CUDA
# context), and the error must surface at the synchronisation
WRONG_LIVE_PROBE = """
import sys, torch
from recursivefactorization_jl_tpu_torch.ops.panel import noswap_plan, panel_factor_noswap_cuda
P = torch.randn(1536, 512, device="cuda")
used0 = torch.zeros(1536, dtype=torch.int32, device="cuda")
print("plan", noswap_plan(1536, 512, torch.float32, live=100), flush=True)
try:
    panel_factor_noswap_cuda(P, used0, True, live=100)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:200])
    sys.exit(0)
print("no error")
sys.exit(1)
"""
BATCHED_KERNELS = {
    # the swap mode's three routes (ops/batched_kernel.py lu_route): a warp
    # per matrix, a register-tiled block, the shared-memory tile
    "batched_lu_warp": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                        "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    "batched_lu_block": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                         "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    "batched_lu_swap": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                        "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    # the noswap mode's routes (ops/batched_kernel.py noswap_route): the warp
    # and block kernels in their noswap mode
    "batched_lu_noswap_warp": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                               "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    "batched_lu_noswap_block": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                                "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    # the solve's two routes (ops/batched_kernel.py solve_route): the warp
    # per matrix (n <= 32), the warp with rows l + 32 r per lane (32 < n <=
    # 128)
    "batched_solve_warp": ("recursivefactorization_jl_tpu_torch/csrc/batched_solve.cu",
                           "recursivefactorization_jl_tpu/ops/batched_kernel.py:415"),
    "batched_solve_wide": ("recursivefactorization_jl_tpu_torch/csrc/batched_solve.cu",
                           "recursivefactorization_jl_tpu/ops/batched_kernel.py:415"),
}
OFFSET_KERNEL = ("recursivefactorization_jl_tpu_torch/csrc/panel_lu.cu",
                 "recursivefactorization_jl_tpu/ops/panel.py:1278")
BATCH_B = 10000
ROUTE_KERNEL = {"warp": "batched_lu_warp", "block": "batched_lu_block", "tile": "batched_lu_swap"}
NOSWAP_KERNEL = {"warp": "batched_lu_noswap_warp", "block": "batched_lu_noswap_block"}
SOLVE_KERNEL = {"warp": "batched_solve_warp", "wide": "batched_solve_wide"}
# the tall batch that takes the tile route on the main path
TALL_B, TALL_SHAPE = 1000, (300, 24)
# the tp_ranks phase: D = 2 gloo ranks on the one card
TP_RANKS_N, TP_RANKS_W, TP_RANKS_SEED = 2048, 128, 5


LOG = None  # a file that also receives every phase line (--log PATH)


def emit(phase, **kw):
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    if LOG is not None:
        LOG.write(line + "\n")
        LOG.flush()


def fail(msg):
    raise AssertionError(msg)


@contextlib.contextmanager
def quiet_c_stdout():
    """Send the C library's stdout to the null device for the block.  The
    linear-algebra library behind ``torch.linalg.lu_factor_ex`` prints a
    size warning from some of its batched routines, which would land
    between the JSON lines."""
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    null = os.open(os.devnull, os.O_WRONLY)
    os.dup2(null, 1)
    try:
        yield
    finally:
        libc.fflush(None)
        os.dup2(saved, 1)
        os.close(saved)
        os.close(null)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def panel_flops_bytes(m, w, itemsize, cplx=False):
    """Operations and bytes of one (m, w) panel LU: the scale and the
    rank-1 updates; the panel read and written once plus the outputs.  A
    complex multiply is 6 real operations, a multiply-subtract 8."""
    minmn = min(m, w)
    scale, update = (6, 8) if cplx else (1, 2)
    flops = sum(scale * (m - k - 1) + update * (m - k - 1) * (w - k - 1)
                for k in range(minmn))
    nbytes = 2 * m * w * itemsize + 4 * (minmn + m + 1)
    return flops, nbytes


def bound(m, w, dtype_name, itemsize):
    flops, nbytes = panel_flops_bytes(m, w, itemsize, dtype_name.startswith("complex"))
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def roofline(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def batched_lu_bound(B, m, n, dtype_name, itemsize, with_perm=True):
    """B LU factorizations of (m, n): the matrices read and written once,
    ipiv, perm and info written once."""
    flops, _ = panel_flops_bytes(m, n, itemsize)
    nbytes = B * (2 * m * n * itemsize + 4 * (min(m, n) + (m if with_perm else 0) + 1))
    return roofline(B * flops, nbytes, dtype_name)


def batched_solve_bound(B, n, nrhs, dtype_name, itemsize):
    """B solves: the factors read once, the right-hand sides read and the
    solutions written once; per column n(n-1) multiply-subtracts in each
    sweep's triangle and n divisions."""
    flops = B * nrhs * (2 * n * (n - 1) + n)
    nbytes = B * (n * n + 2 * n * nrhs) * itemsize
    return roofline(flops, nbytes, dtype_name)


def offset_panel_bound(H, w, ofs, dtype_name, itemsize):
    """The offset kernel on an (H, w) panel from row ``ofs``: the LU of the
    H - ofs live rows, those rows read and written once, piv (w,), perm
    (H,) and info written once (``itemsize``: bytes per element, 8 / 16
    for complex64 / complex128, whose operations count as
    ``panel_flops_bytes`` says)."""
    flops, _ = panel_flops_bytes(H - ofs, w, itemsize, dtype_name.startswith("complex"))
    return roofline(flops, 2 * (H - ofs) * w * itemsize + 4 * (w + H + 1), dtype_name)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_ranks_input(cplx=False):
    """The tp_ranks phase's matrix and right-hand side (numpy, float64 or
    complex128), made alike in every rank and in the parent."""
    import numpy as np

    rng = np.random.default_rng(TP_RANKS_SEED)
    M, v = rng.standard_normal((TP_RANKS_N, TP_RANKS_N)), rng.standard_normal(TP_RANKS_N)
    if cplx:
        M = M + 1j * rng.standard_normal((TP_RANKS_N, TP_RANKS_N))
        v = v + 1j * rng.standard_normal(TP_RANKS_N)
    return M, v


def tp_rank(rank, world, port, out):
    """One rank of the tp_ranks phase, in a spawned process: join a gloo
    group of ``world`` ranks on card 0, factor and solve the phase's matrix
    with ``tp_lu`` / ``tp_lu_solve`` in float32 and in complex64, and put
    what the parent checks on ``out``, a list with one record per type (an
    error's traceback instead, so that no rank waits for nothing)."""
    import datetime
    import hashlib
    import traceback

    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        import recursivefactorization_jl_tpu_torch as rt
        from recursivefactorization_jl_tpu_torch.ops.panel import (
            offset_panel_factor_c64_cuda,
            offset_panel_factor_cuda,
            panel_factor_c64_cuda,
            panel_factor_cuda,
            reset_counts,
        )

        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")  # the device is set before the mesh
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("tp",))
        wrappers = {"panel_lu_offset": offset_panel_factor_cuda,
                    "panel_lu_c64_offset": offset_panel_factor_c64_cuda,
                    "panel_lu": panel_factor_cuda, "panel_lu_c64": panel_factor_c64_cuda}
        records = []
        for dt in (torch.float32, torch.complex64):
            M, v = tp_ranks_input(dt.is_complex)
            A = torch.tensor(M, device="cuda").to(dt)
            b = torch.tensor(v, device="cuda").to(dt)
            reset_counts()
            t0 = time.perf_counter()
            F = rt.tp_lu(A, mesh, "tp", TP_RANKS_W)
            x = rt.tp_lu_solve(F, b, mesh, "tp", TP_RANKS_W)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: wr.counts.launches for k, wr in wrappers.items()}
            n = TP_RANKS_N
            wd = torch.complex128 if dt.is_complex else torch.float64
            r = float((F.L.to(wd) @ F.U.to(wd) - A.to(wd)[F.p.long()]).abs().max())
            g = 20 * n * torch.finfo(torch.float32).eps * float(A.abs().max())
            Ad, xd = A.to(wd), x.to(wd)
            sr = float((Ad @ xd - b.to(wd)).norm() / (Ad.norm() * xd.norm()))
            records.append(dict(
                dtype=str(dt)[6:], ipiv=F.ipiv.cpu().numpy(), perm=F.p.cpu().numpy(),
                info=int(F.info), launches=launches, resid=r, gate=g, solve_rel_resid=sr,
                factor_solve_wall_s=wall,
                factors_sha256=hashlib.sha256(F.factors.cpu().numpy().tobytes()).hexdigest()))
        out.put(dict(rank=rank, ok=True, backend=dist.get_backend(mesh.get_group("tp")),
                     records=records))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the parent
        out.put(dict(rank=rank, ok=False, error=traceback.format_exc()))


def device_rows(prof):
    """(ms, calls, name) of the device-side events of a torch.profiler
    run, longest first: the CPU ops that launched them carry the same
    time again and are left out."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt / 1e3, e.count, e.key[:60]))
    rows.sort(reverse=True)
    return rows


# windows a device-time measurement opens before it gives up: on the H100 the
# profiler has recorded none of a window's kernels, once in three windows in a
# row (the 8160-row update of phase 4g), and late in a run (after the tp
# phase's NCCL world) every window of some measurements of phases 4b, 4g and
# 3h; the second half of the windows records CPU activity too, each empty
# window is noted, and a measurement that no window records is left out with
# a note (the smoke's checks do not read these times)
PROFILER_WINDOWS = 8


def profiled_rows(run, rows, what, before=None):
    """``rows(prof)`` of a torch.profiler window over ``run()`` (which
    synchronises; ``before()`` runs ahead of each window, outside it),
    opening up to PROFILER_WINDOWS windows while the profiler records no
    kernel in one; then None: the caller notes what it could not measure."""
    import torch

    acts = torch.profiler.ProfilerActivity
    for attempt in range(PROFILER_WINDOWS):
        if attempt:
            emit("note", what="profiler_window_empty", of=what, attempt=attempt)
            torch.cuda.synchronize()
            time.sleep(0.5 * attempt)
        if before is not None:
            before()
        late = attempt >= PROFILER_WINDOWS // 2
        with torch.profiler.profile(
                activities=[acts.CPU, acts.CUDA] if late else [acts.CUDA]) as prof:
            run()
        got = rows(prof)
        if got:
            return got
    return None


def device_ms(fn, calls=5):
    """Device time per call of ``fn`` (every kernel it launches), from
    torch.profiler: at small n a call's host time exceeds its kernels'
    and the events around queued calls measure the host.  Where the
    profiler records no kernel in PROFILER_WINDOWS windows, those events
    all the same, in a ``device_ms_by_events`` note."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    got = profiled_rows(run, device_rows, "device_ms")
    if got is not None:
        return sum(r[0] for r in got) / calls
    # the profiler recorded nothing in any window: CUDA events around the
    # synchronised calls instead, the host's gaps between launches included
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / calls
    emit("note", what="device_ms_by_events", windows=PROFILER_WINDOWS, ms=ms)
    return ms


def device_span_ms(fn, setup, calls=5):
    """Calls of ``fn`` (``setup`` before each, outside the window), each
    under torch.profiler: the medians of its device span (from its first
    kernel's start to its last kernel's end: the host's time before the
    first launch left out), of its kernels' busy time, of its chain
    kernels' time and of the host's time to enqueue it, in ms."""
    import torch

    setup()
    fn()
    host = []

    def before():
        setup()
        torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()

    def events(prof):
        return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if "CUDA" in str(getattr(e, "device_type", ""))]

    rec = []
    while len(rec) < calls:
        ev = profiled_rows(run, events, "device_span_ms", before)
        if ev is None:  # no window recorded a kernel: not measured
            emit("note", what="device_span_ms_unmeasured", windows=PROFILER_WINDOWS)
            return dict(span=None, busy=None, chain=None, host_enqueue=host[-1] * 1e3)
        rec.append(((max(t for _, t, _ in ev) - min(s for s, _, _ in ev)) / 1e3,
                    sum(t - s for s, t, _ in ev) / 1e3,
                    sum(t - s for s, t, n in ev if "panel_chain_kernel" in n) / 1e3,
                    host[-1] * 1e3))
    return dict(zip(("span", "busy", "chain", "host_enqueue"),
                    (sorted(x)[len(x) // 2] for x in zip(*rec))))


def kernel_device_ms(fn, names, setup=None, calls=3):
    """Device time per call (ms) and launches per call of the kernels of
    ``fn`` whose names hold each of ``names``, from torch.profiler over
    ``calls`` calls (``setup`` before each, inside the window: name the
    kernels so that its own are not counted).  Where the profiler records
    no kernel in PROFILER_WINDOWS windows: no launches, in a
    ``kernel_device_ms_unmeasured`` note."""
    import torch

    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()

    rows = profiled_rows(run, device_rows, "kernel_device_ms")
    if rows is None:
        # no window recorded a kernel: no launch is counted, so the readers
        # (which keep the names with launches) leave these names out
        emit("note", what="kernel_device_ms_unmeasured", names=list(names),
             windows=PROFILER_WINDOWS)
        return {k: (0.0, 0) for k in names}
    out = {}
    for k in names:
        hit = [r for r in rows if k in r[2]]
        out[k] = (sum(r[0] for r in hit) / calls, sum(r[1] for r in hit) / calls)
    return out


def bf16x3_update_rows(rows):
    """The bf16x3 update kernels among a profiled window's device rows
    (:func:`device_rows`): their device ms, launches and time per launch,
    beside the chain kernels' ms.  The updates run in turn with the chains
    on one stream, so all of their time is on the panels' critical path."""
    ups = [r for r in rows if "panel_update_bf16x3" in r[2]]
    ms, calls = sum(r[0] for r in ups), sum(r[1] for r in ups)
    return dict(update_ms=ms, update_launches=calls,
                update_us_per_launch=1e3 * ms / calls if calls else None,
                chain_ms=sum(r[0] for r in rows if "panel_chain_kernel" in r[2]))


def profile_run(dev, card, factor, solve, expect=(), updates=False, **what):
    """Profile one factor + solve; ``expect`` names kernels (substrings)
    the device rows must hold.  Only CUDA activity is recorded: with CPU
    activity on too, the profiler dropped the batched factor kernel of
    the window (PERF.md), and with CUDA activity alone it once dropped
    the 5 ms factor kernel at n = 128: a window that lacks an
    expected kernel is taken again, up to three windows.  A small
    kernel opens the window, so that a record lost at the start would
    be that one.  ``updates``: the bf16x3 updates' device time
    (:func:`bf16x3_update_rows`) in the line."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    solve(factor())
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            F = factor()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solve(F)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        # (busy time includes the opening fill and add of one element, ~2 us)
        rows = device_rows(prof)
        missing = [k for k in expect if not any(k in r[2] for r in rows)]
        if not missing:
            break
    busy = sum(r[0] for r in rows)
    wall = (t2 - t0) * 1e3
    emit("profile", card=card, factor_wall_ms=(t1 - t0) * 1e3,
         solve_wall_ms=(t2 - t1) * 1e3, device_busy_ms=busy,
         idle_share=1 - busy / wall if wall > 0 else None,
         top=[{"ms": r[0], "calls": r[1], "name": r[2]} for r in rows[:12]],
         expected_kernels=list(expect), missing_kernels=missing, windows=attempt, **what,
         **(bf16x3_update_rows(rows) if updates else {}))
    if missing:
        fail(f"profile: kernels {missing} not recorded ({what})")


def bf16x3_profile(rt, card, gen, dev):
    """``lu`` + ``lu_solve`` under ``panel_boundary_precision='bf16x3'`` at
    n = 1536 and 4096 under the profiler: device time by kernel and the
    updates' time and launches."""
    import torch

    cfg = rt.LUConfig(panel_boundary_precision="bf16x3")
    for n in (1536, 4096):
        M = torch.randn(n, n, generator=gen).to(dev)
        v = torch.randn(n, generator=gen).to(dev)
        profile_run(dev, card, lambda: rt.lu(M, check=False, config=cfg),
                    lambda F: rt.lu_solve(F, v), expect=("panel_update_bf16x3_tiled",),
                    updates=True, n=n, dtype="float32", config="bf16x3")


def profile(rt, card, gen, dev, tp_mesh):
    """Device time by kernel over one factor + solve at 1536 and 4096 in
    float32 (the default route, ``schedule='physical'``,
    ``panel_variant='shadow'`` and ``panel_boundary_precision='bf16x3'``)
    and complex64, over two RBT solves at
    1536, over one batched factor + solve of 10 000 matrices at n = 16, 64
    and 128 (perm, ipiv and noswap pairs),
    and over ``tp_lu`` + ``tp_lu_solve`` on ``tp_mesh`` (one rank) beside
    ``lu`` + ``lu_solve`` at n = 4096, w = 128 and 512 (torch.profiler),
    and the device's idle share of the wall time."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk

    def run(factor, solve, expect=(), **what):
        profile_run(dev, card, factor, solve, expect, **what)

    for n, dt in ((1536, torch.float32), (4096, torch.float32),
                  (1536, torch.complex64), (4096, torch.complex64)):
        M = torch.randn(n, n, generator=gen).to(dev).to(dt)
        v = torch.randn(n, generator=gen).to(dev).to(dt)
        if dt.is_complex:
            M = M + 1j * torch.randn(n, n, generator=gen).to(dev)
        run(lambda: rt.lu(M, check=False), lambda F: rt.lu_solve(F, v), n=n,
            dtype=str(dt)[6:])
        if dt.is_complex:
            continue
        for name, cfg in (("physical", rt.LUConfig(schedule="physical")),
                          ("shadow", rt.LUConfig(panel_variant="shadow"))):
            run(lambda: rt.lu(M, check=False, config=cfg), lambda F: rt.lu_solve(F, v),
                n=n, dtype=str(dt)[6:], config=name)
    bf16x3_profile(rt, card, gen, dev)
    n = 1536
    M = (torch.randn(n, n, generator=gen) + n * torch.eye(n)).to(dev)
    v = torch.randn(n, generator=gen).to(dev)
    # "factor": workspace + solve; "solve": one more solve of the same workspace
    run(lambda: rt.butterfly_solve(rt.butterfly_workspace(M, v)),
        lambda x: rt.butterfly_solve(rt.butterfly_workspace(M, v)), n=n,
        dtype="float32", path="rbt (both halves: workspace + transform + factor + solve)")
    for n in (16, 64, 128):
        A = torch.randn(BATCH_B, n, n, generator=gen).to(dev)
        b = torch.randn(BATCH_B, n, generator=gen).to(dev)
        both = ("batched_lu_", "batched_solve_")
        run(lambda: rt.batched_lu_factor_perm(A),
            lambda F: rt.batched_lu_solve_perm(F[0], F[1], b),
            expect=both, path="batched_perm", batch=BATCH_B, n=n)
        run(lambda: rt.batched_lu_factor(A),
            lambda F: rt.batched_lu_solve(F[0], F[1], b),
            expect=both, path="batched_ipiv", batch=BATCH_B, n=n)
        # the noswap kernel (warp or block route in its noswap mode)
        run(lambda: bk.batched_lu_noswap(A),
            lambda F: rt.batched_lu_solve_perm(F[0], F[1], b),
            expect=("batched_lu_warp" if n <= 32 else "batched_lu_block_noswap",
                    "batched_solve_"), path="batched_noswap", batch=BATCH_B, n=n)
    n = 4096
    M = torch.randn(n, n, generator=gen).to(dev)
    v = torch.randn(n, generator=gen).to(dev)
    for w in (128, 512):
        run(lambda: rt.tp_lu(M, tp_mesh, "tp", w),
            lambda F: rt.tp_lu_solve(F, v, tp_mesh, "tp", w), path="tp, one rank",
            n=n, dtype="float32", panel_width=w)
        cfg = rt.LUConfig(panel_width=w)
        run(lambda: rt.lu(M, check=False, config=cfg), lambda F: rt.lu_solve(F, v),
            n=n, dtype="float32", panel_width=w)


def first_choice_gap(A, pa, pb):
    """Two pivot sequences of one real matrix or panel part at step k:
    eliminate k steps in float64 with the pivots they share (columns k and
    before: they alone decide column k) and return k and ||c[a]| - |c[b]||
    / max|c| for the two rows chosen there from column k."""
    import torch

    k = int((pa != pb).nonzero()[0])
    M = A[:, :k + 1].double().clone()
    for j in range(k):
        pj = int(pa[j])
        M[[j, pj]] = M[[pj, j]]
        M[j + 1:, j] /= M[j, j]
        M[j + 1:, j + 1:] -= torch.outer(M[j + 1:, j], M[j, j + 1:])
    c = M[:, k].abs()
    return k, float((c[int(pa[k])] - c[int(pb[k])]).abs() / c[k:].max())


# ---- panel_boundary_precision='bf16x3': phases 2g, 3g and 4g ---------------

# the kernel of the bf16x3 update (built into csrc/panel_lu.cu's library) and
# the TPU kernel's boundary matmul it replaces (`mmb` in _panel_kernel_fori)
BF16X3_UPDATE = ("recursivefactorization_jl_tpu_torch/csrc/panel_cluster.cuh",
                 "recursivefactorization_jl_tpu/ops/panel.py:472")
# H100 SXM data sheet: dense bf16 on the tensor cores
PEAK_BF16 = 989e12
BF16X3_SHAPES = ((1536, 512), (4096, 512), (8192, 512))
BF16X3_MICRO = 32  # LUConfig().resolved_panel_micro(): the knob's block width
# where the kernel's and the plain version's pivots part, the two candidates
# must tie to a bf16's precision relative to the column (both are bf16x3
# computations, which part by the split's rounding)
BF16X3_TIE = 2.0 ** -8


def bf16x3_reference(C, L, U):
    """``C - (hh + hl + lh)`` in float64 (the products of two bf16 values are
    exact there) and the sum of the three products' magnitudes."""
    import torch

    def split(X):
        h = X.to(torch.bfloat16)
        return h.double(), (X - h.float()).to(torch.bfloat16).double()

    lh, ll = split(L)
    uh, ul = split(U)
    ref = C.double() - (lh @ uh + lh @ ul + ll @ uh)
    mag = lh.abs() @ uh.abs() + lh.abs() @ ul.abs() + ll.abs() @ uh.abs()
    return ref, mag


def bf16x3_ratio(out, ref, mag, nb):
    """The worst |out - ref| over the deterministic bound 2^-24 ((nb + 2)
    sum |products| + |ref|) of the tensor-core sums and the two roundings
    after them."""
    import torch

    err = (out.double() - ref).abs()
    bnd = 2.0 ** -24 * ((nb + 2) * mag + ref.abs())
    r = torch.where(bnd > 0, err / bnd.clamp_min(1e-300), (err > 0).double() * float("inf"))
    return float(r.max())


def bf16x3_blocks(m, w, b):
    """The block boundaries of an (m, w) panel in blocks of b steps:
    (rows, cols, nb) of each update the launcher issues."""
    b = min(b, m, w)
    steps = min(m, w)
    out = []
    if b >= w:
        return out
    for k0 in range(0, steps, b):
        nb = min(b, steps - k0)
        rows, cols = m - k0 - nb, w - k0 - nb
        if rows > 0 and cols > 0:
            out.append((rows, cols, nb))
    return out


def bf16x3_update_bound(rows, cols, nb):
    """One update: L, U and C read once, C written once; three products of
    2 rows cols nb operations at the bf16 tensor-core peak."""
    t_ops = 3 * 2 * rows * cols * nb / PEAK_BF16
    t_bytes = 4 * (rows * nb + nb * cols + 2 * rows * cols) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def bf16x3_panel_bound(m, w, b):
    """A panel in the bf16x3 form: the panel's float32 operations less its
    delayed updates' products at the f32 peak, plus those updates' three
    bf16 products at the bf16 peak; or the panel's bytes."""
    flops, nbytes = panel_flops_bytes(m, w, 4)
    upd = sum(2 * r * c * nb for r, c, nb in bf16x3_blocks(m, w, b))
    t_ops = (flops - upd) / PEAK_FLOPS["float32"] + 3 * upd / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def bf16x3_kernel_phase(dev, gen):
    """Phase 2g: the bf16x3 update alone against the exact sum of its split
    products, against its plain version and, bit for bit, the tiled kernel
    against the simple kernel; then the bf16x3 form of the panel kernel
    against ``micro_blocked_lu(..., 'bf16x3')`` on the card, and on the
    tiled update bit for bit against the simple one, on panels too tall
    for a cluster too; every block's chain forced onto the grid against
    the cluster chain.  Returns the largest |kernel - plain| of each update
    kernel and |grid chain - cluster chain|."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        bf16x3_plan,
        bf16x3_update_plan,
        panel_factor_cuda,
        panel_update_bf16x3_cuda,
    )
    from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
    from recursivefactorization_jl_tpu_torch.ops.unblocked import micro_blocked_lu

    def i32(t):
        return t.contiguous().view(torch.int32)

    max_err = {"tiled": 0.0, "simple": 0.0}
    # (rows, cols, pad): C, L and U are views of one matrix whose row stride
    # is 64 + cols + pad; pad 0 keeps every operand on 16 bytes where nb is a
    # multiple of 4 (the panel's case), pad 3 puts every row off them
    # (nb past 64: the kernels go through K in chunks of 64)
    for nb in (1, 8, 16, 20, 32, 40, 64, 80, 256):
        o = max(64, nb)
        for rows, cols, pad in ((1000, 300, 0), (1000, 300, 3), (8192, 512, 0), (33, 4065, 0),
                                (4065, 33, 0)):
            big = torch.randn(rows + o, o + cols + pad, generator=gen).to(dev)

            def views(X):
                return X[o:, o:o + cols], X[o:, o - nb:o], X[o - nb:o, o:o + cols]

            C, L, U = views(big)
            ref, mag = bf16x3_reference(C, L, U)
            plain = C - schur_product(L, U, "bf16x3")
            outside = torch.ones_like(big, dtype=torch.bool)
            outside[o:, o:o + cols] = False
            runs = {}
            for upd in ("tiled", "simple"):
                X = big.clone()
                k0 = panel_update_bf16x3_cuda.counts.launches
                panel_update_bf16x3_cuda(*views(X), _update=upd)
                torch.cuda.synchronize()
                if panel_update_bf16x3_cuda.counts.launches != k0 + 1:
                    fail("the bf16x3 update's launch count")
                if not torch.equal(X[outside], big[outside]):
                    fail(f"the bf16x3 update wrote outside C ({upd})")
                runs[upd] = views(X)[0]
            tiled, simple = runs["tiled"], runs["simple"]
            rec = dict(kernel="panel_lu_bf16x3_update", nb=nb, shape=[rows, cols],
                       lda=big.stride(0), plan=bf16x3_update_plan(rows, cols, nb),
                       worst_ratio_to_bound=bf16x3_ratio(tiled, ref, mag, nb),
                       simple_worst_ratio_to_bound=bf16x3_ratio(simple, ref, mag, nb),
                       plain_worst_ratio_to_bound=bf16x3_ratio(plain, ref, mag, nb),
                       max_abs_err=float((tiled - plain).abs().max()),
                       bitwise_simple=bool(torch.equal(i32(tiled), i32(simple))))
            max_err["tiled"] = max(max_err["tiled"], rec["max_abs_err"])
            max_err["simple"] = max(max_err["simple"], float((simple - plain).abs().max()))
            emit("kernel", **rec)
            if not (rec["worst_ratio_to_bound"] <= 1 and rec["bitwise_simple"]):
                fail(f"the bf16x3 update: {rec}")
            del big, ref, mag, plain, runs, tiled, simple
    # an inf in L or U: NaN where the plain version has NaN
    L, U, C = (torch.randn(*s, generator=gen).to(dev) for s in ((512, 32), (32, 480), (512, 480)))
    L[3, 2], U[5, 7] = float("inf"), float("-inf")
    plain = C - schur_product(L, U, "bf16x3")
    S = C.clone()
    panel_update_bf16x3_cuda(C, L, U)
    panel_update_bf16x3_cuda(S, L, U, _update="simple")
    nan_same = bool(torch.equal(torch.isnan(C), torch.isnan(plain)))
    emit("kernel", kernel="panel_lu_bf16x3_update", input="inf in L and in U",
         nan_count=int(torch.isnan(C).sum()), nan_equal_plain=nan_same,
         bitwise_simple=bool(torch.equal(i32(C), i32(S))))
    if not (nan_same and torch.equal(i32(C), i32(S))):
        fail("the bf16x3 update's NaN entries are not the plain version's or the simple kernel's")

    def check_panel(A, name, pivot, b, updates=("tiled", "simple"), lda=None, col=0):
        """The bf16x3 panel on ``updates`` against micro_blocked_lu(...,
        'bf16x3') on the card (and each update kernel's panel bit for bit
        the first's); the grid chain's launches, as the launcher reports
        them, counted against the plan.  ``lda``: the kernel factors the
        panel as columns ``col`` ... of an m x lda matrix (a column block of
        lu's matrix), not as a contiguous copy."""
        m, w = A.shape
        plan = bf16x3_plan(m, w, b)
        outs = {}
        for upd in updates:
            if lda is None:
                Q = A.clone()
            else:
                Q = torch.empty(m, lda, device=dev)[:, col:col + w]
                Q.copy_(A)
            u0 = panel_factor_cuda.counts.bf16x3_update_launches
            g0 = panel_factor_cuda.counts.grid_block_launches
            got = panel_factor_cuda(Q, pivot, block=b, precision="bf16x3", _update=upd)
            torch.cuda.synchronize()
            outs[upd] = (Q, *got, panel_factor_cuda.counts.bf16x3_update_launches - u0,
                         panel_factor_cuda.counts.grid_block_launches - g0)
        first = outs[updates[0]]
        P, piv, perm, info, updates_n, grid_blocks = first
        f, rpiv, rperm, rinfo = micro_blocked_lu(A, pivot, b, "bf16x3")
        f32 = micro_blocked_lu(A, pivot, b)[0]
        rec = dict(kernel="panel_lu_bf16x3", shape=[m, w], input=name, pivot=pivot, block=b,
                   lda=P.stride(0), col=col, plan=plan, info=int(info),
                   info_equal=int(info) == int(rinfo), ipiv_equal=bool(torch.equal(piv, rpiv)),
                   updates=updates_n, expected_updates=len(bf16x3_blocks(m, w, b)),
                   grid_block_launches=grid_blocks,
                   bitwise_across_updates=all(
                       torch.equal(i32(x), i32(y)) for o in outs.values()
                       for x, y in zip(first[:4], o[:4])))
        if "simple" in outs:
            rec["simple_updates"] = outs["simple"][4]
        ok = (rec["info_equal"] and rec["bitwise_across_updates"]
              and all(o[4] == rec["expected_updates"] for o in outs.values())
              and all(o[5] == plan["grid_blocks"] for o in outs.values()))
        finite = bool(torch.isfinite(A).all())
        if not rec["ipiv_equal"]:
            rec["first_differing_step"], rec["tie_gap"] = first_choice_gap(A, piv, rpiv)
            ok = ok and finite and rec["tie_gap"] <= BF16X3_TIE
        else:
            spread = float((f - f32).nan_to_num(0).abs().max())
            diff = float((P - f).nan_to_num(0).abs().max())
            rec.update(perm_equal=bool(torch.equal(perm, rperm)),
                       nan_equal=bool(torch.equal(torch.isnan(P), torch.isnan(f))),
                       max_abs_err=diff, knob_effect=spread,
                       tolerance=2 * spread + 2.0 ** -20 * float(f.nan_to_num(0).abs().max()))
            ok = ok and rec["perm_equal"] and rec["nan_equal"] and diff <= rec["tolerance"]
        if finite:
            k = min(m, w)
            Lm = torch.tril(P[:, :k].double(), -1) + torch.eye(m, k, dtype=torch.float64,
                                                               device=dev)
            r = float((Lm @ torch.triu(P[:k].double()) - A.double()[perm.long()]).abs().max())
            g = 20 * m * torch.finfo(torch.float32).eps * float(A.abs().max())
            rec.update(resid=r, gate=g if pivot else 10 * g ** 0.5)
            ok = ok and r < rec["gate"]
        emit("kernel", **rec)
        if not ok:
            fail(f"the bf16x3 panel disagrees with its plain version: {rec}")
        return info

    for m, w in BF16X3_SHAPES:
        base = torch.randn(m, w, generator=gen)
        for name, pivot in (("randn", True), ("randn", False), ("zero_col", True),
                            ("ties", True), ("nan", True)):
            A = (torch.randint(-2, 3, (m, w), generator=gen).float() if name == "ties"
                 else base.clone()).to(dev)
            if name == "zero_col":
                A[:, 100] = 0
            if name == "nan":
                A[30, 9] = float("nan")
            if not pivot:
                A += m * torch.eye(m, w, device=dev)
            # the tiled update (the main path's), then the simple one
            info = check_panel(A, name, pivot, BF16X3_MICRO)
            if name == "zero_col" and int(info) != 101:
                fail(f"zeroed column 100 gave info {int(info)}")
    # panels too tall for a cluster at their block width (28 672 rows at b
    # 32, 100 000 at b 8): the blocks whose live rows do not fit one run
    # their chain on the grid, the block boundaries where they are
    for (m, w), b in (((28672, 64), BF16X3_MICRO), ((100000, 64), 8)):
        A = torch.randn(m, w, generator=gen).to(dev)
        if bf16x3_plan(m, w, b)["grid_blocks"] == 0:
            fail(f"the {m} x {w} panel at b {b} planned no block on the grid chain")
        check_panel(A, "randn, too tall for a cluster", True, b, updates=("tiled",))
        del A
    # lu's panels at n = 28 672 as lu hands them over: the first column
    # block of the n x n matrix (28 672 x 512, row stride n: 512-wide
    # blocks, delayed passes of up to 480 columns on up to 28 640 rows) and
    # rows 512.. of the second (28 160 x 512 at column 512)
    n, w = BF16X3_TALL_N, max(w for _, w in BF16X3_SHAPES)
    for m, col in ((n, 0), (n - w, w)):
        A = torch.randn(m, w, generator=gen).to(dev)
        if bf16x3_plan(m, w, BF16X3_MICRO)["grid_blocks"] == 0:
            fail(f"lu's {m} x {w} panel at b {BF16X3_MICRO} planned no block on the grid chain")
        check_panel(A, f"randn, column block {col // w} of lu at n {n}", True, BF16X3_MICRO,
                    updates=("tiled",), lda=n, col=col)
        del A
    # every block's chain forced onto the grid on panels that fit a cluster:
    # bit for bit the cluster chain's result (both rounded once per product
    # and difference, the same winner at every step)
    for m, w in ((1536, 512), (4096, 512)):
        A = torch.randn(m, w, generator=gen)
        A[:, 100] = 0
        A = A.to(dev)
        outs = {}
        for chain in ("auto", "grid"):
            Q = A.clone()
            g0 = panel_factor_cuda.counts.grid_block_launches
            got = panel_factor_cuda(Q, True, block=BF16X3_MICRO, precision="bf16x3", _chain=chain)
            torch.cuda.synchronize()
            outs[chain] = (Q, *got, panel_factor_cuda.counts.grid_block_launches - g0)
        plan = bf16x3_plan(m, w, BF16X3_MICRO, _chain="grid")
        same = all(torch.equal(i32(x), i32(y)) for x, y in zip(outs["auto"][:4], outs["grid"][:4]))
        err = float((outs["grid"][0] - outs["auto"][0]).abs().max())
        max_err["grid_chain"] = max(max_err.get("grid_chain", 0.0), err)
        rec = dict(kernel="panel_grid_chain", form="bf16x3", shape=[m, w], block=BF16X3_MICRO,
                   plan=plan, grid_block_launches=outs["grid"][4], cluster_run_grid_blocks=
                   outs["auto"][4], bitwise_cluster_chain=same, max_abs_err=err,
                   info=int(outs["grid"][3]))
        emit("kernel", **rec)
        if not (same and outs["grid"][4] == plan["blocks"] == plan["grid_blocks"]
                and outs["auto"][4] == 0 and int(outs["grid"][3]) == 101):
            fail(f"the grid chain is not the cluster chain's result: {rec}")
        del A, outs
    return max_err


def chunked_lu_resid(A, F, rows=2048):
    """``max |L U - A[p]|`` in float64 and the gate 20 n eps max|A| of a
    large square factorization, L taken from ``F.factors`` a block of rows
    at a time (U in float64 once): n = 28 672 needs 6.6 GB for U, not the
    26 GB of the whole product."""
    import torch

    n = A.shape[0]
    U = torch.triu(F.factors).double()
    p = F.p.long()
    r = 0.0
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        Lc = torch.tril(F.factors[i0:i1].double(), diagonal=i0 - 1)
        Lc[torch.arange(i1 - i0), torch.arange(i0, i1)] = 1.0
        r = max(r, float((Lc @ U - A[p[i0:i1]].double()).abs().max()))
        del Lc
    del U
    return r, 20 * n * torch.finfo(A.dtype).eps * float(A.abs().max())


def chunked_solve_resid(A, x, b, rows=4096):
    """``||A x - b|| / (||A|| ||x||)`` in float64, A a block of rows at a
    time."""
    import torch

    xd, bd = x.double(), b.double()
    rr, an = 0.0, 0.0
    for i0 in range(0, A.shape[0], rows):
        Ad = A[i0:i0 + rows].double()
        rr += float(((Ad @ xd - bd[i0:i0 + rows]) ** 2).sum())
        an += float((Ad ** 2).sum())
    return (rr / an) ** 0.5 / float(xd.norm())


# lu under the knob at this n: its first four 512-wide panels have more than
# 26 624 live rows, too many for a cluster at 32-step blocks, so their
# blocks' chains run on the grid
BF16X3_TALL_N = 28672


def bf16x3_main_phase(rt, dev, TF32Watch, resid_gate, solve_resid):
    """Phase 3g: ``lu`` + ``lu_solve`` under ``panel_boundary_precision=
    'bf16x3'`` at n = 1536 / 4096 / 8192, alone and with ``schur_precision=
    'bf16x3'``, and at n = 28 672 (panels too tall for a cluster: the grid
    chain).  Returns the launch counts per run."""
    import numpy as np
    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        bf16x3_plan,
        panel_factor_cuda,
        panel_update_bf16x3_cuda,
        reset_counts,
    )

    rng = np.random.default_rng(12)
    cfg = rt.LUConfig()
    w = cfg.resolved_panel_width()
    b = cfg.resolved_panel_micro()
    counts = {}
    runs = [(1536, "entry"), (1536, "randn"), (1536, "zero_col"), (4096, "randn"),
            (8192, "randn"), (BF16X3_TALL_N, "randn")]
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the port must turn it off
    for n, name in runs:
        big = n == BF16X3_TALL_N
        if big:  # made on the card (3.3 GB): the residuals a block of rows at a time
            g = torch.Generator(device=dev).manual_seed(12)
            A = torch.randn(n, n, generator=g, device=dev)
            v = torch.randn(n, generator=g, device=dev)
            lu_resid, sol_resid = chunked_lu_resid, chunked_solve_resid
        else:
            M = rng.standard_normal((n, n), dtype=np.float32)
            if name == "entry":
                M += np.float32(n) * np.eye(n, dtype=np.float32)
            if name == "zero_col":
                M[:, 700] = 0
            A = torch.from_numpy(M).to(dev)
            v = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
            del M
            lu_resid, sol_resid = resid_gate, solve_resid
        route = rt.dispatch_route((n, n), torch.float32, True, cfg)
        panels = [(n - s, min(w, n - s)) for s in range(0, n, w)] if route == "blocked" \
            else [(n, n)]
        expect_updates = sum(len(bf16x3_blocks(pm, pw, b)) for pm, pw in panels)
        # the blocks whose live rows do not fit a cluster (the plan's count)
        expect_grid = sum(bf16x3_plan(pm, pw, b)["grid_blocks"] for pm, pw in panels)
        # the float32 form on the same matrix, for its scaled residual
        F32 = rt.lu(A, check=False)
        r32 = lu_resid(A, F32)[0] / (n * torch.finfo(torch.float32).eps * float(A.abs().max()))
        del F32
        for schur in ("float32", "bf16x3") if name != "zero_col" and not big else ("float32",):
            knob = rt.LUConfig(panel_boundary_precision="bf16x3", schur_precision=schur)
            watch = TF32Watch()
            reset_counts()
            t0 = time.perf_counter()
            with watch:
                F = rt.lu(A, check=False, config=knob)
                x = rt.lu_solve(F, v)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(panel_launches=panel_factor_cuda.counts.launches,
                       bf16x3_panel_launches=panel_factor_cuda.counts.bf16x3_launches,
                       bf16x3_update_launches=panel_factor_cuda.counts.bf16x3_update_launches,
                       bf16x3_simple_update_launches=(
                           panel_factor_cuda.counts.bf16x3_simple_update_launches),
                       grid_route_launches=panel_factor_cuda.counts.grid_route_launches,
                       grid_block_launches=panel_factor_cuda.counts.grid_block_launches)
            counts[(n, name, schur)] = got
            r, g = lu_resid(A, F)
            rec = dict(what="bf16x3", n=n, input=name, schur_precision=schur, route=route,
                       **got, expected_panels=len(panels), expected_updates=expect_updates,
                       expected_grid_blocks=expect_grid, resid=r, gate=g,
                       scaled_resid=r / (n * torch.finfo(torch.float32).eps * float(A.abs().max())),
                       float32_scaled_resid=r32,
                       solve_rel_resid=sol_resid(A, x, v), info=int(F.info),
                       matmuls=len(watch.flags), tf32_seen=any(watch.flags),
                       factor_solve_wall_s=wall)
            emit("main", **rec)
            want_info = 701 if name == "zero_col" else 0
            if not (got["panel_launches"] == got["bf16x3_panel_launches"] == len(panels)
                    and got["bf16x3_update_launches"] == expect_updates
                    and got["bf16x3_simple_update_launches"] == 0
                    and got["grid_block_launches"] == expect_grid
                    and (expect_grid > 0) == big
                    and got["grid_route_launches"] == 0 and r < g and rec["info"] == want_info
                    and watch.flags and not any(watch.flags)
                    and (name == "zero_col" or np.isfinite(rec["solve_rel_resid"]))):
                fail(f"lu under panel_boundary_precision='bf16x3': {rec}")
        del A, v, F, x
    if torch.backends.cuda.matmul.allow_tf32 is not True:
        fail("the caller's TF32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    return counts


def bf16x3_timing_phase(rt, dev, gen, card, round_robin, timed):
    """Phase 4g, in turns within this call: the update alone at the first
    boundary of each main-path panel (the tiled kernel, the simple kernel,
    the plain version and one float32 library product), by CUDA events over
    queued calls and by torch.profiler's device time, on the same operands
    (L2-warm, as in the panel) and on operands rotated over copies that
    hold twice the L2 (cold, what the byte bound assumes); the panel kernel
    per main-path panel in its bf16x3 form (on the tiled and on the simple
    update) beside its float32 form at the same block width, at the default
    plan and the library; ``lu`` factor and factor+solve at 1536 / 4096 /
    8192 under float32, bf16x3 and bf16x3 + bf16x3 Schur beside the
    library.  Returns the update's rows."""
    import itertools

    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        bf16x3_plan,
        bf16x3_update_plan,
        micro_plan,
        panel_factor_cuda,
        panel_factor_shadow_cuda,
        panel_plan,
        panel_update_bf16x3_cuda,
    )
    from recursivefactorization_jl_tpu_torch.ops.schur import schur_product
    from recursivefactorization_jl_tpu_torch.ops.unblocked import micro_blocked_lu
    from recursivefactorization_jl_tpu_torch.utils.config import full_matmul_precision

    b = BF16X3_MICRO
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
    update_rows = {}
    forms = {
        "kernel": lambda C, L, U: panel_update_bf16x3_cuda(C, L, U),
        "simple": lambda C, L, U: panel_update_bf16x3_cuda(C, L, U, _update="simple"),
        "plain": lambda C, L, U: C.sub_(schur_product(L, U, "bf16x3")),
        "library": lambda C, L, U: C.addmm_(L, U, alpha=-1),
    }
    for m, w in BF16X3_SHAPES:
        rows, cols, nb = bf16x3_blocks(m, w, b)[0]
        big = torch.randn(rows + nb, w, generator=gen).to(dev)
        C0 = big[nb:, nb:].clone()
        C, L, U = big[nb:, nb:], big[nb:, :nb], big[:nb, nb:]
        # copies of the operands that hold twice the L2: a call on one finds
        # none of it in the L2, which the others' calls since its last have
        # filled twice over
        copies = max(4, -(-2 * l2 // (big.numel() * 4)))
        bigs = [big.clone() for _ in range(copies)]
        sets = [(X[nb:, nb:], X[nb:, :nb], X[:nb, nb:]) for X in bigs]
        turn = itertools.cycle(range(copies))
        with full_matmul_precision():
            t = round_robin({k: lambda f=f: f(C, L, U) for k, f in forms.items()}, rounds=9,
                            inner=20, setup=lambda: C.copy_(C0))
            warm = {k: device_ms(lambda f=f: f(C, L, U), calls=20) for k, f in forms.items()}
            cold = {k: device_ms(lambda f=f: f(*sets[next(turn)]), calls=max(20, copies))
                    for k, f in forms.items()}
        b_ms, b_by = bf16x3_update_bound(rows, cols, nb)
        row = dict(shape=[rows, cols], nb=nb, lda=big.stride(0),
                   plan=bf16x3_update_plan(rows, cols, nb), kernel_ms=t["kernel"],
                   simple_ms=t["simple"], plain_ms=t["plain"], library_ms=t["library"],
                   device_ms_warm=warm, device_ms_cold=cold, cold_copies=copies,
                   l2_bytes=l2, bound_ms=b_ms, bound_by=b_by,
                   kernel_over_bound=cold["kernel"] / b_ms,
                   simple_over_bound=cold["simple"] / b_ms,
                   warm_kernel_over_bound=warm["kernel"] / b_ms,
                   library_call="C.addmm_(L, U, alpha=-1), float32, TF32 off")
        update_rows[(m, w)] = row
        emit("timing", what="bf16x3_update", card=card, **row)
        del big, C0, C, L, U, bigs, sets
    plain_panel_ms = {}
    for m, w in BF16X3_SHAPES:
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        plan = bf16x3_plan(m, w, b)
        panels = {
            "bf16x3": lambda: panel_factor_cuda(P, True, block=b, precision="bf16x3"),
            "bf16x3_simple": lambda: panel_factor_cuda(P, True, block=b, precision="bf16x3",
                                                       _update="simple"),
        }
        with quiet_c_stdout():
            t = round_robin({
                **panels,
                "float32_same_b": lambda: panel_factor_cuda(P, True, block=b,
                                                            cluster=plan["cluster"]),
                "float32_default": lambda: panel_factor_cuda(P, True),
                "library": lambda: torch.linalg.lu_factor_ex(P),
            }, rounds=10, setup=lambda: P.copy_(X), mirror=True)
        span = {k: device_span_ms(f, lambda: P.copy_(X)) for k, f in panels.items()}
        p_ms, _ = timed(lambda: micro_blocked_lu(X, True, b, "bf16x3"), None, reps=1, warm=0)
        plain_panel_ms[(m, w)] = p_ms
        b_ms, b_by = bf16x3_panel_bound(m, w, b)
        emit("timing", what="bf16x3_panel", card=card, shape=[m, w], block=b, plan=plan,
             default_plan=panel_plan(m, w, torch.float32), ms=t, plain_ms=p_ms,
             device_ms=span, bound_ms=b_ms, bound_by=b_by,
             updates=len(bf16x3_blocks(m, w, b)),
             bf16x3_over_float32_same_b=t["bf16x3"] / t["float32_same_b"],
             tiled_over_simple=t["bf16x3"] / t["bf16x3_simple"],
             bf16x3_over_float32_default=t["bf16x3"] / t["float32_default"])
        del X, P
    # the grid block chain: per step beside the cluster chain on the same
    # blocks (every block's chain forced onto the grid) and beside the float32
    # form's grid route (panel_lu_kernel, block=-1), device time by kernel;
    # on the first panel of lu at n = 28 672 (too tall for a cluster at b 32)
    # beside the float32 form's own plan
    names = ("panel_grid_chain_kernel", "panel_chain_kernel", "panel_lu_kernel")
    grid_rows = {}
    for m, w in BF16X3_SHAPES[:2] + ((BF16X3_TALL_N, 512),):
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        runs = {
            "bf16x3": lambda: panel_factor_cuda(P, True, block=b, precision="bf16x3"),
            "bf16x3_grid_chain": lambda: panel_factor_cuda(P, True, block=b, precision="bf16x3",
                                                           _chain="grid"),
            "float32_grid_route": lambda: panel_factor_cuda(P, True, block=-1),
            "float32_default": lambda: panel_factor_cuda(P, True),
        }
        if m == BF16X3_TALL_N:  # the cluster chain cannot take these blocks at b 32
            del runs["bf16x3_grid_chain"]
        with quiet_c_stdout():
            t = round_robin({**runs, "library": lambda: torch.linalg.lu_factor_ex(P)},
                            rounds=5 if m == BF16X3_TALL_N else 7, setup=lambda: P.copy_(X),
                            mirror=True)
        dev_t = {k: kernel_device_ms(f, names, setup=lambda: P.copy_(X)) for k, f in runs.items()}
        # per step from the mean launch (the profiler may drop a launch's
        # record): a chain launch covers its block's steps, panel_lu_kernel
        # the panel's
        blocks = {"bf16x3": bf16x3_plan(m, w, b)["blocks"],
                  "bf16x3_grid_chain": bf16x3_plan(m, w, b)["blocks"],
                  "float32_grid_route": 1,
                  "float32_default": panel_plan(m, w, torch.float32)["blocks"]}
        steps = min(m, w)
        per_step = {k: {n_: 1e3 * v[0] / v[1] * blocks[k] / steps for n_, v in d.items() if v[1]}
                    for k, d in dev_t.items()}
        b_ms, b_by = bf16x3_panel_bound(m, w, b)
        grid_rows[(m, w)] = dict(
            shape=[m, w], block=b, plan=bf16x3_plan(m, w, b), ms=t, bound_ms=b_ms, bound_by=b_by,
            plain_ms=plain_panel_ms.get((m, w)),
            chain_device_ms={k: {n_: v for n_, v in d.items() if v[1]} for k, d in dev_t.items()},
            chain_us_per_step=per_step)
        emit("timing", what="grid_chain", card=card, **grid_rows[(m, w)])
        del X, P
    # the delayed kernels at nb = 64 / 128 / 256 on a 4096 x 512 panel:
    # swap / solve and the sum-first update (the micro route), the bf16x3
    # update (the bf16x3 form), device time per launch
    X = torch.randn(4096, 512, generator=gen).to(dev)
    P = torch.empty_like(X)
    delayed = ("panel_swap_solve_kernel", "panel_update_kernel", "panel_update_bf16x3_tiled")
    for nb in (64, 128, 256):
        rec = {}
        forms = {"micro": lambda: panel_factor_shadow_cuda(P, True, nb),
                 "bf16x3": lambda: panel_factor_cuda(P, True, block=nb, precision="bf16x3")}
        for form, fn in forms.items():
            d = kernel_device_ms(fn, delayed, setup=lambda: P.copy_(X))
            rec[form] = {k: {"ms_per_launch": v[0] / v[1], "launches": v[1]}
                         for k, v in d.items() if v[1]}
        # the panels whole, on their plans and with every chain on the grid
        t = round_robin({**forms,
                         "micro_grid_chain": lambda: panel_factor_shadow_cuda(P, True, nb,
                                                                              _chain="grid"),
                         "bf16x3_grid_chain": lambda: panel_factor_cuda(
                             P, True, block=nb, precision="bf16x3", _chain="grid")},
                        rounds=5, setup=lambda: P.copy_(X), mirror=True)
        emit("timing", what="delayed_kernels", card=card, shape=[4096, 512], nb=nb,
             micro_plan=micro_plan(4096, 512, torch.float32, nb),
             bf16x3_plan=bf16x3_plan(4096, 512, nb), panel_ms=t, **rec)
    del X, P
    cfgs = {"float32": rt.LUConfig(),
            "bf16x3": rt.LUConfig(panel_boundary_precision="bf16x3"),
            "bf16x3_schur": rt.LUConfig(panel_boundary_precision="bf16x3",
                                        schur_precision="bf16x3")}
    # lu at n = 28 672 (its first four panels on the grid chain) in turns
    # beside the float32 form and the library
    n = BF16X3_TALL_N
    g = torch.Generator(device=dev).manual_seed(13)
    M = torch.randn(n, n, generator=g, device=dev)
    with quiet_c_stdout():
        t = round_robin({"float32_factor": lambda: rt.lu(M, check=False, config=cfgs["float32"]),
                         "bf16x3_factor": lambda: rt.lu(M, check=False, config=cfgs["bf16x3"]),
                         "library_factor": lambda: torch.linalg.lu_factor_ex(M)},
                        rounds=3, mirror=True)
    emit("timing", what="bf16x3_end_to_end", card=card, n=n, dtype="float32", ms=t,
         bf16x3_over_float32=t["bf16x3_factor"] / t["float32_factor"],
         bf16x3_over_library=t["bf16x3_factor"] / t["library_factor"])
    tall_row = dict(n=n, ms=t)
    del M
    for n in (1536, 4096, 8192):
        M = torch.randn(n, n, generator=gen).to(dev)
        v = torch.randn(n, generator=gen).to(dev)
        fns = {}
        for k, c in cfgs.items():
            fns[f"{k}_factor"] = lambda c=c: rt.lu(M, check=False, config=c)
            fns[f"{k}_factor_solve"] = lambda c=c: rt.lu_solve(rt.lu(M, check=False, config=c), v)

        def lib_fs():
            LU_, piv, _ = torch.linalg.lu_factor_ex(M)
            torch.linalg.lu_solve(LU_, piv, v[:, None])

        fns["library_factor"] = lambda: torch.linalg.lu_factor_ex(M)
        fns["library_factor_solve"] = lib_fs
        t = round_robin(fns, rounds=7 if n < 8192 else 5)
        emit("timing", what="bf16x3_end_to_end", card=card, n=n, dtype="float32", ms=t,
             bf16x3_over_float32=t["bf16x3_factor"] / t["float32_factor"],
             bf16x3_schur_over_float32=t["bf16x3_schur_factor"] / t["float32_factor"])
        del M, v
    return update_rows, grid_rows, tall_row


# the live heights of the float64 panels of a blocked lu at n = 4096 (512
# columns each): what the benchmark's float64 cell factors
F64_LU_HEIGHTS = tuple(range(512, 4097, 512))


def plan_sweep(dev, card, gen, round_robin, shapes, turns=3):
    """The cluster route's block width b and cluster size C per live height,
    width and element type (csrc/panel_cluster.cuh ``plan_for``, the
    entries of its auto rule ``Auto<T, K>``): every b x C that fits the card
    (b = w: one slab for the whole panel) and ``auto``, the launcher's own
    choice, timed in turns, in ``turns`` runs of ``round_robin`` of 5
    rounds each.  Per plan: the median of its turns' medians and their
    spread ((largest - smallest) / median); ``beats_auto`` when the best
    plan's gain over ``auto`` passes both plans' spreads.  One
    ``sweep_plan`` line per shape."""
    import statistics

    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        panel_factor_c64_cuda,
        panel_factor_cuda,
        panel_plan,
    )

    rows = []
    for m, w, dt in shapes:
        cplx = dt.is_complex
        real = torch.float32 if dt == torch.complex64 else torch.float64
        X = (torch.complex(torch.randn(m, w, generator=gen, dtype=real),
                           torch.randn(m, w, generator=gen, dtype=real)) if cplx
             else torch.randn(m, w, generator=gen, dtype=dt)).to(dev)
        P = torch.empty_like(X)
        wrapper = panel_factor_c64_cuda if cplx else panel_factor_cuda
        fns = {"auto": lambda: wrapper(P, True)}
        for b in (8, 16, 32, 64, w):
            for C in (1, 2, 4, 8, 16):
                try:
                    panel_plan(m, w, dt, block=b, cluster=C)
                except RuntimeError:
                    continue  # does not fit the card
                fns[f"b{b}_C{C}"] = (lambda b=b, C=C: wrapper(P, True, block=b, cluster=C))
        per = [round_robin(fns, rounds=5, setup=lambda: P.copy_(X)) for _ in range(turns)]
        ms = {k: statistics.median(t[k] for t in per) for k in fns}
        spread = {k: (max(t[k] for t in per) - min(t[k] for t in per)) / ms[k] for k in fns}
        best = min((k for k in ms if k != "auto"), key=ms.get)
        gain = 1 - ms[best] / ms["auto"]
        row = dict(shape=[m, w], dtype=str(dt)[6:], auto=panel_plan(m, w, dt), best=best,
                   best_ms=ms[best], auto_ms=ms["auto"], gain=gain,
                   spread_best=spread[best], spread_auto=spread["auto"],
                   beats_auto=gain > max(spread[best], spread["auto"]), ms=ms, spread=spread)
        emit("timing", what="sweep_plan", card=card, **row)
        rows.append(row)
        del X, P
    return rows


# phase 3h: the keys whose programs are captured, (name, shape, dtype name,
# LUConfig fields, inputs); "entry" is randn + n*I (__graft_entry__.py's
# matrix), "zero_col" randn with column 700 zeroed (info 701).  Tall keys
# capture the factor only (warmup solves square shapes).  The grid route's
# shape is found on the card: the smallest (m, 512) whose panel plan_for
# sends to the cooperative grid kernel
GRAPH_KEYS = (
    ("f32", (1536, 1536), "float32", {}, ("entry", "randn", "zero_col")),
    ("f32", (4096, 4096), "float32", {}, ("randn",)),
    ("f64", (1536, 1536), "float64", {}, ("randn",)),
    ("f64", (4096, 4096), "float64", {}, ("randn",)),
    ("c64", (1536, 1536), "complex64", {}, ("randn",)),
    ("physical", (1536, 1536), "float32", {"schedule": "physical"}, ("randn",)),
    ("bf16x3", (1536, 1536), "float32", {"panel_boundary_precision": "bf16x3"}, ("randn",)),
    # the bf16x3 form's blocks too tall for a cluster: the cooperative grid
    # block chain (panel_grid_chain_kernel)
    ("grid_chain", (28672, 64), "float32", {"panel_boundary_precision": "bf16x3"},
     ("randn",)),
)
GRAPH_BATCHES = ((BATCH_B, 16), (BATCH_B, 64))
# the keys captured by graphs.capturing() around the rest of the entry
# points: (kind, n, dtype name, inputs or panel width, refine / rhs columns)
GRAPH_MORE = (
    ("lu_inplace", 1536, "float32", ("entry", "zero_col")),
    ("lu_inplace", 4096, "float32", ("randn",)),
    ("rbt", 801, "float64", ((0, None), (2, 4), (0, 4), (2, None))),
    ("rbt", 1536, "float32", ((0, None), (2, 4), (0, 4), (2, None))),
    ("tp", 4096, "float32", 128),
    ("tp", 4096, "float32", 512),
    ("tp", 4096, "complex64", 128),
    ("sharded", 64, "float32", BATCH_B),
)
# the capture stream's cuBLAS workspaces stay after the programs are freed
GRAPH_WORKSPACE_SLACK = 64 << 20


# the mixed phase: LAPACK's DSGESV through mixed_lu / mixed_lu_solve
MIXED_NS, MIXED_SEED = (4096, 8192), 27


def mixed_phase(rt, dev, card, round_robin):
    """``mixed_lu`` + ``mixed_lu_solve`` on HPL's float64 matrix at n = 4096
    and 8192: ITER, the float32 factorization's route, the two kernels of
    ``csrc/mixed_refine.cu`` bit for bit their tensor twins (on the call's
    own A and x), LAPACK's stopping test and HPL's float64 residual, the
    kernels' device ms beside their bounds (bytes at 3.35 TB/s), and the
    call's ms by replay in turns beside ``lu`` + ``lu_solve`` in float64
    (replayed) and ``torch.linalg.solve`` in float64 (TF32 off).  Returns
    the ``kernels`` line's rows of the two kernels, measured at 4096."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops import _counts
    from recursivefactorization_jl_tpu_torch.ops import mixed_refine as mr
    from recursivefactorization_jl_tpu_torch.utils import graphs, warmup

    def bits(t):
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)

    def max_err(got, want):
        return max(float((p.double() - q.double()).abs().max()) if p.numel() else 0.0
                   for p, q in zip(got, want))

    kernel_rows = []
    for n in MIXED_NS:
        g = torch.Generator(device=dev).manual_seed(MIXED_SEED + n)
        A = torch.rand(n, n, generator=g, device=dev, dtype=torch.float64) - 0.5
        b = torch.rand(n, generator=g, device=dev, dtype=torch.float64) - 0.5
        A0 = A.clone()
        _counts.reset_counts()
        F = rt.mixed_lu(A)
        x, it = rt.mixed_lu_solve(F, b, return_iter=True)
        torch.cuda.synchronize()
        launches = dict(rt.mixed_lu_solve.counts.kernel_launches)
        # the kernels against their twins on this call's A and x
        narrow, narrow_twin = mr.narrow_cuda(A), mr.narrow_tensor(A)
        X, B = x[:, None].contiguous(), b[:, None].contiguous()
        s1 = torch.zeros(2, dtype=torch.int32, device=dev)
        s2 = s1.clone()
        res = mr.residual_cuda(A, X, B, F.anrm, s1, True, 30)
        res_twin = mr.residual_tensor(A, X, B, F.anrm, s2, True, 30)
        torch.cuda.synchronize()
        narrow_equal = all(torch.equal(bits(p), bits(q)) for p, q in zip(narrow, narrow_twin))
        residual_equal = (all(torch.equal(bits(p), bits(q)) for p, q in zip(res, res_twin))
                          and s1.tolist() == s2.tolist())
        cte = float(A.abs().sum(1).max()) * 2.0 ** -53 * n ** 0.5
        r = b - A @ x
        lapack_ratio = float(r.abs().max()) / (float(x.abs().max()) * cte)
        hpl = float(r.abs().max()) / (2.0 ** -53 * (float(A.abs().sum(1).max()) * float(
            x.abs().max()) + float(b.abs().max())) * n)

        def status():
            return torch.zeros(2, dtype=torch.int32, device=dev)

        def narrow_library():
            # the same three outputs by torch's ops
            return A.float(), A.abs().sum(1).amax(), ((A < -mr.RMAX) | (A > mr.RMAX)).any()

        def residual_library():
            # r by cuBLAS's DGEMV, then single(r), max|r| and max|x|
            r = torch.addmm(B, A, X, alpha=-1.0)
            return r, r.float(), r.abs().amax(0), X.abs().amax(0)

        fns = {
            "narrow": lambda: mr.narrow_cuda(A),
            "narrow_plain": lambda: mr.narrow_tensor(A),
            "narrow_library": narrow_library,
            "residual": lambda: mr.residual_cuda(A, X, B, F.anrm, status(), True, 30),
            "residual_plain": lambda: mr.residual_tensor(A, X, B, F.anrm, status(), True, 30),
            "residual_library": residual_library}
        # device time (torch.profiler): the kernel's own, and every kernel
        # the twin and the library ops launch; beside it the CUDA-event time
        # of a call in turns, the host's launches included
        names = {"narrow": mr.NARROW_KERNEL, "residual": mr.RESIDUAL_KERNEL}
        ms = {}
        for k, fn in fns.items():
            ms[k] = (kernel_device_ms(fn, [names[k]])[names[k]][0] if k in names
                     else device_ms(fn))
        call_ms = round_robin(fns, rounds=7, mirror=True)
        bw = 3.35e12
        bounds = {"narrow": 12.0 * n * n / bw * 1e3,
                  "residual": (8.0 * n * n + 28 * n) / bw * 1e3}
        if n == MIXED_NS[0]:
            for kind, name, err in (("narrow", mr.NARROW_KERNEL, max_err(narrow, narrow_twin)),
                                    ("residual", mr.RESIDUAL_KERNEL, max_err(res, res_twin))):
                kernel_rows.append({
                    "name": name,
                    "route": "cuda",
                    "source": "recursivefactorization_jl_tpu_torch/csrc/mixed_refine.cu",
                    # the JAX package has no mixed-precision solver
                    "replaces": None,
                    # the first mixed_lu + mixed_lu_solve of this phase's matrix
                    "launches": launches.get(name, 0),
                    # against its tensor twin on the card, on that call's A and x
                    "max_abs_err": err,
                    "ms": ms[kind],
                    "call_ms": call_ms[kind],
                    "plain_ms": ms[f"{kind}_plain"],
                    "plain_call_ms": call_ms[f"{kind}_plain"],
                    "bound_ms": bounds[kind],
                    "bound_by": "bytes",
                    "library_ms": ms[f"{kind}_library"],
                    "library_call_ms": call_ms[f"{kind}_library"],
                    "shape": [n, n],
                    "dtype": "float64",
                })
        # warmed: the mixed_lu program, lu / lu_solve in float64
        with graphs.capturing():
            rt.mixed_lu_solve(rt.mixed_lu(A), b)
        warmup.warmup(shapes=[(n, n)], dtypes=[torch.float64])

        def mixed():
            rt.mixed_lu_solve(rt.mixed_lu(A), b)

        def lu64():
            rt.lu_solve(rt.lu(A, check=False), b)

        def library():
            torch.linalg.solve(A, b)

        solve_ms = round_robin({"mixed": mixed, "lu_f64": lu64, "torch_linalg_solve_f64": library},
                               rounds=7, mirror=True)
        _counts.reset_counts()
        mixed()
        torch.cuda.synchronize()
        replay_counts = rt.mixed_lu_solve.counts
        warmup.clear_caches()
        flops = 2.0 / 3.0 * n ** 3 + 1.5 * n ** 2
        row = dict(what="mixed_dsgesv", card=card, n=n, iter=it, route=rt.dispatch_route(
            (n, n), torch.float32), info=int(F.info), fallback=F.fallback is not None,
            launches=launches, replay_host_checks=replay_counts.host_checks,
            replay_iters=dict(replay_counts.iters), narrow_equal=narrow_equal,
            residual_equal=residual_equal, a_unchanged=bool(torch.equal(A, A0)),
            lapack_ratio=lapack_ratio, hpl_resid=hpl,
            narrow_ms=ms["narrow"], narrow_bound_ms=bounds["narrow"],
            residual_ms=ms["residual"], residual_bound_ms=bounds["residual"],
            ms=solve_ms, gflops={k: flops / v / 1e6 for k, v in solve_ms.items()})
        emit("mixed", **row)
        if not (narrow_equal and residual_equal and row["a_unchanged"] and it >= 0
                and lapack_ratio <= 1 and hpl <= 16):
            fail(f"mixed-precision solve at n = {n}: {row}")
    return kernel_rows


def graph_phase(rt, dev, card, round_robin, tp_mesh, dp_mesh):
    """Phase 3h: the compiled entry points.  For every key of GRAPH_KEYS,
    the batched pairs at GRAPH_BATCHES, the entry step captured whole and
    the smallest shape on the panel kernel's cooperative grid route: the
    eager call once under ``torch.cuda.set_sync_debug_mode("error")``,
    ``utils.warmup.warmup`` (or ``graphs.capturing()``), the memory the
    programs hold, every output of the replay bit for bit the eager
    call's (NaN for NaN) on each input and on a second input, the
    residual gate, CUDA-event ms per call in turns (eager, replay,
    library) and the idle share of each under torch.profiler; the same
    for the keys of GRAPH_MORE, captured by ``graphs.capturing()`` (the
    tp and sharded ones over ``tp_mesh`` / ``dp_mesh``, NCCL worlds of
    one rank); at the end ``clear_caches`` and the memory it gives
    back."""
    import torch

    from recursivefactorization_jl_tpu_torch.models import lu as lu_mod
    from recursivefactorization_jl_tpu_torch.models import solve as solve_mod
    from recursivefactorization_jl_tpu_torch.ops.panel import (
        bf16x3_plan,
        panel_factor_cuda,
        panel_plan,
        reset_counts,
    )
    from recursivefactorization_jl_tpu_torch.parallel import batched as batched_mod
    from recursivefactorization_jl_tpu_torch.utils import graphs, warmup

    warmup.clear_caches()
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}

    def bits_equal(xs, ys):
        for x, y in zip(xs, ys):
            if x.dtype != y.dtype or x.shape != y.shape:
                return False
            if not (x.is_floating_point() or x.is_complex()):
                if not torch.equal(x, y):
                    return False
                continue
            if x.is_complex():
                x, y = torch.view_as_real(x), torch.view_as_real(y)
            ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]
            nx, ny = torch.isnan(x), torch.isnan(y)
            if not (torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0).view(ints),
                                                        y.masked_fill(ny, 0).view(ints))):
                return False
        return True

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def no_sync(fn):
        """``fn()`` with every synchronising torch call an error."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return res

    def replays():
        return sum(p.replays for p in graphs.programs().values())

    def idle(fns, calls=3):
        """Idle share of the wall, device busy ms and device records per
        call of each callable, under torch.profiler (CUDA activity)."""
        res = {}
        for k, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            wall = []

            def run():
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)

            rows = profiled_rows(run, device_rows, f"graph idle {k}")
            if rows is None:  # no window recorded a kernel: not measured
                emit("note", what="graph_idle_unmeasured", of=k, windows=PROFILER_WINDOWS)
                res[k] = dict(idle_share=None, busy_ms=None, device_records=None)
                continue
            busy = sum(r[0] for r in rows)
            res[k] = dict(idle_share=1 - busy / wall[-1], busy_ms=busy / calls,
                          device_records=sum(r[1] for r in rows) / calls)
        return res

    def host_ms(fns, reps=5):
        """Median host time (ms) to enqueue one call of each callable: what
        the host spends before the call returns, the device not waited
        for."""
        res = {}
        for k, fn in fns.items():
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            res[k] = sorted(ts)[len(ts) // 2]
        return res

    def matrix(shape, dtype, kind):
        A = torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
        if kind == "entry":
            A += shape[0] * torch.eye(*shape, device=dev, dtype=dtype)
        if kind == "zero_col":
            A[:, 700] = 0
        return A

    def scaled_resid(A, F):
        wide = torch.complex128 if A.is_complex() else torch.float64
        r = float((F.L.to(wide) @ F.U.to(wide) - A.to(wide)[F.p.long()]).abs().max())
        eps = torch.finfo(A.real.dtype if A.is_complex() else A.dtype).eps
        return r / (A.shape[0] * eps * float(A.abs().max()))

    def smallest_grid_rows(w=512):
        """The fewest rows (a multiple of 512) of an (m, w) float32 panel
        that plan_for sends to the grid route, or None up to 2**20."""
        def grid(k):
            return panel_plan(512 * k, w, torch.float32)["route"] == "grid"
        hi = 1
        while not grid(hi):
            hi *= 2
            if hi > 2048:
                return None
        lo = hi // 2
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if grid(mid) else (mid, hi)
        return 512 * hi

    r_start = reserved()
    held_total = 0
    m_grid = smallest_grid_rows()
    keys = list(GRAPH_KEYS)
    if m_grid is not None:
        keys.append(("grid_route", (m_grid, 512), "float32", {}, ("randn",)))
    for name, shape, dname, fields, inputs in keys:
        dtype = getattr(torch, dname)
        cfg = rt.LUConfig(**fields)
        square = shape[0] == shape[1]
        mats = [matrix(shape, dtype, k) for k in inputs] + [matrix(shape, dtype, "randn")]
        b = torch.randn(shape[1], generator=gen, device=dev, dtype=dtype)

        def call(A):
            F = rt.lu(A, check=False, config=cfg)
            return (F, rt.lu_solve(F, b)) if square else (F, None)

        def outputs(F, x):
            return (F.factors, F.ipiv, F.p, F.info) + ((x,) if x is not None else ())

        rec = dict(key=name, shape=list(shape), dtype=dname, config=fields,
                   inputs=list(inputs), card=card)
        reset_counts()
        eager = [no_sync(lambda A=A: call(A)) for A in mats]
        rec["eager_no_sync"] = True
        before = set(graphs.programs())
        r0 = reserved()
        try:
            warmup.warmup((shape,), (dtype,), config=cfg)
        except RuntimeError as e:
            rec.update(captured=False, error=str(e)[:400])
            emit("graph", **rec)
            if name not in ("grid_route", "grid_chain") or "lu_factor" not in str(e):
                fail(f"warmup could not capture {name}: {e}")
            out[(name, shape[0])] = rec
            continue
        rec["held_bytes"] = reserved() - r0
        held_total += rec["held_bytes"]
        rec["programs"] = [k[0] for k in graphs.programs() if k not in before]
        n0 = replays()
        got = [call(A) for A in mats]
        torch.cuda.synchronize()
        rec["replays"] = replays() - n0
        rec["bitwise"] = [bits_equal(outputs(*g), outputs(*e)) for g, e in zip(got, eager)]
        rec["info"] = [int(g[0].info) for g in got]
        rec["scaled_resid"] = [scaled_resid(A, g[0]) for A, g in zip(mats, got)]
        if name == "grid_chain":
            rec["grid_blocks"] = bf16x3_plan(*shape, 32)["grid_blocks"]
        if name == "grid_route":
            rec["plan"] = panel_plan(*shape, torch.float32)
        # the chains of the eager calls and of the capture, by plan; on the
        # default schedule each is the launcher's plan of a live height
        chains = panel_factor_cuda.counts.chain_launches_by_plan
        rec["chain_launches_by_plan"] = {f"{d}_b{b}_C{c}": k for (d, b, c), k in chains.items()}
        real = dname in ("float32", "float64")
        heights = range(shape[0], 0, -512) if square and real and not fields else ()
        plans = {(dname, p["block"], p["cluster"]) for p in
                 (panel_plan(m, min(512, shape[1]), dtype) for m in heights)
                 if p["route"] == "cluster"}
        if heights and not (chains and set(chains) <= plans):
            fail(f"graph key {name} {shape}: chain plans {chains}, the launcher's {plans}")
        if "zero_col" in inputs:
            try:
                rt.lu(mats[list(inputs).index("zero_col")], config=cfg)
                rec["check_raises"] = False
            except rt.SingularMatrixError:
                rec["check_raises"] = True
        A, (Fe, xe) = mats[0], eager[0]
        pe = Fe.p if square else None

        def eager_call():
            # what the entry points run for a key without a program
            f, _, p, _ = lu_mod._lu_factor_impl(A, True, cfg)
            return solve_mod._lu_solve_impl(f, p, b, True, 0) if square else f

        fns = {
            "eager": eager_call,
            "replay": lambda: call(A),
            "library": (lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2],
                                                      b[:, None])) if square
            else (lambda: torch.linalg.lu_factor_ex(A)),
        }
        rec["ms"] = round_robin(fns, rounds=7, mirror=True)
        if square:
            LUl, piv, _ = torch.linalg.lu_factor_ex(A)
            rec["solve_ms"] = round_robin({
                "eager": lambda: solve_mod._lu_solve_impl(Fe.factors, pe, b, True, 0),
                "replay": lambda: rt.lu_solve(Fe, b),
                "library": lambda: torch.linalg.lu_solve(LUl, piv, b[:, None]),
            }, rounds=9, inner=4, mirror=True)
            del LUl, piv
        rec["profile"] = idle(fns)
        rec["host_ms"] = host_ms(fns)
        emit("graph", captured=True, **rec)
        out[(name, shape[0])] = rec
        # the factor's program is new; the solve's key holds no config, so
        # another key's warmup may have captured it already (as jax.jit
        # shares the solve's program)
        calls_per_input = 2 if square else 1
        ok = (rec["programs"][:1] == ["lu_factor"]
              and set(rec["programs"]) <= {"lu_factor", "lu_solve"} and all(rec["bitwise"])
              and rec["replays"] == len(mats) * calls_per_input)
        for k, i, sr in zip(list(inputs) + ["second"], rec["info"], rec["scaled_resid"]):
            ok = ok and (i == 701 if k == "zero_col" else i == 0 and sr < 20)
        if "zero_col" in inputs:
            ok = ok and rec["check_raises"]
        if name == "grid_chain":
            ok = ok and rec["grid_blocks"] > 0
        if name == "grid_route":
            ok = ok and rec["plan"]["route"] == "grid"
        if not ok:
            fail(f"graph key {name}: {rec}")
        del mats, eager, got, fns, A, Fe, xe

    # the batched pairs, captured by graphs.capturing() around the calls
    cfg = rt.default_config()
    for B, n in GRAPH_BATCHES:
        A, A2 = (torch.randn(B, n, n, generator=gen, device=dev) for _ in range(2))
        b = torch.randn(B, n, generator=gen, device=dev)

        def pairs(A):
            f, perm, info = rt.batched_lu_factor_perm(A)
            g, ipiv, ginfo = rt.batched_lu_factor(A)
            return (f, perm, info, rt.batched_lu_solve_perm(f, perm, b),
                    g, ipiv, ginfo, rt.batched_lu_solve(g, ipiv, b))

        rec = dict(key="batched", shape=[B, n, n], dtype="float32", card=card)
        eager = [no_sync(lambda A=A: pairs(A)) for A in (A, A2)]
        rec["eager_no_sync"] = True
        before = set(graphs.programs())
        r0 = reserved()
        with graphs.capturing():
            pairs(A)
        rec["held_bytes"] = reserved() - r0
        held_total += rec["held_bytes"]
        rec["programs"] = [k[0] for k in graphs.programs() if k not in before]
        n0 = replays()
        got = [pairs(M) for M in (A, A2)]
        torch.cuda.synchronize()
        rec["replays"] = replays() - n0
        rec["bitwise"] = [bits_equal(g, e) for g, e in zip(got, eager)]
        rec["info_nonzero"] = int((got[0][2] != 0).sum())
        fe, pe = eager[0][0], eager[0][1]

        def eager_pair():
            # what the perm pair runs for a key without a program
            f, perm, _ = batched_mod._batched_lu_factor_perm_impl(A, True, cfg)
            return batched_mod._solve_impl(f, b, perm, 0, cfg, "perm")

        fns = {
            "eager": eager_pair,
            "replay": lambda: rt.batched_lu_solve_perm(*rt.batched_lu_factor_perm(A)[:2], b),
            "library": lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2],
                                                     b[:, :, None]),
        }
        with quiet_c_stdout():
            rec["ms"] = round_robin(fns, rounds=7, inner=4, mirror=True)
            LUl, piv, _ = torch.linalg.lu_factor_ex(A)
            rec["solve_ms"] = round_robin({
                "eager": lambda: batched_mod._solve_impl(fe, b, pe, 0, cfg, "perm"),
                "replay": lambda: rt.batched_lu_solve_perm(fe, pe, b),
                "library": lambda: torch.linalg.lu_solve(LUl, piv, b[:, :, None]),
            }, rounds=9, inner=4, mirror=True)
            del LUl, piv
            rec["profile"] = idle(fns)
            rec["host_ms"] = host_ms(fns)
        emit("graph", captured=True, **rec)
        out[("batched", n)] = rec
        if not (sorted(rec["programs"]) == sorted(["batched_lu_factor_perm", "batched_lu_factor",
                                                   "batched_lu_solve_perm", "batched_lu_solve"])
                and all(rec["bitwise"]) and rec["replays"] == 8):
            fail(f"graph key batched {n}: {rec}")
        del A, A2, b, eager, got, fns, fe, pe

    # the entry step (__graft_entry__.py's jitted step): factor + solve as
    # one program, the factor in place on the program's copy of A
    n = 1536

    def step(A, b):
        factors, ipiv, perm, info = lu_mod._dispatch_factor(A, True, cfg)
        return solve_mod._lu_solve_impl(factors, perm, b, True, 0), info

    A, A2 = matrix((n, n), torch.float32, "entry"), matrix((n, n), torch.float32, "entry")
    b = torch.randn(n, generator=gen, device=dev)
    rec = dict(key="entry_step", shape=[n, n], dtype="float32", card=card)
    eager = [no_sync(lambda M=M: step(M.clone(), b)) for M in (A, A2)]
    rec["eager_no_sync"] = True
    r0 = reserved()
    program = graphs.capture("entry_step", step, (A, b), ())
    rec["held_bytes"] = reserved() - r0
    held_total += rec["held_bytes"]
    got = [program(M, b) for M in (A, A2)]
    torch.cuda.synchronize()
    rec["bitwise"] = [bits_equal(g, e) for g, e in zip(got, eager)]
    rec["info"] = [int(g[1]) for g in got]
    fns = {"eager": lambda: step(A.clone(), b), "replay": lambda: program(A, b),
           "library": lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2],
                                                    b[:, None])}
    rec["ms"] = round_robin(fns, rounds=7, mirror=True)
    rec["profile"] = idle(fns)
    rec["host_ms"] = host_ms(fns)
    emit("graph", captured=True, **rec)
    out["entry_step"] = rec
    if not (all(rec["bitwise"]) and rec["info"] == [0, 0]):
        fail(f"graph key entry_step: {rec}")
    del program, got, eager, fns, A, A2, b

    held_total += graph_more(rt, dev, card, round_robin, tp_mesh, dp_mesh, gen, bits_equal,
                             reserved, no_sync, replays, idle, host_ms, matrix, scaled_resid)

    r_held = reserved()
    warmup.clear_caches()
    r_end = reserved()
    rec = dict(key="clear_caches", card=card, reserved_start=r_start, reserved_held=r_held,
               reserved_end=r_end, freed_bytes=r_held - r_end, held_bytes_measured=held_total,
               programs_left=len(graphs.programs()))
    emit("graph", **rec)
    if not (rec["programs_left"] == 0 and r_end - r_start <= GRAPH_WORKSPACE_SLACK
            and r_held - r_end > 0):
        fail(f"clear_caches did not free the programs: {rec}")
    return out


def graph_more(rt, dev, card, round_robin, tp_mesh, dp_mesh, gen, bits_equal, reserved,
               no_sync, replays, idle, host_ms, matrix, scaled_resid):
    """Phase 3h's keys of GRAPH_MORE (graph_phase's helpers passed in).
    Returns the bytes their programs hold."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from recursivefactorization_jl_tpu_torch.models import butterfly as rbt_mod
    from recursivefactorization_jl_tpu_torch.models import lu as lu_mod
    from recursivefactorization_jl_tpu_torch.parallel import batched as batched_mod
    from recursivefactorization_jl_tpu_torch.parallel import blockcyclic as tp_mod
    from recursivefactorization_jl_tpu_torch.utils import graphs

    cfg = rt.default_config()
    held_total = 0

    def wide(t):
        return t.to(torch.complex128) if t.is_complex() else t.double()

    def solve_resid(A, x, b):
        Ad, xd, bd = wide(A), wide(x), wide(b)
        return float((Ad @ xd - bd).norm() / (Ad.norm() * xd.norm()))

    def key(rec, run, inputs, eager_no_sync, fns, want_programs, want_replays):
        """Eager under the sync debug mode, the capture, the replays bit
        for bit on each input, ms in turns, idle shares, host ms and the
        memory held; ``rec`` gets them.  Returns the replays' outputs."""
        nonlocal held_total
        eager = [run(*M) for M in inputs]
        for M in inputs:
            no_sync(lambda M=M: eager_no_sync(*M))
        rec["eager_no_sync"] = True
        before = set(graphs.programs())
        r0 = reserved()
        with graphs.capturing():
            run(*inputs[0])
        rec["held_bytes"] = reserved() - r0
        held_total += rec["held_bytes"]
        rec["programs"] = sorted(k[0] for k in graphs.programs() if k not in before)
        n0 = replays()
        got = [run(*M) for M in inputs]
        torch.cuda.synchronize()
        rec["replays"] = replays() - n0
        rec["bitwise"] = [bits_equal(g, e) for g, e in zip(got, eager)]
        rec["ms"] = round_robin(fns, rounds=7, mirror=True)
        rec["profile"] = idle(fns)
        rec["host_ms"] = host_ms(fns)
        rec["ok_programs"] = rec["programs"] == sorted(want_programs)
        rec["ok_replays"] = rec["replays"] == want_replays
        return got

    def done(rec, ok):
        emit("graph", captured=True, **rec)
        if not (ok and rec["ok_programs"] and rec["ok_replays"] and all(rec["bitwise"])):
            fail(f"graph key {rec['key']}: {rec}")

    for kind, n, dname, what in GRAPH_MORE:
        dtype = getattr(torch, dname)
        rec = dict(key=kind, n=n, dtype=dname, card=card)
        if kind == "lu_inplace":
            mats = [(matrix((n, n), dtype, k),) for k in what] + [(matrix((n, n), dtype,
                                                                          "randn"),)]
            rec["inputs"] = list(what) + ["second"]

            def run(A):
                T = A.clone()
                F = rt.lu_inplace(T, check=False)
                if F.factors is not T:
                    fail("lu_inplace: the factors are not the caller's tensor")
                return F.factors, F.ipiv, F.p, F.info

            A = mats[0][0]
            fns = {"eager": lambda: lu_mod._dispatch_factor(A.clone(), True, cfg),
                   "replay": lambda: run(A),
                   "library": lambda: torch.linalg.lu_factor_ex(A)}
            if n == 1536:  # lu's program of this key, captured by the warmup above
                fns["lu_replay"] = lambda: rt.lu(A, check=False, config=rt.LUConfig())
            got = key(rec, run, mats, run, fns, ["lu_factor_donated"], len(mats))
            if n == 1536:
                n0 = replays()
                fns["lu_replay"]()
                rec["lu_replay_replays"] = replays() - n0
            rec["info"] = [int(g[3]) for g in got]
            rec["scaled_resid"] = [scaled_resid(M[0], rt.LU(g[0], g[1], g[3], perm=g[2]))
                                   for M, g in zip(mats, got)]
            ok = True
            for k, i, sr in zip(rec["inputs"], rec["info"], rec["scaled_resid"]):
                ok = ok and (i == 701 if k == "zero_col" else i == 0 and sr < 20)
            if "zero_col" in what:
                try:
                    rt.lu_inplace(mats[list(what).index("zero_col")][0].clone())
                    rec["check_raises"] = False
                except rt.SingularMatrixError:
                    rec["check_raises"] = True
                ok = ok and rec["check_raises"]
            done(rec, ok)
            del mats, got, fns, A
        elif kind == "rbt":
            if dtype == torch.float64:  # Wilkinson's matrix, pivot growth 2^(n-1)
                W = torch.eye(n, dtype=dtype, device=dev) - torch.ones(
                    n, n, dtype=dtype, device=dev).tril(-1)
                W[:, -1] = 1
                A, A2 = W, W + 0.5 * torch.eye(n, dtype=dtype, device=dev)
                rec["inputs"] = ["wilkinson", "wilkinson + I/2"]
            else:
                A, A2 = matrix((n, n), dtype, "entry"), matrix((n, n), dtype, "entry")
                rec["inputs"] = ["entry", "entry (second)"]
            rec["padded"] = n + (-n) % 4
            # the values of every key of this size: their copy from the CPU
            # generator is the one host operation, made outside the graphs
            uv = rbt_mod.generate_butterfly_values(rec["padded"], rbt_mod.DEFAULT_SEED, dtype,
                                                   dev)
            for refine, cols in what:
                shape = (n,) if cols is None else (n, cols)
                b, b2 = (torch.rand(*shape, generator=gen, device=dev, dtype=dtype)
                         for _ in range(2))
                sub = dict(rec, refine=refine, rhs=list(shape))

                def run(A, b, refine=refine):
                    ws = rt.butterfly_workspace(A, b)
                    x, info = rt.butterfly_solve(ws, refine=refine, return_info=True)
                    return (ws.A, ws.b, ws.uv, x, info) + tuple(ws.UV())

                def body(A, b, refine=refine):
                    # the programs' own code on the values made first
                    Ap, bp, _ = rbt_mod._workspace_arrays(A, b, uv, rbt_mod.DEFAULT_SEED)
                    return (rbt_mod._butterfly_solve_impl(Ap, bp, uv, cfg, refine),
                            rbt_mod.materialize_uv(uv, rec["padded"]))

                ws = rt.butterfly_workspace(A, b)
                fns = {"eager": lambda ws=ws, r=refine: rbt_mod._butterfly_solve_impl(
                           ws.A, ws.b, ws.uv, cfg, r),
                       "replay": lambda ws=ws, r=refine: rt.butterfly_solve(ws, refine=r),
                       "library": lambda b=b: torch.linalg.lu_solve(
                           *torch.linalg.lu_factor_ex(A)[:2], b[:, None] if b.ndim == 1 else b)}
                # the workspace's program is new for each right-hand side's
                # shape, the solve's for each (shape, refine), UV's once
                want = ["butterfly_workspace", "butterfly_solve"]
                if (refine, cols) == what[0]:
                    want.append("materialize_uv")
                if (refine, cols) in what[2:]:  # the workspace key came earlier
                    want.remove("butterfly_workspace")
                got = key(sub, run, [(A, b), (A2, b2)], body, fns, want, 6)
                sub["info"] = [int(g[4]) for g in got]
                x = got[0][3]
                if dtype == torch.float64:
                    sub["err_2norm"] = float((wide(A) @ wide(x[:n]) - wide(b)).norm())
                    ok = sub["err_2norm"] <= 1e-10
                else:
                    sub["solve_rel_resid"] = solve_resid(A, x[:n], b)
                    ok = sub["solve_rel_resid"] < 100 * torch.finfo(dtype).eps
                ok = ok and sub["info"] == [0, 0]
                done(sub, ok)
                del got, fns, ws
            del A, A2, uv
        elif kind == "tp":
            w = what
            group = tp_mesh.get_group("tp")
            rec.update(panel_width=w, backend=dist.get_backend(group), ranks=1,
                       inputs=["randn", "randn (second)"])
            mats = [(matrix((n, n), dtype, "randn"),) for _ in range(2)]
            b = torch.randn(n, generator=gen, device=dev, dtype=dtype)

            def run(A, w=w):
                F = rt.tp_lu(A, tp_mesh, "tp", w)
                return (F.factors, F.ipiv, F.p, F.info) + tuple(
                    rt.tp_lu_solve(F, b, tp_mesh, "tp", w, trans=t) for t in ("N", "T", "H"))

            def eager_pair(A, w=w):
                F, ipiv, perm, info = tp_mod._tp_lu_factor_impl(A, group, w, True, cfg)
                return tp_mod._tp_lu_solve_impl(F, b, perm[:n], group, w, 0)

            A = mats[0][0]
            fns = {"eager": lambda: eager_pair(A), "replay": lambda: rt.tp_lu_solve(
                       rt.tp_lu(A, tp_mesh, "tp", w), b, tp_mesh, "tp", w),
                   "library": lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2],
                                                            b[:, None])}
            got = key(rec, run, mats, run, fns,
                      ["tp_lu_factor", "tp_lu_solve", "tp_lu_solve", "tp_lu_solve"], 8)
            rec["info"] = [int(g[3]) for g in got]
            rec["scaled_resid"] = [scaled_resid(M[0], rt.LU(g[0], g[1], g[3], perm=g[2]))
                                   for M, g in zip(mats, got)]
            rec["solve_rel_resid"] = {t: solve_resid(op, x, b) for t, op, x in zip(
                "NTH", (A, A.T, A.mH), got[0][4:])}
            ok = (rec["info"] == [0, 0] and all(r < 20 for r in rec["scaled_resid"])
                  and all(np.isfinite(v) for v in rec["solve_rel_resid"].values()))
            done(rec, ok)
            del mats, got, fns, A, b
        else:  # the sharded pair
            B = what
            group = dp_mesh.get_group("dp")
            rec.update(shape=[B, n, n], backend=dist.get_backend(group), ranks=1,
                       inputs=["randn", "randn (second)"])
            mats = [(torch.randn(B, n, n, generator=gen, device=dev),) for _ in range(2)]
            b = torch.randn(B, n, generator=gen, device=dev)

            def run(A):
                f, ipiv, info = rt.sharded_batched_lu_factor(A, dp_mesh, "dp")
                return f, ipiv, info, rt.sharded_batched_lu_solve(f, ipiv, b, dp_mesh, "dp")

            def eager_pair(A):
                f, ipiv, info = batched_mod._sharded_factor_impl(A, group, True, cfg)
                return batched_mod._sharded_solve_impl(f, ipiv, b, group, True, cfg)

            A = mats[0][0]
            fns = {"eager": lambda: eager_pair(A), "replay": lambda: run(A),
                   "library": lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A)[:2],
                                                            b[:, :, None])}
            with quiet_c_stdout():
                got = key(rec, run, mats, run, fns,
                          ["sharded_batched_lu_factor", "sharded_batched_lu_solve"], 4)
            unsharded = rt.batched_lu_factor(A)
            rec["equal_unsharded"] = bits_equal(got[0][:3], unsharded)
            done(rec, rec["equal_unsharded"])
            del mats, got, fns, A, b, unsharded

    # a gloo group asked to capture raises, naming its backend; outside
    # capturing() it runs eagerly (gloo stages CUDA tensors through the host)
    gloo = dist.new_group([0], backend="gloo")

    class GlooMesh:
        def get_group(self, axis):
            return gloo

    A = matrix((512, 512), torch.float32, "entry")
    rec = dict(key="gloo_refused", card=card, n=512)
    try:
        with graphs.capturing():
            rt.tp_lu(A, GlooMesh(), "tp", 128)
        rec["raised"] = None
    except RuntimeError as e:
        rec.update(raised=str(e)[-160:], names_key=str(e).startswith(
            "could not capture the program of ('tp_lu_factor'"), names_backend="'gloo'" in str(e))
    rec["eager_info"] = int(rt.tp_lu(A, GlooMesh(), "tp", 128).info)
    emit("graph", **rec)
    if not (rec["raised"] and rec["names_key"] and rec["names_backend"]
            and rec["eager_info"] == 0):
        fail(f"a gloo group asked to capture: {rec}")
    dist.destroy_process_group(gloo)
    return held_total


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    import recursivefactorization_jl_tpu_torch as rt
    from recursivefactorization_jl_tpu_torch.ops import _kernels
    from recursivefactorization_jl_tpu_torch.ops.panel import (
        offset_panel_factor,
        offset_panel_factor_c64_cuda,
        offset_panel_factor_cuda,
        panel_factor_basic_cuda,
        panel_factor_c64_cuda,
        panel_factor_cuda,
        panel_factor_noswap_cuda,
        panel_factor_shadow_cuda,
        micro_plan,
        noswap_plan,
        panel_plan,
        reset_counts,
    )
    from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
    from recursivefactorization_jl_tpu_torch.ops.unblocked import (
        micro_blocked_lu,
        offset_panel_lu,
        offset_panel_lu_cabs1,
        unblocked_lu,
        unblocked_lu_cabs1,
        unblocked_lu_noswap,
    )
    from recursivefactorization_jl_tpu_torch.utils import graphs, warmup

    quick = "--quick" in argv
    # phases 1, 2b and 4b only
    batched_only = "--batched" in argv
    if "--log" in argv:
        global LOG
        path = argv[argv.index("--log") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        LOG = open(path, "w")
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. env ----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build((*_kernels.SOURCES, *_kernels.VARIANTS))  # the trace build too
    build_s = time.perf_counter() - t0
    ptxas = [
        ln.strip() for rec in _kernels.BUILD_LOG.values()
        for ln in rec["log"].splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    ]
    emit("env", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=build_s, build_dir=str(_kernels.BUILD_DIR),
         ptxas=ptxas)
    print(card, flush=True)
    # utils.warmup after the build: the first factor + solve at the entry
    # point's size (the kernels are built, so it only loads them) and the
    # capture of their programs; then the programs are freed, so that the
    # main path below runs eagerly through the wrappers it counts
    t0 = time.perf_counter()
    warmup.warmup(((1536, 1536),), (torch.float32,))
    emit("warmup", card=card, shapes=[[1536, 1536]], dtypes=["float32"],
         seconds=time.perf_counter() - t0, build_seconds=build_s,
         programs=[k[0] for k in graphs.programs()])
    warmup.clear_caches()

    cfg = rt.default_config()
    w_main = cfg.resolved_panel_width()

    def main_shape(n):
        route = rt.dispatch_route((n, n), torch.float32, True, cfg)
        return route, ((n, n) if route == "whole" else (n, w_main))

    def bits(t):
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)

    def timed(fn, setup=None, reps=5, warm=2):
        ts = []
        for i in range(warm + reps):
            if setup is not None:
                setup()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            if i >= warm:
                ts.append(e0.elapsed_time(e1))
        ts.sort()
        return ts[len(ts) // 2], ts

    def round_robin(fns, rounds=7, warm=1, inner=1, setup=None, mirror=False):
        """Median CUDA-event ms of each callable, run in turns (every
        round times each once), so host noise spreads over all of them.
        With ``inner`` > 1 a turn queues the callable that many times
        between its two events and the time is per call: the device stays
        fed and the host's launch latency falls out of a sub-millisecond
        kernel's time.  ``setup`` runs before each timing, outside it.
        ``mirror``: every other round runs the callables in reverse order,
        so no one of them always follows the same other."""
        ts = {k: [] for k in fns}
        for r in range(warm + rounds):
            for k, fn in (reversed(fns.items()) if mirror and r % 2 else fns.items()):
                if setup is not None:
                    setup()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(inner):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                if r >= warm:
                    ts[k].append(e0.elapsed_time(e1) / inner)
        return {k: sorted(v)[len(v) // 2] for k, v in ts.items()}

    gen = torch.Generator(device="cpu").manual_seed(1)
    if "--plans" in argv:  # phase 1 and the float64 b x C sweep only
        plan_sweep(dev, card, gen, round_robin,
                   [(m, 512, torch.float64) for m in F64_LU_HEIGHTS])
        print(json.dumps({"ok": True, "plans_only": True}))
        return 0
    if "--graph" in argv:  # phases 1 and 3h only
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                                world_size=1)
        try:
            graph_phase(rt, dev, card, round_robin,
                        init_device_mesh("cuda", (1,), mesh_dim_names=("tp",)),
                        init_device_mesh("cuda", (1,), mesh_dim_names=("dp",)))
        finally:
            warmup.clear_caches()
            dist.destroy_process_group()
        print(json.dumps({"ok": True, "graph_only": True}))
        return 0
    if "--mixed" in argv:  # phase 1 and the mixed phase only
        print(json.dumps({"kernels": mixed_phase(rt, dev, card, round_robin)}), flush=True)
        print(json.dumps({"ok": True, "mixed_only": True}))
        return 0
    if "--bf16x3" in argv:  # phases 1, 2g and 4g (and the bf16x3 profile) only
        bf16x3_kernel_phase(dev, gen)
        bf16x3_timing_phase(rt, dev, gen, card, round_robin, timed)
        if "--profile" in argv:
            bf16x3_profile(rt, card, gen, dev)
        print(json.dumps({"ok": True, "bf16x3_only": True}))
        return 0
    # ---- 2. kernel vs plain ---------------------------------------------
    if not batched_only:
        max_err = 0.0
        shapes = sorted({main_shape(n)[1] for n in (1536, 4096)})
        cases = []
        for (m, w) in shapes:
            for dt in (torch.float32, torch.float64):
                base = torch.randn(m, w, generator=gen, dtype=dt)
                zcol = base.clone()
                zcol[:, min(5, w - 1)] = 0
                ties = torch.randint(-2, 3, (m, w), generator=gen).to(dt)
                for name, X in (("randn", base), ("zero_col", zcol), ("ties", ties)):
                    for pivot in (True, False):
                        if name == "ties" and not pivot:
                            continue
                        cases.append(((m, w), dt, name, pivot, X))
        for (m, w), dt, name, pivot, X in cases:
            A = X.to(dev)
            f_p, piv_p, perm_p, info_p = unblocked_lu(A, pivot)
            P = A.clone()
            piv_k, perm_k, info_k = panel_factor_cuda(P, pivot)
            torch.cuda.synchronize()
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(P), bits(f_p))),
            }
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            max_err = max(max_err, err)
            emit("kernel", shape=[m, w], dtype=str(dt)[6:], input=name,
                 pivot=pivot, info=int(info_k), max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"kernel disagrees with its plain version: {same}")
            if name == "zero_col" and int(info_k) == 0:
                fail("zeroed column gave info 0")
        # the cluster route's plans (csrc/panel_lu.cu): every block width b and
        # cluster size C on one panel (ragged last blocks: w = 100), one slab
        # for the whole panel (b = w), then the shapes of the slice: a whole
        # 512 x 512 matrix, 8192 x 512, a column block of a 4096 x 4096 matrix
        # (row stride 4096), and panels too tall for a cluster (the grid route)
        f32, f64 = torch.float32, torch.float64
        plans_run = set()

        def check_panel(A, pivot, what, block=0, cluster=0, view=None, grid_route=False):
            """Factor ``A`` (or the ``view`` of it) with the kernel and compare
            with unblocked_lu; returns the launch's plan."""
            nonlocal max_err
            X = A if view is None else view(A)
            f_p, piv_p, perm_p, info_p = unblocked_lu(X, pivot)
            W = A.clone()
            P = W if view is None else view(W)
            plan = panel_plan(*P.shape, P.dtype, block=block, cluster=cluster)
            g0 = panel_factor_cuda.counts.grid_route_launches
            piv_k, perm_k, info_k = panel_factor_cuda(P, pivot, block=block, cluster=cluster)
            torch.cuda.synchronize()
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(P), bits(f_p))),
                "route_as_expected": (panel_factor_cuda.counts.grid_route_launches - g0
                                      == int(grid_route)) and plan["route"] == (
                                          "grid" if grid_route else "cluster"),
            }
            if view is not None:
                rest = torch.ones_like(A, dtype=torch.bool)
                view(rest).fill_(False)
                same["rest_untouched"] = bool(torch.equal(W[rest], A[rest]))
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            max_err = max(max_err, err)
            emit("kernel", shape=list(P.shape), lda=P.stride(0), dtype=str(P.dtype)[6:],
                 input=what, pivot=pivot, plan=plan, info=int(info_k), max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"kernel disagrees with its plain version: {same}")
            return plan

        for dt in (f32, f64):
            for (m, w), widths in (((1000, 100), (8, 16, 32, 64, 100)), ((1000, 12), (12,))):
                X = torch.randn(m, w, generator=gen, dtype=dt).to(dev)
                X[:, 7] = 0
                for b in widths:
                    for C in (1, 2, 4, 8, 16):
                        try:
                            panel_plan(m, w, dt, block=b, cluster=C)
                        except RuntimeError:
                            continue  # this (b, C) does not fit the card
                        check_panel(X, True, f"zero_col, b={b}, C={C}", block=b, cluster=C)
                        plans_run.add((str(dt)[6:], b, C))
        if not {b for _, b, _ in plans_run} >= {8, 16, 32, 64, 100, 12} or \
                not {C for _, _, C in plans_run} >= {1, 2, 4, 8}:
            fail(f"the plan cases missed a block width or a cluster size: {sorted(plans_run)}")
        for dt in (f32, f64):
            R = torch.randn(777, 130, generator=gen, dtype=dt)
            check_panel((R + 777 * torch.eye(777, 130, dtype=dt)).to(dev), False, "randn + m*I")
            T_ = torch.randint(-2, 3, (777, 130), generator=gen).to(dt).to(dev)
            check_panel(T_, True, "ties")
            R[400, 3] = R[500, 3] = float("nan")
            check_panel(R.to(dev), True, "nan")
            check_panel(torch.randn(512, 512, generator=gen, dtype=dt).to(dev), True, "randn, whole")
            check_panel(torch.randn(64, 200, generator=gen, dtype=dt).to(dev), True, "randn, fat")
            M = torch.randn(4096, 4096, generator=gen, dtype=dt).to(dev)
            check_panel(M, True, "column block", view=lambda t: t[512:, 512:1024])
            del M
        check_panel(torch.randn(8192, 512, generator=gen).to(dev), True, "randn")
        tall = {f32: (100000, 8), f64: (60000, 16)}
        for dt, (m, w) in tall.items():
            check_panel(torch.randn(m, w, generator=gen, dtype=dt).to(dev), True, "randn, tall",
                        grid_route=True)
        check_panel(torch.randn(2000, 64, generator=gen).to(dev), True, "randn, forced grid",
                    block=-1, grid_route=True)

        # ---- 2c. the complex kernel vs plain ---------------------------------
        # csrc/panel_lu_c64.cu on its cluster route (csrc/panel_cluster.cuh with
        # a complex element) and its grid route, against unblocked_lu_cabs1:
        # every plan b x C on a ragged panel, the main path's panels, ties, a
        # zeroed column, NaN in re, in im and at row m - 1 (the pivot row is
        # then m - 1), pivot on and off, complex64 and complex128, the grid
        # route forced and on panels too tall for a cluster
        def crandn(m, w, dt):
            real = torch.float32 if dt == torch.complex64 else torch.float64
            return torch.complex(torch.randn(m, w, generator=gen, dtype=real),
                                 torch.randn(m, w, generator=gen, dtype=real))

        def cbits(t):
            return bits(torch.view_as_real(t).contiguous())

        c64, c128 = torch.complex64, torch.complex128
        max_err_c = {"cluster": 0.0, "grid": 0.0}
        cplans_run = set()

        def complex_input(name, m, w, dt, pivot):
            X = crandn(m, w, dt)
            if name == "ties":
                real = X.real.dtype
                X = torch.complex(torch.randint(-2, 3, (m, w), generator=gen).to(real),
                                  torch.randint(-2, 3, (m, w), generator=gen).to(real))
            if not pivot:
                X += max(m, w) * torch.eye(m, w, dtype=dt)
            if name == "zero_col":
                X[:, min(5, w - 1)] = 0
            if name == "nan_re":
                X[m // 2, 7] = complex(float("nan"), 1.0)
            if name == "nan_im":
                X[m // 2, 7] = complex(1.0, float("nan"))
            if name == "nan_last_row":
                X[m - 1, 7] = complex(float("nan"), 1.0)
            return X

        def check_cpanel(A, pivot, what, block=0, cluster=0, grid_route=False, view=None):
            """Factor complex ``A`` (or the ``view`` of it) with the kernel and
            compare with unblocked_lu_cabs1; returns the launch's plan."""
            X = A if view is None else view(A)
            f_p, piv_p, perm_p, info_p = unblocked_lu_cabs1(X, pivot)
            W = A.clone()
            P = W if view is None else view(W)
            m, w = P.shape
            plan = panel_plan(m, w, P.dtype, block=block, cluster=cluster)
            g0 = panel_factor_c64_cuda.counts.grid_route_launches
            piv_k, perm_k, info_k = panel_factor_c64_cuda(P, pivot, block=block, cluster=cluster)
            torch.cuda.synchronize()
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(cbits(P), cbits(f_p))),
                "route_as_expected": (panel_factor_c64_cuda.counts.grid_route_launches - g0
                                      == int(grid_route)) and plan["route"] == (
                                          "grid" if grid_route else "cluster"),
            }
            if view is not None:
                rest = torch.ones(A.shape, dtype=torch.bool, device=dev)
                view(rest).fill_(False)
                same["rest_untouched"] = bool(torch.equal(cbits(W[rest]), cbits(A[rest])))
            if what.startswith("nan") and pivot and w > 7 and m > 8:
                same["nan_rows_pivot_last"] = bool((piv_k[7:] == m - 1).all())
            if what.startswith("zero_col") and min(m, w) > 5:
                same["info_as_expected"] = int(info_k) == (6 if pivot else -6)
            err = float(torch.view_as_real(P - f_p).abs().nan_to_num(0.0, 0.0, 0.0).max())
            key = plan["route"]
            max_err_c[key] = max(max_err_c[key], err)
            emit("kernel", kernel="panel_lu_c64", shape=[m, w], lda=P.stride(0),
                 dtype=str(P.dtype)[6:], input=what, pivot=pivot, plan=plan, info=int(info_k),
                 max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"complex kernel disagrees with its plain version: {same}")
            return plan

        for dt in (c64, c128):
            X = complex_input("zero_col", 1000, 100, dt, True).to(dev)
            for b in (8, 16, 32, 64, 100):
                for C in (1, 2, 4, 8, 16):
                    try:
                        panel_plan(1000, 100, dt, block=b, cluster=C)
                    except RuntimeError:
                        continue  # this (b, C) does not fit the card
                    check_cpanel(X, True, f"zero_col, b={b}, C={C}", block=b, cluster=C)
                    cplans_run.add((str(dt)[6:], b, C))
            X = complex_input("nan_re", 1000, 100, dt, True).to(dev)
            for b, C in ((8, 1), (16, 2), (32, 4), (100, 16)):
                check_cpanel(X, True, f"nan_re, b={b}, C={C}", block=b, cluster=C)
        if not {b for _, b, _ in cplans_run} >= {8, 16, 32, 64, 100} or \
                not {C for _, _, C in cplans_run} >= {1, 2, 4, 8, 16}:
            fail(f"the complex plan cases missed a block width or a cluster size: "
                 f"{sorted(cplans_run)}")
        ccases = []
        for (m, w) in shapes:  # the main path's panels: the plain version once per case
            ccases += [((m, w), c64, "randn", True), ((m, w), c64, "zero_col", True),
                       ((m, w), c128, "randn", True), ((m, w), c64, "nan_re", True)]
        ccases += [((512, 512), c64, "randn", True), ((512, 512), c64, "randn", False),
                   ((512, 512), c128, "zero_col", False)]
        for (m, w) in ((777, 130), (130, 300)):  # ragged tall, fat
            for dt in (c64, c128):
                ccases += [((m, w), dt, "randn", True), ((m, w), dt, "randn", False),
                           ((m, w), dt, "zero_col", True), ((m, w), dt, "zero_col", False),
                           ((m, w), dt, "ties", True), ((m, w), dt, "nan_re", True),
                           ((m, w), dt, "nan_im", True), ((m, w), dt, "nan_last_row", True)]
        for (m, w), dt, name, pivot in ccases:
            A = complex_input(name, m, w, dt, pivot).to(dev)
            check_cpanel(A, pivot, name)
            if (m, w) == (777, 130):  # the same cases on the grid route, forced
                check_cpanel(A, pivot, f"{name}, forced grid", block=-1, grid_route=True)
        M = crandn(2048, 2048, c64).to(dev)
        check_cpanel(M, True, "column block", view=lambda t: t[512:, 512:1024])
        del M
        # too tall for a cluster of 16 even at b = 8: the grid route
        check_cpanel(crandn(60000, 8, c64).to(dev), True, "randn, tall", grid_route=True)
        check_cpanel(crandn(30000, 8, c128).to(dev), True, "randn, tall", grid_route=True)
        for bad in (torch.zeros(8, 4, device=dev), torch.zeros(8, 4, dtype=c64),
                    torch.zeros(8, 4, device=dev, dtype=c64).T):
            try:
                panel_factor_c64_cuda(bad, True)
            except ValueError:
                continue
            fail(f"panel_factor_c64_cuda took {tuple(bad.shape)} {bad.dtype} {bad.device}")
        for bad in (lambda: panel_plan(64, 8, torch.float16),
                    lambda: panel_plan(64, 8, torch.int32),
                    lambda: panel_factor_c64_cuda(torch.zeros(64, 8, device=dev, dtype=c64),
                                                  True, block=True)):
            try:
                bad()
            except ValueError:
                continue
            fail("the complex plan took a request it must refuse")
        try:  # a slab too large for one CTA
            panel_factor_c64_cuda(torch.zeros(1000, 100, device=dev, dtype=c128), True,
                                  block=64, cluster=1)
        except RuntimeError:
            pass
        else:
            fail("the complex kernel took a plan that does not fit the card")

        # ---- 2d. the micro-blocked and the no-swap kernels vs plain -----------
        micro_wrappers = {"panel_lu_micro_shadow": panel_factor_shadow_cuda,
                          "panel_lu_micro_basic": panel_factor_basic_cuda}

        def real_input(name, m, w, dt, pivot):
            if name == "ties":
                return torch.randint(-2, 3, (m, w), generator=gen).to(dt)
            X = torch.randn(m, w, generator=gen, dtype=dt)
            if not pivot:
                X += max(m, w) * torch.eye(m, w, dtype=dt)
            if name == "zero_col":
                X[:, min(5, w - 1)] = 0
            if name == "nan":  # two NaN candidates in column 3: the first wins
                X[m // 3, 3] = X[m // 2, 3] = float("nan")
            return X

        def same_bits_nan(x, y):
            nx, ny = torch.isnan(x), torch.isnan(y)
            return bool(torch.equal(nx, ny)) and bool(
                torch.equal(bits(x.masked_fill(nx, 0)), bits(y.masked_fill(ny, 0))))

        new_err = {k: 0.0 for k in NEW_PANEL_KERNELS}
        new_err["panel_grid_chain"] = 0.0
        mcases = []  # shape, dtype, input, pivot, micro
        for (m, w) in shapes:
            mcases += [((m, w), f32, "randn", True, 32), ((m, w), f64, "randn", True, 16)]
        mcases += [(shapes[0], f32, "zero_col", True, 32), (shapes[0], f32, "ties", True, 16),
                   (shapes[0], f32, "randn", False, 32),
                   ((512, 512), f32, "randn", True, 32), ((512, 512), f64, "zero_col", False, 16)]
        for dt in (f32, f64):
            mcases += [((777, 130), dt, "randn", True, 32), ((777, 130), dt, "zero_col", True, 16),
                       ((777, 130), dt, "ties", True, 32), ((130, 300), dt, "randn", True, 32),
                       ((130, 300), dt, "zero_col", False, 16)]
        mcases += [((777, 130), f32, "nan", True, 12), ((1000, 100), f64, "randn", True, 12),
                   ((130, 300), f32, "randn", True, 12)]

        def check_micro(A, pivot, micro, what, block=0, cluster=0, plain=None, chain="auto"):
            """Both micro wrappers on ``A`` (a tensor or a view) against
            micro_blocked_lu, on the cluster route (block 0; ``chain``
            'grid': every block's chain on the grid) or the grid route
            (block -1); returns the factored panels."""
            f_p, piv_p, perm_p, info_p = plain or micro_blocked_lu(A, pivot, micro)
            m, w = A.shape
            grid_route = block < 0
            outs = {}
            for kern, wrapper in micro_wrappers.items():
                key = (f"{kern}_grid" if grid_route
                       else "panel_grid_chain" if chain == "grid" else kern)
                plan = micro_plan(m, w, A.dtype, micro, kern.rsplit("_", 1)[1], block=block,
                                  cluster=cluster, _chain=chain)
                P = A.clone()
                g0 = (wrapper.counts.grid_route_launches, wrapper.counts.grid_block_launches)
                piv_k, perm_k, info_k = wrapper(P, pivot, micro, block=block, cluster=cluster,
                                                _chain=chain)
                torch.cuda.synchronize()
                outs[kern] = P
                same = {
                    "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                    "perm_equal": bool(torch.equal(perm_k, perm_p)),
                    "info_equal": int(info_k) == int(info_p),
                    "bitwise": same_bits_nan(P, f_p),
                    "route_as_expected": (
                        wrapper.counts.grid_route_launches - g0[0] == int(grid_route)
                        and plan["route"] == ("grid" if grid_route else "cluster")),
                    "grid_blocks_as_planned": wrapper.counts.grid_block_launches - g0[1] == (
                        0 if grid_route else plan["grid_blocks"]),
                }
                if chain == "grid":
                    same["every_block_on_the_grid"] = plan["grid_blocks"] == plan["blocks"]
                err = float((P - f_p).abs().nan_to_num(0.0).max())
                new_err[key] = max(new_err[key], err)
                emit("kernel", kernel=key, shape=[m, w], dtype=str(A.dtype)[6:], input=what,
                     pivot=pivot, micro=micro, plan=plan, info=int(info_k), max_abs_err=err,
                     **same)
                if not all(same.values()):
                    fail(f"{key} disagrees with its plain version: {same}")
                if what.startswith("zero_col") and int(info_k) != (6 if pivot else -6):
                    fail(f"zeroed column 5 gave info {int(info_k)}")
            return outs

        for (m, w), dt, name, pivot, micro in mcases:
            A = real_input(name, m, w, dt, pivot).to(dev)
            plain = micro_blocked_lu(A, pivot, micro)
            for block in (0, -1):
                outs = check_micro(A, pivot, micro, name, block=block, plain=plain)
                if not same_bits_nan(outs["panel_lu_micro_shadow"], outs["panel_lu_micro_basic"]):
                    fail("the staged and the in-place micro kernel differ")
            del outs, plain
        # every plan of the micro route: blocks of micro in {8, 12, 16, 32, 64}
        # steps on every cluster size that fits a ragged 1000 x 100 panel
        mplans = set()
        for dt in (f32, f64):
            X = real_input("zero_col", 1000, 100, dt, True).to(dev)
            for micro in (8, 12, 16, 32, 64):
                plain = micro_blocked_lu(X, True, micro)
                for C in (1, 2, 4, 8, 16):
                    try:
                        micro_plan(1000, 100, dt, micro, cluster=C)
                    except RuntimeError:
                        continue  # this (micro, C) does not fit the card
                    check_micro(X, True, micro, f"zero_col, C={C}", cluster=C, plain=plain)
                    mplans.add((str(dt)[6:], micro, C))
        if not {b for _, b, _ in mplans} >= {8, 12, 16, 32, 64} or \
                not {C for _, _, C in mplans} >= {1, 2, 4, 8, 16}:
            fail(f"the micro plan cases missed a block width or a cluster size: {sorted(mplans)}")
        # blocks past the grid route's 64 steps (the delayed kernels stage
        # them in chunks; a block whose live rows do not fit a cluster runs
        # its chain on the grid), and every block's chain forced onto the
        # grid: the main path's panels, f32 and f64
        for (m, w) in shapes:
            for dt in (f32, f64):
                A = real_input("zero_col", m, w, dt, True).to(dev)
                for micro in (65, 128, 256, 512):
                    plain = micro_blocked_lu(A, True, micro)
                    for chain in ("auto", "grid"):
                        outs = check_micro(A, True, micro, f"zero_col, micro {micro}",
                                           plain=plain, chain=chain)
                        if not same_bits_nan(outs["panel_lu_micro_shadow"],
                                             outs["panel_lu_micro_basic"]):
                            fail("the staged and the in-place micro kernel differ")
                del A, plain, outs

        ncases = []  # shape, dtype, input, pivot, share of rows taken before
        for (m, w) in shapes:
            ncases += [((m, w), f32, "randn", True, 0.0), ((m, w), f32, "randn", True, 0.5)]
        ncases += [(shapes[0], f32, "zero_col", True, 0.5), (shapes[0], f32, "randn", False, 0.5),
                   (shapes[0], f64, "randn", True, 0.5), (shapes[-1], f32, "ties", True, 0.0),
                   ((512, 512), f32, "randn", True, 0.0), ((512, 512), f64, "zero_col", False, 0.0)]
        for dt in (f32, f64):
            ncases += [((777, 130), dt, "randn", True, 0.3), ((777, 130), dt, "ties", True, 0.3),
                       ((777, 130), dt, "zero_col", False, 0.0), ((777, 130), dt, "nan", True, 0.3),
                       ((777, 130), dt, "randn", True, 0.95)]  # 38 rows for 130 steps

        def check_noswap(A, used0, pivot, what, live=None, block=0, cluster=0, plain=None):
            """The no-swap wrapper on ``A`` under ``used0`` against
            unblocked_lu_noswap: the cluster route sized for ``live`` rows
            (block 0 or an explicit b, C) or the grid route (block -1)."""
            f_p, prow_p, used_p, info_p = plain or unblocked_lu_noswap(A, used0, pivot)
            m, w = A.shape
            taken = int((used0 != 0).sum())
            plan = noswap_plan(m, w, A.dtype, live=live, block=block, cluster=cluster)
            grid_route = plan["route"] == "grid"
            key = "panel_lu_noswap_grid" if grid_route else "panel_lu_noswap"
            P = A.clone()
            g0 = panel_factor_noswap_cuda.counts.grid_route_launches
            prow_k, used_k, info_k = panel_factor_noswap_cuda(P, used0, pivot, live=live,
                                                              block=block, cluster=cluster)
            torch.cuda.synchronize()
            same = {
                "prow_equal": bool(torch.equal(prow_k, prow_p)),
                "used_equal": bool(torch.equal(used_k, used_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": same_bits_nan(P, f_p),
                "taken_rows_untouched": same_bits_nan(P[used0.bool()], A[used0.bool()]),
                "used_count": int(used_k.sum()) == min(m, taken + min(m, w)),
                "route_as_expected": (panel_factor_noswap_cuda.counts.grid_route_launches - g0
                                      == int(grid_route)) and grid_route == (block < 0),
            }
            if what.startswith("nan") and pivot:
                same["first_nan_row"] = int(prow_k[3]) in (m // 3, m // 2) or \
                    bool(used0[m // 3] and used0[m // 2])
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            new_err[key] = max(new_err[key], err)
            emit("kernel", kernel=key, shape=[m, w], lda=A.stride(0), dtype=str(A.dtype)[6:],
                 input=what, pivot=pivot, rows_taken_before=taken, live=live, plan=plan,
                 info=int(info_k), max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"{key} disagrees with its plain version: {same}")
            if what.startswith("zero_col") and int(info_k) != (6 if pivot else -6):
                fail(f"zeroed column 5 gave info {int(info_k)}")

        def scattered(m, share):
            used0 = torch.zeros(m, dtype=torch.int32)
            used0[torch.randperm(m, generator=gen)[:int(share * m)]] = 1
            return used0.to(dev)

        for (m, w), dt, name, pivot, share in ncases:
            A = real_input(name, m, w, dt, True).to(dev)  # unpivoted: rows in order
            used0 = scattered(m, share)
            plain = unblocked_lu_noswap(A, used0, pivot)
            live = m - int(used0.sum())
            check_noswap(A, used0, pivot, name, live=live, plain=plain)
            check_noswap(A, used0, pivot, f"{name}, no live count", plain=plain)
            if (m, w) == (777, 130):  # the same cases on the grid route, forced
                check_noswap(A, used0, pivot, f"{name}, forced grid", block=-1, plain=plain)
        # every plan of the cluster route on a ragged 1000 x 100 panel with 300
        # rows taken before: b in {8, 16, 32, 64, 100 (one block)} x C
        nplans = set()
        for dt in (f32, f64):
            X = real_input("zero_col", 1000, 100, dt, True).to(dev)
            used0 = scattered(1000, 0.3)
            plain = unblocked_lu_noswap(X, used0, True)
            for b in (8, 16, 32, 64, 100):
                for C in (1, 2, 4, 8, 16):
                    try:
                        noswap_plan(1000, 100, dt, live=700, block=b, cluster=C)
                    except RuntimeError:
                        continue  # this (b, C) does not fit the card
                    check_noswap(X, used0, True, f"zero_col, b={b}, C={C}", live=700, block=b,
                                 cluster=C, plain=plain)
                    nplans.add((str(dt)[6:], b, C))
        if not {b for _, b, _ in nplans} >= {8, 16, 32, 64, 100} or \
                not {C for _, _, C in nplans} >= {1, 2, 4, 8, 16}:
            fail(f"the no-swap plan cases missed a block width or a cluster size: "
                 f"{sorted(nplans)}")
        # a live count too small for the mask: the launch must fail, in a
        # child process (the trap ends its CUDA context)
        probe = subprocess.run([sys.executable, "-c", WRONG_LIVE_PROBE], capture_output=True,
                               text=True, timeout=300,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
        emit("kernel", kernel="panel_lu_noswap", input="live count 100 for 1536 free rows",
             child_rc=probe.returncode, child_out=probe.stdout[-400:],
             child_err=probe.stderr[-400:])
        if probe.returncode != 0 or "raised:" not in probe.stdout:
            fail("a live count too small for the mask did not fail the launch")
        # the views the main path hands over: a column block of an n x n matrix
        # (row stride n, not w), and for the no-swap kernel the mask that its
        # own first panel returned
        n_v, w_v = 1536, w_main
        for dt in (f32, f64):
            M = torch.randn(n_v, n_v, generator=gen, dtype=dt).to(dev)
            for kern, wrapper in micro_wrappers.items():
                W = M.clone()
                view = W[w_v:, w_v:2 * w_v]
                f_p, piv_p, perm_p, info_p = micro_blocked_lu(M[w_v:, w_v:2 * w_v], True, 32)
                piv_k, perm_k, info_k = wrapper(view, True, 32)
                torch.cuda.synchronize()
                rest = torch.ones(n_v, n_v, dtype=torch.bool, device=dev)
                rest[w_v:, w_v:2 * w_v] = False
                same = {
                    "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                    "perm_equal": bool(torch.equal(perm_k, perm_p)),
                    "info_equal": int(info_k) == int(info_p),
                    "bitwise": bool(torch.equal(bits(view), bits(f_p))),
                    "rest_untouched": bool(torch.equal(W[rest], M[rest])),
                }
                err = float((view - f_p).abs().nan_to_num(0.0).max())
                new_err[kern] = max(new_err[kern], err)
                emit("kernel", kernel=kern, shape=[n_v - w_v, w_v], lda=n_v, dtype=str(dt)[6:],
                     input="column block", pivot=True, micro=32, info=int(info_k),
                     max_abs_err=err, **same)
                if not all(same.values()):
                    fail(f"{kern} on a column block disagrees with its plain version: {same}")
            W = M.clone()
            used_k = used_p = torch.zeros(n_v, dtype=torch.int32, device=dev)
            for s in (0, w_v):
                block = slice(s, s + w_v)
                f_p, prow_p, used_p_next, info_p = unblocked_lu_noswap(M[:, block], used_p, True)
                prow_k, used_k_next, info_k = panel_factor_noswap_cuda(W[:, block], used_k, True,
                                                                       live=n_v - s)
                torch.cuda.synchronize()
                taken = used_p.bool()
                same = {
                    "prow_equal": bool(torch.equal(prow_k, prow_p)),
                    "used_equal": bool(torch.equal(used_k_next, used_p_next)),
                    "info_equal": int(info_k) == int(info_p),
                    "bitwise": bool(torch.equal(bits(W[:, block]), bits(f_p))),
                    "taken_rows_untouched": bool(torch.equal(W[taken][:, block], M[taken][:, block])),
                    "rest_untouched": bool(torch.equal(W[:, s + w_v:], M[:, s + w_v:])),
                    "used_count": int(used_k_next.sum()) == s + w_v,
                }
                err = float((W[:, block] - f_p).abs().nan_to_num(0.0).max())
                new_err["panel_lu_noswap"] = max(new_err["panel_lu_noswap"], err)
                emit("kernel", kernel="panel_lu_noswap", shape=[n_v, w_v], lda=n_v,
                     dtype=str(dt)[6:], input="column block, mask of the panel before",
                     pivot=True, rows_taken_before=s, info=int(info_k), max_abs_err=err, **same)
                if not all(same.values()):
                    fail(f"panel_lu_noswap on a column block disagrees with its plain version: {same}")
                used_k, used_p = used_k_next, used_p_next
            del M, W
        for bad in (lambda: panel_factor_shadow_cuda(torch.zeros(8, 4), True, 4),
                    # the grid route takes at most 64 steps (the cluster route any)
                    lambda: panel_factor_basic_cuda(torch.zeros(200, 100, device=dev), True, 65,
                                                    block=-1),
                    lambda: panel_factor_basic_cuda(torch.zeros(200, 100, device=dev), True, 8,
                                                    _chain="wide"),
                    lambda: panel_factor_shadow_cuda(torch.zeros(200, 100, device=dev), True, 8,
                                                     block=8),
                    lambda: panel_factor_noswap_cuda(torch.zeros(8, 4, device=dev),
                                                     torch.zeros(8, dtype=torch.int32, device=dev),
                                                     True, live=9),
                    lambda: panel_factor_noswap_cuda(torch.zeros(8, 4, device=dev),
                                                     torch.zeros(7, dtype=torch.int32, device=dev), True),
                    lambda: panel_factor_noswap_cuda(torch.zeros(8, 4),
                                                     torch.zeros(8, dtype=torch.int32), True)):
            try:
                bad()
            except ValueError:
                continue
            fail("a new panel wrapper took an argument it must refuse")

        # ---- 2e. the offset kernel vs plain ----------------------------------
        # the tensor-parallel panel: (4096, 128) at the offsets of the first,
        # a middle and the last panel of a stage, and a column block of a wider
        # matrix (row stride > w)
        def offset_input(name, H, w, ofs, dt, pivot):
            X = torch.randn(H, w, generator=gen, dtype=dt)
            if not pivot:
                X[ofs + torch.arange(w), torch.arange(w)] += H
            if name == "zero_col":
                X[ofs:, 5] = 0
            if name == "nan":
                X[ofs + 40, 3] = float("nan")
                X[ofs + 90, 3] = float("nan")
            return X

        offset_err = 0.0
        H_o, w_o = 4096, 128
        ocases = [(dt, pivot, ofs, name) for dt in (f32, f64) for pivot in (True, False)
                  for ofs in (0, 1000, H_o - w_o) for name in ("randn", "zero_col", "nan")]
        for dt, pivot, ofs, name in ocases:
            A = offset_input(name, H_o, w_o, ofs, dt, pivot).to(dev)
            f_p, piv_p, perm_p, info_p = offset_panel_lu(A, ofs, pivot)
            P = A.clone()
            piv_k, perm_k, info_k = offset_panel_factor_cuda(P, ofs, pivot)
            torch.cuda.synchronize()
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(P), bits(f_p))),
                "rows_above_untouched": bool(torch.equal(bits(P[:ofs]), bits(A[:ofs]))),
            }
            if name == "zero_col":
                same["info_as_expected"] = int(info_k) == (6 if pivot else -6)
            if name == "nan" and pivot:
                same["first_nan_row"] = int(piv_k[3]) == ofs + 40
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            offset_err = max(offset_err, err)
            emit("kernel", kernel="panel_lu_offset", shape=[H_o, w_o], ofs=ofs, dtype=str(dt)[6:],
                 input=name, pivot=pivot, info=int(info_k), max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"panel_lu_offset disagrees with its plain version: {same}")
        for dt in (f32, f64):
            M = torch.randn(H_o, 8 * w_o, generator=gen, dtype=dt).to(dev)
            W_ = M.clone()
            view = W_[:, 2 * w_o:3 * w_o]
            f_p, piv_p, perm_p, info_p = offset_panel_lu(M[:, 2 * w_o:3 * w_o], 1000, True)
            piv_k, perm_k, info_k = offset_panel_factor_cuda(view, 1000, True)
            torch.cuda.synchronize()
            rest = torch.ones_like(M, dtype=torch.bool)
            rest[1000:, 2 * w_o:3 * w_o] = False
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(view), bits(f_p))),
                "rest_untouched": bool(torch.equal(W_[rest], M[rest])),
            }
            err = float((view - f_p).abs().nan_to_num(0.0).max())
            offset_err = max(offset_err, err)
            emit("kernel", kernel="panel_lu_offset", shape=[H_o, w_o], lda=8 * w_o, ofs=1000,
                 dtype=str(dt)[6:], input="column block", pivot=True, info=int(info_k),
                 max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"panel_lu_offset on a column block disagrees with its plain version: {same}")
            del M, W_
        # the offset kernel's plans: block widths and cluster sizes at ofs 1000,
        # the plan the launcher picks for 128 live rows, and panels too tall
        # for a cluster (the grid route)
        def check_offset(A, ofs, pivot, what, block=0, cluster=0, grid_route=False):
            nonlocal offset_err
            f_p, piv_p, perm_p, info_p = offset_panel_lu(A, ofs, pivot)
            P = A.clone()
            plan = panel_plan(*P.shape, P.dtype, ofs=ofs, block=block, cluster=cluster)
            g0 = offset_panel_factor_cuda.counts.grid_route_launches
            piv_k, perm_k, info_k = offset_panel_factor_cuda(P, ofs, pivot, block=block,
                                                             cluster=cluster)
            torch.cuda.synchronize()
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(P), bits(f_p))),
                "rows_above_untouched": bool(torch.equal(bits(P[:ofs]), bits(A[:ofs]))),
                "route_as_expected": (offset_panel_factor_cuda.counts.grid_route_launches - g0
                                      == int(grid_route)) and plan["route"] == (
                                          "grid" if grid_route else "cluster"),
            }
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            offset_err = max(offset_err, err)
            emit("kernel", kernel="panel_lu_offset", shape=list(P.shape), ofs=ofs,
                 dtype=str(P.dtype)[6:], input=what, pivot=pivot, plan=plan, info=int(info_k),
                 max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"panel_lu_offset disagrees with its plain version: {same}")
            return plan

        for dt in (f32, f64):
            X = offset_input("zero_col", H_o, w_o, 1000, dt, True).to(dev)
            for b in (8, 16, 32, 64, w_o):
                for C in (2, 4, 8, 16):
                    try:
                        panel_plan(H_o, w_o, dt, ofs=1000, block=b, cluster=C)
                    except RuntimeError:
                        continue
                    check_offset(X, 1000, True, f"zero_col, b={b}, C={C}", block=b, cluster=C)
            plan = check_offset(offset_input("randn", H_o, w_o, H_o - w_o, dt, False).to(dev),
                                H_o - w_o, False, "randn + H*I, 128 live rows")
            if plan["cluster"] != 1:
                fail(f"128 live rows should run on one CTA, plan {plan}")
        check_offset(torch.randn(100000, 8, generator=gen).to(dev), 5000, True, "randn, tall",
                     grid_route=True)
        check_offset(torch.randn(60000, 16, generator=gen, dtype=f64).to(dev), 100, True,
                     "randn, tall", grid_route=True)
        for bad in (lambda: offset_panel_factor_cuda(torch.zeros(64, 8, device=dev), 57, True),
                    lambda: offset_panel_factor_cuda(torch.zeros(64, 8), 0, True),
                    lambda: offset_panel_factor(torch.zeros(64, 8, device=dev), 0, True,
                                                rt.LUConfig(tp_panel_backend="jax"))):
            try:
                bad()
            except ValueError:
                continue
            fail("the offset kernel's wrapper took an argument it must refuse")

        # ---- 2f. the complex offset kernel vs plain --------------------------
        # the offset form of csrc/panel_lu_c64.cu (the panel step of complex
        # tp_lu) on its cluster route and forced onto its grid route
        # (block=-1), against offset_panel_lu_cabs1: complex64 4096 x 128 and
        # complex128 1536 x 128 (the tp cells' panels) at the offsets of the
        # first, a middle and the last panel of a stage; randn, a zeroed
        # column, a NaN candidate (the pivot row is then H - 1), pivot on and
        # off; a column block of a wider matrix; an offset beyond H - w
        def cbits_nan_equal(x, y):
            """Bitwise equal, NaN for NaN (a NaN's payload not compared)."""
            x, y = torch.view_as_real(x), torch.view_as_real(y)
            nx, ny = torch.isnan(x), torch.isnan(y)
            return bool(torch.equal(nx, ny)) and bool(torch.equal(
                bits(x.masked_fill(nx, 0).contiguous()), bits(y.masked_fill(ny, 0).contiguous())))

        coffset_err = {"cluster": 0.0, "grid": 0.0}
        coffset_shapes = {c64: (4096, 128), c128: (1536, 128)}
        for dt, (H_c, w_c) in coffset_shapes.items():
            for ofs in (0, 1000, H_c - w_c):
                for name, pivot in (("randn", True), ("randn", False), ("zero_col", True),
                                    ("zero_col", False), ("nan", True)):
                    X = crandn(H_c, w_c, dt)
                    if not pivot:
                        X[ofs + torch.arange(w_c), torch.arange(w_c)] += H_c
                    if name == "zero_col":
                        X[ofs:, 5] = 0
                    if name == "nan":
                        X[ofs + 40, 3] = complex(float("nan"), 1.0)
                    A = X.to(dev)
                    f_p, piv_p, perm_p, info_p = offset_panel_lu_cabs1(A, ofs, pivot)
                    for route, block in (("cluster", 0), ("grid", -1)):
                        P = A.clone()
                        plan = panel_plan(H_c, w_c, dt, ofs=ofs, block=block)
                        g0 = offset_panel_factor_c64_cuda.counts.grid_route_launches
                        piv_k, perm_k, info_k = offset_panel_factor_c64_cuda(P, ofs, pivot,
                                                                             block=block)
                        torch.cuda.synchronize()
                        same = {
                            "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                            "perm_equal": bool(torch.equal(perm_k, perm_p)),
                            "info_equal": int(info_k) == int(info_p),
                            "bitwise": cbits_nan_equal(P, f_p),
                            "rows_above_untouched": bool(torch.equal(cbits(P[:ofs]),
                                                                     cbits(A[:ofs]))),
                            "route_as_expected": plan["route"] == route and (
                                offset_panel_factor_c64_cuda.counts.grid_route_launches - g0
                                == int(route == "grid")),
                        }
                        if name == "zero_col":
                            same["info_as_expected"] = int(info_k) == (6 if pivot else -6)
                        if name == "nan":
                            same["nan_takes_row_H_minus_1"] = bool((piv_k[3:] == H_c - 1).all())
                        err = float(torch.view_as_real(P - f_p).abs().nan_to_num(0.0, 0.0, 0.0)
                                    .max())
                        coffset_err[route] = max(coffset_err[route], err)
                        emit("kernel", kernel="panel_lu_c64_offset", route=route,
                             shape=[H_c, w_c], ofs=ofs, dtype=str(dt)[6:], input=name,
                             pivot=pivot, plan=plan, info=int(info_k), max_abs_err=err, **same)
                        if not all(same.values()):
                            fail(f"the complex offset kernel disagrees with its plain "
                                 f"version: {same}")
                    del X, A, P
        M = crandn(4096, 8 * 128, c64).to(dev)
        W_ = M.clone()
        view = W_[:, 256:384]
        f_p, piv_p, perm_p, info_p = offset_panel_lu_cabs1(M[:, 256:384], 1000, True)
        piv_k, perm_k, info_k = offset_panel_factor_c64_cuda(view, 1000, True)
        torch.cuda.synchronize()
        rest = torch.ones(M.shape, dtype=torch.bool, device=dev)
        rest[1000:, 256:384] = False
        same = {"ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": cbits_nan_equal(view, f_p),
                "rest_untouched": bool(torch.equal(cbits(W_[rest]), cbits(M[rest])))}
        emit("kernel", kernel="panel_lu_c64_offset", route="cluster", shape=[4096, 128],
             lda=8 * 128, ofs=1000, dtype="complex64", input="column block", pivot=True,
             info=int(info_k), **same)
        if not all(same.values()):
            fail(f"the complex offset kernel on a column block: {same}")
        del M, W_, view, rest
        for bad, exc in ((lambda: panel_plan(64, 8, c64, ofs=57), RuntimeError),
                         (lambda: offset_panel_factor_c64_cuda(
                             torch.zeros(64, 8, device=dev, dtype=c64), 57, True), ValueError),
                         (lambda: offset_panel_factor_c64_cuda(
                             torch.zeros(64, 8, device=dev), 0, True), ValueError)):
            try:
                bad()
            except exc:
                continue
            fail("the complex offset kernel took a request it must refuse")

    # ---- 2g. the bf16x3 form of the panel kernel vs plain -------------------
    if not batched_only:
        bf16x3_err = bf16x3_kernel_phase(dev, gen)

    # ---- 2b. batched kernels vs plain -----------------------------------
    def same_bits(x, y):
        """Bitwise equal, NaN for NaN: a NaN's sign and payload are not
        compared (in f64 the card propagates an operand's NaN, and the
        plain version's torch ops and the kernels' rsub may pass on
        another one)."""
        x, y = x.contiguous(), y.contiguous()
        nx, ny = torch.isnan(x), torch.isnan(y)
        return bool(torch.equal(nx, ny)
                    and torch.equal(bits(x.masked_fill(nx, 0)), bits(y.masked_fill(ny, 0))))

    def abs_err(x, y):
        return float((x - y).abs().nan_to_num(0.0, 0.0, 0.0).max()) if x.numel() else 0.0

    def batch_input(name, B, m, n, dt, pivot):
        """(batch on the card, info expected per matrix or None)."""
        if name == "ties":
            return torch.randint(-2, 3, (B, m, n), generator=gen).to(dt).to(dev), None
        X = torch.randn(B, m, n, generator=gen, dtype=dt)
        if not pivot:
            X += max(m, n) * torch.eye(m, n, dtype=dt)
        want = torch.zeros(B, dtype=torch.int32)
        if name == "inf_nan":
            # in every fifth matrix a row that wins the first pivot carries
            # inf and NaN into the U row, so later candidates are NaN
            for i in range(1, B, 5):
                r = (i // 5) % m
                X[i, r, 0] = 1e3
                X[i, r, 1 % n] = float("inf")
                X[i, r, 2 % n] = float("nan")
            return X.to(dev), None
        if name == "nan_used_last" and m > 1 and n > 1:
            # in every third matrix row m - 1 wins the first pivot, and a NaN
            # in row 0 of column 1 then makes the NaN rule pick row m - 1
            # again (the noswap mode: a row that is used already)
            X[::3, m - 1, 0] = 1e3
            X[::3, 0, 1] = float("nan")
            return X.to(dev), None
        if name == "zero_col":
            # a zeroed column in every seventh matrix, at a column that
            # changes with the matrix
            for i in range(3, B, 7):
                c = i % min(m, n)
                X[i, :, c] = 0
                want[i] = c + 1 if pivot else -(c + 1)
        return X.to(dev), want.to(dev)

    batched_err = {k: 0.0 for k in BATCHED_KERNELS}
    lu_shapes = [(1000, 16, 16), (1000, 64, 64), (37, 128, 128), (37, 96, 40), (37, 40, 96),
                 # the routes' boundaries (warp: m, n <= 32; block: up to 128),
                 # batches that are not a multiple of the warp route's matrices
                 # per block (4 or 8), tall and wide batches (the tile route)
                 (5, 1, 1), (5, 31, 31), (5, 32, 32), (5, 33, 33), (5, 32, 40), (5, 40, 32),
                 (5, 20, 32), (1, 16, 16), (3, 32, 32), (1001, 16, 16), (1001, 32, 32),
                 (9, 300, 24), (9, 40, 200),
                 # the noswap mode's warp widths and block grids (8, 17, 127)
                 (37, 8, 8), (37, 17, 17), (37, 127, 127)]
    inputs = (("randn", True), ("zero_col", True), ("ties", True), ("inf_nan", True),
              ("nan_used_last", True), ("randn", False), ("zero_col", False))
    n_cases = 0
    for (B, m, n) in lu_shapes:
        for dt in (torch.float32, torch.float64):
            for name, pivot in inputs:
                A, want = batch_input(name, B, m, n, dt, pivot)
                own = bk.lu_route(m, n)
                # every shape on its own route and on the tile route (the
                # original design), square ones on the noswap kernel too: its own
                # route and (n <= 32) the block route forced
                runs = [own] + (["tile"] if own != "tile" else [])
                if m == n:
                    runs += ["noswap_" + r for r in dict.fromkeys((bk.noswap_route(n), "block"))]
                plain = bk.batched_lu_plain(A, pivot, True)
                plain_noswap = bk.batched_lu_noswap_plain(A, pivot) if m == n else None
                for route in runs:
                    if not route.startswith("noswap_"):
                        kern = ROUTE_KERNEL[route]
                        f_p, ipiv_p, perm_p, info_p = plain
                        before = dict(bk.batched_lu_cuda.route_launches)
                        f_k, ipiv_k, perm_k, info_k = bk.batched_lu_cuda(A, pivot, True, route=route)
                        torch.cuda.synchronize()
                        after = bk.batched_lu_cuda.route_launches
                        same = {
                            "ipiv_equal": bool(torch.equal(ipiv_k, ipiv_p)),
                            "perm_is_folded_ipiv": bool(torch.equal(
                                perm_k, rt.batched_ipiv_to_perm(ipiv_k, m))),
                            "one_launch_on_route": after[route] - before[route] == 1
                            and sum(after.values()) - sum(before.values()) == 1,
                        }
                        _, _, none_perm, _ = bk.batched_lu_cuda(A, pivot, False, route=route)
                        same["no_perm_is_none"] = none_perm is None
                    else:
                        nroute = route[len("noswap_"):]
                        kern = NOSWAP_KERNEL[nroute]
                        f_p, perm_p, info_p = plain_noswap
                        before = dict(bk.batched_lu_noswap_cuda.route_launches)
                        f_k, perm_k, info_k = bk.batched_lu_noswap_cuda(A, pivot, route=nroute)
                        torch.cuda.synchronize()
                        after = bk.batched_lu_noswap_cuda.route_launches
                        same = {"one_launch_on_route": after[nroute] - before[nroute] == 1
                                and sum(after.values()) - sum(before.values()) == 1}
                    same.update(
                        perm_equal=bool(torch.equal(perm_k, perm_p)),
                        info_equal=bool(torch.equal(info_k, info_p)),
                        bitwise=same_bits(f_k, f_p),
                    )
                    if want is not None:
                        same["info_as_expected"] = bool(torch.equal(info_k, want))
                    err = abs_err(f_k, f_p)
                    batched_err[kern] = max(batched_err[kern], err)
                    n_cases += 1
                    emit("batched_kernel", kernel=kern, shape=[B, m, n], dtype=str(dt)[6:],
                         input=name, pivot=pivot, nonzero_info=int((info_k != 0).sum()),
                         max_abs_err=err, **same)
                    if not all(same.values()):
                        fail(f"{kern} disagrees with its plain version: {same}")
    # the solve kernel on each shape's own route (ops/batched_kernel.py
    # solve_route: warp at n <= 32, wide up to 128): the warp route's lane
    # counts (1, 8, 15, 16, 17, 31, 32), the wide route's rows per lane (33,
    # 48, 64: two; 96: three; 127, 128: four), batches that are not a multiple
    # of either's matrices per block, no row order, perm or ipiv, one
    # right-hand side as a vector, as a column and 5 (one full and one partial
    # pass of 4), a zero on U's diagonal in one matrix of each batch (inf / NaN
    # there and only there)
    solve_cases = [(B, n) for n in (1, 8, 15, 16, 17, 31, 32) for B in (1, 3, 37, 1001)]
    solve_cases += [(B, n) for n in (33, 48, 96, 127) for B in (1, 37)]
    solve_cases += [(1000, 64), (37, 128), (1001, 128)]
    solve_err = dict.fromkeys(bk.SOLVE_ROUTES, 0.0)
    for (B, n) in solve_cases:
        for dt in (torch.float32, torch.float64):
            A, _ = batch_input("randn", B, n, n, dt, True)
            f, ipiv, perm, info = bk.batched_lu_cuda(A, True, True)
            sing = B // 2
            f[sing, n // 2, n // 2] = 0  # a zero on U's diagonal
            ok_rows = torch.ones(B, dtype=torch.bool, device=dev)
            ok_rows[sing] = False
            route = bk.solve_route(n, 1)
            for nrhs in (None, 1, 5):
                b = torch.randn((B, n) if nrhs is None else (B, n, nrhs),
                                generator=gen, dtype=dt).to(dev)
                want = {"none": bk.batched_solve_plain(f, b),
                        "perm": bk.batched_solve_plain(f, b, perm=perm)}
                want["ipiv"] = want["perm"]
                for order, kw in (("none", {}), ("perm", {"perm": perm}),
                                  ("ipiv", {"ipiv": ipiv})):
                    before = dict(bk.batched_solve_cuda.route_launches)
                    x_k = bk.batched_solve_cuda(f, b, route=route, **kw)
                    torch.cuda.synchronize()
                    after = bk.batched_solve_cuda.route_launches
                    x_p = want[order]
                    finite_k = torch.isfinite(x_k.reshape(B, -1)).all(dim=1)
                    same = {
                        "bitwise": same_bits(x_k, x_p),
                        "nonfinite_only_where_singular": bool(torch.equal(
                            finite_k, ok_rows)),
                        "one_launch_on_route": after[route] - before[route] == 1
                        and sum(after.values()) - sum(before.values()) == 1,
                    }
                    err = abs_err(x_k[ok_rows], x_p[ok_rows])
                    solve_err[route] = max(solve_err[route], err)
                    kern = SOLVE_KERNEL[route]
                    batched_err[kern] = max(batched_err[kern], err)
                    n_cases += 1
                    emit("batched_kernel", kernel=kern, shape=[B, n, n],
                         rhs=list(b.shape), order=order, route=route,
                         dtype=str(dt)[6:], max_abs_err=err, **same)
                    if not all(same.values()):
                        fail(f"batched_solve ({route} route) disagrees with its plain "
                             f"version: {same}")
    for bad in (lambda: bk.batched_solve_cuda(torch.zeros(4, 33, 33, device=dev),
                                              torch.zeros(4, 33, device=dev), route="warp"),
                lambda: bk.batched_solve_cuda(torch.zeros(4, 32, 32, device=dev),
                                              torch.zeros(4, 32, device=dev), route="wide"),
                lambda: bk.batched_solve_cuda(torch.zeros(4, 8, 8, device=dev),
                                              torch.zeros(4, 8, device=dev), route="tile"),
                lambda: bk.batched_solve_cuda(torch.zeros(4, 8, 8, device=dev),
                                              torch.zeros(4, 8, device=dev), route="block"),
                lambda: bk.batched_lu_noswap_cuda(torch.zeros(4, 8, 8, device=dev),
                                                  route="tile"),
                lambda: bk.batched_lu_noswap_cuda(torch.zeros(4, 33, 33, device=dev),
                                                  route="warp"),
                lambda: bk.batched_lu_noswap_cuda(torch.zeros(4, 8, 8, device=dev),
                                                  route="wide")):
        try:
            bad()
        except ValueError:
            continue
        fail("a batched wrapper took a route that does not take the shape")
    # what the wrappers refuse, and a strided batch (copied, not refused)
    for bad in (torch.zeros(4, 8, 8, device=dev, dtype=torch.float16),
                torch.zeros(4, 129, 129, device=dev),
                torch.zeros(8, 8, device=dev)):
        try:
            bk.batched_lu_cuda(bad)
        except ValueError:
            continue
        fail(f"batched_lu_cuda took {tuple(bad.shape)} {bad.dtype}")
    S = torch.randn(9, 24, 48, generator=gen).to(dev)[:, :, ::2]
    if not same_bits(bk.batched_lu_cuda(S)[0], bk.batched_lu_plain(S)[0]):
        fail("strided batch: kernel and plain version differ")
    emit("batched_kernel", summary=True, cases=n_cases, max_abs_err=batched_err)


    # ---- 4b (defined here: --batched runs it right after 2b) -------------
    NS_TIMED = (8, 16, 24, 32, 48, 64, 96, 128)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def occupancy(plan, batch=BATCH_B):
        """A kernel's plan with what caps its blocks per SM (threads, the
        32-block limit, shared memory, registers) and its waves over a
        batch of ``batch`` matrices."""
        warps = -(-plan["threads"] // 32)
        regs_warp = -(-plan["registers"] * 32 // 256) * 256
        caps = {"threads": 2048 // plan["threads"], "blocks": 32,
                "shared_memory": 233472 // (plan["smem"] + plan["static_smem"] + 1024),
                "registers": 65536 // (regs_warp * warps)}
        grid = -(-batch // plan["per_block"])
        plan.update(caps=caps, capped_by=[k for k, v in caps.items()
                                          if v == plan["blocks_per_sm"]],
                    grid=grid, sms=sms, waves=grid / (plan["blocks_per_sm"] * sms),
                    resident_matrices_per_sm=plan["blocks_per_sm"] * plan["per_block"])
        return plan

    def lu_occupancy(n, route, dt=torch.float32, swap=True):
        """The swap (or noswap) kernel's plan at (n, n) with its caps and
        waves."""
        return occupancy(bk.lu_plan(n, n, dt, route, swap=swap))

    # clock64() stamps of one step of thread 0 of block 0, by route (the
    # phases are listed above each kernel in csrc/batched_lu.cu; the noswap
    # mode stamps the same phases on the warp and block routes): (a, b)
    # pairs of stamps summed into each part
    trace_parts = {
        "tile": {"search": [(0, 1)], "swap_scale": [(2, 3)], "update": [(4, 5)],
                 "barrier": [(1, 2), (3, 4), (5, 6)], "step": [(0, 6)]},
        "warp": {"search": [(0, 1)], "exchange": [(1, 2)], "update": [(2, 3)],
                 "step": [(0, 3)]},
        "block": {"search": [(1, 2)], "publish": [(2, 3)], "update": [(4, 5)],
                  "barrier": [(0, 1), (3, 4)], "step": [(0, 5)]},
    }
    trace_lib = []

    def lu_trace(A, route, swap=True):
        """Where a step of the swap (or noswap) kernel's ``route`` goes, from
        the trace build of csrc/batched_lu.cu (a separate library) on the
        batch A."""
        if not trace_lib:
            trace_lib.append(_kernels.load("batched_lu_trace"))
        lib = trace_lib[0]
        B, m, n = A.shape
        k = min(m, n)
        buf = torch.zeros(8 * k + 4, dtype=torch.int64, device=dev)
        out = torch.empty_like(A)
        ipiv = torch.empty((B, k), dtype=torch.int32, device=dev)
        perm = torch.empty((B, m), dtype=torch.int32, device=dev)
        info = torch.empty(B, dtype=torch.int32, device=dev)
        f64 = A.element_size() == 8
        stream = torch.cuda.current_stream().cuda_stream
        r = bk.LU_ROUTES.index(route) + 1
        if swap:
            fn = lib.rf_batched_lu_swap_f64 if f64 else lib.rf_batched_lu_swap_f32
            args = (A.data_ptr(), out.data_ptr(), ipiv.data_ptr(), perm.data_ptr(),
                    info.data_ptr(), B, m, n, 1, r,
                    bk.lu_smem_bytes(m, n, A.element_size(), route),
                    torch.cuda.current_device(), stream)
        else:
            fn = lib.rf_batched_lu_noswap_f64 if f64 else lib.rf_batched_lu_noswap_f32
            args = (A.data_ptr(), out.data_ptr(), perm.data_ptr(), info.data_ptr(), B, n, 1, r,
                    bk.noswap_smem_bytes(n, A.element_size(), route),
                    torch.cuda.current_device(), stream)
        _kernels.check(lib, fn(*args), "trace build launch")  # warm
        torch.cuda.synchronize()
        _kernels.check(lib, lib.rf_batched_lu_set_trace(buf.data_ptr()), "set trace")
        try:
            _kernels.check(lib, fn(*args), "trace build launch")
            torch.cuda.synchronize()
        finally:
            lib.rf_batched_lu_set_trace(None)
        t = buf.cpu().double()
        st, tail = t[:8 * k].view(k, 8), t[8 * k:]
        ghz = float((tail[3] - tail[1]) / (tail[2] - tail[0]))
        ns = {}
        for part, pairs in trace_parts[route].items():
            v = sum((st[:, b_] - st[:, a_] for a_, b_ in pairs), torch.zeros(k, dtype=torch.float64))
            ns[part] = float(v.median()) / ghz
        # the steps' halves: on the noswap block route every row slot stays in
        # the update, on the swap route the finished ones drop out
        step = sum((st[:, b_] - st[:, a_] for a_, b_ in trace_parts[route]["step"]),
                   torch.zeros(k, dtype=torch.float64)) / ghz
        return dict(route=route, mode="swap" if swap else "noswap", sm_ghz=ghz,
                    step_ns_median=ns.pop("step"), phase_ns_median=ns,
                    step_ns_first_half_mean=float(step[:k // 2].mean()) if k > 1 else None,
                    step_ns_second_half_mean=float(step[k // 2:].mean()),
                    first_block_us=float(tail[2] - tail[0]) / 1e3)

    def batched_timing():
        """Phase 4b: the swap kernel on its own route and on the tile route
        (the original design) per n, the noswap kernel and the solve on their
        own routes, and the factor+solve pairs, in turns beside the library; each
        route's plan and occupancy, and (n = 16, 32, 64, 128) a step's
        phases from the trace build, both modes."""
        rows = {}
        for n in NS_TIMED:
            A = torch.randn(BATCH_B, n, n, generator=gen).to(dev)
            b = torch.randn(BATCH_B, n, generator=gen).to(dev)
            f, perm, _ = rt.batched_lu_factor_perm(A)
            _, ipiv, _ = rt.batched_lu_factor(A)
            rhs = b.gather(1, perm.long())
            lib_lu, lib_piv, _ = torch.linalg.lu_factor_ex(A)
            ident = torch.arange(1, n + 1, dtype=lib_piv.dtype, device=dev).repeat(BATCH_B, 1)
            route = bk.lu_route(n, n)
            nroute = bk.noswap_route(n)

            def lib_fs():
                LU_, piv, _ = torch.linalg.lu_factor_ex(A)
                torch.linalg.lu_solve(LU_, piv, b[:, :, None])

            fns = {
                "swap": lambda: bk.batched_lu_cuda(A, True, True),
                "swap_no_perm": lambda: bk.batched_lu_cuda(A, True, False),
                "perm_factor_solve": lambda: rt.batched_lu_solve_perm(
                    *rt.batched_lu_factor_perm(A)[:2], b),
                "ipiv_factor_solve": lambda: rt.batched_lu_solve(
                    *rt.batched_lu_factor(A)[:2], b),
                "noswap_factor_solve": lambda: rt.batched_lu_solve_perm(
                    *bk.batched_lu_noswap(A)[:2], b),
            }
            if route != "tile":
                fns["swap_tile"] = lambda: bk.batched_lu_cuda(A, True, True, route="tile")
            solve_route = bk.solve_route(n, 1)
            if n in (16, 32, 64):
                # eight right-hand sides: two passes of the warp or wide route
                rhs8 = torch.randn(BATCH_B, n, 8, generator=gen).to(dev)
                fns["solve_nrhs8"] = lambda: bk.batched_solve_cuda(f, rhs8)
                fns["library_solve_nrhs8"] = lambda: torch.linalg.lu_solve(f, ident, rhs8)
            fns.update({
                "noswap": lambda: bk.batched_lu_noswap_cuda(A, True),
                "solve": lambda: bk.batched_solve_cuda(f, rhs),
                "solve_with_perm": lambda: bk.batched_solve_cuda(f, b, perm=perm),
                "solve_with_ipiv": lambda: bk.batched_solve_cuda(f, b, ipiv=ipiv),
                "ipiv_to_perm": lambda: rt.batched_ipiv_to_perm(ipiv, n),
                "library_factor": lambda: torch.linalg.lu_factor_ex(A),
                # the same function as the solve kernel: no row exchange
                "library_solve": lambda: torch.linalg.lu_solve(f, ident, rhs[:, :, None]),
                "library_solve_with_pivots": lambda: torch.linalg.lu_solve(
                    lib_lu, lib_piv, b[:, :, None]),
                "library_factor_solve": lib_fs,
            })
            t = round_robin(fns, inner=4)
            dev_t = {k: device_ms(fns[k]) for k in (
                "swap", "swap_tile", "noswap", "solve",
                "solve_with_perm", "solve_with_ipiv", "library_factor", "library_solve",
                "solve_nrhs8", "library_solve_nrhs8",
                "perm_factor_solve", "ipiv_factor_solve") if k in fns}
            plain = {
                "swap": timed(lambda: bk.batched_lu_plain(A, True, True), reps=1, warm=0)[0],
                "noswap": timed(lambda: bk.batched_lu_noswap_plain(A, True), reps=1, warm=0)[0],
                "solve": timed(lambda: bk.batched_solve_plain(f, rhs), reps=1, warm=0)[0],
            }
            bounds = {
                "swap": batched_lu_bound(BATCH_B, n, n, "float32", 4),
                "noswap": batched_lu_bound(BATCH_B, n, n, "float32", 4),
                "solve": batched_solve_bound(BATCH_B, n, 1, "float32", 4),
            }
            plans = {("swap", r): lu_occupancy(n, r) for r in dict.fromkeys((route, "tile"))}
            plans[("noswap", nroute)] = lu_occupancy(n, nroute, swap=False)
            plans[("solve", solve_route)] = occupancy(bk.solve_plan(n, 1, torch.float32,
                                                                    solve_route))
            traces = {}
            if n in (16, 32, 64, 128):
                traces[("swap", route)] = lu_trace(A, route)
                traces[("noswap", nroute)] = lu_trace(A, nroute, swap=False)
                traces[("swap", "tile")] = lu_trace(A, "tile")
            swaps = [k for k in ("swap", "swap_tile", "noswap") if k in t]
            rows[n] = dict(t=t, dev=dev_t, plain=plain, bounds=bounds, route=route)
            emit("timing", what="batched", card=card, batch=BATCH_B, n=n,
                 dtype="float32", route=route, noswap_route=nroute, solve_route=solve_route,
                 kernel_ms=t, device_ms=dev_t, plain_ms=plain,
                 bound_ms={k: v[0] for k, v in bounds.items()},
                 bound_by={k: v[1] for k, v in bounds.items()},
                 launches_per_timing=4,
                 us_per_step={k: 1e3 * t[k] / n for k in swaps},
                 over_library={k: t[k] / t["library_factor"] for k in swaps},
                 device_over_library={k: dev_t[k] / dev_t["library_factor"] for k in swaps},
                 solve_device_over_library=dev_t["solve"] / dev_t["library_solve"],
                 noswap_over_swap=t["noswap"] / t["swap"],
                 noswap_device_over_swap=dev_t["noswap"] / dev_t["swap"])
            for (mode, r), plan in plans.items():
                kern = {"swap": ROUTE_KERNEL, "noswap": NOSWAP_KERNEL,
                        "solve": SOLVE_KERNEL}[mode][r]
                emit("timing", what="batched_plan", card=card, batch=BATCH_B, n=n,
                     dtype="float32", kernel=kern, **plan, trace=traces.get((mode, r)))
            del A, b, f, rhs, lib_lu

        # f64 at the main size: the same kernels on the card's f64 units;
        # the solve with 1 and 8 right-hand sides beside lu_solve
        A = torch.randn(BATCH_B, 64, 64, generator=gen, dtype=torch.float64).to(dev)
        b = torch.randn(BATCH_B, 64, generator=gen, dtype=torch.float64).to(dev)
        b8 = torch.randn(BATCH_B, 64, 8, generator=gen, dtype=torch.float64).to(dev)
        f, perm, _ = rt.batched_lu_factor_perm(A)
        rhs = b.gather(1, perm.long())
        ident = torch.arange(1, 65, dtype=torch.int32, device=dev).repeat(BATCH_B, 1)
        fns = {
            "swap": lambda: bk.batched_lu_cuda(A, True, True),
            "swap_tile": lambda: bk.batched_lu_cuda(A, True, True, route="tile"),
            "noswap": lambda: bk.batched_lu_noswap_cuda(A, True),
            "solve": lambda: bk.batched_solve_cuda(f, rhs),
            "solve_nrhs8": lambda: bk.batched_solve_cuda(f, b8),
            "solve_with_perm": lambda: bk.batched_solve_cuda(f, b, perm=perm),
            "library_factor": lambda: torch.linalg.lu_factor_ex(A),
            "library_solve": lambda: torch.linalg.lu_solve(f, ident, rhs[:, :, None]),
            "library_solve_nrhs8": lambda: torch.linalg.lu_solve(f, ident, b8),
        }
        t = round_robin(fns, inner=4)
        dev_t = {k: device_ms(f_) for k, f_ in fns.items() if k != "solve_with_perm"}
        plans = {ROUTE_KERNEL[r]: lu_occupancy(64, r, torch.float64) for r in ("block", "tile")}
        plans[NOSWAP_KERNEL["block"]] = lu_occupancy(64, "block", torch.float64, swap=False)
        plans[SOLVE_KERNEL["wide"]] = occupancy(bk.solve_plan(64, 1, torch.float64, "wide"))
        f64_bounds = {"swap": batched_lu_bound(BATCH_B, 64, 64, "float64", 8),
                      "solve": batched_solve_bound(BATCH_B, 64, 1, "float64", 8)}
        emit("timing", what="batched", card=card, batch=BATCH_B, n=64,
             dtype="float64", kernel_ms=t, device_ms=dev_t, launches_per_timing=4,
             bound_ms={k: v[0] for k, v in f64_bounds.items()},
             bound_by={k: v[1] for k, v in f64_bounds.items()},
             noswap_device_over_swap=dev_t["noswap"] / dev_t["swap"], plans=plans)
        rows["f64"] = dict(t=t, dev=dev_t, bounds=f64_bounds)
        del A, b, b8, f, rhs
        # the wide route at n = 128 in f64: one matrix's tile is 33.8 KB
        A = torch.randn(BATCH_B, 128, 128, generator=gen, dtype=torch.float64).to(dev)
        b = torch.randn(BATCH_B, 128, generator=gen, dtype=torch.float64).to(dev)
        f, perm, _ = rt.batched_lu_factor_perm(A)
        rhs = b.gather(1, perm.long())
        ident = torch.arange(1, 129, dtype=torch.int32, device=dev).repeat(BATCH_B, 1)
        fns = {"solve": lambda: bk.batched_solve_cuda(f, rhs),
               "library_solve": lambda: torch.linalg.lu_solve(f, ident, rhs[:, :, None])}
        dev_t = {k: device_ms(f_) for k, f_ in fns.items()}
        plans = {SOLVE_KERNEL["wide"]: occupancy(bk.solve_plan(128, 1, torch.float64, "wide"))}
        emit("timing", what="batched_solve", card=card, batch=BATCH_B, n=128,
             dtype="float64", device_ms=dev_t,
             bound_ms=batched_solve_bound(BATCH_B, 128, 1, "float64", 8)[0], plans=plans)
        del A, b, f, rhs
        # the tall batch of the main path (tile route) beside the library
        A = torch.randn((TALL_B,) + TALL_SHAPE, generator=gen).to(dev)
        fns = {"swap": lambda: bk.batched_lu_cuda(A, True, True),
               "library_factor": lambda: torch.linalg.lu_factor_ex(A)}
        t = round_robin(fns, inner=4)
        dev_t = {k: device_ms(f_) for k, f_ in fns.items()}
        plain = {"swap": timed(lambda: bk.batched_lu_plain(A, True, True), reps=1, warm=0)[0]}
        bounds = {"swap": batched_lu_bound(TALL_B, *TALL_SHAPE, "float32", 4)}
        rows["tall"] = dict(t=t, dev=dev_t, plain=plain, bounds=bounds)
        emit("timing", what="batched", card=card, batch=TALL_B, shape=list(TALL_SHAPE),
             dtype="float32", route=bk.lu_route(*TALL_SHAPE), kernel_ms=t, device_ms=dev_t,
             plain_ms=plain,
             bound_ms=bounds["swap"][0], bound_by=bounds["swap"][1], launches_per_timing=4)
        del A
        # the register routes' ptxas lines: no stack frame, no spill
        log = _kernels.BUILD_LOG.get("batched_lu", {}).get("log", "").splitlines()
        lines = []
        for i, ln in enumerate(log):
            if "Compiling entry" in ln and ("batched_lu_warp" in ln or "batched_lu_block" in ln):
                lines.append(" | ".join(x.strip() for x in log[i:i + 4]))
        slog = _kernels.BUILD_LOG.get("batched_solve", {}).get("log", "").splitlines()
        for i, ln in enumerate(slog):
            if "Compiling entry" in ln and ("batched_solve_warp" in ln or "batched_solve_wide" in ln):
                lines.append(" | ".join(x.strip() for x in slog[i:i + 4]))
        # the LU's warp route (both modes) has no local memory at all; the
        # solve's register kernels may keep a frame for the division's
        # slow-path call (up to 16 bytes: every f64 instance of the wide
        # route has one), but never a larger one that could hold the x they
        # keep (warp: a row of N values; wide: R x RC values)
        def frame(ln):
            return int(ln.split(" bytes stack frame")[0].rsplit("|", 1)[-1].strip())

        def held_bytes(ln):
            for kind in ("batched_solve_warp_kernelI", "batched_solve_wide_kernelI"):
                if kind in ln:
                    name = ln.split(kind, 1)[1]
                    size = 8 if name[0] == "d" else 4
                    a_, b_ = (int(v.split("E", 1)[0]) for v in name.split("Li", 3)[1:3])
                    return size * (a_ if "warp" in kind else a_ * b_)
            return 0

        spills = [ln for ln in lines if "batched_lu_warp" in ln
                  and not ("0 bytes stack frame" in ln and "0 bytes spill stores" in ln)]
        spills += [ln for ln in lines if "batched_solve_" in ln
                   and frame(ln) > 16 and frame(ln) >= held_bytes(ln)]
        emit("timing", what="batched_ptxas", card=card, lines=lines, register_route_spills=spills)
        if spills:
            fail(f"register route kernels keep their values in local memory: {spills}")
        return rows

    if batched_only:
        with torch.no_grad():
            batched_timing()
        print(json.dumps({"ok": True, "batched_only": True}))
        return 0

    if quick:
        print(json.dumps({"ok": True, "quick": True}))
        return 0

    # ---- 3. main path ----------------------------------------------------
    matmuls = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul,
               torch.Tensor.__matmul__, torch.Tensor.mm, torch.addmm,
               torch.Tensor.addmm_, torch.linalg.solve_triangular}
    from torch.overrides import TorchFunctionMode

    def tf32_allowed():
        mm = torch.backends.cuda.matmul
        try:
            return bool(mm.allow_tf32)
        except RuntimeError:  # PyTorch refuses the legacy flag once the current API is set
            return mm.fp32_precision == "tf32"

    class TF32Watch(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.flags = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls:
                self.flags.append(tf32_allowed())
            return func(*args, **(kwargs or {}))

    def wide(t):
        return t.to(torch.complex128) if t.is_complex() else t.double()

    def resid_gate(A, F):
        n = A.shape[0]
        eps = torch.finfo(A.dtype).eps
        r = float((wide(F.L) @ wide(F.U) - wide(A)[F.p.long()]).abs().max())
        g = 20 * n * eps * float(A.abs().max())
        return r, g

    def solve_resid(A, x, b):
        Ad, xd, bd = wide(A), wide(x), wide(b)
        return float((Ad @ xd - bd).norm() / (Ad.norm() * xd.norm()))

    rng = np.random.default_rng(0)
    mats = []
    n = 1536
    entry = rng.standard_normal((n, n)) + n * np.eye(n)
    randn = rng.standard_normal((n, n))
    sing = rng.standard_normal((n, n))
    zc = 700
    sing[:, zc] = 0.0
    mats += [("entry", entry), ("randn", randn), ("zero_col", sing)]
    mats += [("randn", rng.standard_normal((4096, 4096)))]
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the port must turn it off
    launches = {}
    for name, M in mats:
        n = M.shape[0]
        A = torch.tensor(M, dtype=torch.float32, device=dev)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
        route, (pm, pw) = main_shape(n)
        expect = 1 if route == "whole" else -(-n // pw)
        watch = TF32Watch()
        reset_counts()
        with watch:
            F = rt.lu(A, check=False)
            x = rt.lu_solve(F, b)
            torch.cuda.synchronize()
        got = panel_factor_cuda.counts.launches
        launches[(n, name)] = got
        if panel_factor_cuda.counts.grid_route_launches:
            fail("a main-path panel took the grid route")
        r, g = resid_gate(A, F)
        sr = solve_resid(A, x, b)
        info = int(F.info)
        rec = dict(n=n, input=name, route=route, launches=got,
                   expected_launches=expect, resid=r, gate=g,
                   scaled_resid=r / (n * torch.finfo(torch.float32).eps * float(A.abs().max())),
                   solve_rel_resid=sr, info=info,
                   matmuls=len(watch.flags), tf32_seen=any(watch.flags))
        if name == "zero_col":
            try:
                rt.lu(A, check=True)
                rec["check_raises"] = False
            except rt.SingularMatrixError:
                rec["check_raises"] = True
        emit("main", **rec)
        if got != expect:
            fail(f"panel kernel launched {got} times, expected {expect}")
        if not r < g:
            fail(f"residual {r} over the gate {g}")
        if name != "zero_col" and not np.isfinite(sr):
            fail("solve produced non-finite values")
        if watch.flags == [] or any(watch.flags):
            fail(f"TF32 products during the run: {watch.flags[:8]}")
        if name == "zero_col":
            if info != zc + 1 or not rec["check_raises"]:
                fail(f"singular matrix: info {info}, check_raises {rec['check_raises']}")
        elif info != 0:
            fail(f"info {info} on a nonsingular matrix")
    if torch.backends.cuda.matmul.allow_tf32 is not True:
        fail("the caller's TF32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before

    # PyTorch's current TF32 API: a caller who set fp32_precision = 'tf32'
    # still gets full-precision products, and the setting back
    n = 1536
    A = torch.tensor(entry, dtype=torch.float32, device=dev)
    b = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    mm = torch.backends.cuda.matmul
    precision_before = mm.fp32_precision
    mm.fp32_precision = "tf32"
    watch = TF32Watch()
    with watch:
        F = rt.lu(A, check=False)
        x = rt.lu_solve(F, b)
        torch.cuda.synchronize()
    restored = mm.fp32_precision == "tf32"
    mm.fp32_precision = precision_before
    r, g = resid_gate(A, F)
    rec = dict(n=n, input="entry", tf32_api="fp32_precision='tf32'", resid=r, gate=g,
               solve_rel_resid=solve_resid(A, x, b), info=int(F.info),
               matmuls=len(watch.flags), tf32_seen=any(watch.flags), restored=restored)
    emit("main", **rec)
    if not (r < g and rec["info"] == 0 and watch.flags and not any(watch.flags) and restored
            and rec["solve_rel_resid"] < 100 * torch.finfo(torch.float32).eps):
        fail(f"the current TF32 API: {rec}")

    # the generic route: an int32 matrix factors as its float64 copy, on the
    # float64 panel kernel; the solve of an int32 right-hand side in float64
    Ai = torch.tensor(rng.integers(-100, 100, (n, n)), dtype=torch.int32, device=dev)
    bi = torch.tensor(rng.integers(-100, 100, n), dtype=torch.int32, device=dev)
    route, (pm, pw) = main_shape(n)
    expect = 1 if route == "whole" else -(-n // pw)
    reset_counts()
    F = rt.lu(Ai, check=False)
    x = rt.lu_solve(F, bi)
    torch.cuda.synchronize()
    got = panel_factor_cuda.counts.launches
    G = rt.lu(Ai.double(), check=False)
    r, g = resid_gate(Ai.double(), F)
    rec = dict(n=n, input="randint(-100, 100)", dtype="int32",
               dispatch=rt.dispatch_route((n, n), torch.int32, True, cfg), launches=got,
               expected_launches=expect, factors_dtype=str(F.factors.dtype)[6:],
               solution_dtype=str(x.dtype)[6:], resid=r, gate=g,
               solve_rel_resid=solve_resid(Ai.double(), x, bi.double()), info=int(F.info),
               ipiv_equal_f64_run=bool(torch.equal(F.ipiv, G.ipiv)),
               perm_equal_f64_run=bool(torch.equal(F.p, G.p)),
               info_equal_f64_run=int(F.info) == int(G.info),
               factors_equal_f64_run=bool(torch.equal(F.factors, G.factors)))
    emit("main", **rec)
    if not (got == expect and panel_factor_cuda.counts.grid_route_launches == 0 and r < g
            and rec["info"] == 0 and rec["factors_dtype"] == rec["solution_dtype"] == "float64"
            and rec["ipiv_equal_f64_run"] and rec["perm_equal_f64_run"]
            and rec["info_equal_f64_run"] and rec["factors_equal_f64_run"]
            and np.isfinite(rec["solve_rel_resid"])):
        fail(f"the generic route: {rec}")
    del A, b, F, G, x, Ai, bi

    # ---- 3c. the complex and half-precision path -------------------------
    def cabs1(t):
        return t.real.abs() + t.imag.abs()

    def first_choice_gap_cabs1(A, piv_a, piv_b):
        """Two pivot sequences of one complex matrix part at step k.
        Eliminate k steps in complex128 on the card with the pivots they
        share and return k and ||c[a]| - |c[b]|| / max|c| (CABS1) for the
        two rows chosen there from column k."""
        k = int((piv_a != piv_b).nonzero()[0])
        M = A.to(torch.complex128).clone()
        for j, pj in enumerate(piv_a[:k].tolist()):
            if pj != j:
                M[[j, pj]] = M[[pj, j]]
            M[j + 1:, j] /= M[j, j]
            M[j + 1:, j + 1:] -= torch.outer(M[j + 1:, j], M[j, j + 1:])
        c = cabs1(M[:, k])
        return k, float((c[int(piv_a[k])] - c[int(piv_b[k])]).abs() / c[k:].max())

    def cnormal(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    n = 1536
    zsing = cnormal((n, n))
    zsing[:, zc] = 0.0
    cmats = [
        ("entry", torch.complex64, cnormal((n, n)) + n * np.eye(n)),
        ("randn", torch.complex64, cnormal((n, n))),
        ("zero_col", torch.complex64, zsing),
        ("randn", torch.complex64, cnormal((4096, 4096))),
        ("randn", torch.complex128, cnormal((n, n))),
        ("entry", torch.bfloat16, rng.standard_normal((n, n)) + n * np.eye(n)),
        ("entry", torch.float16, rng.standard_normal((n, n)) + n * np.eye(n)),
    ]
    del zsing
    torch.backends.cuda.matmul.allow_tf32 = True  # the port must turn it off
    launches_c = {}
    for name, dt, M in cmats:
        n = M.shape[0]
        cplx = dt.is_complex
        A = torch.tensor(M, device=dev).to(dt)
        bn = cnormal(n) if cplx else rng.standard_normal(n)
        b = torch.tensor(bn, device=dev).to(dt)
        route = rt.dispatch_route((n, n), torch.float32, True, cfg)
        expect = 1 if route == "whole" else -(-n // w_main)
        watch = TF32Watch()
        reset_counts()
        with watch:
            F = rt.lu(A, check=False)
            xs = {t: rt.lu_solve(F, b, trans=t) for t in ("N", "T", "H")}
            torch.cuda.synchronize()
        got = {"panel_lu": panel_factor_cuda.counts.launches,
               "panel_lu_c64": panel_factor_c64_cuda.counts.launches,
               "panel_lu_c64_grid_route": panel_factor_c64_cuda.counts.grid_route_launches}
        want = {"panel_lu": 0 if cplx else expect, "panel_lu_c64": expect if cplx else 0,
                "panel_lu_c64_grid_route": 0}
        launches_c[(n, name, dt)] = got["panel_lu_c64"]
        r, g = resid_gate(A, F)
        ops = {"N": A, "T": A.T, "H": A.mH}
        sr = {t: solve_resid(ops[t], xs[t], b) for t in xs}
        info = int(F.info)
        eps = torch.finfo(dt).eps
        rec = dict(n=n, input=name, dtype=str(dt)[6:], route=route,
                   dispatch=rt.dispatch_route((n, n), dt, True, cfg), launches=got,
                   expected_launches=want, resid=r, gate=g,
                   scaled_resid=r / (n * eps * float(A.abs().max())),
                   solve_rel_resid=sr, info=info, factors_dtype=str(F.factors.dtype)[6:],
                   matmuls=len(watch.flags), tf32_seen=any(watch.flags))
        if cplx:
            lib_piv = (torch.linalg.lu_factor_ex(A)[1] - 1).int()
            differ = int((F.ipiv != lib_piv).sum())
            rec["ipiv_steps_differing_from_library"] = differ
            rec["ipiv_near_tie_or_equal"] = True
            if differ and name != "zero_col":
                k, gap = first_choice_gap_cabs1(A, F.ipiv, lib_piv)
                rec["ipiv_first_difference"] = {"step": k, "gap": gap}
                rec["ipiv_near_tie_or_equal"] = gap <= n * eps
            # the CABS1 maximum bounds the modulus of a multiplier by sqrt(2)
            rec["multipliers_at_most_sqrt2"] = bool(
                name == "zero_col"
                or (torch.tril(F.factors, -1).abs() <= 2 ** 0.5 * (1 + 8 * eps)).all())
        else:
            G = rt.lu(A.float(), check=False)
            rec["pivots_equal_f32_run"] = bool(
                torch.equal(F.ipiv, G.ipiv) and torch.equal(F.p, G.p))
            rec["factors_are_rounded_f32_run"] = bool(
                torch.equal(F.factors, G.factors.to(dt)))
        if name == "zero_col":
            try:
                rt.lu(A, check=True)
                rec["check_raises"] = False
            except rt.SingularMatrixError:
                rec["check_raises"] = True
        emit("main", **rec)
        if got != want:
            fail(f"panel kernels launched {got}, expected {want}")
        if str(F.factors.dtype) != str(dt):
            fail(f"factors came back as {F.factors.dtype}, not {dt}")
        if not r < g:
            fail(f"residual {r} over the gate {g}")
        if watch.flags == [] or any(watch.flags):
            fail(f"TF32 products during the run: {watch.flags[:8]}")
        if name == "zero_col":
            if info != zc + 1 or not rec["check_raises"]:
                fail(f"singular matrix: info {info}, check_raises {rec['check_raises']}")
            continue
        if info != 0:
            fail(f"info {info} on a nonsingular matrix")
        # entry matrices are well conditioned: hold the solves to the type
        solve_gate = 100 * eps if name == "entry" else float("inf")
        if not all(np.isfinite(v) and v < solve_gate for v in sr.values()):
            fail(f"solve residuals {sr} (gate {solve_gate})")
        if cplx and not (rec["ipiv_near_tie_or_equal"]
                         and rec["multipliers_at_most_sqrt2"]):
            fail(f"pivots part from the library's beyond a tie: {rec}")
        if dt == torch.complex128 and differ:
            fail(f"complex128 pivots differ from the library's in {differ} steps")
        if not cplx and not (rec["pivots_equal_f32_run"]
                             and rec["factors_are_rounded_f32_run"]):
            fail(f"promote route differs from the float32 run: {rec}")
        del A, b, F, xs
    if torch.backends.cuda.matmul.allow_tf32 is not True:
        fail("the caller's TF32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    del cmats

    # ---- 3d. the opt-in schedules and the RBT solver ----------------------
    panel_wrappers = {"panel_lu": panel_factor_cuda, "panel_lu_c64": panel_factor_c64_cuda,
                      "panel_lu_micro_shadow": panel_factor_shadow_cuda,
                      "panel_lu_micro_basic": panel_factor_basic_cuda,
                      "panel_lu_noswap": panel_factor_noswap_cuda}
    opt_cfgs = {
        "physical": (rt.LUConfig(schedule="physical"), "panel_lu_noswap"),
        "shadow": (rt.LUConfig(panel_variant="shadow"), "panel_lu_micro_shadow"),
        "basic": (rt.LUConfig(panel_variant="basic"), "panel_lu_micro_basic"),
    }

    def first_choice_gap_perm(A, perm_a, perm_b):
        """Two row permutations of one square real matrix part at step k.
        Eliminate k steps in f64 on the card in the order both share and
        return k and ||c[a]| - |c[b]|| / max|c| for the two rows chosen
        there from column k."""
        k = int((perm_a != perm_b).nonzero()[0])
        pa = perm_a.long()
        M = A.double()[pa]
        for j in range(k):
            M[j + 1:, j] /= M[j, j]
            M[j + 1:, j + 1:] -= torch.outer(M[j + 1:, j], M[j, j + 1:])
        where_b = int((pa == int(perm_b[k])).nonzero()[0])
        c = M[:, k].abs()
        return k, float((c[k] - c[where_b]).abs() / c[k:].max())

    n = 1536
    omats = {
        ("entry", n): rng.standard_normal((n, n)) + n * np.eye(n),
        ("randn", n): rng.standard_normal((n, n)),
        ("zero_col", n): sing,
        ("randn", 4096): rng.standard_normal((4096, 4096)),
    }
    oruns = [("physical", "entry", n, f32), ("physical", "randn", n, f32),
             ("physical", "zero_col", n, f32), ("physical", "randn", 4096, f32),
             ("physical", "randn", n, f64)]
    for variant in ("shadow", "basic"):
        oruns += [(variant, "entry", n, f32), (variant, "randn", n, f32),
                  (variant, "randn", 4096, f32)]
    torch.backends.cuda.matmul.allow_tf32 = True  # the port must turn it off
    launches_o = {}
    for what, name, n, dt in oruns:
        ocfg, kern = opt_cfgs[what]
        A = torch.tensor(omats[(name, n)], dtype=dt, device=dev)
        b = torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)
        expect = -(-n // ocfg.resolved_panel_width())
        route = rt.dispatch_route((n, n), dt, True, ocfg)
        watch = TF32Watch()
        reset_counts()
        with watch:
            F = rt.lu(A, check=False, config=ocfg)
            x = rt.lu_solve(F, b)
            torch.cuda.synchronize()
        got = {k: wr.counts.launches for k, wr in panel_wrappers.items()}
        want = {k: (expect if k == kern else 0) for k in panel_wrappers}
        # every panel of these sizes fits a cluster: no grid-route launch
        grid_got = {k: wr.counts.grid_route_launches for k, wr in panel_wrappers.items()}
        launches_o.setdefault((what, name, n, dt), got[kern])
        r, g = resid_gate(A, F)
        sr = solve_resid(A, x, b)
        info = int(F.info)
        eps = torch.finfo(dt).eps
        F0 = rt.lu(A, check=False)  # the default route
        differ = int((F.p != F0.p).sum())
        rec = dict(config=what, n=n, input=name, dtype=str(dt)[6:], route=route,
                   launches=got, expected_launches=want, grid_route_launches=grid_got,
                   resid=r, gate=g,
                   scaled_resid=r / (n * eps * float(A.abs().max())),
                   solve_rel_resid=sr, info=info, matmuls=len(watch.flags),
                   tf32_seen=any(watch.flags),
                   perm_entries_differing_from_default_route=differ,
                   perm_near_tie_or_equal=True)
        if what == "physical":
            rec["ipiv_is_perm_prefix"] = bool(torch.equal(F.ipiv, F.p[:n]))
        else:
            rec["ipiv_folds_to_perm"] = bool(torch.equal(rt.ipiv_to_perm(F.ipiv, n), F.p))
        if differ and name != "zero_col":
            k, gap = first_choice_gap_perm(A, F.p, F0.p)
            rec["perm_first_difference"] = {"step": k, "gap": gap}
            rec["perm_near_tie_or_equal"] = gap <= n * eps
        if name == "zero_col":
            try:
                rt.lu(A, check=True, config=ocfg)
                rec["check_raises"] = False
            except rt.SingularMatrixError:
                rec["check_raises"] = True
        emit("main", **rec)
        if got != want:
            fail(f"{what}: panel kernels launched {got}, expected {want}")
        if any(grid_got.values()):
            fail(f"{what}: grid-route launches {grid_got}, expected none")
        if route != ("physical" if what == "physical" else "blocked"):
            fail(f"{what}: route {route}")
        if not r < g:
            fail(f"{what}: residual {r} over the gate {g}")
        if watch.flags == [] or any(watch.flags):
            fail(f"TF32 products during the run: {watch.flags[:8]}")
        if not rec.get("ipiv_is_perm_prefix", True) or not rec.get("ipiv_folds_to_perm", True):
            fail(f"{what}: ipiv and perm disagree")
        if name == "zero_col":
            if info != zc + 1 or not rec["check_raises"]:
                fail(f"singular matrix: info {info}, check_raises {rec['check_raises']}")
            continue
        if info != 0 or not np.isfinite(sr):
            fail(f"{what}: info {info}, solve residual {sr}")
        if name == "entry" and not sr < 100 * eps:
            fail(f"{what}: solve residual {sr} on the entry matrix")
        if not rec["perm_near_tie_or_equal"]:
            fail(f"{what}: pivots part from the default route's beyond a tie: {rec}")
        del A, b, F, F0, x
    if torch.backends.cuda.matmul.allow_tf32 is not True:
        fail("the caller's TF32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    del omats

    # RBT: pivot-free, so the panel kernel runs with pivot=False
    def wilkinson(n):
        W = np.tril(-np.ones((n, n)), -1) + np.eye(n)
        W[:, -1] = 1.0
        return W

    n = 800
    W, wb = wilkinson(n), rng.random(n)
    reset_counts()
    torch.backends.cuda.matmul.allow_tf32 = True
    watch = TF32Watch()
    with watch:
        ws = rt.butterfly_workspace(W, wb)
        xw, winfo = rt.butterfly_solve(ws, return_info=True)
        torch.cuda.synchronize()
    restored = torch.backends.cuda.matmul.allow_tf32 is True
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    werr = float(np.linalg.norm(W @ xw.cpu().numpy() - wb))
    rbt_launches = panel_factor_cuda.counts.launches
    rec = dict(what="rbt_wilkinson", n=n, dtype="float64", err_2norm=werr, gate=1e-10,
               info=int(winfo), launches={"panel_lu": rbt_launches},
               expected_launches={"panel_lu": -(-n // w_main)}, on_card=bool(xw.is_cuda),
               tf32_seen=any(watch.flags), tf32_restored=restored)
    emit("main", **rec)
    if not (werr <= 1e-10 and int(winfo) == 0 and xw.is_cuda and restored
            and rbt_launches == -(-n // w_main) and watch.flags and not any(watch.flags)):
        fail(f"RBT on the Wilkinson matrix: {rec}")
    n = 1536
    Ae = torch.tensor(rng.standard_normal((n, n)) + n * np.eye(n), dtype=f32, device=dev)
    be = torch.tensor(rng.standard_normal(n), dtype=f32, device=dev)
    reset_counts()
    ws = rt.butterfly_workspace(Ae, be)
    xr = {k: rt.butterfly_solve(ws, refine=k) for k in (0, 2)}
    torch.cuda.synchronize()
    rbt_launches_1536 = panel_factor_cuda.counts.launches
    xp = rt.lu_solve(rt.lu(Ae), be)
    rr = {f"refine_{k}": solve_resid(Ae, v, be) for k, v in xr.items()}
    rr["pivoted"] = solve_resid(Ae, xp, be)
    rec = dict(what="rbt_entry", n=n, dtype="float32", solve_rel_resid=rr,
               launches={"panel_lu": rbt_launches_1536},
               expected_launches={"panel_lu": 2 * -(-n // w_main)})
    emit("main", **rec)
    eps32 = torch.finfo(f32).eps
    if not (all(np.isfinite(v) and v < 100 * eps32 for v in rr.values())
            and rr["refine_2"] <= rr["refine_0"] * 1.5
            and rbt_launches_1536 == 2 * -(-n // w_main)):
        fail(f"RBT on the entry matrix: {rec}")
    del Ae, be, ws, xr, xp
    # the benchmark's RBT problem (rbt_f32): HPL's uniform [-0.5, 0.5) matrix
    # at n = 4096 through the factor / solve split, the fused transform's
    # device time beside its tensor code's (one 64 MiB matrix, past the L2)
    from recursivefactorization_jl_tpu_torch.models import butterfly as rbt_mod
    from recursivefactorization_jl_tpu_torch.ops.butterfly import butterfly_mul_cuda

    n = 4096
    gu = torch.Generator(device=dev).manual_seed(2500000301)
    Au = torch.rand(n, n, generator=gu, device=dev, dtype=f32) - 0.5
    bu = torch.rand(n, generator=gu, device=dev, dtype=f32) - 0.5
    reset_counts()
    ws = rt.butterfly_workspace(Au, bu)
    F = rt.butterfly_factor(ws)
    xs = {k: rt.butterfly_factor_solve(F, ws.b, refine=k) for k in (0, 1, 2)}
    split_is_solve = torch.equal(xs[1], rt.butterfly_solve(ws, refine=1))
    torch.cuda.synchronize()
    eps32 = torch.finfo(f32).eps / 2
    Ad = wide(Au)
    hpl = {}
    for k, v in xs.items():
        xd, bd = wide(v), wide(bu)
        hpl[f"refine_{k}"] = float((Ad @ xd - bd).abs().max() / (
            eps32 * (Ad.abs().sum(1).max() * xd.abs().max() + bd.abs().max()) * n))
    counts = butterfly_mul_cuda.counts
    rbt_launches = {f"{d}_n{m}": c for (d, m), c in counts.launches.items()}
    tensor_transforms = counts.tensor_transforms
    # the kernel against its plain version (the tensor code) on this matrix
    got_t = butterfly_mul_cuda(ws.A, ws.uv)
    plain_t = rbt_mod._butterfly_mul_tensor(ws.A, ws.uv)
    transform_bitwise = torch.equal(got_t, plain_t)
    transform_err = float((got_t - plain_t).abs().max())
    del got_t, plain_t
    kernel_ms = device_ms(lambda: butterfly_mul_cuda(ws.A, ws.uv))
    tensor_ms = device_ms(lambda: rbt_mod._butterfly_mul_tensor(ws.A, ws.uv))
    # A read once, U^T A V written once, the 4n values: 8 operations an element
    least_ms, least_by = roofline(8 * n * n, 4 * (2 * n * n + 4 * n), "float32")
    rbt_row = dict(what="rbt_hpl_split", n=n, dtype="float32", hpl_resid=hpl, info=int(F.info),
                   split_is_solve=split_is_solve, transform_launches=rbt_launches,
                   tensor_transforms=tensor_transforms, transform_bitwise=transform_bitwise,
                   transform_max_abs_err=transform_err, transform_kernel_ms=kernel_ms,
                   transform_tensor_ms=tensor_ms, transform_bound_ms=least_ms,
                   transform_bound_by=least_by, transform_roofline_pct=100 * least_ms / kernel_ms)
    emit("main", **rbt_row)
    if not (hpl["refine_1"] < 16.0 and int(F.info) == 0 and split_is_solve and transform_bitwise
            and rbt_launches == {f"float32_n{n}": 2} and tensor_transforms == 0):
        fail(f"RBT on HPL's matrix through the factor / solve split: {rbt_row}")
    del Au, bu, ws, F, xs, Ad

    # ---- 3g. lu under panel_boundary_precision='bf16x3' -------------------
    bf16x3_counts = bf16x3_main_phase(rt, dev, TF32Watch, resid_gate, solve_resid)

    # ---- 3b. the batched path -------------------------------------------
    def reset_batched_counts():
        bk.reset_lu_launches()
        bk.reset_solve_launches()
        bk.reset_noswap_launches()

    def batched_counts():
        """Launches per kernel since the last reset: the swap, noswap and
        solve kernels' by route (one kernel function each)."""
        got = {ROUTE_KERNEL[r]: c for r, c in bk.batched_lu_cuda.route_launches.items()}
        got.update({NOSWAP_KERNEL[r]: c for r, c in bk.batched_lu_noswap_cuda.route_launches.items()})
        got.update({SOLVE_KERNEL[r]: c for r, c in bk.batched_solve_cuda.route_launches.items()})
        return got

    def batch_resid(A, f, perm):
        """Per matrix max|LU - A[perm]| and its gate, in f64 ((m, n)
        matrices: L is m x k, U is k x n, k = min(m, n))."""
        _, m, n = A.shape
        k = min(m, n)
        fd = f.double()
        eye = torch.eye(m, k, dtype=torch.float64, device=dev)
        LU_ = torch.bmm(torch.tril(fd[:, :, :k], -1) + eye, torch.triu(fd[:, :k, :]))
        LU_ -= A.double().gather(1, perm.long()[:, :, None].expand(-1, -1, n))
        r = LU_.abs().amax(dim=(1, 2))
        g = 20 * max(m, n) * torch.finfo(A.dtype).eps * A.abs().amax(dim=(1, 2)).double()
        return r, g

    def batch_solve_resid(A, x, b):
        Ad, xd, bd = A.double(), x.double(), b.double()
        r = torch.bmm(Ad, xd[:, :, None])[:, :, 0] - bd
        return r.norm(dim=1) / (Ad.flatten(1).norm(dim=1) * xd.norm(dim=1))

    batched_launches = {}
    full_err = {}
    for n in (16, 64, 128):
        A = torch.tensor(rng.standard_normal((BATCH_B, n, n)), dtype=torch.float32, device=dev)
        b = torch.tensor(rng.standard_normal((BATCH_B, n)), dtype=torch.float32, device=dev)
        b3 = torch.tensor(rng.standard_normal((BATCH_B, n, 2)), dtype=torch.float32, device=dev)
        Z = A.clone()
        zrows = torch.arange(0, BATCH_B, 10, device=dev)
        zcols = zrows % n
        Z[zrows, :, zcols] = 0
        want_info = torch.zeros(BATCH_B, dtype=torch.int32, device=dev)
        want_info[zrows] = (zcols + 1).int()
        lib_piv = torch.linalg.lu_factor_ex(A)[1] - 1
        reset_batched_counts()
        # the path, as a user calls it
        f1, perm1, info1 = rt.batched_lu_factor_perm(A)
        x1 = rt.batched_lu_solve_perm(f1, perm1, b)
        f2, ipiv2, info2 = rt.batched_lu_factor(A)
        x2 = rt.batched_lu_solve(f2, ipiv2, b3)
        f3, perm3, info3 = bk.batched_lu_noswap(A)
        x3 = rt.batched_lu_solve_perm(f3, perm3, b)
        _, _, infoz = rt.batched_lu_factor(Z)
        torch.cuda.synchronize()
        got = batched_counts()
        batched_launches[n] = got
        expect = {k: 0 for k in got}
        expect.update({ROUTE_KERNEL[bk.lu_route(n, n)]: 3, NOSWAP_KERNEL[bk.noswap_route(n)]: 1,
                       SOLVE_KERNEL[bk.solve_route(n, 1)]: 3})
        rec = dict(batch=BATCH_B, n=n, dtype="float32", launches=got,
                   expected_launches=expect)
        # what the path's launches returned, against the plain versions on
        # the same inputs at this size
        fp, ipivp, permp, infop = bk.batched_lu_plain(A, True, True)
        fn, permn, infon = bk.batched_lu_noswap_plain(A, True)
        infozp = bk.batched_lu_plain(Z, True, False)[3]
        xp1 = bk.batched_solve_plain(f1, b, perm=perm1)
        xp2 = bk.batched_solve_plain(f2, b3, perm=rt.batched_ipiv_to_perm(ipiv2, n))
        xp3 = bk.batched_solve_plain(f3, b, perm=perm3)
        rec["plain_equal"] = {
            "swap_ipiv_perm_info": bool(
                torch.equal(ipiv2, ipivp) and torch.equal(perm1, permp)
                and torch.equal(info1, infop) and torch.equal(info2, infop)
                and torch.equal(infoz, infozp)),
            "swap_bitwise": same_bits(f1, fp) and same_bits(f2, fp),
            "noswap_perm_info": bool(torch.equal(perm3, permn) and torch.equal(info3, infon)),
            "noswap_bitwise": same_bits(f3, fn),
            "solve_bitwise": same_bits(x1, xp1) and same_bits(x2, xp2) and same_bits(x3, xp3),
        }
        full_err[n] = {
            ROUTE_KERNEL[bk.lu_route(n, n)]: max(abs_err(f1, fp), abs_err(f2, fp)),
            NOSWAP_KERNEL[bk.noswap_route(n)]: abs_err(f3, fn),
            SOLVE_KERNEL[bk.solve_route(n, 1)]: max(abs_err(x1, xp1), abs_err(x2, xp2),
                                                    abs_err(x3, xp3)),
        }
        rec["max_abs_err_vs_plain"] = full_err[n]
        del fp, fn, xp1, xp2, xp3
        for name, f, perm in (("factor_perm", f1, perm1),
                              ("factor", f2, rt.batched_ipiv_to_perm(ipiv2, n)),
                              ("noswap", f3, perm3)):
            r, g = batch_resid(A, f, perm)
            rec[f"{name}_scaled_resid_max"] = float((r / (g / 20)).max())
            rec[f"{name}_resid_ok"] = bool((r < g).all())
        # The library is the oracle of the pivot rule.  In f64 its pivots
        # must equal the kernel's in every matrix.  In f32 it rounds
        # otherwise (blocked, fused multiply-adds), which flips the choice
        # between two candidates that agree to rounding in a handful of
        # the 10 000 x n decisions: hold the count of such matrices at 10,
        # in each of them the two candidates of the first differing step
        # within n eps max|column| of each other (after an f64
        # elimination by the pivots both share), and every multiplier at
        # |l| <= 1, which says each choice was the largest entry of the
        # kernel's own column.
        _, ipiv64, _ = rt.batched_lu_factor(A.double())
        lib_piv64 = torch.linalg.lu_factor_ex(A.double())[1] - 1
        rec["ipiv_equals_library_f64"] = bool(torch.equal(ipiv64, lib_piv64.int()))
        differ = int((ipiv2 != lib_piv.int()).any(dim=1).sum())
        rec["ipiv_f32_matrices_differing_from_library"] = differ
        gaps = []
        for i in (ipiv2 != lib_piv.int()).any(dim=1).nonzero().flatten().tolist()[:10]:
            k, gap = first_choice_gap(A[i], ipiv2[i].cpu(), lib_piv[i].cpu())
            gaps.append({"matrix": i, "step": k, "gap": gap})
        rec["ipiv_f32_first_differences"] = gaps
        tie_gate = n * torch.finfo(torch.float32).eps
        rec["ipiv_f32_close_to_library"] = differ <= 10 and all(
            g["gap"] <= tie_gate for g in gaps)
        rec["multipliers_at_most_one"] = bool((torch.tril(f2, -1).abs() <= 1).all())
        rec["info_zero_on_randn"] = bool(
            (info1 == 0).all() and (info2 == 0).all() and (info3 == 0).all())
        rec["info_exact_on_zeroed_columns"] = bool(torch.equal(infoz, want_info))
        sr = [batch_solve_resid(A, x1, b), batch_solve_resid(A, x2[:, :, 1], b3[:, :, 1]),
              batch_solve_resid(A, x3, b)]
        rec["solve_rel_resid_max"] = [float(t.max()) for t in sr]
        rec["solve_finite"] = all(bool(torch.isfinite(t).all()) for t in sr)
        # the library-route solve (trans) under the caller's TF32 setting
        watch = TF32Watch()
        torch.backends.cuda.matmul.allow_tf32 = True
        with watch:
            xt = rt.batched_lu_solve_perm(f1, perm1, b, trans="T")
            torch.cuda.synchronize()
        restored = torch.backends.cuda.matmul.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = tf32_before
        rt_res = batch_solve_resid(A.mT, xt, b)
        rec.update(trans_solve_rel_resid_max=float(rt_res.max()),
                   trans_solve_watched=len(watch.flags),
                   trans_solve_tf32_seen=any(watch.flags), tf32_restored=restored)
        emit("batched", **rec)
        if got != expect:
            fail(f"batched kernels launched {got}, expected {expect}")
        if not all(rec["plain_equal"].values()):
            fail(f"batched path at n={n} disagrees with the plain versions: "
                 f"{rec['plain_equal']}")
        for key in ("factor_perm_resid_ok", "factor_resid_ok", "noswap_resid_ok",
                    "ipiv_equals_library_f64", "ipiv_f32_close_to_library",
                    "multipliers_at_most_one", "info_zero_on_randn",
                    "info_exact_on_zeroed_columns", "solve_finite", "tf32_restored"):
            if not rec[key]:
                fail(f"batched path at n={n}: {key} is false")
        if watch.flags == [] or any(watch.flags) or not np.isfinite(rec["trans_solve_rel_resid_max"]):
            fail(f"library-route solve: TF32 flags {watch.flags}, residual "
                 f"{rec['trans_solve_rel_resid_max']}")
        del A, b, b3, Z, f1, f2, f3, x1, x2, x3, xt

    # the tile route as a user reaches it: a tall batch, past the register
    # routes' 128 rows
    At = torch.tensor(rng.standard_normal((TALL_B,) + TALL_SHAPE), dtype=torch.float32, device=dev)
    reset_batched_counts()
    ft, ipt, it = rt.batched_lu_factor(At)
    torch.cuda.synchronize()
    got = batched_counts()
    batched_launches["tall"] = got
    fp, ipp, _, inp = bk.batched_lu_plain(At, True, False)
    full_err["tall"] = {"batched_lu_swap": abs_err(ft, fp)}
    expect = {k: 0 for k in batched_counts()}
    expect["batched_lu_swap"] = 1
    r, g = batch_resid(At, ft, rt.batched_ipiv_to_perm(ipt, TALL_SHAPE[0]))
    rec = dict(batch=TALL_B, shape=list(TALL_SHAPE), dtype="float32", launches=got,
               expected_launches=expect, bitwise=same_bits(ft, fp),
               ipiv_info_equal=bool(torch.equal(ipt, ipp) and torch.equal(it, inp)),
               resid_ok=bool((r < g).all()), max_abs_err_vs_plain=full_err["tall"])
    emit("batched", **rec)
    if got != expect or not (rec["bitwise"] and rec["ipiv_info_equal"] and rec["resid_ok"]):
        fail(f"batched path on the tall batch: {rec}")
    del At, ft, fp

    # ---- 3e. the tensor-parallel path in an NCCL world of one rank --------
    import multiprocessing

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    tp_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
    dp_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
    M2048, v2048 = tp_ranks_input()
    tmats = {
        ("randn", 4096): rng.standard_normal((4096, 4096)),
        ("randn", 1536): rng.standard_normal((1536, 1536)),
        ("entry", 4096): rng.standard_normal((4096, 4096)) + 4096 * np.eye(4096),
        ("zero_col", 1536): sing,
        ("randn", TP_RANKS_N): M2048,
        ("crandn", 4096): cnormal((4096, 4096)),
        ("crandn", 1536): cnormal((1536, 1536)),
        ("randint", 1536): rng.integers(-100, 100, (1536, 1536)),
    }
    # complex tp on the complex offset kernel (complex64 at the f32 cell's
    # size), half tp through the promote route and int32 tp as float64, both
    # on the real offset kernel
    truns = [("randn", 4096, f32, 128, True), ("randn", 4096, f32, 512, True),
             ("randn", 1536, f64, 128, True), ("entry", 4096, f32, 128, False),
             ("zero_col", 1536, f32, 128, True), ("randn", TP_RANKS_N, f32, TP_RANKS_W, True),
             ("crandn", 4096, c64, 128, True), ("crandn", 1536, c128, 128, True),
             ("randn", 1536, torch.bfloat16, 128, True), ("randn", 1536, torch.float16, 128, True),
             ("randint", 1536, torch.int32, 128, True)]
    tp_wrappers = {"panel_lu_offset": offset_panel_factor_cuda,
                   "panel_lu_c64_offset": offset_panel_factor_c64_cuda, **panel_wrappers}
    torch.backends.cuda.matmul.allow_tf32 = True  # the port must turn it off
    tp_launches = {}
    for name, n, dt, w, pivot in truns:
        cplx = dt.is_complex
        integer = not (dt.is_floating_point or cplx)
        A = torch.tensor(tmats[(name, n)], device=dev).to(dt)
        bv = v2048 if n == TP_RANKS_N else cnormal(n) if cplx else rng.standard_normal(n)
        b = torch.tensor(bv, device=dev).to(dt)
        watch = TF32Watch()
        reset_counts()
        with watch:
            F = rt.tp_lu(A, tp_mesh, "tp", w, pivot)
            xs = {t: rt.tp_lu_solve(F, b, tp_mesh, "tp", w, trans=t) for t in ("N", "T", "H")}
            torch.cuda.synchronize()
        got = {k: wr.counts.launches for k, wr in tp_wrappers.items()}
        if offset_panel_factor_cuda.counts.grid_route_launches + \
                offset_panel_factor_c64_cuda.counts.grid_route_launches:
            fail("a tp panel took the grid route")
        kern = "panel_lu_c64_offset" if cplx else "panel_lu_offset"
        want = {k: (n // w if k == kern else 0) for k in tp_wrappers}
        tp_launches[(name, n, w, str(dt)[6:])] = got[kern]
        Aw = A.double() if integer else A  # the generic route's factors are float64
        r, g = resid_gate(Aw, F)
        ops = {"N": Aw, "T": Aw.T, "H": Aw.mH}
        sr = {t: solve_resid(ops[t], xs[t], b) for t in xs}
        info = int(F.info)
        eps = torch.finfo(Aw.dtype).eps
        G = rt.lu(A, pivot, check=False, config=rt.LUConfig(panel_width=w))
        differ = int((F.p != G.p).sum())
        want_dtype = torch.float64 if integer else dt
        rec = dict(n=n, input=name, dtype=str(dt)[6:], panel_width=w, pivot=pivot, ranks=1,
                   backend=dist.get_backend(tp_mesh.get_group("tp")), launches=got,
                   expected_launches=want, resid=r, gate=g,
                   scaled_resid=r / (n * eps * float(Aw.abs().max())), solve_rel_resid=sr,
                   info=info, factors_dtype=str(F.factors.dtype)[6:],
                   solution_dtype=str(xs["N"].dtype)[6:],
                   matmuls=len(watch.flags), tf32_seen=any(watch.flags),
                   perm_entries_differing_from_lu=differ, perm_near_tie_or_equal=True,
                   ipiv_equal_lu=bool(torch.equal(F.ipiv, G.ipiv)))
        if differ and name != "zero_col":
            if cplx:  # CABS1 pivots: the gap of the two candidates' CABS1
                k, gap = first_choice_gap_cabs1(A, F.ipiv, G.ipiv)
            else:
                k, gap = first_choice_gap_perm(A, F.p, G.p)
            rec["perm_first_difference"] = {"step": k, "gap": gap}
            rec["perm_near_tie_or_equal"] = gap <= n * eps
        emit("tp", **rec)
        if got != want:
            fail(f"tp: kernels launched {got}, expected {want}")
        if not r < g:
            fail(f"tp: residual {r} over the gate {g}")
        if F.factors.dtype != want_dtype or any(x.dtype != want_dtype for x in xs.values()):
            fail(f"tp: factors {F.factors.dtype} / solutions of {dt} not {want_dtype}")
        if watch.flags == [] or any(watch.flags):
            fail(f"TF32 products during the run: {watch.flags[:8]}")
        if info != (zc + 1 if name == "zero_col" else 0):
            fail(f"tp: info {info} on {name}")
        if name != "zero_col" and not (all(np.isfinite(v) for v in sr.values())
                                       and rec["perm_near_tie_or_equal"]):
            fail(f"tp: solve residual {sr} or pivots parting beyond a tie: {rec}")
        if name == "entry" and not sr["N"] < 100 * eps:
            fail(f"tp: solve residual {sr} on the entry matrix")
        if n == TP_RANKS_N:
            tp_d1 = dict(A=A, p=F.p.clone(), ipiv=F.ipiv.clone())
        else:
            del A
        del b, F, G, xs
    if torch.backends.cuda.matmul.allow_tf32 is not True:
        fail("the caller's TF32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    del tmats

    # the sharded batch: one rank factors and solves all 10 000 matrices
    A = torch.tensor(rng.standard_normal((BATCH_B, 64, 64)), dtype=f32, device=dev)
    b = torch.tensor(rng.standard_normal((BATCH_B, 64)), dtype=f32, device=dev)
    reset_batched_counts()
    f, ipiv, info = rt.sharded_batched_lu_factor(A, dp_mesh)
    x = rt.sharded_batched_lu_solve(f, ipiv, b, dp_mesh)
    torch.cuda.synchronize()
    got = batched_counts()
    f0, ipiv0, info0 = rt.batched_lu_factor(A)
    x0 = rt.batched_lu_solve(f0, ipiv0, b)
    r, g = batch_resid(A, f, rt.batched_ipiv_to_perm(ipiv, 64))
    want = {k: 0 for k in got}
    want.update({ROUTE_KERNEL[bk.lu_route(64, 64)]: 1,
                 SOLVE_KERNEL[bk.solve_route(64, 1)]: 1})
    rec = dict(batch=BATCH_B, n=64, dtype="float32", ranks=1, launches=got,
               expected_launches=want,
               equal_to_unsharded=same_bits(f, f0) and same_bits(x, x0)
               and bool(torch.equal(ipiv, ipiv0) and torch.equal(info, info0)),
               resid_ok=bool((r < g).all()), info_zero=bool((info == 0).all()),
               solve_rel_resid_max=float(batch_solve_resid(A, x, b).max()))
    emit("tp", what="sharded_batched", **rec)
    if got != rec["expected_launches"] or not (rec["equal_to_unsharded"] and rec["resid_ok"]
                                               and rec["info_zero"]):
        fail(f"sharded batched path: {rec}")
    del A, b, f, x, f0, x0

    # ---- 3f. two gloo ranks sharing the one card --------------------------
    ctx = multiprocessing.get_context("spawn")
    box = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=tp_rank, args=(r, 2, port, box)) for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        ranks = sorted((box.get(timeout=600) for _ in procs), key=lambda d: d["rank"])
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
    for d in ranks:
        if not d["ok"]:
            fail(f"tp_ranks: rank {d['rank']} failed:\n{d['error']}")
    n = TP_RANKS_N
    # float32: pivots against the one-rank run of the tp phase; complex64
    # (on the complex offset kernel): the ranks agree bitwise, a path check
    for i, dtn in enumerate(("float32", "complex64")):
        recs = [d["records"][i] for d in ranks]
        kern = "panel_lu_c64_offset" if dtn == "complex64" else "panel_lu_offset"
        want = {"panel_lu_offset": 0, "panel_lu_c64_offset": 0, "panel_lu": 0, "panel_lu_c64": 0}
        want[kern] = n // TP_RANKS_W
        rec = dict(n=n, dtype=dtn, panel_width=TP_RANKS_W, ranks=2,
                   backend=ranks[0]["backend"],
                   launches=[d["launches"] for d in recs], expected_launches=want,
                   resid=[d["resid"] for d in recs], gate=recs[0]["gate"],
                   solve_rel_resid=[d["solve_rel_resid"] for d in recs],
                   info=[d["info"] for d in recs],
                   factor_solve_wall_s=[d["factor_solve_wall_s"] for d in recs],
                   ranks_agree=all(np.array_equal(d["ipiv"], recs[0]["ipiv"])
                                   and np.array_equal(d["perm"], recs[0]["perm"])
                                   and d["factors_sha256"] == recs[0]["factors_sha256"]
                                   for d in recs),
                   perm_near_tie_or_equal=True,
                   note="two ranks time-share one card and broadcast through the host "
                        "(gloo): a check of the path, not a scaling number")
        if dtn == "float32":
            p2 = torch.tensor(recs[0]["perm"], device=dev)
            differ = int((p2 != tp_d1["p"]).sum())
            rec["perm_entries_differing_from_one_rank"] = differ
            rec["ipiv_equal_one_rank"] = bool(np.array_equal(recs[0]["ipiv"],
                                                             tp_d1["ipiv"].cpu().numpy()))
            if differ:
                k, gap = first_choice_gap_perm(tp_d1["A"], p2, tp_d1["p"])
                rec["perm_first_difference"] = {"step": k, "gap": gap}
                rec["perm_near_tie_or_equal"] = gap <= n * torch.finfo(f32).eps
        emit("tp_ranks", **rec)
        if not (rec["ranks_agree"] and rec["perm_near_tie_or_equal"]
                and all(d["launches"] == want for d in recs)
                and all(d["resid"] < d["gate"] and d["info"] == 0
                        and np.isfinite(d["solve_rel_resid"]) for d in recs)):
            fail(f"tp_ranks: {rec}")
    del tp_d1, p2

    # ---- 4. timing -------------------------------------------------------
    lib_panel = _kernels.load("panel_lu")

    # where a step of the chain kernel goes: CTA 0 stamps clock64() at each
    # phase boundary (rf_panel_lu_set_trace), one run.  panel_chain_kernel
    # (9 stamps a step): thread 0, in warp 0, which publishes the candidate,
    # stamps phases 0-7 (the step's start, reduced, published: its sends and
    # its arrival on the exchange's mbarrier, its deferred share done, data
    # in: its wait returned, agreed, swapped, looked ahead); thread 32, in
    # warp 1, which publishes nothing, stamps the end of its share of the
    # deferred update (8).  A phase is named by the stamp that ends it.  The
    # no-swap chain keeps its 7 stamps (NOSWAP_PHASES).
    phases = ("reduce", "publish", "deferred", "data_in", "agree", "swap", "lookahead")
    NOSWAP_PHASES = ("reduce", "publish", "barrier", "agree", "swap", "update")

    def chain_trace(what, shape, run, plan, set_trace=None, names=phases):
        set_trace = set_trace or lib_panel.rf_panel_lu_set_trace
        # stamps a step: one per phase boundary, and warp 1's for panel_chain_kernel
        P = len(names) + 1 + (names is phases)
        steps = min(shape[0] - shape[2], shape[1])
        buf = torch.zeros(steps * P + 4 * plan["blocks"], dtype=torch.int64, device=dev)
        run()  # warm
        torch.cuda.synchronize()
        set_trace(buf.data_ptr())
        try:
            run()
            torch.cuda.synchronize()
        finally:
            set_trace(None)
        t = buf.cpu().double()
        st = t[:steps * P].view(steps, P)
        ends = t[steps * P:].view(plan["blocks"], 4)
        ghz = float((ends[:, 3] - ends[:, 1]).sum() / (ends[:, 2] - ends[:, 0]).sum())
        ns = {name: float((st[:, i + 1] - st[:, i]).median()) / ghz
              for i, name in enumerate(names)}
        extra = {}
        if names is phases:
            # the exchange, as warp 0 sees it: from the candidate barrier to
            # data in; warp 1's deferred update runs from the same barrier to
            # stamp 8, and the share of it that ended inside the exchange is
            # hidden
            exchange = st[:, 4] - st[:, 1]
            deferred = st[:, 8] - st[:, 1]
            hidden = torch.minimum(deferred, exchange) / deferred.clamp(min=1)
            extra = dict(exchange_ns_median=float(exchange.median()) / ghz,
                         deferred_warp1_ns_median=float(deferred.median()) / ghz,
                         hidden_share_median=float(hidden[1:].median()))
        # one block's last %globaltimer to the next block's first: what runs
        # between two chains (the delayed pass in turn, or only the launch
        # and the next chain's load where that chain carries the pass)
        gaps = ends[1:, 0] - ends[:-1, 2]
        gap = float(gaps.median()) if gaps.numel() else None
        emit("timing", what="chain_trace", card=card, kernel=what, shape=list(shape[:2]),
             ofs=shape[2], dtype=shape[3] if len(shape) > 3 else "float32", plan=plan,
             sm_ghz=ghz, phase_ns_median=ns,
             step_ns_median=float((st[:, len(names)] - st[:, 0]).median()) / ghz,
             chain_kernels_ms=float((ends[:, 2] - ends[:, 0]).sum()) / 1e6,
             chain_gap_ns_median=gap, **extra)

    for (m, w) in shapes + [(8192, 512)]:  # and the n = 8192 lu's first panel
        X = torch.randn(m, w, generator=gen).to(dev)
        P = X.clone()
        chain_trace("panel_lu", (m, w, 0), lambda: panel_factor_cuda(P.copy_(X), True),
                    panel_plan(m, w, torch.float32))
    for ofs in (0, H_o - w_o):
        X = torch.randn(H_o, w_o, generator=gen).to(dev)
        P = X.clone()
        chain_trace("panel_lu_offset", (H_o, w_o, ofs),
                    lambda: offset_panel_factor_cuda(P.copy_(X), ofs, True),
                    panel_plan(H_o, w_o, torch.float32, ofs=ofs))
    lib_c64 = _kernels.load("panel_lu_c64")
    for (m, w) in shapes:
        for dt in (c64, c128):
            X = crandn(m, w, dt).to(dev)
            P = X.clone()
            chain_trace("panel_lu_c64", (m, w, 0, str(dt)[6:]),
                        lambda: panel_factor_c64_cuda(P.copy_(X), True),
                        panel_plan(m, w, dt), lib_c64.rf_panel_lu_c_set_trace)
    del X, P

    # the panel kernel per main-path panel, in turns beside PR 4's grid-barrier
    # design (shadow, micro 32) and the library
    micro_main = rt.LUConfig().resolved_panel_micro()
    kernel_rows = []
    for (m, w) in shapes:
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        with quiet_c_stdout():
            t = round_robin({
                "panel_lu": lambda: panel_factor_cuda(P, True),
                "shadow": lambda: panel_factor_shadow_cuda(P, True, micro_main),
                "library": lambda: torch.linalg.lu_factor_ex(P),
            }, rounds=9, setup=lambda: P.copy_(X))
        p_ms, _ = timed(lambda: unblocked_lu(X, True), None, reps=2, warm=1)
        b_ms, b_by = bound(m, w, "float32", 4)
        row = dict(shape=[m, w], dtype="float32", plan=panel_plan(m, w, torch.float32),
                   kernel_ms=t["panel_lu"], shadow_ms=t["shadow"], plain_ms=p_ms,
                   library_ms=t["library"], bound_ms=b_ms, bound_by=b_by,
                   us_per_step=1e3 * t["panel_lu"] / min(m, w),
                   shadow_us_per_step=1e3 * t["shadow"] / min(m, w))
        kernel_rows.append(row)
        emit("timing", what="panel_kernel", card=card, **row)

    # the complex kernel per panel on its cluster route and, forced, on its
    # grid route (the PR 3 design), in turns beside the library
    ckernel_rows = []
    for (m, w) in shapes + [(512, 512)]:
        for dt in (c64, c128):
            if dt == c128 and (m, w) != main_shape(1536)[1]:
                continue
            X = crandn(m, w, dt).to(dev)
            P = torch.empty_like(X)
            with quiet_c_stdout():
                t = round_robin({
                    "cluster": lambda: panel_factor_c64_cuda(P, True),
                    "grid": lambda: panel_factor_c64_cuda(P, True, block=-1),
                    "library": lambda: torch.linalg.lu_factor_ex(P),
                }, rounds=9, setup=lambda: P.copy_(X))
            p_ms, _ = timed(lambda: unblocked_lu_cabs1(X, True), None, reps=1, warm=0)
            b_ms, b_by = bound(m, w, str(dt)[6:], X.element_size())
            row = dict(shape=[m, w], dtype=str(dt)[6:], plan=panel_plan(m, w, dt),
                       kernel_ms=t["cluster"], grid_ms=t["grid"], plain_ms=p_ms,
                       library_ms=t["library"], bound_ms=b_ms, bound_by=b_by,
                       us_per_step=1e3 * t["cluster"] / min(m, w),
                       grid_us_per_step=1e3 * t["grid"] / min(m, w),
                       grid_over_cluster=t["grid"] / t["cluster"])
            ckernel_rows.append(row)
            emit("timing", what="panel_kernel_c64", card=card, **row)
            del X, P

    def e2e(n, dt=torch.float32):
        cplx = dt.is_complex
        M = (crandn(n, n, dt) if cplx else torch.randn(n, n, generator=gen)).to(dev)
        v = (crandn(n, 1, dt)[:, 0] if cplx else torch.randn(n, generator=gen)).to(dev)
        F = rt.lu(M, check=False)

        def lib_fs():
            LU_, piv, _ = torch.linalg.lu_factor_ex(M)
            torch.linalg.lu_solve(LU_, piv, v[:, None])

        t = round_robin({
            "factor": lambda: rt.lu(M, check=False),
            "solve": lambda: rt.lu_solve(F, v),
            "factor_solve": lambda: rt.lu_solve(rt.lu(M, check=False), v),
            "library_factor": lambda: torch.linalg.lu_factor_ex(M),
            "library_factor_solve": lib_fs,
        })
        gf = (8 if cplx else 2) * n**3 / 3 / 1e9
        emit("timing", what="end_to_end", card=card, n=n, dtype=str(dt)[6:],
             route=rt.dispatch_route((n, n), dt, True, cfg),
             factor_ms=t["factor"], solve_ms=t["solve"],
             factor_solve_ms=t["factor_solve"],
             factor_gflops=gf / (t["factor"] / 1e3),
             library_factor_ms=t["library_factor"],
             library_factor_solve_ms=t["library_factor_solve"],
             library_factor_gflops=gf / (t["library_factor"] / 1e3))

    with torch.no_grad():
        e2e(1536)
        e2e(4096)
        e2e(1536, c64)
        e2e(4096, c64)
        e2e(1536, c128)
        # the routing defaults of utils/config.py: panel width, whole-vs-
        # blocked crossover (small_threshold) and the recursive tail, in
        # turns per size
        sweep = [(n, dt) for dt in (torch.float32, c64) for n in (1024, 1536, 2048, 4096)]
        for n, dt in (sweep if "--sweep" in argv else ()):
            M = (crandn(n, n, dt) if dt.is_complex else torch.randn(n, n, generator=gen)).to(dev)
            cfgs = {("blocked", w, None): rt.LUConfig(panel_width=w, small_threshold=0)
                    for w in (64, 128, 256, 512, 1024)}
            if n <= 2048:
                cfgs[("whole", None, None)] = rt.LUConfig(small_threshold=n)
            if n == 4096:
                for tail in (1024, 2048):
                    cfgs[("blocked", 512, tail)] = rt.LUConfig(
                        panel_width=512, small_threshold=0, tail_threshold=tail)
            t = round_robin({k: (lambda c=c: rt.lu(M, check=False, config=c))
                             for k, c in cfgs.items()}, rounds=5)
            for (route, w, tail), ms in t.items():
                emit("timing", what="sweep", card=card, n=n, dtype=str(dt)[6:],
                     route=route, panel_width=w, tail_threshold=tail, factor_ms=ms)

        # ---- 4b. the batched kernels, in turns beside the library ---------
        batched_rows = batched_timing()

    # ---- 4d. the new panel kernels, the opt-in schedules, RBT -------------
    # the micro-blocked and the no-swap kernel per main-path panel on their
    # cluster routes and, forced, on their grid routes (the grid-barrier
    # kernels), in
    # turns beside csrc/panel_lu.cu and the library; the no-swap kernel also
    # with half the rows taken, sized by the live count as the physical
    # schedule sizes it; the micro route at micro 8 / 16 / 64 too
    new_rows = {}
    for (m, w) in shapes:
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        none_used = torch.zeros(m, dtype=torch.int32, device=dev)
        half_used = none_used.clone()
        half_used[torch.randperm(m, generator=gen)[: m // 2].to(dev)] = 1
        half_live = m - m // 2
        fns = {
            "panel_lu": lambda: panel_factor_cuda(P, True),
            "panel_lu_micro_shadow": lambda: panel_factor_shadow_cuda(P, True, micro_main),
            "panel_lu_micro_basic": lambda: panel_factor_basic_cuda(P, True, micro_main),
            "panel_lu_micro_shadow_grid": lambda: panel_factor_shadow_cuda(
                P, True, micro_main, block=-1),
            "panel_lu_micro_basic_grid": lambda: panel_factor_basic_cuda(
                P, True, micro_main, block=-1),
            "panel_lu_noswap": lambda: panel_factor_noswap_cuda(P, none_used, True, live=m),
            "panel_lu_noswap_grid": lambda: panel_factor_noswap_cuda(P, none_used, True,
                                                                     block=-1),
            "panel_lu_noswap_half_used": lambda: panel_factor_noswap_cuda(
                P, half_used, True, live=half_live),
            "panel_lu_noswap_half_used_grid": lambda: panel_factor_noswap_cuda(
                P, half_used, True, block=-1),
            "library": lambda: torch.linalg.lu_factor_ex(P),
        }
        for mc in (8, 16, 64):
            fns[f"micro_{mc}"] = lambda mc=mc: panel_factor_shadow_cuda(P, True, mc)
        with quiet_c_stdout():
            t = round_robin(fns, rounds=9, setup=lambda: P.copy_(X))
        plain = {
            "panel_lu_micro_shadow": timed(lambda: micro_blocked_lu(X, True, micro_main),
                                           reps=1, warm=0)[0],
            "panel_lu_noswap": timed(lambda: unblocked_lu_noswap(X, none_used, True),
                                     reps=1, warm=0)[0],
        }
        for k in ("panel_lu_micro_shadow", "panel_lu_micro_basic", "panel_lu_noswap"):
            plain[k] = plain[k.replace("basic", "shadow")]  # one plain version per pair
            plain[f"{k}_grid"] = plain[k]
        b_ms, b_by = bound(m, w, "float32", 4)
        hb_ms, _ = bound(half_live, w, "float32", 4)  # the rows this mask leaves
        grid_over_cluster = {k: t[f"{k}_grid"] / t[k] for k in (
            "panel_lu_micro_shadow", "panel_lu_micro_basic", "panel_lu_noswap",
            "panel_lu_noswap_half_used")}
        grid_over_cluster["panel_lu_micro_basic_grid_over_shadow"] = (
            t["panel_lu_micro_basic_grid"] / t["panel_lu_micro_shadow"])
        plans = {"micro": micro_plan(m, w, torch.float32, micro_main),
                 "noswap": noswap_plan(m, w, torch.float32, live=m),
                 "noswap_half_used": noswap_plan(m, w, torch.float32, live=half_live)}
        new_rows[(m, w)] = dict(t=t, plain=plain, bound=(b_ms, b_by))
        emit("timing", what="new_panel_kernels", card=card, shape=[m, w], dtype="float32",
             micro=micro_main, plans=plans, kernel_ms=t, plain_ms=plain, bound_ms=b_ms,
             bound_by=b_by, bound_ms_half_used=hb_ms, grid_over_cluster=grid_over_cluster,
             us_per_step={k: 1e3 * v / min(m, w) for k, v in t.items()})
        # where a step of the new chains goes (the phase trace of their
        # chain kernels; the no-swap chain has no swap phase)
        lib_micro = _kernels.load("panel_lu_micro")
        lib_noswap = _kernels.load("panel_lu_noswap")
        chain_trace("panel_lu_micro", (m, w, 0), lambda: panel_factor_shadow_cuda(
            P.copy_(X), True, micro_main), plans["micro"], lib_micro.rf_panel_lu_micro_set_trace)
        chain_trace("panel_lu_noswap", (m, w, 0), lambda: panel_factor_noswap_cuda(
            P.copy_(X), none_used, True, live=m), plans["noswap"],
            lib_noswap.rf_panel_lu_noswap_set_trace, NOSWAP_PHASES)
        chain_trace("panel_lu_noswap_half_used", (m, w, 0), lambda: panel_factor_noswap_cuda(
            P.copy_(X), half_used, True, live=half_live), plans["noswap_half_used"],
            lib_noswap.rf_panel_lu_noswap_set_trace, NOSWAP_PHASES)
        del X, P

    def e2e_opt(n):
        M = torch.randn(n, n, generator=gen).to(dev)
        v = torch.randn(n, generator=gen).to(dev)
        cfgs = {"default": None, **{k: c for k, (c, _) in opt_cfgs.items()}}

        def lib_fs():
            LU_, piv, _ = torch.linalg.lu_factor_ex(M)
            torch.linalg.lu_solve(LU_, piv, v[:, None])

        fns = {}
        for k, c in cfgs.items():
            fns[f"{k}_factor"] = lambda c=c: rt.lu(M, check=False, config=c)
            fns[f"{k}_factor_solve"] = lambda c=c: rt.lu_solve(
                rt.lu(M, check=False, config=c), v)
        fns["library_factor"] = lambda: torch.linalg.lu_factor_ex(M)
        fns["library_factor_solve"] = lib_fs
        t = round_robin(fns, rounds=5)
        emit("timing", what="end_to_end_opt_in", card=card, n=n, dtype="float32",
             micro=micro_main, ms=t,
             physical_over_default=t["physical_factor"] / t["default_factor"],
             shadow_over_default=t["shadow_factor"] / t["default_factor"],
             basic_over_default=t["basic_factor"] / t["default_factor"])

    with torch.no_grad():
        e2e_opt(1536)
        e2e_opt(4096)
        n = 1536
        M = (torch.randn(n, n, generator=gen) + n * torch.eye(n)).to(dev)
        v = torch.randn(n, generator=gen).to(dev)
        ws = rt.butterfly_workspace(M, v)
        t = round_robin({
            "rbt_workspace_transform_factor_solve": lambda: rt.butterfly_solve(
                rt.butterfly_workspace(M, v)),
            "rbt_transform_factor_solve": lambda: rt.butterfly_solve(ws),
            "rbt_refine_2": lambda: rt.butterfly_solve(ws, refine=2),
            "rbt_transform": lambda: rt.butterfly_mul(ws.A, ws.uv),
            "nopivot_factor": lambda: rt.lu(M, False, check=False),
            "pivoted_factor_solve": lambda: rt.lu_solve(rt.lu(M, check=False), v),
            "library_solve": lambda: torch.linalg.solve(M, v),
        }, rounds=5)
        emit("timing", what="rbt", card=card, n=n, dtype="float32", input="randn + n*I", ms=t)
        del M, v, ws

        if "--sweep" in argv:
            # the micro-block width and the panel width of the micro-blocked
            # kernels: per panel, and through lu at both sizes
            for m in (1536, 4096):
                for w in (128, 256, 512):
                    X = torch.randn(m, w, generator=gen).to(dev)
                    P = torch.empty_like(X)
                    fns = {("fori", None): lambda: panel_factor_cuda(P, True)}
                    for micro in (8, 16, 32, 64):
                        fns[("shadow", micro)] = lambda mc=micro: panel_factor_shadow_cuda(P, True, mc)
                        fns[("basic", micro)] = lambda mc=micro: panel_factor_basic_cuda(P, True, mc)
                    t = round_robin(fns, rounds=5, setup=lambda: P.copy_(X))
                    for (variant, micro), ms in t.items():
                        emit("timing", what="sweep_micro_panel", card=card, shape=[m, w],
                             dtype="float32", variant=variant, micro=micro, kernel_ms=ms,
                             us_per_step=1e3 * ms / w)
            for n in (1536, 4096):
                M = torch.randn(n, n, generator=gen).to(dev)
                cfgs = {("fori3", w, None): rt.LUConfig(panel_width=w, small_threshold=0)
                        for w in (256, 512)}
                cfgs[("physical", 256, None)] = rt.LUConfig(schedule="physical", panel_width=256)
                cfgs[("physical", 512, None)] = rt.LUConfig(schedule="physical", panel_width=512)
                for variant in ("shadow", "basic"):
                    for w in (256, 512):
                        for micro in (8, 16, 32, 64):
                            cfgs[(variant, w, micro)] = rt.LUConfig(
                                panel_variant=variant, panel_width=w, small_threshold=0,
                                panel_micro=micro)
                t = round_robin({k: (lambda c=c: rt.lu(M, check=False, config=c))
                                 for k, c in cfgs.items()}, rounds=5)
                for (variant, w, micro), ms in t.items():
                    emit("timing", what="sweep_micro_lu", card=card, n=n, dtype="float32",
                         variant=variant, panel_width=w, micro=micro, factor_ms=ms)

    # ---- 4e. the offset kernel per panel; tp at D = 1 beside lu ----------
    with torch.no_grad():
        offset_rows = {}
        for ofs in (0, 1000, H_o - w_o):
            X = torch.randn(H_o, w_o, generator=gen).to(dev)
            P = torch.empty_like(X)
            with quiet_c_stdout():
                t = round_robin({
                    "panel_lu_offset": lambda: offset_panel_factor_cuda(P, ofs, True),
                    # PR 4's grid-barrier design on the same live rows
                    "shadow": lambda: panel_factor_shadow_cuda(P[ofs:], True, micro_main),
                    # the same LU by one library call on the live rows
                    "library": lambda: torch.linalg.lu_factor_ex(P[ofs:]),
                }, rounds=9, setup=lambda: P.copy_(X))
            p_ms = timed(lambda: offset_panel_lu(X, ofs, True), reps=1, warm=0)[0]
            b_ms, b_by = offset_panel_bound(H_o, w_o, ofs, "float32", 4)
            offset_rows[ofs] = dict(kernel_ms=t["panel_lu_offset"], plain_ms=p_ms,
                                    library_ms=t["library"], bound_ms=b_ms, bound_by=b_by)
            emit("timing", what="offset_kernel", card=card, shape=[H_o, w_o], ofs=ofs,
                 dtype="float32", plan=panel_plan(H_o, w_o, torch.float32, ofs=ofs),
                 us_per_step=1e3 * t["panel_lu_offset"] / w_o, shadow_ms=t["shadow"],
                 **offset_rows[ofs])
            del X, P
        # the complex offset kernel (the panel of complex tp_lu) on both
        # routes, beside one library call on the live rows: complex64 at the
        # tp cell's panel, complex128 at the f64 cell's
        coffset_rows = {}
        for dt, H_c, ofs_list in ((c64, 4096, (0, 1000, 4096 - 128)), (c128, 1536, (0,))):
            w_c = 128
            for ofs in ofs_list:
                X = crandn(H_c, w_c, dt).to(dev)
                P = torch.empty_like(X)
                with quiet_c_stdout():
                    t = round_robin({
                        "cluster": lambda: offset_panel_factor_c64_cuda(P, ofs, True),
                        "grid": lambda: offset_panel_factor_c64_cuda(P, ofs, True, block=-1),
                        "library": lambda: torch.linalg.lu_factor_ex(P[ofs:]),
                    }, rounds=9, setup=lambda: P.copy_(X))
                p_ms = timed(lambda: offset_panel_lu_cabs1(X, ofs, True), reps=1, warm=0)[0]
                b_ms, b_by = offset_panel_bound(H_c, w_c, ofs, str(dt)[6:], X.element_size())
                coffset_rows[(str(dt)[6:], ofs)] = dict(
                    kernel_ms=t["cluster"], grid_ms=t["grid"], plain_ms=p_ms,
                    library_ms=t["library"], bound_ms=b_ms, bound_by=b_by)
                emit("timing", what="offset_kernel_c64", card=card, shape=[H_c, w_c], ofs=ofs,
                     dtype=str(dt)[6:], plan=panel_plan(H_c, w_c, dt, ofs=ofs),
                     us_per_step=1e3 * t["cluster"] / w_c,
                     **coffset_rows[(str(dt)[6:], ofs)])
                del X, P
        if "--sweep" in argv:
            sweep_plans = [(m, 512, f32) for m in (512, 1024, 1536, 2048, 3072, 4096, 8192)]
            sweep_plans += [(m, 128, f32) for m in (128, 256, 512, 1024, 2048, 4096)]
            sweep_plans += [(m, 512, f64) for m in F64_LU_HEIGHTS] + [(4096, 128, f64)]
            sweep_plans += [(m, 512, c64) for m in (512, 1024, 1536, 2048, 4096)]
            sweep_plans += [(m, 512, c128) for m in (1536, 4096)]
            plan_sweep(dev, card, gen, round_robin, sweep_plans)
        n = 4096
        M = torch.randn(n, n, generator=gen).to(dev)
        v = torch.randn(n, generator=gen).to(dev)
        fns = {}
        for w in (128, 512):
            cfg_w = rt.LUConfig(panel_width=w)
            fns[f"tp_factor_w{w}"] = lambda w=w: rt.tp_lu_factor(M, tp_mesh, "tp", w)
            fns[f"lu_factor_w{w}"] = lambda c=cfg_w: rt.lu(M, check=False, config=c)
        Ftp = rt.tp_lu(M, tp_mesh, "tp", 128)
        Flu = rt.lu(M, check=False, config=rt.LUConfig(panel_width=128))
        fns["tp_solve_w128"] = lambda: rt.tp_lu_solve(Ftp, v, tp_mesh, "tp", 128)
        fns["lu_solve_w128"] = lambda: rt.lu_solve(Flu, v)
        fns["library_factor"] = lambda: torch.linalg.lu_factor_ex(M)
        t = round_robin(fns, rounds=5)
        emit("timing", what="tp_one_rank", card=card, n=n, dtype="float32", ranks=1,
             backend=dist.get_backend(tp_mesh.get_group("tp")), ms=t,
             tp_over_lu_w128=t["tp_factor_w128"] / t["lu_factor_w128"],
             tp_over_lu_w512=t["tp_factor_w512"] / t["lu_factor_w512"])
        del M, v, Ftp, Flu
        # complex64 tp at one rank beside complex64 lu at the same widths
        M = crandn(n, n, c64).to(dev)
        fns = {}
        for w in (128, 512):
            cfg_w = rt.LUConfig(panel_width=w)
            fns[f"tp_factor_w{w}"] = lambda w=w: rt.tp_lu_factor(M, tp_mesh, "tp", w)
            fns[f"lu_factor_w{w}"] = lambda c=cfg_w: rt.lu(M, check=False, config=c)
        fns["library_factor"] = lambda: torch.linalg.lu_factor_ex(M)
        t = round_robin(fns, rounds=5)
        emit("timing", what="tp_one_rank", card=card, n=n, dtype="complex64", ranks=1,
             backend=dist.get_backend(tp_mesh.get_group("tp")), ms=t,
             tp_over_lu_w128=t["tp_factor_w128"] / t["lu_factor_w128"],
             tp_over_lu_w512=t["tp_factor_w512"] / t["lu_factor_w512"])
        del M

    # ---- 4g. the bf16x3 form, in turns beside the float32 form -------------
    bf16x3_rows, grid_rows, tall_row = bf16x3_timing_phase(rt, dev, gen, card, round_robin,
                                                           timed)
    graph_phase(rt, dev, card, round_robin, tp_mesh, dp_mesh)

    if "--profile" in argv:
        profile(rt, card, gen, dev, tp_mesh)
    dist.destroy_process_group()

    # ---- 5. kernels ------------------------------------------------------
    main_row = kernel_rows[[r["shape"] for r in kernel_rows].index(list(main_shape(1536)[1]))]
    kernels = [{
        "name": "panel_lu",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches[(1536, "entry")],
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "dtype": "float32",
    }]
    crow = next(r for r in ckernel_rows
                if r["shape"] == list(main_shape(1536)[1]) and r["dtype"] == "complex64")
    # the complex kernel's two routes: the cluster route (the main path's)
    # and the grid route (panels too tall for a cluster; none on the main
    # path), timed forced on the same panel
    for name, route, key in (("panel_lu_c64", "cluster", "kernel_ms"),
                             ("panel_lu_c64_grid", "grid", "grid_ms")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE_C64,
            "replaces": REPLACES_C64,
            "launches": launches_c[(1536, "entry", c64)] if route == "cluster" else 0,
            "max_abs_err": max_err_c[route],
            "ms": crow[key],
            "plain_ms": crow["plain_ms"],
            "bound_ms": crow["bound_ms"],
            "bound_by": crow["bound_by"],
            "library_ms": crow["library_ms"],
            "shape": crow["shape"],
            "dtype": "complex64",
        })
    # each route's kernel at the shape of its own main-path run (the warp
    # routes at n = 16, the block and wide routes at n = 64, the tile route
    # on the tall batch)
    for name, at, key, lib in (("batched_lu_warp", 16, "swap", "library_factor"),
                               ("batched_lu_block", 64, "swap", "library_factor"),
                               ("batched_lu_swap", "tall", "swap", "library_factor"),
                               ("batched_lu_noswap_warp", 16, "noswap", "library_factor"),
                               ("batched_lu_noswap_block", 64, "noswap", "library_factor"),
                               ("batched_solve_warp", 16, "solve", "library_solve"),
                               ("batched_solve_wide", 64, "solve", "library_solve")):
        row = batched_rows[at]
        base_key = key.split("_")[0]  # the plain version and the bound
        shape = ([TALL_B, *TALL_SHAPE] if at == "tall"
                 else [BATCH_B, at, at] if base_key != "solve" else [BATCH_B, at, 1])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": BATCHED_KERNELS[name][0],
            "replaces": BATCHED_KERNELS[name][1],
            "launches": batched_launches[at][name],
            # against the plain version at this shape, in the batched phase
            # (else over every case of phase 2b)
            "max_abs_err": full_err[at].get(name, batched_err[name]),
            "max_abs_err_all_cases": max([batched_err[name]] + [
                e[name] for e in full_err.values() if name in e]),
            # device time (torch.profiler, every kernel of the call); the
            # CUDA-event time of queued wrapper calls, host included, beside
            "ms": row["dev"][key],
            "call_ms": row["t"][key],
            "plain_ms": row["plain"][base_key],
            "bound_ms": row["bounds"][base_key][0],
            "bound_by": row["bounds"][base_key][1],
            "library_ms": row["dev"][lib],
            "library_call_ms": row["t"][lib],
            "shape": shape,
            "dtype": "float32",
        })
    # the micro-blocked and no-swap kernels on their cluster routes (the main
    # path's) and on their grid routes (none on the main path: every panel
    # of these sizes fits a cluster), timed forced on the same panel
    nrow = new_rows[tuple(main_shape(1536)[1])]
    for name, run in (("panel_lu_micro_shadow", ("shadow", "entry", 1536, f32)),
                      ("panel_lu_micro_basic", ("basic", "entry", 1536, f32)),
                      ("panel_lu_noswap", ("physical", "entry", 1536, f32)),
                      ("panel_lu_micro_shadow_grid", None),
                      ("panel_lu_micro_basic_grid", None),
                      ("panel_lu_noswap_grid", None)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": NEW_PANEL_KERNELS[name][0],
            "replaces": NEW_PANEL_KERNELS[name][1],
            "launches": launches_o[run] if run else 0,
            "max_abs_err": new_err[name],
            "ms": nrow["t"][name],
            "plain_ms": nrow["plain"][name],
            "bound_ms": nrow["bound"][0],
            "bound_by": nrow["bound"][1],
            # the panel's LU by one library call (rows in pivot order)
            "library_ms": nrow["t"]["library"],
            "shape": list(main_shape(1536)[1]),
            "dtype": "float32",
        })
    orow = offset_rows[0]
    kernels.append({
        "name": "panel_lu_offset",
        "route": "cuda",
        "source": OFFSET_KERNEL[0],
        "replaces": OFFSET_KERNEL[1],
        # the tp phase's first run: tp_lu at n = 4096, w = 128, one rank
        "launches": tp_launches[("randn", 4096, 128, "float32")],
        "max_abs_err": offset_err,
        "ms": orow["kernel_ms"],
        "plain_ms": orow["plain_ms"],
        "bound_ms": orow["bound_ms"],
        "bound_by": orow["bound_by"],
        # torch.linalg.lu_factor_ex on the live rows panel[ofs:]
        "library_ms": orow["library_ms"],
        "shape": [H_o, w_o],
        "ofs": 0,
        "dtype": "float32",
    })
    # the complex offset kernel on its cluster route (the tp path's) and its
    # grid route (none on the path), timed forced on the same panel
    corow = coffset_rows[("complex64", 0)]
    for name, route, key in (("panel_lu_c64_offset", "cluster", "kernel_ms"),
                             ("panel_lu_c64_offset_grid", "grid", "grid_ms")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE_C64,
            "replaces": REPLACES_C64_OFFSET,
            # the tp phase's complex64 run: tp_lu at n = 4096, w = 128, one rank
            "launches": tp_launches[("crandn", 4096, 128, "complex64")] if route == "cluster"
            else 0,
            "max_abs_err": coffset_err[route],
            "ms": corow[key],
            "plain_ms": corow["plain_ms"],
            "bound_ms": corow["bound_ms"],
            "bound_by": corow["bound_by"],
            # torch.linalg.lu_factor_ex on the live rows panel[ofs:]
            "library_ms": corow["library_ms"],
            "shape": [4096, 128],
            "ofs": 0,
            "dtype": "complex64",
        })
    # the bf16x3 update's two kernels at the first boundary of the 1536 main
    # path's first panel: the tiled kernel (the main path's) and the simple
    # kernel (forced only); their launches are those of phase 3g's first
    # run (lu + lu_solve of the entry matrix at n = 1536 under
    # panel_boundary_precision='bf16x3')
    brow = bf16x3_rows[tuple(main_shape(1536)[1])]
    bcount = bf16x3_counts[(1536, "entry", "float32")]
    simple = bcount["bf16x3_simple_update_launches"]
    for name, key, launched in (
            ("panel_lu_bf16x3_update", "kernel", bcount["bf16x3_update_launches"] - simple),
            ("panel_lu_bf16x3_update_simple", "simple", simple)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": BF16X3_UPDATE[0],
            "replaces": BF16X3_UPDATE[1],
            "launches": launched,
            # against its plain version (ops/schur.py's split on the card),
            # over phase 2g's isolated updates
            "max_abs_err": bf16x3_err["tiled" if key == "kernel" else "simple"],
            # device time (torch.profiler) on operands rotated past the L2,
            # as the byte bound assumes; beside it the device time on the
            # same operands (L2-warm, as in the panel) and the CUDA-event
            # time of 20 queued wrapper calls, host included
            "ms": brow["device_ms_cold"][key],
            "warm_ms": brow["device_ms_warm"][key],
            "call_ms": brow[f"{key}_ms"],
            "plain_ms": brow["device_ms_cold"]["plain"],
            "plain_call_ms": brow["plain_ms"],
            "bound_ms": brow["bound_ms"],
            "bound_by": brow["bound_by"],
            # one float32 product C - L @ U (Tensor.addmm_, TF32 off): the
            # function the split approximates; no library call computes the
            # split itself
            "library_ms": brow["device_ms_cold"]["library"],
            "library_call_ms": brow["library_ms"],
            "shape": brow["shape"],
            "nb": brow["nb"],
            "dtype": "float32",
        })
    # the grid block chain (the blocked forms' chain for blocks too tall for a
    # cluster): its launches those of phase 3g's lu at n = 28 672 under the
    # knob; held bit for bit to the plain version (the micro-blocked route
    # with every block's chain on the grid, phase 2d) and to the cluster
    # chain (the bf16x3 form, phase 2g); timed as the 4096 x 512 bf16x3
    # panel with every block's chain on the grid, its chain kernels' device
    # time per step beside
    grow = grid_rows[(4096, 512)]
    kernels.append({
        "name": "panel_grid_chain",
        "route": "cuda",
        "source": BF16X3_UPDATE[0],
        "replaces": REPLACES,
        "launches": bf16x3_counts[(BF16X3_TALL_N, "randn", "float32")]["grid_block_launches"],
        "max_abs_err": max(new_err["panel_grid_chain"], bf16x3_err["grid_chain"]),
        "ms": grow["ms"]["bf16x3_grid_chain"],
        "plain_ms": grow["plain_ms"],
        "bound_ms": grow["bound_ms"],
        "bound_by": grow["bound_by"],
        "library_ms": grow["ms"]["library"],
        "chain_us_per_step": grow["chain_us_per_step"]["bf16x3_grid_chain"],
        "cluster_chain_us_per_step": grow["chain_us_per_step"]["bf16x3"],
        "lu_tall_ms": tall_row["ms"],
        "shape": grow["shape"],
        "block": grow["block"],
        "dtype": "float32",
    })
    # the RBT solver's depth-2 transform: its launches those of phase 3d's
    # workspace + factor + solve at n = 4096 (one a factor, one a solve),
    # held bit for bit to the tensor code there, timed on that matrix
    kernels.append({
        "name": "butterfly_depth2_kernel",
        "route": "cuda",
        "source": "recursivefactorization_jl_tpu_torch/csrc/butterfly.cu",
        # the JAX package leaves the transform to XLA, which fuses it
        "replaces": None,
        "launches": rbt_row["transform_launches"][f"float32_n{rbt_row['n']}"],
        "max_abs_err": rbt_row["transform_max_abs_err"],
        "ms": rbt_row["transform_kernel_ms"],
        "plain_ms": rbt_row["transform_tensor_ms"],
        "bound_ms": rbt_row["transform_bound_ms"],
        "bound_by": rbt_row["transform_bound_by"],
        "shape": [rbt_row["n"], rbt_row["n"]],
        "dtype": "float32",
    })
    # the mixed refinement's narrowing and residual kernels (the mixed phase)
    kernels += mixed_phase(rt, dev, card, round_robin)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
