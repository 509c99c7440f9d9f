#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernels-vs-plain only
    python3 chip_smoke.py --profile  # every phase + a device-time breakdown
    python3 chip_smoke.py --sweep    # every phase + the panel routing sweep
    python3 chip_smoke.py --log F    # also write the phase lines to file F

Phases, JSON lines each:

1. env      card name and power limit (nvidia-smi), torch/CUDA versions,
            the kernels' build seconds and ptxas resource lines;
2. kernel   the Hopper panel kernel against its plain PyTorch version on
            the main path's panel shapes, f32/f64, pivot on/off, a zeroed
            column and exact ties: ipiv, perm and info equal, factors
            bitwise equal (both round every product and difference once);
3. main     ``lu`` + ``lu_solve`` of the port at n=1536 (the entry
            matrix randn + n*I, plain randn, a zeroed column) and n=4096
            (randn): residual gate ||LU - A[p]||_max < 20*n*eps*max|A|,
            info, SingularMatrixError under check, the kernel's launch
            count, and no TF32 in any product;
4. timing   CUDA-event times: kernel per panel shape, factor and
            factor+solve at 1536/4096 beside torch.linalg.lu_factor_ex
            (+ lu_solve); with ``--sweep`` the width/route/tail sweep
            behind the routing defaults of utils/config.py;
5. kernels  one line for all ported kernels (launches, error, times,
            bound).

The batched small-matrix path adds, in the same order:

2b. batched_kernel  the swap, noswap and solve kernels against their
            plain versions: f32/f64, n = 16/64/128 and rectangular
            shapes, pivot on/off, zeroed columns in some matrices, exact
            ties, batch sizes 1000 and 37: ipiv, perm, info equal,
            factors and solutions bitwise equal;
3b. batched the four public functions at B = 10 000, n = 64 and n = 128,
            f32, plus the noswap kernel as its caller reaches it: every
            output held against the plain versions on the same inputs
            (ipiv, perm, info equal, factors and solutions bitwise equal:
            the error the ``kernels`` line reports), residual gate per
            matrix, ipiv equal to torch.linalg.lu_factor_ex's (f64:
            everywhere; f32: in all but at most 10 matrices, each a near
            tie of the two candidates at its first differing step), info
            exact on zeroed columns, one launch per call, no TF32 on the
            library-route solve;
4b. timing  swap, noswap, solve and factor+solve at n = 16/32/64/128,
            B = 10 000, in turns beside torch.linalg.lu_factor_ex and
            lu_solve; the plain versions once.

The complex and half-precision path adds:

2c. kernel  the complex panel kernel (csrc/panel_lu_c64.cu) against its
            plain version on the real and imaginary planes: complex64 and
            complex128, the main path's panel shapes, a whole 512 x 512
            matrix, a ragged tall and a fat panel, pivot on/off, a zeroed
            column, exact CABS1 ties, a NaN candidate: ipiv, perm and
            info equal, factors bitwise equal;
3c. main    ``lu`` + ``lu_solve`` (N, T, H) on complex64 at n=1536 (the
            entry matrix, plain randn, a zeroed column) and n=4096, on
            complex128 at 1536, and on bfloat16/float16 at 1536 through
            the promote route: the residual gate with the type's eps,
            info, SingularMatrixError under check, launch counts, no TF32
            product, pivots against torch.linalg.lu_factor_ex (where they
            part, the two candidates of the first differing step must tie
            to n*eps in a complex128 elimination), half pivots equal to
            the float32 run's;
4c. timing  the complex kernel per panel shape, complex64 factor and
            factor+solve at 1536/4096 in turns beside the library.

The opt-in schedules and the RBT solver add:

2d. kernel  the two micro-blocked kernels (csrc/panel_lu_micro.cu: staged
            ``shadow``, in-place ``basic``) against ``micro_blocked_lu``
            and each other, and the no-swap kernel
            (csrc/panel_lu_noswap.cu) against ``unblocked_lu_noswap``, on
            the main path's panels (the no-swap one also with half the
            rows taken by earlier panels), a whole 512 x 512, a ragged
            tall and (micro kernels) a fat panel: f32/f64, pivot on/off,
            a zeroed column, exact ties, micro 16/32: ipiv / prow, perm /
            used and info equal, factors bitwise equal; the same on
            column blocks of a 1536 x 1536 matrix (row stride n, as the
            blocked schedules hand them over), the no-swap kernel's
            second block under the mask its first one returned;
3d. main    ``lu`` + ``lu_solve`` under ``schedule='physical'`` at n=1536
            (entry matrix, randn, zeroed column) and 4096, f64 at 1536,
            and under ``panel_variant='shadow'`` / ``'basic'`` at 1536
            and 4096: residual gate, info, launch counts per kernel, no
            TF32 product, the permutation against the default route's
            (equal, or the two candidates of the first differing step tie
            to n*eps in an f64 elimination).  ``butterfly_solve`` on a
            Wilkinson matrix of n=800 in f64 (||Ax - b|| <= 1e-10) and on
            randn + n*I at n=1536 in f32 with refine 0 and 2 beside the
            pivoted ``lu_solve``; the panel kernel's launches with
            pivot=False;
4d. timing  the three kernels per panel shape in turns beside
            csrc/panel_lu.cu and torch.linalg.lu_factor_ex, their plain
            versions once; factor and factor+solve at 1536/4096 for the
            default route, ``physical``, ``shadow``, ``basic`` and the
            library in turns; RBT beside the pivoted solve; ``--sweep``
            adds micro 8/16/32/64 x panel width.

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
NEW_PANEL_KERNELS = {
    "panel_lu_micro_shadow": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_micro.cu",
                              "recursivefactorization_jl_tpu/ops/panel.py:266"),
    "panel_lu_micro_basic": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_micro.cu",
                             "recursivefactorization_jl_tpu/ops/panel.py:161"),
    "panel_lu_noswap": ("recursivefactorization_jl_tpu_torch/csrc/panel_lu_noswap.cu",
                        "recursivefactorization_jl_tpu/ops/panel.py:742"),
}
BATCHED_KERNELS = {
    "batched_lu_swap": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                        "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    "batched_lu_noswap": ("recursivefactorization_jl_tpu_torch/csrc/batched_lu.cu",
                          "recursivefactorization_jl_tpu/ops/batched_kernel.py:78"),
    "batched_solve": ("recursivefactorization_jl_tpu_torch/csrc/batched_solve.cu",
                      "recursivefactorization_jl_tpu/ops/batched_kernel.py:415"),
}
BATCH_B = 10000


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


def profile(rt, card, gen, dev):
    """Device time by kernel over one factor + solve at 1536 and 4096 in
    float32 (the default route, ``schedule='physical'`` and
    ``panel_variant='shadow'``) and complex64, over two RBT solves at
    1536, and over one batched factor + solve of 10 000 matrices at n = 64 and 128
    (torch.profiler), and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    def run(factor, solve, **what):
        solve(factor())
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            F = factor()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solve(F)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        wall = (t2 - t0) * 1e3
        emit("profile", card=card, factor_wall_ms=(t1 - t0) * 1e3,
             solve_wall_ms=(t2 - t1) * 1e3, device_busy_ms=busy,
             idle_share=1 - busy / wall if wall > 0 else None,
             top=[{"ms": r[0], "calls": r[1], "name": r[2]} for r in rows[:12]],
             **what)

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
    n = 1536
    M = (torch.randn(n, n, generator=gen) + n * torch.eye(n)).to(dev)
    v = torch.randn(n, generator=gen).to(dev)
    # "factor": workspace + solve; "solve": one more solve of the same workspace
    run(lambda: rt.butterfly_solve(rt.butterfly_workspace(M, v)),
        lambda x: rt.butterfly_solve(rt.butterfly_workspace(M, v)), n=n,
        dtype="float32", path="rbt (both halves: workspace + transform + factor + solve)")
    for n in (64, 128):
        A = torch.randn(BATCH_B, n, n, generator=gen).to(dev)
        b = torch.randn(BATCH_B, n, generator=gen).to(dev)
        run(lambda: rt.batched_lu_factor_perm(A),
            lambda F: rt.batched_lu_solve_perm(F[0], F[1], b),
            path="batched_perm", batch=BATCH_B, n=n)
        run(lambda: rt.batched_lu_factor(A),
            lambda F: rt.batched_lu_solve(F[0], F[1], b),
            path="batched_ipiv", batch=BATCH_B, n=n)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    import recursivefactorization_jl_tpu_torch as rt
    from recursivefactorization_jl_tpu_torch.ops import _kernels
    from recursivefactorization_jl_tpu_torch.ops.panel import (
        panel_factor_basic_cuda,
        panel_factor_c64_cuda,
        panel_factor_cuda,
        panel_factor_noswap_cuda,
        panel_factor_shadow_cuda,
    )
    from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
    from recursivefactorization_jl_tpu_torch.ops.unblocked import (
        micro_blocked_lu,
        unblocked_lu,
        unblocked_lu_cabs1,
        unblocked_lu_noswap,
    )

    quick = "--quick" in argv
    if "--log" in argv:
        global LOG
        path = argv[argv.index("--log") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        LOG = open(path, "w")
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. env ----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    build_s = time.perf_counter() - t0
    ptxas = [
        ln.strip() for rec in _kernels.BUILD_LOG.values()
        for ln in rec["log"].splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    ]
    emit("env", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=build_s, ptxas=ptxas)
    print(card, flush=True)

    cfg = rt.default_config()
    w_main = cfg.resolved_panel_width()

    def main_shape(n):
        route = rt.dispatch_route((n, n), torch.float32, True, cfg)
        return route, ((n, n) if route == "whole" else (n, w_main))

    def bits(t):
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)

    # ---- 2. kernel vs plain ---------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(1)
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
    # ---- 2c. the complex kernel vs plain ---------------------------------
    def crandn(m, w, dt):
        real = torch.float32 if dt == torch.complex64 else torch.float64
        return torch.complex(torch.randn(m, w, generator=gen, dtype=real),
                             torch.randn(m, w, generator=gen, dtype=real))

    def cbits(t):
        return bits(torch.view_as_real(t).contiguous())

    c64, c128 = torch.complex64, torch.complex128
    ccases = []
    for (m, w) in shapes:  # the main path's panels: the plain version once per case
        ccases += [((m, w), c64, "randn", True), ((m, w), c64, "zero_col", True),
                   ((m, w), c128, "randn", True)]
    ccases += [((512, 512), c64, "randn", True), ((512, 512), c64, "randn", False),
               ((512, 512), c128, "zero_col", False)]
    for (m, w) in ((777, 130), (130, 300)):  # ragged tall, fat
        for dt in (c64, c128):
            ccases += [((m, w), dt, "randn", True), ((m, w), dt, "randn", False),
                       ((m, w), dt, "zero_col", True), ((m, w), dt, "ties", True),
                       ((m, w), dt, "nan", True)]
    max_err_c = 0.0
    for (m, w), dt, name, pivot in ccases:
        X = crandn(m, w, dt)
        if name == "ties":
            real = X.real.dtype
            X = torch.complex(torch.randint(-2, 3, (m, w), generator=gen).to(real),
                              torch.randint(-2, 3, (m, w), generator=gen).to(real))
        if not pivot:
            X += max(m, w) * torch.eye(m, w, dtype=dt)
        if name == "zero_col":
            X[:, min(5, w - 1)] = 0
        if name == "nan":
            X[m // 2, 7] = complex(float("nan"), 1.0)
        A = X.to(dev)
        f_p, piv_p, perm_p, info_p = unblocked_lu_cabs1(A, pivot)
        P = A.clone()
        piv_k, perm_k, info_k = panel_factor_c64_cuda(P, pivot)
        torch.cuda.synchronize()
        same = {
            "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
            "perm_equal": bool(torch.equal(perm_k, perm_p)),
            "info_equal": int(info_k) == int(info_p),
            "bitwise": bool(torch.equal(cbits(P), cbits(f_p))),
        }
        if name == "nan":
            same["nan_rows_pivot_last"] = bool((piv_k[7:] == m - 1).all())
        err = float(torch.view_as_real(P - f_p).abs().nan_to_num(0.0, 0.0, 0.0).max())
        max_err_c = max(max_err_c, err)
        emit("kernel", kernel="panel_lu_c64", shape=[m, w], dtype=str(dt)[6:],
             input=name, pivot=pivot, info=int(info_k), max_abs_err=err, **same)
        if not all(same.values()):
            fail(f"complex kernel disagrees with its plain version: {same}")
        if name == "zero_col" and int(info_k) != (6 if pivot else -6):
            fail(f"zeroed column 5 gave info {int(info_k)}")
    for bad in (torch.zeros(8, 4, device=dev), torch.zeros(8, 4, dtype=c64),
                torch.zeros(8, 4, device=dev, dtype=c64).T):
        try:
            panel_factor_c64_cuda(bad, True)
        except ValueError:
            continue
        fail(f"panel_factor_c64_cuda took {tuple(bad.shape)} {bad.dtype} {bad.device}")

    # ---- 2d. the micro-blocked and the no-swap kernels vs plain -----------
    f32, f64 = torch.float32, torch.float64
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
        return X

    new_err = {k: 0.0 for k in NEW_PANEL_KERNELS}
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
    for (m, w), dt, name, pivot, micro in mcases:
        A = real_input(name, m, w, dt, pivot).to(dev)
        f_p, piv_p, perm_p, info_p = micro_blocked_lu(A, pivot, micro)
        outs = {}
        for kern, wrapper in micro_wrappers.items():
            P = A.clone()
            piv_k, perm_k, info_k = wrapper(P, pivot, micro)
            torch.cuda.synchronize()
            outs[kern] = P
            same = {
                "ipiv_equal": bool(torch.equal(piv_k, piv_p)),
                "perm_equal": bool(torch.equal(perm_k, perm_p)),
                "info_equal": int(info_k) == int(info_p),
                "bitwise": bool(torch.equal(bits(P), bits(f_p))),
            }
            err = float((P - f_p).abs().nan_to_num(0.0).max())
            new_err[kern] = max(new_err[kern], err)
            emit("kernel", kernel=kern, shape=[m, w], dtype=str(dt)[6:], input=name,
                 pivot=pivot, micro=micro, info=int(info_k), max_abs_err=err, **same)
            if not all(same.values()):
                fail(f"{kern} disagrees with its plain version: {same}")
            if name == "zero_col" and int(info_k) != (6 if pivot else -6):
                fail(f"zeroed column 5 gave info {int(info_k)}")
        if not torch.equal(bits(outs["panel_lu_micro_shadow"]),
                           bits(outs["panel_lu_micro_basic"])):
            fail("the staged and the in-place micro kernel differ")
        del outs

    ncases = []  # shape, dtype, input, pivot, share of rows taken before
    for (m, w) in shapes:
        ncases += [((m, w), f32, "randn", True, 0.0), ((m, w), f32, "randn", True, 0.5)]
    ncases += [(shapes[0], f32, "zero_col", True, 0.5), (shapes[0], f32, "randn", False, 0.5),
               (shapes[0], f64, "randn", True, 0.5), (shapes[-1], f32, "ties", True, 0.0),
               ((512, 512), f32, "randn", True, 0.0), ((512, 512), f64, "zero_col", False, 0.0)]
    for dt in (f32, f64):
        ncases += [((777, 130), dt, "randn", True, 0.3), ((777, 130), dt, "ties", True, 0.3),
                   ((777, 130), dt, "zero_col", False, 0.0)]
    for (m, w), dt, name, pivot, share in ncases:
        A = real_input(name, m, w, dt, True).to(dev)  # unpivoted: rows in order
        used0 = torch.zeros(m, dtype=torch.int32)
        taken = int(share * m)
        used0[torch.randperm(m, generator=gen)[:taken]] = 1
        used0 = used0.to(dev)
        f_p, prow_p, used_p, info_p = unblocked_lu_noswap(A, used0, pivot)
        P = A.clone()
        prow_k, used_k, info_k = panel_factor_noswap_cuda(P, used0, pivot)
        torch.cuda.synchronize()
        same = {
            "prow_equal": bool(torch.equal(prow_k, prow_p)),
            "used_equal": bool(torch.equal(used_k, used_p)),
            "info_equal": int(info_k) == int(info_p),
            "bitwise": bool(torch.equal(bits(P), bits(f_p))),
            "taken_rows_untouched": bool(torch.equal(P[used0.bool()], A[used0.bool()])),
            "used_count": int(used_k.sum()) == taken + min(m, w),
        }
        err = float((P - f_p).abs().nan_to_num(0.0).max())
        new_err["panel_lu_noswap"] = max(new_err["panel_lu_noswap"], err)
        emit("kernel", kernel="panel_lu_noswap", shape=[m, w], dtype=str(dt)[6:],
             input=name, pivot=pivot, rows_taken_before=taken, info=int(info_k),
             max_abs_err=err, **same)
        if not all(same.values()):
            fail(f"panel_lu_noswap disagrees with its plain version: {same}")
        if name == "zero_col" and int(info_k) != (6 if pivot else -6):
            fail(f"zeroed column 5 gave info {int(info_k)}")
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
            prow_k, used_k_next, info_k = panel_factor_noswap_cuda(W[:, block], used_k, True)
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
                lambda: panel_factor_basic_cuda(torch.zeros(200, 100, device=dev), True, 65),
                lambda: panel_factor_noswap_cuda(torch.zeros(8, 4, device=dev),
                                                 torch.zeros(7, dtype=torch.int32, device=dev), True),
                lambda: panel_factor_noswap_cuda(torch.zeros(8, 4),
                                                 torch.zeros(8, dtype=torch.int32), True)):
        try:
            bad()
        except ValueError:
            continue
        fail("a new panel wrapper took an argument it must refuse")

    # ---- 2b. batched kernels vs plain -----------------------------------
    def same_bits(x, y):
        return bool(torch.equal(bits(x.contiguous()), bits(y.contiguous())))

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
        if name == "zero_col":
            # a zeroed column in every seventh matrix, at a column that
            # changes with the matrix
            for i in range(3, B, 7):
                c = i % min(m, n)
                X[i, :, c] = 0
                want[i] = c + 1 if pivot else -(c + 1)
        return X.to(dev), want.to(dev)

    batched_err = {k: 0.0 for k in BATCHED_KERNELS}
    lu_shapes = [(1000, 16, 16), (1000, 64, 64), (37, 128, 128), (37, 96, 40), (37, 40, 96)]
    n_cases = 0
    for (B, m, n) in lu_shapes:
        for dt in (torch.float32, torch.float64):
            for name, pivot in (("randn", True), ("zero_col", True), ("ties", True),
                                ("randn", False), ("zero_col", False)):
                A, want = batch_input(name, B, m, n, dt, pivot)
                kernels = ["batched_lu_swap"] + (["batched_lu_noswap"] if m == n else [])
                for kern in kernels:
                    if kern == "batched_lu_swap":
                        f_p, ipiv_p, perm_p, info_p = bk.batched_lu_plain(A, pivot, True)
                        f_k, ipiv_k, perm_k, info_k = bk.batched_lu_cuda(A, pivot, True)
                        torch.cuda.synchronize()
                        same = {
                            "ipiv_equal": bool(torch.equal(ipiv_k, ipiv_p)),
                            "perm_is_folded_ipiv": bool(torch.equal(
                                perm_k, rt.batched_ipiv_to_perm(ipiv_k, m))),
                        }
                        _, _, none_perm, _ = bk.batched_lu_cuda(A, pivot, False)
                        same["no_perm_is_none"] = none_perm is None
                    else:
                        f_p, perm_p, info_p = bk.batched_lu_noswap_plain(A, pivot)
                        f_k, perm_k, info_k = bk.batched_lu_noswap_cuda(A, pivot)
                        torch.cuda.synchronize()
                        same = {}
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
    for (B, n) in ((1000, 16), (1000, 64), (37, 128)):
        for dt in (torch.float32, torch.float64):
            A, _ = batch_input("randn", B, n, n, dt, True)
            A[5, :, n // 3] = 0  # a singular matrix: inf/nan there and only there
            f, ipiv, perm, info = bk.batched_lu_cuda(A, True, True)
            for nrhs in (None, 3):
                b = torch.randn((B, n) if nrhs is None else (B, n, nrhs),
                                generator=gen, dtype=dt).to(dev)
                x_p = bk.batched_solve_plain(f, b)
                x_k = bk.batched_solve_cuda(f, b)
                xp_p = bk.batched_solve_plain(f, b, perm=perm)
                xp_k = bk.batched_solve_cuda(f, b, perm=perm)
                xi_k = bk.batched_solve_cuda(f, b, ipiv=ipiv)
                torch.cuda.synchronize()
                ok_rows = info == 0
                finite_k = torch.isfinite(x_k.reshape(B, -1)).all(dim=1)
                same = {
                    "bitwise_nonsingular": same_bits(x_k[ok_rows], x_p[ok_rows]),
                    "bitwise_with_perm": same_bits(xp_k[ok_rows], xp_p[ok_rows]),
                    "bitwise_with_ipiv": same_bits(xi_k[ok_rows], xp_p[ok_rows]),
                    "nonfinite_same_place": bool(torch.equal(
                        torch.isfinite(x_k), torch.isfinite(x_p))),
                    "nonfinite_only_where_singular": bool(torch.equal(finite_k, ok_rows)),
                }
                err = abs_err(x_k[ok_rows], x_p[ok_rows])
                batched_err["batched_solve"] = max(batched_err["batched_solve"], err)
                n_cases += 1
                emit("batched_kernel", kernel="batched_solve", shape=[B, n, n],
                     rhs=list(b.shape), dtype=str(dt)[6:], max_abs_err=err, **same)
                if not all(same.values()):
                    fail(f"batched_solve disagrees with its plain version: {same}")
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

    if quick:
        print(json.dumps({"ok": True, "quick": True}))
        return 0

    # ---- 3. main path ----------------------------------------------------
    matmuls = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul,
               torch.Tensor.__matmul__, torch.Tensor.mm, torch.addmm,
               torch.Tensor.addmm_, torch.linalg.solve_triangular}
    from torch.overrides import TorchFunctionMode

    class TF32Watch(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.flags = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls:
                self.flags.append(torch.backends.cuda.matmul.allow_tf32)
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
        panel_factor_cuda.launches = 0
        with watch:
            F = rt.lu(A, check=False)
            x = rt.lu_solve(F, b)
            torch.cuda.synchronize()
        got = panel_factor_cuda.launches
        launches[(n, name)] = got
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
        panel_factor_cuda.launches = 0
        panel_factor_c64_cuda.launches = 0
        with watch:
            F = rt.lu(A, check=False)
            xs = {t: rt.lu_solve(F, b, trans=t) for t in ("N", "T", "H")}
            torch.cuda.synchronize()
        got = {"panel_lu": panel_factor_cuda.launches,
               "panel_lu_c64": panel_factor_c64_cuda.launches}
        want = {"panel_lu": 0 if cplx else expect, "panel_lu_c64": expect if cplx else 0}
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
        for wr in panel_wrappers.values():
            wr.launches = 0
        with watch:
            F = rt.lu(A, check=False, config=ocfg)
            x = rt.lu_solve(F, b)
            torch.cuda.synchronize()
        got = {k: wr.launches for k, wr in panel_wrappers.items()}
        want = {k: (expect if k == kern else 0) for k in panel_wrappers}
        launches_o.setdefault((what, name, n, dt), got[kern])
        r, g = resid_gate(A, F)
        sr = solve_resid(A, x, b)
        info = int(F.info)
        eps = torch.finfo(dt).eps
        F0 = rt.lu(A, check=False)  # the default route
        differ = int((F.p != F0.p).sum())
        rec = dict(config=what, n=n, input=name, dtype=str(dt)[6:], route=route,
                   launches=got, expected_launches=want, resid=r, gate=g,
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
    panel_factor_cuda.launches = 0
    torch.backends.cuda.matmul.allow_tf32 = True
    watch = TF32Watch()
    with watch:
        ws = rt.butterfly_workspace(W, wb)
        xw, winfo = rt.butterfly_solve(ws, return_info=True)
        torch.cuda.synchronize()
    restored = torch.backends.cuda.matmul.allow_tf32 is True
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    werr = float(np.linalg.norm(W @ xw.cpu().numpy() - wb))
    rbt_launches = panel_factor_cuda.launches
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
    panel_factor_cuda.launches = 0
    ws = rt.butterfly_workspace(Ae, be)
    xr = {k: rt.butterfly_solve(ws, refine=k) for k in (0, 2)}
    torch.cuda.synchronize()
    rbt_launches_1536 = panel_factor_cuda.launches
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

    # ---- 3b. the batched path -------------------------------------------
    wrappers = {"batched_lu_swap": bk.batched_lu_cuda,
                "batched_lu_noswap": bk.batched_lu_noswap_cuda,
                "batched_solve": bk.batched_solve_cuda}

    def batch_resid(A, f, perm):
        """Per matrix max|LU - A[perm]| and its gate, in f64."""
        n = A.shape[1]
        fd = f.double()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        LU_ = torch.bmm(torch.tril(fd, -1) + eye, torch.triu(fd))
        LU_ -= A.double().gather(1, perm.long()[:, :, None].expand(-1, -1, n))
        r = LU_.abs().amax(dim=(1, 2))
        g = 20 * n * torch.finfo(A.dtype).eps * A.abs().amax(dim=(1, 2)).double()
        return r, g

    def batch_solve_resid(A, x, b):
        Ad, xd, bd = A.double(), x.double(), b.double()
        r = torch.bmm(Ad, xd[:, :, None])[:, :, 0] - bd
        return r.norm(dim=1) / (Ad.flatten(1).norm(dim=1) * xd.norm(dim=1))

    def first_choice_gap(Ai, piv_a, piv_b):
        """Two pivot sequences of one matrix part at step k.  Eliminate k
        steps in f64 with the pivots they share and return k and
        ||c[a]| - |c[b]|| / max|c| for the two rows chosen there from
        column k."""
        k = int((piv_a != piv_b).nonzero()[0])
        M = Ai.double().cpu()
        for j in range(k):
            pj = int(piv_a[j])
            M[[j, pj]] = M[[pj, j]]
            M[j + 1:, j] /= M[j, j]
            M[j + 1:, j + 1:] -= torch.outer(M[j + 1:, j], M[j, j + 1:])
        c = M[:, k].abs()
        return k, float((c[int(piv_a[k])] - c[int(piv_b[k])]).abs() / c[k:].max())

    batched_launches = {}
    full_err = {}
    for n in (64, 128):
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
        for w in wrappers.values():
            w.launches = 0
        # the path, as a user calls it
        f1, perm1, info1 = rt.batched_lu_factor_perm(A)
        x1 = rt.batched_lu_solve_perm(f1, perm1, b)
        f2, ipiv2, info2 = rt.batched_lu_factor(A)
        x2 = rt.batched_lu_solve(f2, ipiv2, b3)
        f3, perm3, info3 = bk.batched_lu_noswap(A)
        x3 = rt.batched_lu_solve_perm(f3, perm3, b)
        _, _, infoz = rt.batched_lu_factor(Z)
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        batched_launches[n] = got
        expect = {"batched_lu_swap": 3, "batched_lu_noswap": 1, "batched_solve": 3}
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
            "batched_lu_swap": max(abs_err(f1, fp), abs_err(f2, fp)),
            "batched_lu_noswap": abs_err(f3, fn),
            "batched_solve": max(abs_err(x1, xp1), abs_err(x2, xp2), abs_err(x3, xp3)),
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

    # ---- 4. timing -------------------------------------------------------
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

    kernel_rows = []
    for (m, w) in shapes:
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        reset = lambda: P.copy_(X)  # noqa: E731
        k_ms, _ = timed(lambda: panel_factor_cuda(P, True), reset, reps=10)
        p_ms, _ = timed(lambda: unblocked_lu(X, True), None, reps=2, warm=1)
        with quiet_c_stdout():
            l_ms, _ = timed(lambda: torch.linalg.lu_factor_ex(P), reset, reps=10)
        b_ms, b_by = bound(m, w, "float32", 4)
        row = dict(shape=[m, w], dtype="float32", kernel_ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                   us_per_step=1e3 * k_ms / min(m, w))
        kernel_rows.append(row)
        emit("timing", what="panel_kernel", card=card, **row)

    ckernel_rows = []
    for (m, w) in shapes + [(512, 512)]:
        for dt in (c64, c128):
            if dt == c128 and (m, w) != main_shape(1536)[1]:
                continue
            X = crandn(m, w, dt).to(dev)
            P = torch.empty_like(X)
            reset = lambda: P.copy_(X)  # noqa: E731
            k_ms, _ = timed(lambda: panel_factor_c64_cuda(P, True), reset, reps=10)
            p_ms, _ = timed(lambda: unblocked_lu_cabs1(X, True), None, reps=1, warm=0)
            with quiet_c_stdout():
                l_ms, _ = timed(lambda: torch.linalg.lu_factor_ex(P), reset, reps=10)
            b_ms, b_by = bound(m, w, str(dt)[6:], X.element_size())
            row = dict(shape=[m, w], dtype=str(dt)[6:], kernel_ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                       us_per_step=1e3 * k_ms / min(m, w))
            ckernel_rows.append(row)
            emit("timing", what="panel_kernel_c64", card=card, **row)

    def round_robin(fns, rounds=7, warm=1, inner=1, setup=None):
        """Median CUDA-event ms of each callable, run in turns (every
        round times each once), so host noise spreads over all of them.
        With ``inner`` > 1 a turn queues the callable that many times
        between its two events and the time is per call: the device stays
        fed and the host's launch latency falls out of a sub-millisecond
        kernel's time.  ``setup`` runs before each timing, outside it."""
        ts = {k: [] for k in fns}
        for r in range(warm + rounds):
            for k, fn in fns.items():
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
        batched_rows = {}
        for n in (16, 32, 64, 128):
            A = torch.randn(BATCH_B, n, n, generator=gen).to(dev)
            b = torch.randn(BATCH_B, n, generator=gen).to(dev)
            f, perm, _ = rt.batched_lu_factor_perm(A)
            _, ipiv, _ = rt.batched_lu_factor(A)
            rhs = b.gather(1, perm.long())
            lib_lu, lib_piv, _ = torch.linalg.lu_factor_ex(A)
            ident = torch.arange(1, n + 1, dtype=lib_piv.dtype, device=dev).repeat(BATCH_B, 1)

            def lib_fs():
                LU_, piv, _ = torch.linalg.lu_factor_ex(A)
                torch.linalg.lu_solve(LU_, piv, b[:, :, None])

            t = round_robin({
                "swap": lambda: bk.batched_lu_cuda(A, True, True),
                "swap_no_perm": lambda: bk.batched_lu_cuda(A, True, False),
                "noswap": lambda: bk.batched_lu_noswap_cuda(A, True),
                "solve": lambda: bk.batched_solve_cuda(f, rhs),
                "solve_with_perm": lambda: bk.batched_solve_cuda(f, b, perm=perm),
                "solve_with_ipiv": lambda: bk.batched_solve_cuda(f, b, ipiv=ipiv),
                "perm_factor_solve": lambda: rt.batched_lu_solve_perm(
                    *rt.batched_lu_factor_perm(A)[:2], b),
                "ipiv_factor_solve": lambda: rt.batched_lu_solve(
                    *rt.batched_lu_factor(A)[:2], b),
                "ipiv_to_perm": lambda: rt.batched_ipiv_to_perm(ipiv, n),
                "library_factor": lambda: torch.linalg.lu_factor_ex(A),
                # the same function as the solve kernel: no row exchange
                "library_solve": lambda: torch.linalg.lu_solve(f, ident, rhs[:, :, None]),
                "library_solve_with_pivots": lambda: torch.linalg.lu_solve(
                    lib_lu, lib_piv, b[:, :, None]),
                "library_factor_solve": lib_fs,
            }, inner=4)
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
            batched_rows[n] = dict(t=t, plain=plain, bounds=bounds)
            emit("timing", what="batched", card=card, batch=BATCH_B, n=n,
                 dtype="float32", kernel_ms=t, plain_ms=plain,
                 bound_ms={k: v[0] for k, v in bounds.items()},
                 bound_by={k: v[1] for k, v in bounds.items()},
                 launches_per_timing=4,
                 noswap_over_swap=t["noswap"] / t["swap"])
            del A, b, f, rhs, lib_lu

        # f64 at the main size: the same kernels on the card's f64 units
        A = torch.randn(BATCH_B, 64, 64, generator=gen, dtype=torch.float64).to(dev)
        b = torch.randn(BATCH_B, 64, generator=gen, dtype=torch.float64).to(dev)
        f, perm, _ = rt.batched_lu_factor_perm(A)
        t = round_robin({
            "swap": lambda: bk.batched_lu_cuda(A, True, True),
            "noswap": lambda: bk.batched_lu_noswap_cuda(A, True),
            "solve_with_perm": lambda: bk.batched_solve_cuda(f, b, perm=perm),
            "library_factor": lambda: torch.linalg.lu_factor_ex(A),
        }, inner=4)
        emit("timing", what="batched", card=card, batch=BATCH_B, n=64,
             dtype="float64", kernel_ms=t, launches_per_timing=4,
             bound_ms={"swap": batched_lu_bound(BATCH_B, 64, 64, "float64", 8)[0],
                       "solve_with_perm": batched_solve_bound(BATCH_B, 64, 1, "float64", 8)[0]})
        del A, b, f

    # ---- 4d. the new panel kernels, the opt-in schedules, RBT -------------
    micro_main = rt.LUConfig().resolved_panel_micro()
    new_rows = {}
    for (m, w) in shapes:
        X = torch.randn(m, w, generator=gen).to(dev)
        P = torch.empty_like(X)
        none_used = torch.zeros(m, dtype=torch.int32, device=dev)
        half_used = none_used.clone()
        half_used[torch.randperm(m, generator=gen)[: m // 2].to(dev)] = 1
        with quiet_c_stdout():
            t = round_robin({
                "panel_lu": lambda: panel_factor_cuda(P, True),
                "panel_lu_micro_shadow": lambda: panel_factor_shadow_cuda(P, True, micro_main),
                "panel_lu_micro_basic": lambda: panel_factor_basic_cuda(P, True, micro_main),
                "panel_lu_noswap": lambda: panel_factor_noswap_cuda(P, none_used, True),
                "panel_lu_noswap_half_used": lambda: panel_factor_noswap_cuda(P, half_used, True),
                "library": lambda: torch.linalg.lu_factor_ex(P),
            }, rounds=9, setup=lambda: P.copy_(X))
        plain = {
            "panel_lu_micro_shadow": timed(lambda: micro_blocked_lu(X, True, micro_main),
                                           reps=1, warm=0)[0],
            "panel_lu_noswap": timed(lambda: unblocked_lu_noswap(X, none_used, True),
                                     reps=1, warm=0)[0],
        }
        plain["panel_lu_micro_basic"] = plain["panel_lu_micro_shadow"]  # one plain version
        b_ms, b_by = bound(m, w, "float32", 4)
        hb_ms, _ = bound(m - m // 2, w, "float32", 4)  # the rows this mask leaves
        new_rows[(m, w)] = dict(t=t, plain=plain, bound=(b_ms, b_by))
        emit("timing", what="new_panel_kernels", card=card, shape=[m, w], dtype="float32",
             micro=micro_main, kernel_ms=t, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
             bound_ms_half_used=hb_ms,
             us_per_step={k: 1e3 * v / min(m, w) for k, v in t.items()})
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

    if "--profile" in argv:
        profile(rt, card, gen, dev)

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
    kernels.append({
        "name": "panel_lu_c64",
        "route": "cuda",
        "source": SOURCE_C64,
        "replaces": REPLACES_C64,
        "launches": launches_c[(1536, "entry", c64)],
        "max_abs_err": max_err_c,
        "ms": crow["kernel_ms"],
        "plain_ms": crow["plain_ms"],
        "bound_ms": crow["bound_ms"],
        "bound_by": crow["bound_by"],
        "library_ms": crow["library_ms"],
        "shape": crow["shape"],
        "dtype": "complex64",
    })
    row = batched_rows[64]
    for name, key, lib in (("batched_lu_swap", "swap", "library_factor"),
                           ("batched_lu_noswap", "noswap", "library_factor"),
                           ("batched_solve", "solve", "library_solve")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": BATCHED_KERNELS[name][0],
            "replaces": BATCHED_KERNELS[name][1],
            "launches": batched_launches[64][name],
            # against the plain version at this shape, in the batched phase
            "max_abs_err": full_err[64][name],
            "max_abs_err_all_cases": max(batched_err[name], full_err[128][name]),
            "ms": row["t"][key],
            "plain_ms": row["plain"][key],
            "bound_ms": row["bounds"][key][0],
            "bound_by": row["bounds"][key][1],
            "library_ms": row["t"][lib],
            "shape": [BATCH_B, 64, 64] if key != "solve" else [BATCH_B, 64, 1],
            "dtype": "float32",
        })
    nrow = new_rows[tuple(main_shape(1536)[1])]
    for name, run in (("panel_lu_micro_shadow", ("shadow", "entry", 1536, f32)),
                      ("panel_lu_micro_basic", ("basic", "entry", 1536, f32)),
                      ("panel_lu_noswap", ("physical", "entry", 1536, f32))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": NEW_PANEL_KERNELS[name][0],
            "replaces": NEW_PANEL_KERNELS[name][1],
            "launches": launches_o[run],
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
