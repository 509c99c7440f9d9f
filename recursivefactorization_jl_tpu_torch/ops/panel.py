"""Tall-panel LU factorization: the Hopper kernels and their routing.

``panel_factor`` factors an (m, w) panel, or a whole matrix, in place.
A CUDA tensor goes to a hand-written kernel.  float32/float64 panels:
``config.panel_variant`` picks csrc/panel_lu.cu (``'fori'`` / ``'fori2'``
/ ``'fori3'``, the port of the TPU kernel ``_panel_kernel_fori``) or one
of the two micro-blocked kernels of csrc/panel_lu_micro.cu (``'shadow'``:
the port of ``_panel_kernel_shadow``, the micro block staged in shared
memory; ``'basic'``: the port of ``_panel_kernel``, in place).
complex64/complex128 panels go to csrc/panel_lu_c64.cu (the port of
``_panel_kernel_fori_c64``) whatever the variant: the JAX package has no
other complex kernel either.  A CPU tensor goes to the kernel's plain
version in ops/unblocked.py: ``unblocked_lu``, ``micro_blocked_lu`` or,
for complex panels, ``unblocked_lu_cabs1``.

``panel_factor_noswap`` is the panel layer of ``schedule='physical'``:
csrc/panel_lu_noswap.cu (the port of ``_panel_kernel_noswap``) on the
card, ``unblocked_lu_noswap`` on the CPU.

There is no fallback between kernel and plain version: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import FORI_VARIANTS, PANEL_MICRO_MAX, LUConfig
from . import _kernels
from .unblocked import (
    micro_blocked_lu,
    unblocked_lu,
    unblocked_lu_cabs1,
    unblocked_lu_noswap,
)

_REAL = (torch.float32, torch.float64)
_COMPLEX = (torch.complex64, torch.complex128)

def panel_route(m: int, w: int, dtype, config: LUConfig, device="cuda") -> str:
    """Which implementation factors an (m, w) panel of ``dtype`` on
    ``device``:

    * ``"kernel"``: csrc/panel_lu.cu (CUDA; f32/f64, a fori variant) or
      csrc/panel_lu_c64.cu (complex64/complex128, any variant; the JAX
      package says ``"pallas-c64"``);
    * ``"kernel-shadow"`` / ``"kernel-basic"``: the staged / in-place
      micro-blocked kernel of csrc/panel_lu_micro.cu (CUDA; f32/f64,
      ``panel_variant`` ``'shadow'`` / ``'basic'``);
    * ``"unblocked"``: the plain version (CPU tensors, or
      ``backend='xla'`` on the CPU): the CABS1 one for complex panels;
    * ``"micro-blocked"``: the plain version of the micro-blocked
      kernels (CPU tensors, f32/f64, ``'shadow'`` or ``'basic'``).

    Complex panels ignore the variant.  The TPU package's ``"split"``
    route answers the program size of its statically unrolled kernels;
    it is not ported: the Hopper kernels take any width.
    """
    config.check_variants()
    micro = config.panel_variant not in FORI_VARIANTS and dtype in _REAL
    if torch.device(device).type != "cuda":
        return "micro-blocked" if micro else "unblocked"
    if dtype not in _REAL + _COMPLEX:
        raise NotImplementedError(
            "the Hopper panel kernels take float32/float64/complex64/"
            f"complex128, not {dtype} (half types reach them promoted to "
            "float32; integer and generic types: ROADMAP.md Queue 1 item 14)"
        )
    if config.backend == "xla":
        raise ValueError(
            "backend='xla' selects the plain panel, which runs only on "
            "CPU tensors"
        )
    return f"kernel-{config.panel_variant}" if micro else "kernel"


def _check_panel(what, panel, dtypes):
    """The argument checks the panel kernels share.  Returns ``(m, w,
    lda, device index, real dtype, bytes per real)``."""
    if not isinstance(panel, torch.Tensor) or panel.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor")
    if panel.dtype not in dtypes:
        names = "/".join(str(d)[6:] for d in dtypes)
        raise ValueError(f"panel dtype must be {names}, got {panel.dtype}")
    if panel.dim() != 2:
        raise ValueError(f"panel must be 2-D, got shape {tuple(panel.shape)}")
    if panel.is_conj():
        raise ValueError("panel must not be a lazily conjugated view")
    m, w = panel.shape
    if m < 1 or w < 1:
        raise ValueError(f"empty panel {tuple(panel.shape)}")
    if w > 1 and panel.stride(1) != 1:
        raise ValueError("panel rows must be contiguous (column stride 1)")
    lda = panel.stride(0) if m > 1 else w
    if lda < w or lda >= 2**31:
        raise ValueError(f"unsupported panel row stride {panel.stride(0)}")
    dev = panel.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    real = panel.real.dtype if panel.is_complex() else panel.dtype
    return m, w, lda, index, real, torch.finfo(real).bits // 8


def _launch_panel(wrapper, panel, pivot, lib_name, grid_fn, fn_by_real_size,
                  dtypes, ws_reals, grid_extra=(), fn_extra=()):
    """The checks, allocations and launch the swapping panel kernels
    share.  ``fn_by_real_size`` maps the byte size of the panel's real
    type to the C function; ``ws_reals(G, w)`` is the workspace size in
    reals; ``grid_extra`` follows the element size in the grid query and
    ``fn_extra`` follows ``pivot`` in the launch.  Adds one to
    ``wrapper.launches`` at the launch."""
    m, w, lda, index, real, size = _check_panel(wrapper.__name__, panel, dtypes)
    lib = _kernels.load(lib_name)
    dev = panel.device
    grid = getattr(lib, grid_fn)(m, w, size, *grid_extra, index)
    if grid < 1:
        _kernels.check(lib, -grid, f"{lib_name} grid query")
    piv = torch.empty(min(m, w), dtype=torch.int32, device=dev)
    perm = torch.empty(m, dtype=torch.int32, device=dev)
    info = torch.empty(1, dtype=torch.int32, device=dev)
    ws = torch.empty(ws_reals(grid, w), dtype=real, device=dev)
    iws = torch.empty(4 * grid + 4, dtype=torch.int32, device=dev)
    fn = getattr(lib, fn_by_real_size[size])
    stream = torch.cuda.current_stream(dev).cuda_stream
    wrapper.launches += 1
    code = fn(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), *fn_extra,
        piv.data_ptr(), perm.data_ptr(), info.data_ptr(), ws.data_ptr(),
        iws.data_ptr(), grid, index, stream,
    )
    _kernels.check(lib, code, f"{lib_name} launch")
    return piv, perm, info[0]


def panel_factor_cuda(panel: torch.Tensor, pivot: bool):
    """Launch the Hopper panel kernel on ``panel`` in place.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous (unit
    column stride, row stride >= w, as for a column block of a row-major
    matrix).  Returns ``(piv, perm, info)``: int32 (min(m, w),) 0-based
    pivot rows, int32 (m,) composed row permutation and a 0-d int32
    info, all on ``panel``'s device, allocated here.  Launches on the
    current stream and does not synchronise.  ``panel_factor_cuda.
    launches`` counts the launches."""
    return _launch_panel(
        panel_factor_cuda, panel, pivot, "panel_lu", "rf_panel_lu_grid",
        {4: "rf_panel_lu_f32", 8: "rf_panel_lu_f64"}, _REAL,
        lambda g, w: 2 * g + 2 * g * w + 2 * w,
    )


panel_factor_cuda.launches = 0


def panel_factor_c64_cuda(panel: torch.Tensor, pivot: bool):
    """Launch the Hopper complex panel kernel on ``panel`` in place, on
    its interleaved (re, im) storage.

    ``panel``: CUDA, complex64 or complex128, 2-D, rows contiguous (unit
    column stride, row stride >= w in complex elements), not a lazily
    conjugated view.  Pivots by CABS1 (``|re| + |im|``, first occurrence,
    LAPACK ``cgetrf``'s rule); a NaN among a step's candidates makes the
    pivot row m - 1.  The scale multiplies by ``conj(p) / |p|^2``, whose
    denominator overflows or underflows for pivots beyond the square
    root of the type's range (LAPACK's ``cladiv`` would not); the TPU
    kernel has the same limit.  Returns ``(piv, perm, info)`` as
    :func:`panel_factor_cuda` does, launches on the current stream and
    does not synchronise.  ``panel_factor_c64_cuda.launches`` counts the
    launches."""
    return _launch_panel(
        panel_factor_c64_cuda, panel, pivot, "panel_lu_c64",
        "rf_panel_lu_c_grid", {4: "rf_panel_lu_c64", 8: "rf_panel_lu_c128"},
        _COMPLEX, lambda g, w: 4 * g * w + 8 * w + 2 * g,
    )


panel_factor_c64_cuda.launches = 0


def micro_max_cuda() -> int:
    """The widest micro block the built csrc/panel_lu_micro.cu takes;
    raises if it is not the ``PANEL_MICRO_MAX`` the configuration checks."""
    limit = _kernels.load("panel_lu_micro").rf_panel_lu_micro_max()
    if limit != PANEL_MICRO_MAX:
        raise RuntimeError(
            f"csrc/panel_lu_micro.cu takes blocks of {limit} steps, "
            f"utils/config.py says {PANEL_MICRO_MAX}"
        )
    return limit


def _launch_micro(wrapper, panel, pivot, micro, shadow):
    if not isinstance(micro, int) or micro < 1:
        raise ValueError(f"micro must be a positive int, got {micro!r}")
    _check_panel(wrapper.__name__, panel, _REAL)
    micro = min(micro, *panel.shape)  # one block spans the whole panel
    if micro > micro_max_cuda():
        raise ValueError(
            f"the micro-blocked kernels take blocks of at most "
            f"{PANEL_MICRO_MAX} steps, got micro={micro}"
        )
    which = "shadow" if shadow else "basic"
    return _launch_panel(
        wrapper, panel, pivot, "panel_lu_micro", "rf_panel_lu_micro_grid",
        {4: f"rf_panel_lu_{which}_f32", 8: f"rf_panel_lu_{which}_f64"}, _REAL,
        lambda g, w: 2 * g + 2 * g * w + 2 * w,
        grid_extra=(micro, int(shadow)), fn_extra=(micro,),
    )


def panel_factor_shadow_cuda(panel: torch.Tensor, pivot: bool, micro: int):
    """Launch the staged micro-blocked kernel (``panel_variant='shadow'``)
    on ``panel`` in place: each thread block keeps its rows of the
    current ``micro``-wide block in shared memory.  Arguments, returns
    and stream rule as :func:`panel_factor_cuda`; ``micro`` is cut to
    min(m, w) and may then be at most ``PANEL_MICRO_MAX``.  Computes
    ``micro_blocked_lu(panel, pivot, micro)`` bitwise.
    ``panel_factor_shadow_cuda.launches`` counts the launches."""
    return _launch_micro(panel_factor_shadow_cuda, panel, pivot, micro, True)


panel_factor_shadow_cuda.launches = 0


def panel_factor_basic_cuda(panel: torch.Tensor, pivot: bool, micro: int):
    """Launch the in-place micro-blocked kernel (``panel_variant=
    'basic'``) on ``panel``: as :func:`panel_factor_shadow_cuda`, with
    the micro block read and written in device memory.
    ``panel_factor_basic_cuda.launches`` counts the launches."""
    return _launch_micro(panel_factor_basic_cuda, panel, pivot, micro, False)


panel_factor_basic_cuda.launches = 0


def panel_factor_noswap_cuda(panel: torch.Tensor, used0: torch.Tensor,
                             pivot: bool):
    """Launch the physical-order kernel on the full-height ``panel`` in
    place: no row moves.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous.
    ``used0``: (m,) on the same device, nonzero where an earlier panel
    consumed the row; at least min(m, w) rows should be free (a step
    that finds none writes -1 and does nothing).  Returns ``(prow, used,
    info)``: int32 (min(m, w),) pivot row of each step, int32 (m,) 0/1
    mask of the rows consumed so far, 0-d int32 info, all allocated
    here.  Computes ``unblocked_lu_noswap(panel, used0, pivot)`` bitwise.
    Launches on the current stream and does not synchronise.
    ``panel_factor_noswap_cuda.launches`` counts the launches."""
    m, w, lda, index, real, size = _check_panel(
        "panel_factor_noswap_cuda", panel, _REAL)
    dev = panel.device
    if (not isinstance(used0, torch.Tensor) or used0.device != dev
            or used0.shape != (m,) or used0.dtype.is_floating_point
            or used0.dtype.is_complex):
        raise ValueError(
            f"used0 must be an integer or bool ({m},) tensor on {dev}")
    used0 = used0.to(torch.int32).contiguous()
    lib = _kernels.load("panel_lu_noswap")
    grid = lib.rf_panel_lu_noswap_grid(m, w, size, index)
    if grid < 1:
        _kernels.check(lib, -grid, "panel_lu_noswap grid query")
    prow = torch.empty(min(m, w), dtype=torch.int32, device=dev)
    used = torch.empty(m, dtype=torch.int32, device=dev)
    info = torch.empty(1, dtype=torch.int32, device=dev)
    ws = torch.empty(2 * grid + 2 * grid * w, dtype=real, device=dev)
    iws = torch.empty(2 * grid, dtype=torch.int32, device=dev)
    fn = lib.rf_panel_lu_noswap_f32 if size == 4 else lib.rf_panel_lu_noswap_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    panel_factor_noswap_cuda.launches += 1
    code = fn(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), used0.data_ptr(),
        used.data_ptr(), prow.data_ptr(), info.data_ptr(), ws.data_ptr(),
        iws.data_ptr(), grid, index, stream,
    )
    _kernels.check(lib, code, "panel_lu_noswap launch")
    return prow, used, info[0]


panel_factor_noswap_cuda.launches = 0


def panel_factor(
    panel: torch.Tensor, pivot: bool, config: LUConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor a panel (m x w) **in place**.  Returns ``(panel, piv_local,
    perm_local, info_local)``: the factored panel itself, 0-based
    panel-local pivot rows, the composed panel-local row permutation and
    the 1-based (sign-carrying) panel-local info."""
    m, w = panel.shape
    route = panel_route(m, w, panel.dtype, config, panel.device)
    config.resolved_panel_boundary_precision()
    if route == "kernel":
        cplx = panel.dtype.is_complex
        launch = panel_factor_c64_cuda if cplx else panel_factor_cuda
        piv, perm, info = launch(panel, pivot)
    elif route == "kernel-shadow":
        piv, perm, info = panel_factor_shadow_cuda(
            panel, pivot, config.resolved_panel_micro())
    elif route == "kernel-basic":
        piv, perm, info = panel_factor_basic_cuda(
            panel, pivot, config.resolved_panel_micro())
    else:
        if route == "micro-blocked":
            f, piv, perm, info = micro_blocked_lu(
                panel, pivot, config.resolved_panel_micro())
        elif panel.dtype.is_complex:
            f, piv, perm, info = unblocked_lu_cabs1(panel, pivot)
        else:
            f, piv, perm, info = unblocked_lu(panel, pivot)
        panel.copy_(f)
    return panel, piv, perm, info


def panel_factor_noswap(panel: torch.Tensor, used0: torch.Tensor, pivot: bool):
    """Factor the full-height real ``panel`` **in place** in physical row
    order, skipping the rows ``used0`` marks.  Returns ``(prow, used,
    info)``.  CUDA tensors launch csrc/panel_lu_noswap.cu, CPU tensors
    run ``unblocked_lu_noswap``."""
    if panel.device.type == "cuda":
        return panel_factor_noswap_cuda(panel, used0, pivot)
    f, prow, used, info = unblocked_lu_noswap(panel, used0, pivot)
    panel.copy_(f)
    return prow, used, info
