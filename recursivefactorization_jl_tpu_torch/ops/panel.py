"""Tall-panel LU factorization: the Hopper kernels and their routing.

``panel_factor`` factors an (m, w) panel, or a whole matrix, in place.
A CUDA tensor goes to a hand-written kernel: float32/float64 to
csrc/panel_lu.cu (the port of the TPU kernel ``_panel_kernel_fori``),
complex64/complex128 to csrc/panel_lu_c64.cu (the port of
``_panel_kernel_fori_c64``).  A CPU tensor goes to the kernel's plain
version in ops/unblocked.py: ``unblocked_lu`` for real panels,
``unblocked_lu_cabs1`` for complex ones.  There is no fallback between
the two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import LUConfig
from . import _kernels
from .unblocked import unblocked_lu, unblocked_lu_cabs1

_REAL = (torch.float32, torch.float64)
_COMPLEX = (torch.complex64, torch.complex128)


def panel_route(m: int, w: int, dtype, config: LUConfig, device="cuda") -> str:
    """Which implementation factors an (m, w) panel of ``dtype`` on
    ``device``:

    * ``"kernel"``: a Hopper kernel (CUDA; f32/f64, a fori variant, or
      complex64/complex128, where the JAX package says ``"pallas-c64"``);
    * ``"unblocked"``: the plain version (CPU tensors, or
      ``backend='xla'`` on the CPU): the CABS1 one for complex panels.

    Variants without a Hopper kernel raise ``NotImplementedError``.  The
    TPU package's ``"split"`` route answers Mosaic's program-size and
    VMEM limits; it is not ported.
    """
    config.check_variants()
    if torch.device(device).type != "cuda":
        return "unblocked"
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
    return "kernel"


def _launch_panel(wrapper, panel, pivot, lib_name, grid_fn, fn_by_real_size,
                  dtypes, ws_reals):
    """The argument checks, allocations and launch the two panel kernels
    share.  ``fn_by_real_size`` maps the byte size of the panel's real
    type to the C function; ``ws_reals(G, w)`` is the workspace size in
    reals.  Adds one to ``wrapper.launches`` at the launch."""
    what = wrapper.__name__
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
    lib = _kernels.load(lib_name)
    dev = panel.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    real = panel.real.dtype if panel.is_complex() else panel.dtype
    size = torch.finfo(real).bits // 8
    grid = getattr(lib, grid_fn)(m, w, size, index)
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
        panel.data_ptr(), m, w, lda, int(bool(pivot)), piv.data_ptr(),
        perm.data_ptr(), info.data_ptr(), ws.data_ptr(), iws.data_ptr(),
        grid, index, stream,
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
    cplx = panel.dtype.is_complex
    if route == "kernel":
        launch = panel_factor_c64_cuda if cplx else panel_factor_cuda
        piv, perm, info = launch(panel, pivot)
        return panel, piv, perm, info
    plain = unblocked_lu_cabs1 if cplx else unblocked_lu
    f, piv, perm, info = plain(panel, pivot)
    panel.copy_(f)
    return panel, piv, perm, info
