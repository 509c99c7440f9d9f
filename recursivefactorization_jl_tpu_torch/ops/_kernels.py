"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  Libraries go to
``BUILD_DIR`` (:func:`default_build_dir`: ``build/kernels/`` of the
checkout the package sits in, which ``.gitignore`` lists, or a user cache
directory for an installed package; ``utils.warmup.enable_persistent_cache``
moves it), named by a hash of the source, the headers the sources share
and the flags, so a changed source is rebuilt at its first use.  The
sources and headers are the package's data, so an installed wheel builds
them too.  Nothing here runs at import time but the directory's
resolution.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
# the build directory of an installed package (the JAX package keeps its
# compilation cache beside it, in ~/.cache/recursivefactorization_jl_tpu/xla)
USER_CACHE = Path("~/.cache/recursivefactorization_jl_tpu_torch/kernels")


def default_build_dir() -> Path:
    """Where the kernels are built unless ``enable_persistent_cache`` says
    otherwise: ``build/kernels/`` of the checkout when the package sits in
    one (its parent holds ``pyproject.toml``), else :data:`USER_CACHE`,
    never a directory beside an installed package."""
    root = PACKAGE_DIR.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    return USER_CACHE.expanduser()


BUILD_DIR = default_build_dir()
SOURCES = {
    name: PACKAGE_DIR / "csrc" / f"{name}.cu"
    for name in ("panel_lu", "panel_lu_c64", "panel_lu_micro",
                 "panel_lu_noswap", "batched_lu", "batched_solve", "butterfly",
                 "mixed_refine")
}
# second builds of a source with flags of their own, for measurement only:
# name -> (source, flags).  batched_lu_trace's kernels stamp a phase trace
# (rf_batched_lu_set_trace); the package's wrappers never load it, and
# build() builds it only when named (load() does)
VARIANTS = {"batched_lu_trace": ("batched_lu", ("-DRF_BATCHED_TRACE",))}
# the headers the sources include (nvcc finds them beside them):
# rf_common.cuh by every source, panel_cluster.cuh by the four panel
# kernels' sources; every library's hash covers all of them
HEADERS = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cuh")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # every product and difference rounds on its own, as in the plain
    # versions: no contraction into fused multiply-adds
    "-fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


class PanelStats(ctypes.Structure):
    """csrc/panel_cluster.cuh ``PanelStats``: what one launch of a panel
    kernel reports in host memory (the chain launches that took the
    look-ahead step and the mbarrier exchange, the blocks whose chain ran on
    the grid, the delayed update launches, the chain launches that took the
    previous block's delayed pass at load while the rest of it ran beside
    them)."""

    _fields_ = [("lookaheads", _I), ("grid_blocks", _I), ("updates", _I), ("carried", _I)]


# the int32s of every panel family's plan (csrc/panel_cluster.cuh kPlanInts,
# write_plan): route, b, C or grid, blocks, ws reals, iws int32s, grid blocks
PLAN_INTS = 7


def _panel(*own):
    """The signature every panel entry point shares: panel, m, w, lda,
    pivot, the family's ``own`` arguments, piv, perm, info (the no-swap
    kernel: prow, used, info), ws, iws, stats, device, stream."""
    return (_I, [_P, _I, _I, _I, _I, *own, _P, _P, _P, _P, _P, ctypes.POINTER(PanelStats), _I,
                 _P])


_PANEL_BC = _panel(_I, _I)  # b, C
_PANEL_OFS_BC = _panel(_I, _I, _I)  # ofs, b, C
# micro, b, C, chain; the bf16x3 form: b, C, simple, chain
_PANEL_MICRO = _panel(_I, _I, _I, _I)
_PANEL_NOSWAP = _panel(_I, _I, _I, _P)  # live, b, C, used0
# csrc/panel_lu.cu, csrc/panel_lu_c64.cu: m, w, elem_size, ofs, b, C, device,
# out[PLAN_INTS]; csrc/panel_lu_noswap.cu the same with the live row count
# for ofs
_PANEL_PLAN = (_I, [_I, _I, _I, _I, _I, _I, _I, _P])
# a, out, ipiv, perm, info, batch, m, n, pivot, route, smem, device, stream
_BATCHED_SWAP = (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
# a, out, perm, info, batch, n, pivot, route, smem, device, stream
_BATCHED_NOSWAP = (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
# f, b, x, perm, ipiv, batch, n, nrhs, route, smem, device, stream
_BATCHED_SOLVE = (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
_BATCHED_LU = {
    "rf_batched_lu_swap_f32": _BATCHED_SWAP,
    "rf_batched_lu_swap_f64": _BATCHED_SWAP,
    # m, n, elem, route, device, out[10]
    "rf_batched_lu_swap_plan": (_I, [_I, _I, _I, _I, _I, _P]),
    "rf_batched_lu_noswap_f32": _BATCHED_NOSWAP,
    "rf_batched_lu_noswap_f64": _BATCHED_NOSWAP,
    # n, elem, route, device, out[10]
    "rf_batched_lu_noswap_plan": (_I, [_I, _I, _I, _I, _P]),
    "rf_error_string": (ctypes.c_char_p, [_I]),
}
# a, out, uv, n, width (int*), device, stream
_BUTTERFLY = (_I, [_P, _P, _P, _I, ctypes.POINTER(_I), _I, _P])
# a, sa, anrm, overflow, n, device, stream
_MIXED_NARROW = (_I, [_P, _P, _P, _P, _I, _I, _P])
# a, x, b, anrm, r, sr, status, work, n, k, step, itermax, device, stream
_MIXED_RESIDUAL = (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
# C signatures: name -> (restype, argtypes)
SIGNATURES = {
    "panel_lu": {
        "rf_panel_lu_plan": _PANEL_PLAN,
        "rf_panel_lu_f32": _PANEL_BC,
        "rf_panel_lu_f64": _PANEL_BC,
        "rf_offset_panel_lu_plan": _PANEL_PLAN,
        "rf_offset_panel_lu_f32": _PANEL_OFS_BC,
        "rf_offset_panel_lu_f64": _PANEL_OFS_BC,
        # m, w, b, C, chain, device, out[PLAN_INTS]
        "rf_panel_lu_bf16x3_plan": (_I, [_I, _I, _I, _I, _I, _I, _P]),
        "rf_panel_lu_bf16x3_f32": _PANEL_MICRO,
        # l, ldl, u, ldu, c, ldc, rows, cols, nb, simple, device, stream
        "rf_panel_update_bf16x3_f32": (_I, [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P]),
        # rows, cols, nb, out[5]
        "rf_panel_update_bf16x3_plan": (_I, [_I, _I, _I, _P]),
        "rf_panel_lu_set_trace": (_I, [_P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_c64": {
        "rf_panel_lu_c_plan": _PANEL_PLAN,
        "rf_panel_lu_c64": _PANEL_BC,
        "rf_panel_lu_c128": _PANEL_BC,
        "rf_offset_panel_lu_c_plan": _PANEL_PLAN,
        "rf_offset_panel_lu_c64": _PANEL_OFS_BC,
        "rf_offset_panel_lu_c128": _PANEL_OFS_BC,
        "rf_panel_lu_c_set_trace": (_I, [_P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_micro": {
        "rf_panel_lu_micro_max": (_I, []),
        # m, w, elem_size, micro, shadow, b, C, chain, device, out[PLAN_INTS]
        "rf_panel_lu_micro_plan": (_I, [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "rf_panel_lu_shadow_f32": _PANEL_MICRO,
        "rf_panel_lu_shadow_f64": _PANEL_MICRO,
        "rf_panel_lu_basic_f32": _PANEL_MICRO,
        "rf_panel_lu_basic_f64": _PANEL_MICRO,
        "rf_panel_lu_micro_set_trace": (_I, [_P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_noswap": {
        "rf_panel_lu_noswap_plan": _PANEL_PLAN,
        "rf_panel_lu_noswap_f32": _PANEL_NOSWAP,
        "rf_panel_lu_noswap_f64": _PANEL_NOSWAP,
        "rf_panel_lu_noswap_set_trace": (_I, [_P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "batched_lu": _BATCHED_LU,
    "batched_lu_trace": {**_BATCHED_LU, "rf_batched_lu_set_trace": (_I, [_P])},
    "batched_solve": {
        "rf_batched_solve_f32": _BATCHED_SOLVE,
        "rf_batched_solve_f64": _BATCHED_SOLVE,
        # n, nrhs, elem, route, device, out[10]
        "rf_batched_solve_plan": (_I, [_I, _I, _I, _I, _I, _P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "butterfly": {
        "rf_butterfly_depth2_f32": _BUTTERFLY,
        "rf_butterfly_depth2_f64": _BUTTERFLY,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "mixed_refine": {
        "rf_mixed_narrow_f64": _MIXED_NARROW,
        "rf_mixed_residual_f64": _MIXED_RESIDUAL,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
}

# where nvcc is looked for after CUDA_HOME, CUDA_PATH and PATH
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

# name -> {"seconds", "log", "rc"} of the builds made in this process
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def source(name: str) -> Path:
    """The source file of library ``name`` (of :data:`SOURCES` or
    :data:`VARIANTS`)."""
    return SOURCES[VARIANTS[name][0] if name in VARIANTS else name]


def _source_and_flags(name: str):
    return source(name), NVCC_FLAGS + VARIANTS.get(name, (name, ()))[1]


def library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    h = hashlib.sha256(source.read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet (default: the
    package's own, :data:`SOURCES`; a name of :data:`VARIANTS` too), one
    ``nvcc`` per library, all started together.  Returns name -> library
    path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, flags = _source_and_flags(name)
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0, "log": log, "rc": proc.returncode,
        }
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: library_path(n) for n in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.rf_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
