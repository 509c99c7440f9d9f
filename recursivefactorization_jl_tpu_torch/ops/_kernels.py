"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  Libraries go to
``build/kernels/`` beside the package (``.gitignore`` lists ``build/``),
named by a hash of the source, the header the sources share and the flags,
so a changed source is rebuilt at its first use.  Nothing here runs at
import time.  A missing ``nvcc`` or a failed build raises.
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
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = {
    name: PACKAGE_DIR / "csrc" / f"{name}.cu"
    for name in ("panel_lu", "panel_lu_c64", "panel_lu_micro",
                 "panel_lu_noswap", "batched_lu", "batched_solve")
}
# included by every source (nvcc finds it beside them)
COMMON_HEADER = PACKAGE_DIR / "csrc" / "rf_common.cuh"
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
_PANEL = (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P])
# the same with the micro-block width after pivot
_PANEL_MICRO = (_I, [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P])
# panel, m, w, lda, pivot, used0, used, prow, info, ws, iws, grid, device, stream
_PANEL_NOSWAP = (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P])
# C signatures: name -> (restype, argtypes)
SIGNATURES = {
    "panel_lu": {
        "rf_panel_lu_grid": (_I, [_I, _I, _I, _I]),
        "rf_panel_lu_f32": _PANEL,
        "rf_panel_lu_f64": _PANEL,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_c64": {
        "rf_panel_lu_c_grid": (_I, [_I, _I, _I, _I]),
        "rf_panel_lu_c64": _PANEL,
        "rf_panel_lu_c128": _PANEL,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_micro": {
        "rf_panel_lu_micro_max": (_I, []),
        "rf_panel_lu_micro_grid": (_I, [_I, _I, _I, _I, _I, _I]),
        "rf_panel_lu_shadow_f32": _PANEL_MICRO,
        "rf_panel_lu_shadow_f64": _PANEL_MICRO,
        "rf_panel_lu_basic_f32": _PANEL_MICRO,
        "rf_panel_lu_basic_f64": _PANEL_MICRO,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "panel_lu_noswap": {
        "rf_panel_lu_noswap_grid": (_I, [_I, _I, _I, _I]),
        "rf_panel_lu_noswap_f32": _PANEL_NOSWAP,
        "rf_panel_lu_noswap_f64": _PANEL_NOSWAP,
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "batched_lu": {
        "rf_batched_lu_swap_f32": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
        "rf_batched_lu_swap_f64": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
        "rf_batched_lu_noswap_f32": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "rf_batched_lu_noswap_f64": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "rf_error_string": (ctypes.c_char_p, [_I]),
    },
    "batched_solve": {
        "rf_batched_solve_f32": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "rf_batched_solve_f64": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
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


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(COMMON_HEADER.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
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
