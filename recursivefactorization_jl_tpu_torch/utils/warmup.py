"""First-call latency: the port's counterpart of the JAX package's
utils/warmup.py.

The JAX package keeps compiled XLA programs in a persistent cache and
pre-compiles its entry points.  The port has no tracing or compilation
of its own; what a first call pays for is the ``nvcc`` build of the CUDA
kernels (one process per source, all started together) and, per shape,
the first launch's set-up (the cluster-size queries and plans that the
launchers cache).

* :func:`enable_persistent_cache` sets the directory the kernels are
  built into and loaded from (``ops._kernels.BUILD_DIR``).  A library
  there is named by a hash of its source, the headers and the flags, so
  a later process with the same sources loads it without ``nvcc``.
* :func:`warmup` builds every kernel and runs ``lu_factor`` (and
  ``lu_solve`` for square shapes) once per shape and dtype.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Sequence, Tuple

import torch

from ..ops import _kernels
from .config import resolve_device


def enable_persistent_cache(path: str = str(_kernels.USER_CACHE)) -> None:
    """Build the CUDA kernels into ``path`` (created if missing) and load
    them from there, from now on in this process.  The default is the
    directory an installed package uses, ``~/.cache/
    recursivefactorization_jl_tpu_torch/kernels``; a package that sits in
    a checkout builds into its ``build/kernels/`` until this is called.
    Libraries loaded before the call stay loaded."""
    target = Path(os.path.expanduser(path))
    target.mkdir(parents=True, exist_ok=True)
    _kernels.BUILD_DIR = target


def warmup(
    shapes: Sequence[Tuple[int, int]] = ((256, 256),),
    dtypes: Iterable = (torch.float32,),
    pivot: bool = True,
    solve: bool = True,
    config=None,
    device=None,
) -> None:
    """Build every kernel, then factor (and, for a square shape and
    ``solve``, solve with) the identity of each shape and dtype once, so
    that the first real call pays neither the build nor the first launch.
    ``device=None`` means CUDA and raises without it, as at every entry
    point; on the CPU nothing is built and the plain versions run."""
    from ..models.lu import LU, lu_factor_p
    from ..models.solve import lu_solve

    dev = resolve_device(device)
    if dev.type == "cuda":
        _kernels.build()
    for dtype in dtypes:
        for m, n in shapes:
            A = torch.eye(m, n, device=dev).to(dtype)
            factors, ipiv, perm, info = lu_factor_p(A, pivot, config=config, device=dev)
            if solve and m == n:
                lu_solve(LU(factors, ipiv, info, pivoted=pivot, perm=perm),
                         torch.zeros(n, dtype=factors.dtype, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
