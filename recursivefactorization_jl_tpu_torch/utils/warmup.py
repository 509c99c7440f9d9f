"""First-call latency: the port's counterpart of the JAX package's
utils/warmup.py.

The JAX package keeps compiled XLA programs in a persistent cache and
pre-compiles its jitted entry points for the shapes a workload uses.
The port's counterpart of a jitted program is a CUDA graph per key
(utils/graphs.py).  What a first call pays for is the ``nvcc`` build of
the CUDA kernels (one process per source, all started together), per
shape the first launch's set-up (the cluster-size queries and plans that
the launchers cache) and, without a warmup, one launch from Python at a
time on every call.

* :func:`enable_persistent_cache` sets the directory the kernels are
  built into and loaded from (``ops._kernels.BUILD_DIR``).  A library
  there is named by a hash of its source, the headers and the flags, so
  a later process with the same sources loads it without ``nvcc``.
* :func:`warmup` builds the package's kernels (not the measurement-only
  builds of ``ops._kernels.VARIANTS``), runs ``lu_factor`` (and
  ``lu_solve`` of a vector for square shapes) once per shape and dtype,
  and on the card captures the program of each of those keys: from then
  on a call with that key (``lu_factor``, ``lu_factor_p`` or ``lu`` of a
  matrix of that shape and dtype with the same ``pivot`` and ``config``;
  ``lu_solve`` / ``ldiv`` of such a factorization and a vector of its
  dtype, untransposed) runs as one copy into the program's inputs, one
  graph replay and copies of its outputs, with the eager call's results
  bit for bit.  Each key holds its graph's memory pool (about the memory
  of one eager call of its shape) until :func:`clear_caches`.  A key
  whose capture fails raises there, naming the key and the CUDA error.
* Every other entry point with a program is captured by the calls made
  inside ``utils.graphs.capturing()`` (``warmup`` keeps the JAX
  signature, which warms ``lu_factor`` / ``lu_solve`` only): ``lu_solve``
  with ``trans`` or a matrix right-hand side, ``lu_solve_refined``,
  ``solve``, the four batched functions; ``lu_inplace`` /
  ``lu_factor(donate=True)`` (the ``lu_factor_donated`` program: a
  replay copies ``A`` in and the factors back into ``A``);
  ``butterfly_workspace`` (its butterfly values made once, outside the
  graph, as the program's constant), ``butterfly_solve`` and
  ``BWorkspace.UV``; ``tp_lu_factor(_p)`` / ``tp_lu`` / ``tp_lu_solve``
  and ``sharded_batched_lu_factor`` / ``_solve``, a program per rank on
  an NCCL group only (a gloo group raises), entered on every rank with
  the same calls in the same order.
* :func:`clear_caches` frees every captured program and its memory (the
  counterpart of ``jax.clear_caches``); later calls run eagerly again.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Sequence, Tuple

import torch

from ..ops import _kernels
from . import graphs
from .config import default_config, resolve_device


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
    """Build the package's kernels, then factor (and, for a square shape and
    ``solve``, solve a vector with) the identity of each shape and dtype
    once, and on the card capture the program of each of those keys, so
    that a later call with the key pays neither the build, nor the first
    launch, nor one host call per kernel.  ``device=None`` means CUDA and
    raises without it, as at every entry point; on the CPU nothing is
    built or captured and the plain versions run."""
    from ..models.lu import normalize_pivot

    dev = resolve_device(device)
    pivot = normalize_pivot(pivot)
    config = config or default_config()
    if dev.type == "cuda":
        _kernels.build()
    for dtype in dtypes:
        for m, n in shapes:
            A = torch.eye(m, n, device=dev).to(dtype)
            _factor_and_solve(A, pivot, solve and m == n, config)
            if dev.type == "cuda":
                with graphs.capturing():
                    _factor_and_solve(A, pivot, solve and m == n, config)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _factor_and_solve(A, pivot, solve, config):
    from ..models.lu import LU, lu_factor_p
    from ..models.solve import lu_solve

    factors, ipiv, perm, info = lu_factor_p(A, pivot, config=config, device=A.device)
    if solve:
        lu_solve(LU(factors, ipiv, info, pivoted=pivot, perm=perm),
                 torch.zeros(A.shape[1], dtype=factors.dtype, device=A.device))


def clear_caches() -> None:
    """Free every captured program (by :func:`warmup` or
    ``graphs.capturing()``, every kind), with its graph's memory pool and
    constants (the counterpart of ``jax.clear_caches()``).  Later calls of
    those keys run eagerly until they are captured again.  Call it before
    destroying a process group whose programs were captured."""
    graphs.clear()
