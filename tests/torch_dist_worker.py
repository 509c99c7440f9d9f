"""The rank body of tests/test_torch_parallel.py: one process of a gloo
group that runs the port's distributed functions on the CPU.

It imports torch, numpy and the port, never JAX: the JAX reference runs
in the pytest process, and inputs and results cross as numpy arrays.
pytest does not collect this file (its name lacks the ``test_`` prefix).
Every task returns, besides its results, the collectives the port called
during it: ``(name, shape, dtype)`` of each ``broadcast`` and
``all_reduce``.
"""

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import recursivefactorization_jl_tpu_torch as rt

CALLS = []  # the collectives of the running task


def _recording(name, fn):
    def call(tensor, *args, **kwargs):
        CALLS.append((name, tuple(tensor.shape), str(tensor.dtype)))
        return fn(tensor, *args, **kwargs)

    return call


def _np(t):
    """``t`` as a numpy array; bfloat16 and float16 (which numpy lacks or
    the test compares in float32) as their exact float32 values."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def _input(A, dtype):
    """``A`` as a tensor of the named torch dtype (None: as numpy gives it)."""
    A = torch.as_tensor(A)
    return A if dtype is None else A.to(getattr(torch, dtype))


def _factorization(F):
    return dict(F=_np(F.factors), ipiv=F.ipiv.numpy(), perm=F.p.numpy(),
                info=int(F.info), dtype=str(F.factors.dtype))


def tp_factor(meshes, A, w, pivot=True, config=None, dtype=None):
    """``tp_lu_factor_p`` of ``A`` (of the torch type ``dtype``), with the
    collectives it made."""
    cfg = rt.config_from_mapping(config or {})
    F, ipiv, perm, info = rt.tp_lu_factor_p(_input(A, dtype), meshes["tp"], "tp", w, pivot,
                                            cfg, device="cpu")
    return dict(F=_np(F), ipiv=ipiv.numpy(), perm=perm.numpy(), info=int(info),
                dtype=str(F.dtype), calls=list(CALLS))


def tp_solve(meshes, A, w, rhs, pivot=True, single_device=False, dtype=None):
    """Factor ``A`` (of the torch type ``dtype``) with ``tp_lu`` (or the
    single-device ``lu``) and solve each ``(b, trans)`` of ``rhs`` with
    ``tp_lu_solve``; the collectives of each solve apart."""
    mesh = meshes["tp"]
    A = _input(A, dtype)
    if single_device:
        F = rt.lu(A, pivot, check=False, device="cpu")
    else:
        F = rt.tp_lu(A, mesh, "tp", w, pivot, device="cpu")
    xs, calls, xdtypes = [], [], []
    for b, trans in rhs:
        del CALLS[:]
        x = rt.tp_lu_solve(F, b, mesh, "tp", w, trans, device="cpu")
        xs.append(_np(x))
        xdtypes.append(str(x.dtype))
        calls.append(list(CALLS))
    return dict(x=xs, x_dtype=xdtypes, calls=calls, **_factorization(F))


def sharded(meshes, A, b, pivot=True):
    """The sharded batched factor and solve, on the default axis name."""
    f, ipiv, info = rt.sharded_batched_lu_factor(A, meshes["dp"], pivot=pivot,
                                                 device="cpu")
    x = rt.sharded_batched_lu_solve(f, ipiv, b, meshes["dp"], pivoted=pivot,
                                    device="cpu")
    return dict(f=f.numpy(), ipiv=ipiv.numpy(), info=info.numpy(), x=x.numpy(),
                calls=list(CALLS))


def raises(meshes):
    """The exception each bad call raises (None: it raised nothing)."""
    mesh, world = meshes["tp"], dist.get_world_size()
    bad = {
        "complex": lambda: rt.tp_lu_factor(np.eye(64, dtype=np.complex128), mesh,
                                           "tp", 32, device="cpu"),
        "half": lambda: rt.tp_lu_factor(torch.eye(64, dtype=torch.float16), mesh,
                                        "tp", 32, device="cpu"),
        "integer": lambda: rt.tp_lu_factor(np.eye(64, dtype=np.int64), mesh, "tp", 32,
                                           device="cpu"),
        "not_square": lambda: rt.tp_lu_factor(np.zeros((64, 32)), mesh, "tp", 32,
                                              device="cpu"),
        "rhs_rows": lambda: rt.tp_lu_solve(rt.lu(np.eye(16), device="cpu"), np.zeros(17),
                                           mesh, "tp", 8, device="cpu"),
        "complex_solve": lambda: rt.tp_lu_solve(
            rt.lu(np.eye(16, dtype=np.complex64), device="cpu"), np.zeros(16), mesh,
            "tp", 8, device="cpu"),
        "batch_split": lambda: rt.sharded_batched_lu_factor(
            np.zeros((world + 1, 4, 4)), meshes["dp"], device="cpu"),
        "tp_backend": lambda: rt.tp_lu_factor(
            np.eye(64), mesh, "tp", 32, config=rt.LUConfig(tp_panel_backend="mosaic"),
            device="cpu"),
    }
    out, results = {}, {}
    for name, call in bad.items():
        try:
            got = call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the name is the result
            out[name] = type(e).__name__
            continue
        # what a call that no longer raises returns: the type of its
        # factors or solution, and info for a factorization
        first = got if isinstance(got, torch.Tensor) else got[0]
        results[name] = dict(dtype=str(first.dtype),
                             info=None if isinstance(got, torch.Tensor) else int(got[-1]))
    return dict(raised=out, results=results, calls=list(CALLS))


TASKS = {f.__name__: f for f in (tp_factor, tp_solve, sharded, raises)}


def serve(rank, world, port, inbox, outbox):
    """Join the gloo group of ``world`` ranks at ``tcp://127.0.0.1:port``
    and run ``(task, kwargs)`` from ``inbox`` until ``None``; each result
    goes to ``outbox`` as ``(rank, "ok" or "error", result or
    traceback)``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    meshes = {name: DeviceMesh("cpu", list(range(world)), mesh_dim_names=(name,))
              for name in ("tp", "dp")}
    dist.broadcast = _recording("broadcast", dist.broadcast)
    dist.all_reduce = _recording("all_reduce", dist.all_reduce)
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            name, kwargs = task
            del CALLS[:]
            try:
                outbox.put((rank, "ok", TASKS[name](meshes, **kwargs)))
            except Exception:  # noqa: BLE001 - reported to the test
                outbox.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
