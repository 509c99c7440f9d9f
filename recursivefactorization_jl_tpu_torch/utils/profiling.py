"""Tracing and timing: the port's counterpart of the JAX package's
utils/profiling.py, with its names and return shapes.

* :func:`trace`: ``torch.profiler`` around a block, written as a
  Chrome / Perfetto trace into a directory;
* :func:`timed`: best-of-``reps`` wall time of a call, synchronised with
  the card when the result lies on it;
* :func:`marginal_time` / :func:`marginal_time_stats`: the time of one
  more call of ``fn`` on ``x``, from two runs of ``k1`` and ``k2`` calls
  queued back to back between two CUDA events (the host clock for CPU
  tensors), so the events' and the synchronisation's fixed cost cancels.
  The JAX package differences two loops inside one compiled program for
  the same reason; the port queues eager calls, which the card runs in
  order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable

import torch

from .config import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str | None = None, device=None):
    """``with trace(logdir): ...`` profiles the block and writes
    ``logdir/trace.json`` (Chrome / Perfetto format); yields ``logdir``
    (default: ``rf_torch_trace`` in the temporary directory).  On the card
    (``device=None``, which raises without one) it records CUDA activity
    only, synchronised before the profiler stops; with ``device='cpu'`` it
    records CPU activity."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rf_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = dev.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _cuda_device(result):
    """The CUDA device of the first CUDA tensor in ``result`` (tensors,
    tuples, lists and dataclasses such as ``LU``), or None."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        result = [getattr(result, f.name) for f in dataclasses.fields(result)]
    if isinstance(result, (tuple, list)):
        for x in result:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


def _wait(result):
    dev = _cuda_device(result)
    if dev is not None:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, reps: int = 3):
    """Best-of-``reps`` wall time of ``fn(*args)`` after one warm-up call,
    each call waited for (``torch.cuda.synchronize`` when the result holds
    a CUDA tensor).  Returns ``(best_seconds, last_result)``."""
    result = fn(*args)
    _wait(result)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args)
        _wait(result)
        best = min(best, time.perf_counter() - t0)
    return best, result


def _queued_seconds(fn, x, extra_args, k):
    """Seconds of ``k`` calls of ``fn(x, *extra_args)`` queued back to
    back: between two CUDA events on the current stream for a CUDA ``x``
    (the host does not wait between calls), on the host clock otherwise."""
    if x.is_cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            fn(x, *extra_args)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        fn(x, *extra_args)
    return time.perf_counter() - t0


def marginal_time_stats(fn: Callable, x, k1: int = 3, k2: int = 13, reps: int = 4,
                        extra_args: tuple = ()) -> dict:
    """The time of one call of ``fn(x, *extra_args)`` as the difference of
    two runs, ``k1`` calls and then ``k2`` calls queued back to back
    (``k1`` < ``k2``: the numbers of calls in each run), over ``k2 - k1``.
    The two runs alternate within each of ``reps`` repetitions, after one
    warm-up call.  Returns ``{"time_s": median, "min_s", "max_s", "reps",
    "k1", "k2", "negative_reps"}`` (the JAX package's keys): a repetition
    whose difference is not positive counts in ``negative_reps``, a sign
    that the call is below the noise of the two runs."""
    if not 0 <= k1 < k2:
        raise ValueError(f"need 0 <= k1 < k2, got k1={k1}, k2={k2}")
    _wait(fn(x, *extra_args))
    margs = []
    for _ in range(reps):
        t1 = _queued_seconds(fn, x, extra_args, k1)
        t2 = _queued_seconds(fn, x, extra_args, k2)
        margs.append((t2 - t1) / (k2 - k1))
    margs.sort()
    return {
        "time_s": float(statistics.median(margs)),
        "min_s": margs[0],
        "max_s": margs[-1],
        "reps": reps,
        "k1": k1,
        "k2": k2,
        "negative_reps": sum(1 for m in margs if m <= 0),
    }


def marginal_time(fn: Callable, x, k1: int = 3, k2: int = 13, reps: int = 4) -> float:
    """The median seconds of one call of ``fn(x)``, as
    :func:`marginal_time_stats` measures it."""
    return marginal_time_stats(fn, x, k1, k2, reps)["time_s"]
