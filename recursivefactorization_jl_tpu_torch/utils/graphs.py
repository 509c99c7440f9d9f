"""Compiled entry points: the port's counterpart of the JAX package's
``jax.jit`` programs.

In the JAX package every public entry point is a ``jax.jit`` program,
compiled once per argument shape, dtype and static arguments, cached and
replayed.  Here the program of a key is a CUDA graph: the entry point's
eager code, recorded once on the card by ``torch.cuda.graph`` and then
replayed with one host call.  The key is what ``jax.jit`` keys on: the
kind of entry point, the shape, dtype and device of each tensor argument
and the static arguments (``pivot``, ``config``, ``trans``, ...).

A call whose key has a program runs as one copy into the program's static
inputs, one ``CUDAGraph.replay()`` and fresh copies of its outputs (JAX
returns new arrays on every call, and the next replay overwrites the
static outputs).  Any other call runs eagerly, as the entry point always
did.  Only :func:`capturing` makes programs (``utils.warmup.warmup`` calls
it): each graph keeps its memory pool for as long as it lives, which a
JAX executable does not, so the cache holds only the keys the caller
warmed, and :func:`clear` frees them (``utils.warmup.clear_caches``, the
counterpart of ``jax.clear_caches``).

Capture rules.  Before it records a key, :func:`capture` runs the program
once on a side stream, the stream the capture then uses (one per device,
shared by every key, so cuBLAS keeps one workspace for it): the kernels
are built and loaded, the launchers' plans and first-use attributes are
set and cuBLAS picks its kernels and workspace there, outside the
capture.  Each key has a memory pool of its own, so keys may be called in
any order.
The capture runs under ``capture_error_mode='thread_local'``: a call on
this thread that is not legal in a capture (a synchronisation, a host
read of a device value, a copy to the host) fails the capture, while the
caller's other threads are not stopped from such calls while a warmup
runs (``'global'`` would make their calls fail).  A failed capture raises
and names the key and the CUDA error: a key that was asked for is never
left eager without a word.  The glue of every captured entry point
reads no device value on the host (tests/test_torch_graphs.py), so one
recording serves every input of the key.  Inside a capture an entry point
called by another one runs its eager code, which the outer capture
records.  CPU tensors are never captured.

Threads and streams: a program's static buffers are shared by its
callers, so a replay enqueues its copy in, replay and copies out under the
program's lock, and waits (on the device) for the previous replay's
copies out, whichever stream that one ran on.  Captures run one at a
time.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# key -> program; filled only inside ``capturing()``
_PROGRAMS: Dict[tuple, "_Program"] = {}
# held while a program is captured and entered into _PROGRAMS
_CAPTURE_LOCK = threading.Lock()
# device -> the side stream of every warm run and capture on it
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class _State(threading.local):
    capture = False


_STATE = _State()


def program_key(kind: str, tensors: Sequence[Optional[torch.Tensor]], statics: tuple) -> tuple:
    """The key of an entry point's program: ``kind``, the shape, dtype and
    device of each tensor argument (None for an argument left out) and the
    static arguments, which must hash (``LUConfig`` is a frozen
    dataclass)."""
    sig = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)
    return (kind, sig, tuple(statics))


class _Program:
    """One captured program: static inputs, the graph, static outputs."""

    def __init__(self, fn: Callable, tensors, statics, device: torch.device):
        self.inputs = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                            for t in tensors)
        stream = _STREAMS.get(device)
        if stream is None:
            stream = _STREAMS[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # the warm run, on copies: builds, plans and cuBLAS's choices
            fn(*(None if t is None else t.clone() for t in self.inputs), *statics)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            out = fn(*self.inputs, *statics)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.device = device
        self.replays = 0
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()  # the last replay's copies out

    def __call__(self, *tensors):
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._done)
            for static, t in zip(self.inputs, tensors):
                if static is not None:
                    static.copy_(t)
            self.graph.replay()
            out = tuple(o.clone() for o in self.outputs)
            self._done.record(stream)
            self.replays += 1
        return out[0] if self.single else out


def capture(kind: str, fn: Callable, tensors, statics) -> _Program:
    """The program of ``fn(*tensors, *statics)``'s key, captured now if
    the cache lacks it.  Raises ``RuntimeError`` naming the key and the
    CUDA error where the capture fails, ``ValueError`` for CPU tensors."""
    key = program_key(kind, tensors, statics)
    device = next(t.device for t in tensors if t is not None)
    if device.type != "cuda":
        raise ValueError(f"only CUDA tensors are captured, not {key}")
    with _CAPTURE_LOCK:
        if key in _PROGRAMS:
            return _PROGRAMS[key]
        saved, _STATE.capture = _STATE.capture, False  # no nested programs
        try:
            program = _Program(fn, tensors, statics, device)
        except RuntimeError as e:
            raise RuntimeError(f"could not capture the program of {key}: {e}") from e
        finally:
            _STATE.capture = saved
        _PROGRAMS[key] = program
    return program


def call(kind: str, fn: Callable, tensors: Tuple[Optional[torch.Tensor], ...], statics: tuple):
    """``fn(*tensors, *statics)``: by replay of its key's program where one
    was captured, else eagerly; inside :func:`capturing` a CUDA key without
    a program is captured first.  ``fn`` takes the tensors (None for an
    argument left out) and then the statics."""
    key = program_key(kind, tensors, statics)
    device = next(t.device for t in tensors if t is not None)
    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return fn(*tensors, *statics)
    program = _PROGRAMS.get(key)
    if program is None and _STATE.capture:
        program = capture(kind, fn, tensors, statics)
    if program is None:
        return fn(*tensors, *statics)
    return program(*tensors)


@contextlib.contextmanager
def capturing():
    """Within the block (on this thread), every entry-point call on CUDA
    tensors whose key has no program captures one, then replays it."""
    saved, _STATE.capture = _STATE.capture, True
    try:
        yield
    finally:
        _STATE.capture = saved


def programs() -> Dict[tuple, _Program]:
    """The captured programs by key (a copy of the cache)."""
    return dict(_PROGRAMS)


def clear() -> None:
    """Free every captured program and its memory pool: the graphs are
    reset, their static tensors dropped and the caching allocator's free
    blocks returned to CUDA."""
    with _CAPTURE_LOCK:
        held = list(_PROGRAMS.values())
        _PROGRAMS.clear()
    while held:
        held.pop().graph.reset()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
