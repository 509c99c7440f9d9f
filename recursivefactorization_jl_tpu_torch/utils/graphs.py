"""Compiled entry points: the port's counterpart of the JAX package's
``jax.jit`` programs.

In the JAX package every public entry point is a ``jax.jit`` program,
compiled once per argument shape, dtype and static arguments, cached and
replayed.  Here the program of a key is a CUDA graph: the entry point's
eager code, recorded once on the card by ``torch.cuda.graph`` and then
replayed with one host call.  The key is what ``jax.jit`` keys on: the
kind of entry point, the shape, dtype and device of each tensor argument
and the static arguments (``pivot``, ``config``, ``trans``, ...).  A
``torch.distributed`` process group among the statics enters the key as
its name, size and rank (a program of the tensor-parallel or sharded
functions is one per rank and group).

A call whose key has a program runs as one copy into the program's static
inputs, one ``CUDAGraph.replay()`` and fresh copies of its outputs (JAX
returns new arrays on every call, and the next replay overwrites the
static outputs).  Any other call runs eagerly, as the entry point always
did.  Only :func:`capturing` makes programs (``utils.warmup.warmup`` calls
it): each graph keeps its memory pool for as long as it lives, which a
JAX executable does not, so the cache holds only the keys the caller
warmed, and :func:`clear` frees them (``utils.warmup.clear_caches``, the
counterpart of ``jax.clear_caches``).

Three kinds of program go beyond copy in, replay, copies out:

* constants: tensors that are a function of the key alone (RBT's
  butterfly values, drawn from a CPU generator and copied to the card,
  which a capture cannot record) are made once, outside the capture, by
  the ``constants`` callable given to :func:`call`, and held by the
  program; ``fn`` takes them after the tensors, on every call;
* donated programs (``donate=True``, ``lu_inplace``): the program
  factors its static copy of tensor 0 in place, and a replay copies
  output 0 back into the caller's tensor 0 and returns that tensor
  itself, not a clone;
* programs over a process group: only NCCL collectives are captured.  A
  capture request for a key whose group runs another backend (gloo
  stages CUDA tensors through the host) raises ``RuntimeError`` naming
  the key and the backend.  Every rank of the group must make the same
  calls inside :func:`capturing`, in the same order, and replay them
  together: the warm run and the capture each issue the collectives.  A
  replay refuses a group other than the one it was captured on (call
  :func:`clear` before destroying a group whose programs were captured).

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

Spans and counters (``utils/profiling.py``): every call opens a span
named by its kind, and inside it ``graphs.copy_in``, ``graphs.replay``
and ``graphs.copy_out`` (a replay), ``graphs.eager`` (a CUDA call whose
key has no program) or ``graphs.capture``.  A program captured while
recording holds its spans as graph nodes and reports them per replay.
:func:`stats` counts replays, captures and eager CUDA calls, always.

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
import torch.distributed as dist

from . import profiling

# key -> program; filled only inside ``capturing()``
_PROGRAMS: Dict[tuple, "_Program"] = {}
# held while a program is captured and entered into _PROGRAMS
_CAPTURE_LOCK = threading.Lock()
# device -> the side stream of every warm run and capture on it
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


# captures made and CUDA calls run eagerly for want of a program, and the
# replays of programs since freed (stats())
_COUNTS = {"captures": 0, "eager": 0, "freed_replays": 0}


class _State(threading.local):
    capture = False


_STATE = _State()


def _is_group(s) -> bool:
    return dist.is_available() and isinstance(s, dist.ProcessGroup)


def _groups(statics) -> tuple:
    return tuple(s for s in statics if _is_group(s))


def program_key(kind: str, tensors: Sequence[Optional[torch.Tensor]], statics: tuple) -> tuple:
    """The key of an entry point's program: ``kind``, the shape, dtype and
    device of each tensor argument (None for an argument left out) and the
    static arguments, which must hash (``LUConfig`` is a frozen
    dataclass); a process group enters as ``("group", name, size,
    rank)``."""
    sig = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)
    stat = tuple(("group", s.group_name, s.size(), s.rank()) if _is_group(s) else s
                 for s in statics)
    return (kind, sig, stat)


def _cuda_backend(group) -> str:
    """The backend that runs the group's collectives on CUDA tensors
    (``"nccl"``, ``"gloo"``, ...; a mixed group names one per device)."""
    name = str(dist.get_backend(group))
    for part in name.split(","):
        dev, _, backend = part.rpartition(":")
        if dev in ("", "cuda"):
            return backend
    return name


class _Program:
    """One captured program: static inputs, constants, the graph, static
    outputs."""

    donate = False  # output 0 goes back into the caller's tensor 0
    groups: tuple = ()  # the process groups the program's collectives run on
    # the spans its capture recorded as graph nodes (profiling.capture_spans)
    spans: tuple = ()

    def __init__(self, fn: Callable, tensors, statics, device: torch.device,
                 constants: Optional[Callable] = None, donate: bool = False):
        self.inputs = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                            for t in tensors)
        # held for the program's life: every replay reads them
        self.constants = tuple(constants()) if constants is not None else ()
        stream = _STREAMS.get(device)
        if stream is None:
            stream = _STREAMS[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # the warm run, on copies: builds, plans, cuBLAS's choices and
            # a process group's communicator
            fn(*(None if t is None else t.clone() for t in self.inputs), *self.constants,
               *statics)
        self.graph = torch.cuda.CUDAGraph()
        with profiling.capture_spans() as spans:
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                out = fn(*self.inputs, *self.constants, *statics)
        self.spans = tuple(tuple(t) for t in spans)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.groups = _groups(statics)
        self.donate = donate
        self.device = device
        self.replays = 0
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()  # the last replay's copies out

    def __call__(self, *tensors):
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._done)
            profiling.before_replay(self)
            with profiling.span("graphs.copy_in"):
                for static, t in zip(self.inputs, tensors):
                    if static is not None:
                        static.copy_(t)
            with profiling.span("graphs.replay") as replay:
                self.graph.replay()
            profiling.after_replay(self, replay)
            with profiling.span("graphs.copy_out"):
                if self.donate:
                    out = (tensors[0].copy_(self.outputs[0]),) + tuple(
                        o.clone() for o in self.outputs[1:])
                else:
                    out = tuple(o.clone() for o in self.outputs)
            self._done.record(stream)
            self.replays += 1
        return out[0] if self.single else out


def capture(kind: str, fn: Callable, tensors, statics, *,
            constants: Optional[Callable] = None, donate: bool = False) -> _Program:
    """The program of ``fn(*tensors, *constants(), *statics)``'s key,
    captured now if the cache lacks it.  Raises ``RuntimeError`` naming
    the key and the CUDA error where the capture fails, or the backend of
    a process group among the statics that is not NCCL; ``ValueError``
    for CPU tensors."""
    key = program_key(kind, tensors, statics)
    device = next(t.device for t in tensors if t is not None)
    if device.type != "cuda":
        raise ValueError(f"only CUDA tensors are captured, not {key}")
    for group in _groups(statics):
        backend = _cuda_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"could not capture the program of {key}: its process group runs the "
                f"{backend!r} backend on CUDA tensors; only NCCL collectives are captured")
    with _CAPTURE_LOCK:
        if key in _PROGRAMS:
            return _PROGRAMS[key]
        saved, _STATE.capture = _STATE.capture, False  # no nested programs
        try:
            with profiling.span("graphs.capture", device):
                program = _Program(fn, tensors, statics, device, constants, donate)
        except RuntimeError as e:
            raise RuntimeError(f"could not capture the program of {key}: {e}") from e
        finally:
            _STATE.capture = saved
        _PROGRAMS[key] = program
        _COUNTS["captures"] += 1
    return program


def call(kind: str, fn: Callable, tensors: Tuple[Optional[torch.Tensor], ...], statics: tuple,
         *, constants: Optional[Callable] = None, donate: bool = False):
    """``fn(*tensors, *constants(), *statics)``: by replay of its key's
    program where one was captured, else eagerly; inside :func:`capturing`
    a CUDA key without a program is captured first.  ``fn`` takes the
    tensors (None for an argument left out), then the constants (tensors
    that depend on the key alone, made by ``constants()`` on every eager
    call and once per program), then the statics.  ``donate``: ``fn``
    writes its output 0 into tensor 0, and so does a replay."""
    key = program_key(kind, tensors, statics)
    device = next(t.device for t in tensors if t is not None)
    with profiling.span(kind, device):
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return fn(*tensors, *(constants() if constants is not None else ()), *statics)
        program = _PROGRAMS.get(key)
        if program is None and _STATE.capture:
            program = capture(kind, fn, tensors, statics, constants=constants, donate=donate)
        if program is None:
            _COUNTS["eager"] += 1
            with profiling.span("graphs.eager"):
                return fn(*tensors, *(constants() if constants is not None else ()), *statics)
        if any(a is not b for a, b in zip(program.groups, _groups(statics))):
            raise RuntimeError(f"the program of {key} was captured on another process group "
                               "of that name; clear the programs when a group is destroyed")
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


def stats() -> Dict[str, int]:
    """Counts since the process started: ``replays`` of every program
    (the sum of each program's ``.replays``, freed ones included),
    ``captures`` made and ``eager`` CUDA calls of a key without a
    program."""
    live = sum(p.replays for p in list(_PROGRAMS.values()))
    return {"replays": _COUNTS["freed_replays"] + live, "captures": _COUNTS["captures"],
            "eager": _COUNTS["eager"]}


def clear() -> None:
    """Free every captured program and its memory pool: the graphs are
    reset, their static tensors dropped and the caching allocator's free
    blocks returned to CUDA."""
    with _CAPTURE_LOCK:
        held = list(_PROGRAMS.values())
        _PROGRAMS.clear()
        _COUNTS["freed_replays"] += sum(p.replays for p in held)
    while held:
        held.pop().graph.reset()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
