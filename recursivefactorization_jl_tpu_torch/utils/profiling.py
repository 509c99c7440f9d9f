"""Tracing and timing: the port's counterpart of the JAX package's
utils/profiling.py, with its names and return shapes.

* :func:`trace`: ``torch.profiler`` around a block, written as a
  Chrome / Perfetto trace into a directory, with the port's spans beside
  it;
* :func:`timed`: best-of-``reps`` wall time of a call, synchronised with
  the card when the result lies on it;
* :func:`marginal_time` / :func:`marginal_time_stats`: the time of one
  more call of ``fn`` on ``x``, from two runs of ``k1`` and ``k2`` calls
  queued back to back between two CUDA events (the host clock for CPU
  tensors), so the events' and the synchronisation's fixed cost cancels.
  The JAX package differences two loops inside one compiled program for
  the same reason; the port queues eager calls, which the card runs in
  order;
* :func:`recording` / :func:`span` / :func:`collect`: the port's spans.

Spans.  The port opens a span at each layer boundary: the entry point
(named by its program's kind, ``lu_factor``, ``lu_solve``,
``batched_lu_factor``, ...), the compiled program's ``graphs.copy_in`` /
``graphs.replay`` / ``graphs.copy_out`` (``graphs.eager`` for a CUDA
call whose key has no program, ``graphs.capture``), the blocked
schedule's steps ``blocked.panel`` / ``blocked.laswp`` / ``blocked.trsm``
/ ``blocked.schur`` / ``blocked.trailing`` / ``blocked.tail``,
``lu.clone``, the solve's ``solve.permute`` / ``solve.forward`` /
``solve.backward`` and the batched ``batched.factor`` /
``batched.solve``.  Off (the default),
:func:`span` tests one module variable and returns a shared no-op
context.  Within :func:`recording` every span is kept in memory until
:func:`collect`: its name, id, parent, the id of the entry-point call it
belongs to (the root span's), its host times (``time.time_ns()``, the
clock ``torch.profiler`` stamps its records with) and, on the card, its
device times: CUDA timing events recorded on the current stream at entry
and exit, in ms from the call's first event.

Inside a CUDA graph capture made while recording
(``utils/graphs.py``) a span records its events as graph nodes
(``external=True``) and no host time; it starts at the end event of the
sibling span that closed just before it on the same stream, so a
parent's children on one stream partition it.  Every replay of that
program records the events again, and the program's spans are read, as
children of its ``graphs.replay`` span, before its next replay (which
waits for the previous one while recording) or at :func:`collect`.  A program captured while not
recording holds no such node: its replays give the host spans and the
device times of the copies and of the replay as a whole only.  Outside
captures the timing events are reused once read (the recorder reads the
spans the card has passed whenever it runs out of free events).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .config import resolve_device

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"


@contextlib.contextmanager
def trace(logdir: str | None = None, device=None):
    """``with trace(logdir): ...`` profiles the block and writes
    ``logdir/trace.json`` (Chrome / Perfetto format) and the port's spans
    of the block, recorded meanwhile, as ``logdir/spans.json`` on the
    same clock (:func:`write_spans`); yields ``logdir`` (default:
    ``rf_torch_trace`` in the temporary directory).  On the card
    (``device=None``, which raises without one) the profiler records
    CUDA activity only, synchronised before it stops, and the spans give
    the host's timeline; with ``device='cpu'`` it records CPU activity."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rf_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = dev.type == "cuda"
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            yield logdir
            if cuda:
                torch.cuda.synchronize(dev)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        base = json.load(f).get("baseTimeNanoseconds", 0)
    write_spans(os.path.join(logdir, SPANS_FILE), rec.collect(), base)


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


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span.  ``call`` is the id of the entry-point call's
    root span (every span of one call shares it), ``parent`` the id of the
    enclosing span (None for a root).  ``host_ns``: ``time.time_ns()`` at
    entry and exit, None for a span replayed inside a CUDA graph.
    ``device_ms``: CUDA-event times in ms from the call's first event,
    None where the span ran on no card."""

    id: int
    name: str
    parent: Optional[int]
    call: int
    host_ns: Optional[Tuple[int, int]]
    device_ms: Optional[Tuple[float, float]]

    @property
    def clock(self) -> str:
        """The clocks the span was read on: ``host``, ``device`` or
        ``host+device``."""
        return "+".join(c for c, t in (("host", self.host_ns), ("device", self.device_ms))
                        if t is not None)


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# the recorder spans go to; None: off
_ACTIVE: Optional["Recorder"] = None


def span(name: str, on=None):
    """A context that records the span ``name`` when a recorder is on
    (:func:`recording`), and the shared no-op context otherwise.  ``on``
    (a tensor or a device) says where the span's work runs: on a CUDA
    device the span records timing events there; None takes the
    enclosing span's device (a root span without ``on`` is host only)."""
    if _ACTIVE is None:
        return _OFF
    return _Open(_ACTIVE, name, on)


def enabled() -> bool:
    """Whether a recorder is on (:func:`recording`)."""
    return _ACTIVE is not None


@contextlib.contextmanager
def recording():
    """Record spans within the block (on every thread); yields the
    :class:`Recorder`, whose :meth:`Recorder.collect` returns them.  At
    exit the spans whose device times are pending are read (this waits
    for the card); the recorder that was on before comes back."""
    global _ACTIVE
    rec, saved = Recorder(), _ACTIVE
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = saved
        rec._settle()


def collect() -> List[Span]:
    """The spans of the recorder that is on, taken out of it (an empty
    list when none is on)."""
    return _ACTIVE.collect() if _ACTIVE is not None else []


class Recorder:
    """The spans of one :func:`recording` block, kept in memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: List[Span] = []
        # closed spans waiting for their device events, in the order they closed
        self._pending: collections.deque = collections.deque()
        self._replays: dict = {}  # program -> (its graphs.replay span, its capture's spans)
        # device -> timing events free for reuse (a call's first event is never
        # reused: the spans of its replays are read from it later)
        self._free: Dict[torch.device, list] = {}
        self._streams: dict = {}  # (stream id, device index, device type) -> Stream

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def stream(self, device: torch.device):
        """The current stream of ``device`` (made once per stream:
        ``torch.cuda.current_stream`` costs more than the event it serves)."""
        key = torch._C._cuda_getCurrentStream(device.index)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def event(self, device: torch.device):
        """A timing event for a span on ``device``: a free one, after reading
        the spans whose events the card has passed, or a new one."""
        with self._lock:
            free = self._free.get(device)
            if not free:
                while self._pending and self._pending[0][1].query():
                    self._read(*self._pending.popleft())
                free = self._free.get(device)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _read(self, sp, end) -> None:
        """Store the closed span ``sp`` with its device times; its events
        become free (under the lock)."""
        origin = sp.root.origin
        self._spans.append(Span(sp.id, sp.name, sp.parent, sp.call, (sp.t0, sp.t1),
                                (origin.elapsed_time(sp.ev0), origin.elapsed_time(end))))
        free = self._free.setdefault(sp.device, [])
        if sp.ev0 is not origin:
            free.append(sp.ev0)
        free.append(end)

    def _settle(self) -> None:
        """Read every pending device time (waits for the card)."""
        for program in list(self._replays):
            self.read_replay(program)
        with self._lock:
            while self._pending:
                sp, end = self._pending.popleft()
                end.synchronize()
                self._read(sp, end)

    def collect(self) -> List[Span]:
        """Every span recorded so far, device times read, in order of id;
        the recorder keeps none of them."""
        self._settle()
        with self._lock:
            spans, self._spans = self._spans, []
        return sorted(spans, key=lambda s: s.id)

    @contextlib.contextmanager
    def capture_spans(self):
        """Within the block (a CUDA graph capture on this thread), spans
        record their events as graph nodes into the yielded list:
        ``(name, index of the parent in the list or None, start event,
        end event)``."""
        saved = getattr(self._local, "template", None)
        template = self._local.template = []
        self._local.last = None  # the sibling just closed: its end starts the next
        try:
            yield template
        finally:
            self._local.template = saved
            self._local.last = None

    def replayed(self, program, replay_span) -> None:
        """``program`` was just replayed inside ``replay_span``: its
        capture's spans are read before its next replay."""
        if program.spans and replay_span is not None and replay_span.root.origin is not None:
            self._replays[program] = (replay_span, program.spans)

    def read_replay(self, program) -> None:
        """The spans of ``program``'s last replay, if not read yet (waits
        for that replay)."""
        last = self._replays.pop(program, None)
        if last is None:
            return
        replay_span, template = last
        origin = replay_span.root.origin
        ids = [next(self._ids) for _ in template]
        at: dict = {}  # id(event) -> ms from the call's first event (siblings share)

        def ms(ev):
            t = at.get(id(ev))
            if t is None:
                ev.synchronize()
                t = at[id(ev)] = origin.elapsed_time(ev)
            return t

        self._spans.extend(
            Span(ids[i], name, replay_span.id if parent is None else ids[parent],
                 replay_span.call, None, (ms(ev0), ms(ev1)))
            for i, (name, parent, ev0, ev1) in enumerate(template))


@contextlib.contextmanager
def capture_spans():
    """The context a CUDA graph capture runs in: yields a list that, while
    recording, receives the spans recorded inside it as graph nodes (a
    program's spans, see :meth:`Recorder.capture_spans`); otherwise it
    stays empty and the capture holds no node of a span."""
    if _ACTIVE is None:
        yield []
        return
    with _ACTIVE.capture_spans() as template:
        yield template


def before_replay(program) -> None:
    """Read the spans of ``program``'s previous replay before a new one
    overwrites its events (while recording)."""
    if _ACTIVE is not None:
        _ACTIVE.read_replay(program)


def after_replay(program, replay_span) -> None:
    """``program`` was just replayed inside ``replay_span`` (while
    recording: its spans are read before its next replay)."""
    if _ACTIVE is not None:
        _ACTIVE.replayed(program, replay_span)


def _cuda_of(on) -> Optional[torch.device]:
    if isinstance(on, torch.Tensor):
        return on.device if on.is_cuda else None
    dev = torch.device(on)
    if dev.type != "cuda":
        return None
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


class _Open:
    """A span while it is open."""

    __slots__ = ("rec", "name", "on", "id", "parent", "call", "root", "device", "origin",
                 "t0", "t1", "ev0", "template", "index")

    def __init__(self, rec: Recorder, name: str, on):
        self.rec, self.name, self.on = rec, name, on

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        up = stack[-1] if stack else None
        self.id = next(rec._ids)
        if up is None:
            self.parent, self.call, self.root = None, self.id, self
            self.device = None if self.on is None else _cuda_of(self.on)
        else:
            self.parent, self.call, self.root = up.id, up.call, up.root
            self.device = up.device if self.on is None else _cuda_of(self.on)
        self.origin = self.ev0 = self.template = None
        if self.device is not None:
            if torch.cuda.is_current_stream_capturing():
                template = getattr(rec._local, "template", None)
                if template is not None:  # a capture made while recording
                    self.template = template
                    self.index = len(template)
                    parent = up.index if up is not None and up.template is template else None
                    last = rec._local.last
                    stream = rec.stream(self.device)
                    if (last is not None and last[0] is template and last[1] == parent
                            and last[3] is stream):
                        self.ev0 = last[2]  # the end of the sibling just closed
                    else:
                        self.ev0 = torch.cuda.Event(enable_timing=True, external=True)
                        self.ev0.record(stream)
                    rec._local.last = None
                    template.append([self.name, parent, self.ev0, None])
            else:
                # a call's first event is its own: the others are reused
                first = self.root.origin is None
                self.ev0 = torch.cuda.Event(enable_timing=True) if first else rec.event(
                    self.device)
                self.ev0.record(rec.stream(self.device))
                if first:
                    self.root.origin = self.ev0
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        rec = self.rec
        rec._stack().pop()
        if self.template is not None:
            stream = rec.stream(self.device)
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record(stream)
            self.template[self.index][3] = end
            rec._local.last = (self.template, self.template[self.index][1], end, stream)
        elif self.ev0 is not None:
            end = rec.event(self.device)
            end.record(rec.stream(self.device))
            rec._pending.append((self, end))
        elif self.device is None:
            rec._spans.append(Span(self.id, self.name, self.parent, self.call,
                                   (self.t0, self.t1), None))
        # else: inside a capture not made while recording, nothing is kept
        return False


# ---------------------------------------------------------------------------
# reading spans
# ---------------------------------------------------------------------------

OUTSIDE = "outside the port"


def span_totals(spans: Iterable[Span], clock: str = "device") -> Dict[str, list]:
    """Duration summed by span name on one clock (``host`` or ``device``;
    spans not read on it are left out): name -> [count, ms]."""
    out: Dict[str, list] = {}
    for s in spans:
        t = s.host_ns if clock == "host" else s.device_ms
        if t is None:
            continue
        entry = out.setdefault(s.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (t[1] - t[0]) * 1e-6 if clock == "host" else t[1] - t[0]
    return out


class HostSpans:
    """The host spans of entry-point calls made on one thread, to ask which
    span was open at a moment (``time.time_ns()``): entry-point calls do
    not overlap."""

    def __init__(self, spans: Sequence[Span]):
        host = [s for s in spans if s.host_ns is not None]
        self._by_call: Dict[int, List[Span]] = {}
        for s in host:
            self._by_call.setdefault(s.call, []).append(s)
        self._roots = sorted((s.host_ns[0], s.host_ns[1], s.call) for s in host
                             if s.parent is None)
        self._starts = [r[0] for r in self._roots]

    def innermost(self, t_ns: int) -> Optional[Span]:
        """The innermost span open at ``t_ns``, or None outside every
        entry-point call."""
        i = bisect.bisect_right(self._starts, t_ns) - 1
        if i < 0 or self._roots[i][1] < t_ns:
            return None
        return max((s for s in self._by_call[self._roots[i][2]]
                    if s.host_ns[0] <= t_ns <= s.host_ns[1]), key=lambda s: s.host_ns[0])


def idle_by_span(gaps: Iterable[Tuple[int, int]], spans: Sequence[Span]) -> Dict[str, list]:
    """Each device idle gap, (start, end) in ``time.time_ns()`` ns (the
    profiler's clock), put down to the innermost host span open at its
    midpoint, or to :data:`OUTSIDE` where no entry-point call was open
    (the caller's own work): name -> [count, seconds]."""
    host = HostSpans(spans)
    out: Dict[str, list] = {}
    for g0, g1 in gaps:
        inner = host.innermost((g0 + g1) // 2)
        entry = out.setdefault(OUTSIDE if inner is None else inner.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (g1 - g0) * 1e-9
    return out


def write_spans(path: str, spans: Sequence[Span], base_ns: int = 0) -> None:
    """The spans as Chrome / Perfetto trace events (``ph: X``, µs from
    ``base_ns``, the ``baseTimeNanoseconds`` of the profiler's trace):
    host times in process 1; device times in process 2, drawn from the
    host start of their call's root span (CUDA events give times within
    a call, not a clock shared with the host)."""
    starts = {s.call: s.host_ns[0] for s in spans if s.parent is None and s.host_ns}
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": name}}
              for pid, name in ((1, "port spans, host clock"),
                                (2, "port spans, device (from each call's start)"))]
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "call": s.call}
        if s.host_ns is not None:
            events.append({"ph": "X", "name": s.name, "pid": 1, "tid": 0, "args": args,
                           "ts": (s.host_ns[0] - base_ns) / 1e3,
                           "dur": (s.host_ns[1] - s.host_ns[0]) / 1e3})
        if s.device_ms is not None and s.call in starts:
            events.append({"ph": "X", "name": s.name, "pid": 2, "tid": 0, "args": args,
                           "ts": (starts[s.call] - base_ns) / 1e3 + s.device_ms[0] * 1e3,
                           "dur": (s.device_ms[1] - s.device_ms[0]) * 1e3})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "displayTimeUnit": "ms",
                   "traceEvents": events}, f)
