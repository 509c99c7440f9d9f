"""What one run recorded, and the interval arithmetic of its trace.

A :class:`Run` is what every metric's reader receives: the calls of the
measured window, their host and device times, the work they did, and in a
``--trace 1`` run the device operations that ``torch.profiler`` recorded
(kernels, copies and sets, from CUDA activity only).  The readers under
``metrics/`` take their numbers from it and nothing else.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

# the profiler's activity types of device work; the rest of its CUDA-side
# records (user annotations, synchronisations) are not device work
DEVICE_ACTIVITIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
# kineto's names of its synchronisation records, which hold no device work
SYNC_NAMES = {"Event Sync", "Stream Sync", "Context Sync", "Stream Wait Event", "Unknown"}


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One operation on the device: ``kind`` is ``kernel``, ``memcpy`` or
    ``memset``; times in ns on the profiler's clock."""

    kind: str
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass(frozen=True)
class Call:
    """One timed call on the host's wall clock (``time.time_ns()``, the
    profiler's clock): from the call, to its return (issue end), to the
    synchronise after it."""

    start_ns: int
    issued_ns: int
    done_ns: int


@dataclasses.dataclass
class Run:
    """The measured window of one run.

    ``call_ms``: each call's time on the device's clock (CUDA events
    recorded on the stream before the call and after its return, read
    after the synchronise; the host's clock on the CPU).
    ``host_issue_ms``: each call's host time from the call to its return.
    ``flops`` / ``bytes``: by work.py, summed over the calls.
    ``window_s``: host clock from before the first call to the end of the
    last call's synchronise.  ``ops`` / ``traced``: the device operations
    of a traced window (``traced`` is False in an untraced run)."""

    dtype: str
    device_kind: str
    setup_s: float
    window_s: float
    calls: List[Call]
    call_ms: List[float]
    host_issue_ms: List[float]
    flops: float
    bytes: float
    ops: List[DeviceOp] = dataclasses.field(default_factory=list)
    traced: bool = False

    @property
    def n_calls(self) -> int:
        return len(self.call_ms)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (union of intervals)."""
        return busy_seconds(self.ops)

    def op_seconds(self, keep: Callable[[DeviceOp], bool]) -> float:
        """Summed duration of the operations that ``keep`` selects."""
        return sum(op.seconds for op in self.ops if keep(op))


def merged(ops: Iterable[DeviceOp]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, as sorted disjoint
    (start, end) pairs."""
    out: List[List[int]] = []
    for s, e in sorted((op.start_ns, op.end_ns) for op in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(ops: Iterable[DeviceOp]) -> float:
    return sum(e - s for s, e in merged(ops)) * 1e-9


def idle_gaps(ops: Sequence[DeviceOp]) -> List[Tuple[int, int, str]]:
    """The gaps between the union's intervals: (start, end, name of the
    operation that ends the gap)."""
    first = {}
    for op in sorted(ops, key=lambda o: (o.start_ns, o.end_ns)):
        first.setdefault(op.start_ns, op.name)
    spans = merged(ops)
    return [(spans[i][1], spans[i + 1][0], first[spans[i + 1][0]])
            for i in range(len(spans) - 1)]


def short_name(name: str, limit: int = 80) -> str:
    """A kernel's function name without its template arguments and
    parameters (``void panel_chain_kernel<float, 16>(...)`` ->
    ``panel_chain_kernel``; ``Memcpy DtoD (Device -> Device)`` ->
    ``Memcpy DtoD``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0][:limit]
    base = re.sub(r"^void ", "", name)
    depth, cut = 0, []
    for ch in base:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            cut.append(ch)
    text = "".join(cut).strip() or name
    return text.split("::")[-1][:limit]


def host_phase(t_ns: int, calls: Sequence[Call]) -> str:
    """What the host was doing at ``t_ns``: issuing a call, waiting in its
    synchronise, or the harness's own work between calls."""
    lo, hi = 0, len(calls)
    while lo < hi:  # the last call that started at or before t_ns
        mid = (lo + hi) // 2
        if calls[mid].start_ns <= t_ns:
            lo = mid + 1
        else:
            hi = mid
    if lo:
        c = calls[lo - 1]
        if t_ns <= c.issued_ns:
            return "issuing"
        if t_ns <= c.done_ns:
            return "synchronising"
    return "between calls"


def totals(run: Run) -> Tuple[dict, dict]:
    """Device time by operation (short name) and idle time by what the host
    was doing (and, while it issued a call, by the operation that ended the
    gap): name -> [count, seconds]."""
    by_op: dict = {}
    for op in run.ops:
        entry = by_op.setdefault(short_name(op.name), [0, 0.0])
        entry[0] += 1
        entry[1] += op.seconds
    by_gap: dict = {}
    for s, e, after in idle_gaps(run.ops):
        phase = host_phase((s + e) // 2, run.calls)
        key = f"issuing, before {short_name(after, 60)}" if phase == "issuing" else phase
        entry = by_gap.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) * 1e-9
    return by_op, by_gap


def breakdown(run: Run, top: int = 10) -> dict:
    """The result line's ``breakdown``: the ``top`` device operations and
    idle gaps of :func:`totals` by their summed seconds, longest first."""
    by_op, by_gap = totals(run)
    order = lambda d: [[k, v[1]] for k, v in sorted(d.items(), key=lambda kv: -kv[1][1])][:top]
    return {"device_ops": order(by_op), "idle_gaps": order(by_gap)}


def device_ops(prof) -> List[DeviceOp]:
    """The device operations a ``torch.profiler.profile`` recorded, from
    its kineto results (no FunctionEvent tree is built).  Where the events
    carry no activity type (PyTorch 2.11), the kind comes from the name:
    the profiler names copies ``Memcpy ...`` and sets ``Memset ...``;
    synchronisation records are left out."""
    events = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        activity = e.activity_type() if hasattr(e, "activity_type") else None
        events.append((e.name(), str(e.device_type()), activity,
                       start, start + int(e.duration_ns())))
    ops: List[DeviceOp] = []
    for name, device, activity, start, end in events:
        if "CUDA" not in device:
            continue
        if activity is not None:
            kind = DEVICE_ACTIVITIES.get(str(activity))
        elif name in SYNC_NAMES:
            kind = None
        else:
            kind = ("memcpy" if name.startswith("Memcpy")
                    else "memset" if name.startswith("Memset") else "kernel")
        if kind is not None:
            ops.append(DeviceOp(kind, name, start, end))
    return ops


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (``q`` in 0..100) of all the values."""
    if not values:
        return None
    ranked = sorted(values)
    k = max(1, -(-len(ranked) * q // 100))  # ceil(N q / 100)
    return ranked[int(k) - 1]


def median(values: Sequence[float]) -> Optional[float]:
    if not values:
        return None
    ranked = sorted(values)
    mid = len(ranked) // 2
    return ranked[mid] if len(ranked) % 2 else 0.5 * (ranked[mid - 1] + ranked[mid])
