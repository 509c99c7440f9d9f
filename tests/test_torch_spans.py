"""The port's spans and counters (``utils/profiling.py``, ``utils/graphs.py``)
on the CPU: off, a span is one shared no-op; on, the entry points' spans
come with their parents and one call id per entry-point call, host times
only.  The device spans of a replay are read from stand-in events here;
tests/test_torch_cuda.py reads them from a real capture on the card."""

import json
import threading

import pytest
import torch

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.utils import graphs, profiling

torch.set_num_threads(1)

BLOCKED = rt.LUConfig(panel_width=8, small_threshold=8, tail_threshold=None)


def _matrix(n, seed=0, batch=None):
    g = torch.Generator().manual_seed(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def _root(spans, name):
    (root,) = [s for s in spans if s.name == name and s.parent is None]
    return root


def test_off_a_span_is_the_shared_no_op_and_nothing_is_kept():
    assert not profiling.enabled() and profiling.collect() == []
    first = profiling.span("blocked.panel")
    assert first is profiling.span("graphs.replay", torch.zeros(1))
    with first as opened:
        assert opened is None
    F = rt.lu(_matrix(32), config=BLOCKED, device="cpu")
    rt.lu_solve(F, torch.ones(32, dtype=torch.float64))
    with profiling.recording() as rec:
        assert profiling.enabled()
    assert not profiling.enabled() and rec.collect() == []


def test_lu_and_lu_solve_spans_name_each_step_under_one_call_each():
    A = _matrix(32)
    with profiling.recording() as rec:
        F = rt.lu(A, config=BLOCKED, device="cpu")
        x = rt.lu_solve(F, torch.ones(32, dtype=torch.float64))
    spans = rec.collect()
    assert torch.allclose(A @ x, torch.ones(32, dtype=torch.float64))
    factor, solve = _root(spans, "lu_factor"), _root(spans, "lu_solve")
    assert factor.call == factor.id and solve.call == solve.id and factor.call != solve.call
    step = ["blocked.panel", "blocked.laswp", "blocked.trsm", "blocked.schur"]
    assert _children(spans, factor) == ["lu.clone"] + step * 3 + step[:2]
    assert _children(spans, solve) == ["solve.permute", "solve.forward", "solve.backward"]
    assert {s.call for s in spans} == {factor.call, solve.call}
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.clock == "host" and s.device_ms is None
        assert s.host_ns[0] <= s.host_ns[1]
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.call == s.call
            assert up.host_ns[0] <= s.host_ns[0] and s.host_ns[1] <= up.host_ns[1]


def test_the_tail_and_the_physical_schedule_have_their_spans():
    with profiling.recording() as rec:
        rt.lu(_matrix(32), config=rt.LUConfig(panel_width=8, small_threshold=8,
                                              tail_threshold=16), device="cpu")
    spans = rec.collect()
    step = ["blocked.panel", "blocked.laswp", "blocked.trsm", "blocked.schur"]
    assert _children(spans, _root(spans, "lu_factor")) == (
        ["lu.clone"] + step * 2 + ["blocked.tail", "blocked.laswp"])

    with profiling.recording() as rec:
        rt.lu(_matrix(32), config=rt.LUConfig(panel_width=8, small_threshold=8,
                                              schedule="physical"), device="cpu")
    spans = rec.collect()
    step = ["blocked.panel", "blocked.trsm", "blocked.schur"]
    assert _children(spans, _root(spans, "lu_factor")) == (
        ["lu.clone"] + step * 3 + ["blocked.panel", "blocked.laswp"])


def test_a_fat_matrix_ends_with_its_permute_and_solve():
    with profiling.recording() as rec:
        rt.lu(_matrix(32)[:16], config=BLOCKED, device="cpu")
    spans = rec.collect()
    names = _children(spans, _root(spans, "lu_factor"))
    assert names[0] == "lu.clone" and names[-2:] == ["blocked.laswp", "blocked.trsm"]


def test_batched_calls_have_their_spans():
    A = _matrix(8, batch=5) + 8 * torch.eye(8, dtype=torch.float64)
    b = torch.ones(5, 8, dtype=torch.float64)
    with profiling.recording() as rec:
        f, ipiv, info = rt.batched_lu_factor(A, device="cpu")
        x = rt.batched_lu_solve(f, ipiv, b, device="cpu")
        g, perm, _ = rt.batched_lu_factor_perm(A, device="cpu")
        rt.batched_lu_solve_perm(g, perm, b, device="cpu")
    spans = rec.collect()
    assert torch.allclose(A @ x[:, :, None], b[:, :, None])
    for kind, inner in (("batched_lu_factor", "batched.factor"),
                        ("batched_lu_solve", "batched.solve"),
                        ("batched_lu_factor_perm", "batched.factor"),
                        ("batched_lu_solve_perm", "batched.solve")):
        assert _children(spans, _root(spans, kind)) == [inner]
    assert len({s.call for s in spans}) == 4


def test_the_fused_solve_and_a_half_solve_open_one_span_per_step():
    A = _matrix(32)
    with profiling.recording() as rec:
        rt.solve(A, torch.ones(32, dtype=torch.float64), config=BLOCKED, device="cpu")
        F = rt.lu(A.to(torch.bfloat16), config=BLOCKED, device="cpu")
        rt.lu_solve(F, torch.ones(32, dtype=torch.bfloat16))
    spans = rec.collect()
    assert _children(spans, _root(spans, "solve"))[-1] == "solve.backward"
    assert _children(spans, _root(spans, "lu_solve")) == [
        "solve.permute", "solve.forward", "solve.backward"]


def test_threads_keep_their_own_calls():
    def work():
        F = rt.lu(_matrix(16), config=BLOCKED, device="cpu")
        rt.lu_solve(F, torch.ones(16, dtype=torch.float64))

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    spans = rec.collect()
    roots = [s for s in spans if s.parent is None]
    assert sorted(s.name for s in roots) == ["lu_factor"] * 4 + ["lu_solve"] * 4
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].call == s.call for s in spans if s.parent is not None)


class _Timed:
    """A stand-in timing event at ``t`` ms of the card's clock."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


class _StandInSpan:
    def __init__(self, sid, call, origin):
        self.id, self.call, self.origin, self.root = sid, call, origin, self


def test_a_replays_spans_are_read_before_the_next_replay_and_at_collect():
    """The spans a capture recorded as graph nodes become children of the
    replay's ``graphs.replay`` span, on the device's clock from the call's
    first event, once per replay."""
    program = type("P", (), {})()
    shared = _Timed(4.0)  # a span inside a capture starts where its sibling ended
    program.spans = (("lu_factor", None, _Timed(1.0), _Timed(9.0)),
                     ("blocked.panel", 0, _Timed(1.5), shared),
                     ("blocked.schur", 0, shared, _Timed(8.5)))
    with profiling.recording() as rec:
        profiling.after_replay(program, _StandInSpan(100, 99, _Timed(0.5)))
        profiling.before_replay(program)  # the next replay reads the last one's
        profiling.after_replay(program, _StandInSpan(200, 199, _Timed(0.0)))
    spans = rec.collect()
    assert [(s.name, s.call) for s in spans] == [
        ("lu_factor", 99), ("blocked.panel", 99), ("blocked.schur", 99),
        ("lu_factor", 199), ("blocked.panel", 199), ("blocked.schur", 199)]
    first, panel = spans[0], spans[1]
    assert first.parent == 100 and panel.parent == first.id
    assert first.device_ms == (0.5, 8.5) and panel.device_ms == (1.0, 3.5)
    assert spans[3].device_ms == (1.0, 9.0) and spans[3].parent == 200
    assert all(s.host_ns is None and s.clock == "device" for s in spans)
    # a program captured while not recording reports nothing
    with profiling.recording() as rec:
        profiling.after_replay(type("Q", (), {"spans": ()})(), _StandInSpan(1, 1, _Timed(0)))
    assert rec.collect() == []


def _span(sid, name, parent, call, t0, t1, device=None):
    return profiling.Span(sid, name, parent, call, (t0, t1), device)


def test_idle_gaps_go_to_the_innermost_host_span_or_outside_the_port():
    spans = [_span(1, "lu_factor", None, 1, 100, 200), _span(2, "graphs.copy_in", 1, 1, 110, 120),
             _span(3, "graphs.replay", 1, 1, 120, 190), _span(4, "lu_solve", None, 4, 300, 350)]
    gaps = [(112, 118), (150, 170), (195, 199), (200, 300), (310, 320), (400, 500)]
    got = profiling.idle_by_span(gaps, spans)
    assert {k: v[0] for k, v in got.items()} == {
        "graphs.copy_in": 1, "graphs.replay": 1, "lu_factor": 1, profiling.OUTSIDE: 2,
        "lu_solve": 1}
    assert got[profiling.OUTSIDE][1] == pytest.approx(200e-9)
    assert got["graphs.replay"][1] == pytest.approx(20e-9)


def test_span_totals_sum_by_name_on_each_clock():
    spans = [_span(1, "lu_factor", None, 1, 0, 2_000_000, (0.0, 5.0)),
             _span(2, "blocked.schur", 1, 1, 0, 500_000, (1.0, 2.5)),
             _span(3, "blocked.schur", 1, 1, 500_000, 1_000_000, (2.5, 3.0)),
             profiling.Span(4, "blocked.panel", 1, 1, None, (3.0, 4.0))]
    assert profiling.span_totals(spans) == {
        "lu_factor": [1, 5.0], "blocked.schur": [2, 2.0], "blocked.panel": [1, 1.0]}
    assert profiling.span_totals(spans, "host") == {
        "lu_factor": [1, 2.0], "blocked.schur": [2, 1.0]}
    assert spans[0].clock == "host+device" and spans[3].clock == "device"


def test_trace_writes_the_spans_beside_the_profilers_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        F = rt.lu(_matrix(32), config=BLOCKED, device="cpu")
        rt.lu_solve(F, torch.ones(32, dtype=torch.float64))
    with open(tmp_path / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    with open(tmp_path / profiling.SPANS_FILE) as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    named = {e["name"]: e for e in spans["traceEvents"] if e["ph"] == "X"}
    assert {"lu_factor", "lu_solve", "blocked.schur", "solve.forward"} <= set(named)
    # the same clock: the profiler's aten records of lu lie inside lu_factor's span
    lu = named["lu_factor"]
    aten = [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("aten::")]
    inside = [e for e in aten if lu["ts"] <= e["ts"] <= lu["ts"] + lu["dur"]]
    assert inside and len(inside) < len(aten)  # lu_solve's lie after it
    assert not profiling.enabled()


def test_stats_count_replays_captures_and_eager_calls(monkeypatch):
    """``stats()`` sums each program's ``.replays``, freed programs
    included; CPU calls are neither replays nor eager CUDA calls."""
    before = graphs.stats()
    assert set(before) == {"replays", "captures", "eager"}
    rt.lu(_matrix(16), device="cpu")
    assert graphs.stats() == before

    class Graph:
        def replay(self):
            pass

        def reset(self):
            pass

    class Done:
        def record(self, stream):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"wait_event": lambda s, e: None})())
    program = object.__new__(graphs._Program)
    program.inputs, program.outputs = (torch.zeros(2),), (torch.zeros(2),)
    program.single, program.replays, program.device = True, 0, torch.device("cpu")
    program._lock, program._done, program.graph = threading.Lock(), Done(), Graph()
    monkeypatch.setitem(graphs._PROGRAMS, ("stand_in",), program)
    program(torch.ones(2))
    program(torch.ones(2))
    assert graphs.stats()["replays"] == before["replays"] + 2
    graphs.clear()
    assert graphs.stats()["replays"] == before["replays"] + 2
