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
    # 4 panels of 8: the first two run their trailing block beside the next
    assert _children(spans, factor) == (
        ["lu.clone"] + (step + ["blocked.trailing"]) * 2 + step + step[:2])
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
    # the panel before the tail has no next panel: no trailing block of its own
    assert _children(spans, _root(spans, "lu_factor")) == (
        ["lu.clone"] + step + ["blocked.trailing"] + step + ["blocked.tail", "blocked.laswp"])

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


def _span_breakdown():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("span_breakdown")


def test_the_chain_gaps_split_each_call_by_the_panels_plans():
    """``span_breakdown.chain_gaps``: a window's ``panel_chain_kernel``
    launches go to the calls whose host windows hold them, each call's
    into panels of ``sizes``; the gap at each boundary runs from one
    panel's last chain to the next panel's first (µs); the other kernels
    are ignored, and a call with a chain missing is left out."""
    sb = _span_breakdown()
    from bench_port.record import Call, DeviceOp, Run

    ops, calls, t = [], [], 0
    for call in range(3):
        t0 = t
        for panel, blocks in enumerate((3, 2, 1)):
            for _ in range(blocks):
                ops.append(DeviceOp("kernel", "void panel_chain_kernel<float, 16>(...)", t,
                                    t + 40_000))
                ops.append(DeviceOp("kernel", "panel_update_kernel", t + 40_000, t + 45_000))
                t += 47_000
            t += (100_000 if panel == 0 else 60_000) + 1000 * call
        calls.append(Call(t0, t0 + 1000, t))
        t += 1_000_000
    del ops[-2]  # the third call's last chain was not recorded
    run = Run("float32", "card", 0.0, 1.0, calls, [1.0] * 3, [0.1] * 3, 0.0, 0.0,
              ops=ops, traced=True)
    got = sb.chain_gaps(run, [3, 2, 1])
    assert (got["chains"], got["calls"], got["whole_calls"]) == (17, 3, 2)
    assert got["by_boundary_us"] == [107.5, 67.5]
    assert got["median_us"] == pytest.approx(87.5)
    assert got["within_panel_us"] == 7.0
    # first chain to last: 5 strides of 47 µs, the last chain's 40, the two gaps' 160 + 1000 ns
    # times the call (0 and 1: median 1)
    assert got["span_ms"] == pytest.approx(0.436)
    assert got["chain_ms_per_call"] == pytest.approx(17 * 0.04 / 3)
    # plans that do not match the recorded chains give no gap
    assert sb.chain_gaps(run, [3, 2, 2]) == {"chains": 17, "calls": 3, "whole_calls": 0}


def test_the_trailing_blocks_overlap_is_read_against_the_panel_spans():
    """``span_breakdown.trailing_overlap``: ``blocked.trailing``'s device ms
    per call, and the part of it inside a ``blocked.panel`` span of the same
    parent (the next panel's kernels)."""
    sb = _span_breakdown()
    spans = [profiling.Span(2, "blocked.panel", 1, 1, None, (0.0, 1.0)),
             profiling.Span(3, "blocked.trailing", 1, 1, None, (1.2, 2.2)),
             profiling.Span(4, "blocked.panel", 1, 1, None, (1.3, 1.9)),
             profiling.Span(6, "blocked.panel", 5, 5, None, (2.0, 3.0)),
             profiling.Span(7, "blocked.trailing", 5, 5, None, (3.0, 3.5))]
    got = sb.trailing_overlap(spans, 2)
    assert got["ms_per_call"] == pytest.approx(0.75)
    assert got["beside_panel_ms_per_call"] == pytest.approx(0.3)
    assert got["beside_share"] == pytest.approx(0.4)
    assert sb.trailing_overlap(spans[:1], 1)["beside_share"] is None
