"""The port's span recorder stays off through a run of the harness, traced
or not: the end-to-end numbers time the port as its users run it, and the
traced run's profiler sees the same programs."""

import pytest

from bench_port import harness
from recursivefactorization_jl_tpu_torch.utils import profiling

SMALL = {
    "lu_f32.replay_n4096": dict(n=64, pool=2),
    "batched_f32.replay_n64": dict(n=16, batch=8, pool=2),
}


class Watched:
    """The cell's calls, noting whether spans were being recorded."""

    def __init__(self, cell):
        self.entry = harness.load_module(
            harness.BENCH_DIR / "entries" / f"{harness.load_spec(cell)['cell']['entry']}.py")
        self.seen = []

    def warm(self, A, b, device):
        self.seen.append(profiling.enabled())
        self.entry.warm(A, b, device)

    def release(self):
        self.entry.release()

    def call(self, A, b, device):
        self.seen.append(profiling.enabled())
        return self.entry.call(A, b, device)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", list(SMALL))
def test_a_run_records_no_span(cell, trace):
    watched = Watched(cell)
    result, _ = harness.run_cell(cell, 5, 0.1, trace, device="cpu", overrides=SMALL[cell],
                                 entry=watched)
    assert result["correct"] and len(watched.seen) > 1
    assert not any(watched.seen) and not profiling.enabled()
    assert profiling.collect() == []
