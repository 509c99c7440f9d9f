"""The interval arithmetic and the metrics' readers on a synthetic trace."""

import pytest

from bench_port import harness, record
from bench_port.record import Call, DeviceOp, Run

MS = 1_000_000  # ns


def op(kind, name, start_ms, end_ms):
    return DeviceOp(kind, name, int(start_ms * MS), int(end_ms * MS))


def synthetic_run(ops, calls=2, window_s=0.010, dtype="float32",
                  kind="NVIDIA H100 80GB HBM3", flops=2e9, nbytes=1e6):
    return Run(dtype, kind, 1.5, window_s,
               [Call(i * 5 * MS, i * 5 * MS + MS, (i + 1) * 5 * MS) for i in range(calls)],
               [4.0, 5.0][:calls], [1.0, 3.0][:calls], flops, nbytes, ops=ops, traced=True)


OPS = [
    op("memcpy", "Memcpy DtoD (Device -> Device)", 0.0, 0.5),
    op("kernel", "void panel_chain_kernel<float, 16>(float*, int)", 0.5, 2.5),
    op("kernel", "void panel_update_kernel<float, false>(float*)", 2.0, 3.0),  # overlaps
    op("kernel", "ampere_sgemm_128x64_nn", 4.0, 4.5),  # gap 3.0 .. 4.0
    op("kernel", "void at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)", 6.0, 6.5),
    op("memset", "Memset (Device)", 6.5, 7.0),
]


def read(name, run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run)


def test_union_and_idle_share():
    assert record.merged(OPS) == [(0, 3 * MS), (4 * MS, int(4.5 * MS)), (6 * MS, 7 * MS)]
    run = synthetic_run(OPS)
    assert run.busy_s == pytest.approx(4.5e-3)
    assert read("device_idle_pct.replay", run) == pytest.approx(100 * (1 - 4.5 / 10))


def test_gaps_are_labelled_by_what_the_host_did():
    gaps = record.idle_gaps(OPS)
    assert [(s / MS, e / MS) for s, e, _ in gaps] == [(3.0, 4.0), (4.5, 6.0)]
    # call 0 issues 0..1 ms and synchronises to 5 ms; call 1 issues 5..6 ms
    assert record.host_phase(int(3.5 * MS), synthetic_run(OPS).calls) == "synchronising"
    assert record.host_phase(int(5.25 * MS), synthetic_run(OPS).calls) == "issuing"
    assert record.host_phase(int(20 * MS), synthetic_run(OPS).calls) == "between calls"
    b = record.breakdown(synthetic_run(OPS))
    assert b["device_ops"][0] == ["panel_chain_kernel", pytest.approx(2e-3)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    labels = dict(b["idle_gaps"])
    assert labels["synchronising"] == pytest.approx(1e-3)
    assert labels["issuing, before direct_copy_kernel_cuda"] == pytest.approx(1.5e-3)


def test_short_names():
    assert record.short_name("void panel_chain_kernel<float, 16>(float*, int)") == "panel_chain_kernel"
    assert record.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert record.short_name(
        "void at::native::(anonymous namespace)::foo_kernel<float>(int)") == "foo_kernel"


def test_device_layer_readers():
    run = synthetic_run(OPS)
    assert read("panel_ms", run) == pytest.approx((2.0 + 1.0) / 2)
    assert read("copy_ms", run) == pytest.approx((0.5 + 0.5 + 0.5) / 2)
    assert read("outside_panel_ms", run) == pytest.approx(0.5 / 2)  # the GEMM
    assert read("batched_kernel_ms", run) is None  # no batched kernel ran
    batched = synthetic_run([op("kernel", "void batched_lu_block_kernel<float, 8, 6>(float*)", 0, 0.8),
                             op("kernel", "void batched_solve_wide_kernel<float, 2, 1>(float*)", 0.8, 0.9)],
                            calls=1)
    assert read("batched_kernel_ms", batched) == pytest.approx(0.9)


def test_outside_panel_is_busy_less_panel_and_copies():
    ops = OPS + [op("kernel", "ampere_sgemm_128x64_nn", 8.0, 10.0)]
    run = synthetic_run(ops)
    assert read("outside_panel_ms", run) == pytest.approx((0.5 + 2.0) / 2)


def test_roofline_share_and_host_readers():
    run = synthetic_run(OPS, flops=67e9, nbytes=1.0)  # 1 ms at 67 TFLOP/s
    assert read("call_roofline", run) == pytest.approx(100 * 1e-3 / 4.5e-3)
    assert read("call_roofline", synthetic_run(OPS, kind="cpu")) is None
    assert read("host_issue_ms.replay", run) == pytest.approx(2.0)
    assert read("call_ms_p95", run) == 5.0


def test_end_to_end_readers():
    run = synthetic_run([], flops=4e9, window_s=2.0)
    assert read("gflops", run) == pytest.approx(2.0)
    assert read("setup_s", run) == 1.5
    # an untraced run has nothing for the per-layer readers
    run.traced = False
    for name in ("panel_ms", "copy_ms", "device_idle_pct.replay", "call_roofline",
                 "host_issue_ms.replay", "outside_panel_ms", "batched_kernel_ms"):
        assert read(name, run) is None


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 101))
    assert record.percentile(values, 95) == 95
    assert record.percentile([3.0], 95) == 3.0
    assert record.percentile(list(range(1, 21)), 95) == 19
    assert record.median([1, 2, 3, 10]) == 2.5


class _Event:
    def __init__(self, name, device, start, duration, activity=None):
        self._v = (name, device, start, duration)
        if activity is not None:
            self.activity_type = lambda: activity

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


class _Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_device_ops_from_the_profilers_events():
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"
    # events without an activity type (PyTorch 2.11): the kind from the name
    ops = record.device_ops(_Profile([
        _Event("void k<float>(float*)", cuda, 0, 5), _Event("Memcpy DtoD (Device -> Device)", cuda, 5, 2),
        _Event("Memset (Device)", cuda, 7, 1), _Event("Stream Sync", cuda, 0, 9),
        _Event("cudaLaunchKernel", cpu, 0, 1)]))
    assert [(o.kind, o.start_ns, o.end_ns) for o in ops] == [
        ("kernel", 0, 5), ("memcpy", 5, 7), ("memset", 7, 8)]
    # events with one: annotations and runtime calls are not device work
    ops = record.device_ops(_Profile([
        _Event("k", cuda, 0, 5, "kernel"), _Event("Memcpy HtoD", cuda, 5, 1, "gpu_memcpy"),
        _Event("range", cuda, 0, 9, "gpu_user_annotation"), _Event("cudaMemcpyAsync", cpu, 0, 1, "cuda_runtime")]))
    assert [o.kind for o in ops] == ["kernel", "memcpy"]
