"""HPL's count, the byte count and the peaks, at small n."""

import pytest

from bench_port import work


@pytest.mark.parametrize("n, batch, expected", [
    (1, None, 2 / 3 + 1.5),
    (2, None, 16 / 3 + 6),
    (3, 10, 10 * (18 + 13.5)),
    (4096, None, 2 / 3 * 4096 ** 3 + 1.5 * 4096 ** 2),
])
def test_hpl_flops(n, batch, expected):
    assert work.hpl_flops(n, batch) == pytest.approx(expected, rel=1e-15)


def test_call_bytes_counts_each_input_read_and_each_output_written_once():
    # n = 2, float32: A 16 + b 8 read; factors 16 + x 8 + ipiv 8 + info 4 written
    assert work.call_bytes(2) == 16 + 8 + 16 + 8 + 8 + 4
    assert work.call_bytes(2, 5) == 5 * 60
    assert work.call_bytes(2, None, "float64") == 32 + 16 + 32 + 16 + 8 + 4


def test_least_seconds_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    # n = 4096: bound by the operations
    f, b = work.hpl_flops(4096), work.call_bytes(4096)
    assert work.least_seconds(f, b, kind, "float32") == pytest.approx(f / 67e12)
    # 10 000 x 64: bound by the bytes
    f, b = work.hpl_flops(64, 10000), work.call_bytes(64, 10000)
    assert b / 3.35e12 > f / 67e12
    assert work.least_seconds(f, b, kind, "float32") == pytest.approx(b / 3.35e12)
    assert work.least_seconds(f, b, "cpu", "float32") is None
