"""Tests of the port's benchmark (``bench_port/``): on the CPU at small
sizes, and, marked ``cuda``, on the card.

    python -m pytest bench_port/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: tests that run the benchmark on a CUDA card; they skip without one")
