"""The yardstick's arithmetic: HPL's operation count, the bytes a call has
to move, and the published peaks of the card.

Everything here is a function of the call's shapes and of the card's
name, never of the program that computes the call, so the counts stay
right whatever kernels a later version of the program runs.
"""

from __future__ import annotations

from typing import Optional

# Published peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W
# power limit): operations per second by element type, outside the tensor
# cores for float32 (TF32 is a lower precision, which the configurations
# rule out), on the FP64 tensor cores for float64; and HBM3 bytes per
# second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12,
        "float64": 67e12,
        "bytes_per_s": 3.35e12,
    },
}

ITEMSIZE = {"float32": 4, "float64": 8}
INDEX_ITEMSIZE = 4  # ipiv and info are int32


def hpl_flops(n: int, batch: Optional[int] = None) -> float:
    """HPL 2.3's operation count of one solve of an n x n system with one
    right-hand side (factor and both substitutions): 2/3 n^3 + 3/2 n^2,
    times the number of systems."""
    return (2.0 / 3.0 * n ** 3 + 1.5 * n ** 2) * (batch or 1)


def call_bytes(n: int, batch: Optional[int] = None, dtype: str = "float32") -> float:
    """The bytes one call has to move at least: A (n x n) and b (n) read
    once; the packed factors (n x n), ipiv (n), info and x (n) written
    once; times the number of systems."""
    item = ITEMSIZE[dtype]
    read = item * (n * n + n)
    written = item * (n * n + n) + INDEX_ITEMSIZE * (n + 1)
    return float(read + written) * (batch or 1)


def least_seconds(flops: float, nbytes: float, kind: str, dtype: str) -> Optional[float]:
    """The least time the card ``kind`` needs for ``flops`` operations and
    ``nbytes`` bytes: the larger of the two at its published peaks; None
    for a card the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None or dtype not in peak:
        return None
    return max(flops / peak[dtype], nbytes / peak["bytes_per_s"])
