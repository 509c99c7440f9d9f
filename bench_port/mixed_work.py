"""The least bytes and the operations of the two float64 passes of
mixed-precision refinement (``csrc/mixed_refine.cu``), for the
``mixed_narrow_roofline`` and ``mixed_residual_roofline`` shares: functions
of the order n alone, which comes back from a run's HPL count
(``rbt_work.order_from_hpl_flops``).
"""

from __future__ import annotations


def narrow_bytes(n: int) -> float:
    """One narrowing pass: A read once in float64 and single(A) written once
    (12 n^2), ||A||_inf and the overflow flag written (8 + 4)."""
    return float(12 * n * n + 12)


def narrow_flops(n: int) -> float:
    """One narrowing pass: a sum of |a_ij| per entry."""
    return float(n * n)


def residual_bytes(n: int) -> float:
    """One residual pass with one right-hand side: A read once (8 n^2); x, b
    and the status read, r (float64) and single(r) written (8 + 8 + 8 + 4 a
    row, and 2 x 8 for the pair, read and written)."""
    return float(8 * n * n + 28 * n + 16)


def residual_flops(n: int) -> float:
    """One residual pass with one right-hand side: a product and a sum per
    entry of A, one difference per row."""
    return float(2 * n * n + n)
