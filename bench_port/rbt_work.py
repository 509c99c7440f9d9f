"""The operations and the least bytes of the depth-2 random butterfly
transform, for the ``rbt_transform_roofline`` share: functions of the
call's shapes alone.

A run carries HPL's operation count of its calls, not their order, so the
order comes back from that count (:func:`order_from_hpl_flops`).
"""

from __future__ import annotations

from . import work


def order_from_hpl_flops(flops: float) -> int:
    """The order n whose HPL count ``work.hpl_flops(n)`` is ``flops``."""
    n = max(1, round((1.5 * flops) ** (1.0 / 3.0)))
    while n > 1 and work.hpl_flops(n) > flops:
        n -= 1
    while work.hpl_flops(n + 1) <= flops:
        n += 1
    if work.hpl_flops(n) != flops:
        raise ValueError(f"{flops} is not HPL's count of one system")
    return n


def transform_bytes(n: int, dtype: str) -> float:
    """The bytes one depth-2 apply ``U^T A V`` has to move at least, at the
    order n padded to a multiple of 4: A read once, ``A~`` written once and
    the 4n butterfly values read once."""
    m = n + (-n) % 4
    return float(work.ITEMSIZE[dtype] * (2 * m * m + 4 * m))


def transform_flops(n: int) -> float:
    """The operations of one depth-2 apply at the order n padded to a
    multiple of 4: each level takes, for every element, one sum or
    difference of two inputs, one of two partial results and two products
    (a scale by u and one by v): 8 m^2 in all."""
    m = n + (-n) % 4
    return 8.0 * m * m
