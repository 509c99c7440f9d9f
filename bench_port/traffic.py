"""The one traffic generator: a closed loop of calls of one shape, and the
seeded pool of inputs they rotate over.

A cell's file (``workloads/<cell>.json``) gives the parameters:

* ``n``: the order of every call's systems;
* ``batch``: systems per call (null: one matrix per call);
* ``pool``: how many inputs are made; call i reads slot i mod pool.

The configuration (``configs/<config>.json``) gives the element type and
the distribution of the entries (``matrix`` and ``rhs``: uniform on
[low, high)).  Inputs are made on the device from the seed, in one call
per tensor, before the window.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any integer)."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Traffic:
    """The schedule of one run: which slot call i reads."""

    def __init__(self, cell: dict, seed: int):
        self.n = int(cell["n"])
        self.batch: Optional[int] = cell.get("batch")
        self.pool = int(cell["pool"])
        self._issued = 0
        self.seed = seed

    def next(self) -> int:
        """The slot of the next call."""
        slot = self._issued % self.pool
        self._issued += 1
        return slot


class Pool:
    """The inputs: ``pool`` A's and b's, made on the device from the seed."""

    def __init__(self, traffic: Traffic, config: dict, device: torch.device):
        dtype = getattr(torch, config["dtype"])
        n, batch = traffic.n, traffic.batch
        lead = (traffic.pool,) if batch is None else (traffic.pool, batch)
        gen = torch.Generator(device=device)
        gen.manual_seed(derive(traffic.seed, "inputs"))

        def uniform(shape: tuple, dist: dict) -> torch.Tensor:
            lo, hi = float(dist["low"]), float(dist["high"])
            t = torch.rand(lead + shape, generator=gen, device=device, dtype=dtype)
            return t.mul_(hi - lo).add_(lo)

        self.A = uniform((n, n), config["matrix"])
        self.b = uniform((n,), config["rhs"])

    def inputs(self, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A, b) of ``slot``."""
        return self.A[slot], self.b[slot]
