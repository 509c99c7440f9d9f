"""Panels whose pivots land where the chain kernel's one-column look-ahead
works (csrc/panel_cluster.cuh `panel_chain_kernel`): on the rows a step
publishes, which take the deferred update early.  Shared by the CPU
emulation (tests/test_torch_panel_schedule.py) and the card tests
(tests/test_torch_cuda.py); imports neither JAX nor the port.

``kind``:

* ``"randn"``: standard normal entries, nothing scaled;
* ``"diag"``: a dominant diagonal, so every step's pivot is row gk itself,
  the CTA's candidate is the row it publishes as row gk too;
* ``"boundary"``: the last row of every CTA of the first block (and the
  first of the first CTA, the panel's last row) scaled by large distinct
  factors, so the first steps' winners sit on CTA boundaries;
* ``"repeat"``: the first row of every CTA scaled by factors falling with
  the CTA, so each is its CTA's candidate in every step until it wins:
  the same row published in many steps running.

``next_block_panel`` puts every pivot of a block of b steps in the next
block's rows (csrc/panel_cluster.cuh `run_cluster`'s carry: the next chain
loads the rows a block's moves bring, and the block's U rows come from rows
that chain holds).
"""

import numpy as np
import torch

KINDS = ("randn", "diag", "boundary", "repeat")


def scaled_rows(kind, m, C):
    """The rows ``lookahead_panel`` scales up, in ascending order: the first
    steps' winners are among them."""
    rows = -(-m // C)
    if kind == "boundary":
        return sorted({min(m, c * rows) - 1 for c in range(1, C + 1)} | {0})
    if kind == "repeat":
        return [c * rows for c in range(C) if c * rows < m]
    return []


def lookahead_panel(kind, m, w, C, dtype=torch.float32, seed=0):
    """An (m, w) panel of ``kind`` for a chain of ``C`` CTAs (the first
    block's rows split in ceil(m / C))."""
    rng = np.random.default_rng([seed, m, w, C, KINDS.index(kind)])
    A = rng.standard_normal((m, w))
    if dtype.is_complex:
        A = A + 1j * rng.standard_normal((m, w))
    if kind == "diag":
        k = min(m, w)
        A[np.arange(k), np.arange(k)] += 4 * m
    rows = scaled_rows(kind, m, C)
    for n, r in enumerate(rows):
        A[r] *= 1e3 * (1 + n / len(rows)) if kind == "boundary" else 1e3 * (len(rows) - n)
    return torch.tensor(A, dtype=dtype)


def next_block_panel(m, w, b, dtype=torch.float32, seed=0):
    """An (m, w) panel whose step k pivots on row k + b wherever that row
    exists (its entry in column k raised far above the rest): each block of
    b steps swaps its rows with the next block's, so its moves bring rows
    into the next chain's slab and its U rows come from rows of that slab."""
    rng = np.random.default_rng([seed, m, w, b, 7])
    A = rng.standard_normal((m, w))
    if dtype.is_complex:
        A = A + 1j * rng.standard_normal((m, w))
    for k in range(min(w, m - b)):
        A[k + b, k] += 1e3 * (m + w)
    return torch.tensor(A, dtype=dtype)
