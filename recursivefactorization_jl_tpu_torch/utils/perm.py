"""Pivot-sequence <-> permutation utilities.

``ipiv`` is the 0-based LAPACK-style swap sequence: ``ipiv[k] = r`` means
that at elimination step k rows k and r (r >= k) were interchanged.
``perm`` is the composed row permutation with ``L @ U == A[perm, :]``.
``info`` keeps the 1-based convention: 0 on success, else the first
zero-pivot step, negated on the no-pivot path.
"""

from __future__ import annotations

import torch


def ipiv_to_perm(ipiv: torch.Tensor, m: int) -> torch.Tensor:
    """Fold the swap sequence ``ipiv`` into a permutation vector ``p`` of
    length ``m`` such that ``A[p, :]`` applies the interchanges in order."""
    piv = ipiv.detach().to("cpu", torch.int64).tolist()
    perm = list(range(m))
    for i, j in enumerate(piv):
        perm[i], perm[j] = perm[j], perm[i]
    return torch.tensor(perm, dtype=torch.int32, device=ipiv.device)


def batched_ipiv_to_perm(ipiv: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`ipiv_to_perm` for a batch: ``ipiv`` (B, k) -> ``perm``
    (B, m) int32.  One step per pivot, vectorised over the batch, with no
    host read, so it runs on the card without synchronising."""
    B, steps = ipiv.shape
    piv = ipiv.long()
    perm = torch.arange(m, dtype=torch.int32, device=ipiv.device).repeat(B, 1)
    for i in range(steps):
        j = piv[:, i : i + 1]
        pi = perm[:, i : i + 1].clone()
        perm[:, i : i + 1] = perm.gather(1, j)
        perm.scatter_(1, j, pi)
    return perm


def batched_invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of each row permutation of ``perm`` (B, n)."""
    inv = torch.empty_like(perm)
    src = torch.arange(perm.shape[1], dtype=perm.dtype, device=perm.device)
    inv.scatter_(1, perm.long(), src.expand_as(perm))
    return inv


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse permutation: ``inv[perm[i]] = i``."""
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv


def perm_to_matrix(perm: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dense permutation matrix P with ``P @ A == A[perm, :]``."""
    n = perm.shape[0]
    P = torch.zeros((n, n), dtype=dtype, device=perm.device)
    P[torch.arange(n, device=perm.device), perm.long()] = 1
    return P


def apply_ipiv_rows(A: torch.Tensor, ipiv: torch.Tensor) -> torch.Tensor:
    """Apply the swap sequence to the rows of ``A`` (forward laswp) as one
    gather."""
    return A[ipiv_to_perm(ipiv, A.shape[0]).long()]


def apply_ipiv_rows_inverse(A: torch.Tensor, ipiv: torch.Tensor) -> torch.Tensor:
    """Apply the inverse of the swap sequence to the rows of ``A``
    (backward laswp)."""
    out = torch.empty_like(A)
    out[ipiv_to_perm(ipiv, A.shape[0]).long()] = A
    return out
