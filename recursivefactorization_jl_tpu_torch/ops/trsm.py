"""Triangular inverses and solves built from matmuls.

The algorithm is the JAX package's (ops/trsm.py), kept so that the two
packages' numbers stay comparable: recursive block triangular inversion
(the trtri strategy)

    inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]

bottoming out in a short substitution loop (n <= 32), and blocked
substitution sweeps over inverted diagonal blocks for large triangles.
Every product runs with TF32 off.

An inverse-based solve errs by about ``|T^-1| |T| |X| eps``, a
substitution by ``|T| |X| eps``.  After partial pivoting ``|L| <= 1`` and
the two agree; without pivoting the multipliers, and with them the
inverse of a block of ``L``, grow without bound (the RBT solver's
transformed matrices: multipliers of 10^3 and more at n >= 512).  So the
pivot-free paths take :func:`substitute` instead, ``xTRSM`` through
``torch.linalg.solve_triangular``, and so does the blocked schedule's TRSM
step with pivoting too: its solve for the next panel's columns waits on
the critical path, where the inverse's base case costs some eighty small
launches a panel (``ops/blocked.py``).  ``lu_solve`` (models/solve.py)
substitutes on every route as well: with one right-hand side on the card
it took a third to two thirds of the inverted blocks' time replayed, and
a tenth or less eagerly.
"""

from __future__ import annotations

import torch

from ..utils.config import full_matmul_precision

_BASE = 32


def _unit_lower_inv_base(L: torch.Tensor) -> torch.Tensor:
    """Forward-substitution inverse of unit-lower L (n <= _BASE), batched
    over leading dims.  Row k of X: e_k - L[k, :k] @ X[:k]."""
    n = L.shape[-1]
    X = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape).clone()
    nL = -L  # negation is exact: one op here instead of one per row
    for k in range(1, n):
        X[..., k, :k] = (nL[..., k : k + 1, :k] @ X[..., :k, :k])[..., 0, :]
    return X


def _upper_inv_base(U: torch.Tensor) -> torch.Tensor:
    """Backward-substitution inverse of (non-unit) upper U (n <= _BASE),
    batched over leading dims.
    Row k of X: (e_k - U[k, k+1:] @ X[k+1:]) / U[k, k]."""
    n = U.shape[-1]
    rd = 1.0 / torch.diagonal(U, dim1=-2, dim2=-1)
    X = torch.diag_embed(rd)
    nrd = -rd
    for k in range(n - 2, -1, -1):
        row = (U[..., k : k + 1, k + 1 :] @ X[..., k + 1 :, k + 1 :])[..., 0, :]
        X[..., k, k + 1 :] = row * nrd[..., k : k + 1]
    return X


def _diag_blocks(X: torch.Tensor, s: int) -> torch.Tensor:
    """(..., n/s, s, s) view of the diagonal s x s blocks of contiguous
    (..., n, n) X."""
    nb = X.shape[-1] // s
    v = X.view(*X.shape[:-2], nb, s, nb, s).diagonal(dim1=-4, dim2=-2)
    return v.movedim(-1, -3)


def _pow2_blocks(n: int) -> bool:
    return n % _BASE == 0 and (n // _BASE) & (n // _BASE - 1) == 0


def _tri_inv_batched(T: torch.Tensor, upper: bool) -> torch.Tensor:
    """Blocked trtri with a batched base, batched over leading dims: all
    diagonal _BASE blocks invert in one substitution loop, then
    log2(n/_BASE) pairwise levels combine them.  Unit-lower when
    ``upper`` is False (``X21 = -iC @ B @ iA``), non-unit upper when True
    (``X12 = -iA @ B @ iC``): the recursive form's splits and products,
    reorganized.  n must be a power-of-2 multiple of _BASE."""
    n = T.shape[-1]
    T = T.contiguous()
    X = torch.zeros_like(T)
    base = _upper_inv_base if upper else _unit_lower_inv_base
    _diag_blocks(X, _BASE).copy_(base(_diag_blocks(T, _BASE)))
    bs = _BASE
    while bs < n:
        Xr = _diag_blocks(X, 2 * bs)
        Tr = _diag_blocks(T, 2 * bs)
        iA = Xr[..., :bs, :bs]
        iC = Xr[..., bs:, bs:]
        if upper:
            Xr[..., :bs, bs:] = -(iA @ (Tr[..., :bs, bs:] @ iC))
        else:
            # the (bs:, :bs) block of packed LU factors lies strictly
            # below the diagonal: all L values, no mask needed
            Xr[..., bs:, :bs] = -(iC @ (Tr[..., bs:, :bs] @ iA))
        bs *= 2
    return X


@full_matmul_precision()
def unit_lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-lower triangle stored in ``L``'s strictly-lower
    part (diagonal implied 1, as in packed LU factors)."""
    n = L.shape[0]
    if n <= _BASE:
        return _unit_lower_inv_base(L)
    if _pow2_blocks(n):
        return _tri_inv_batched(L, upper=False)
    h = (n + 1) // 2
    X = torch.zeros_like(L)
    iA = unit_lower_inverse(L[:h, :h])
    iC = unit_lower_inverse(L[h:, h:])
    X[:h, :h] = iA
    X[h:, h:] = iC
    X[h:, :h] = -(iC @ (L[h:, :h] @ iA))
    return X


@full_matmul_precision()
def upper_inverse(U: torch.Tensor) -> torch.Tensor:
    """Inverse of the upper triangle of ``U`` (non-unit diagonal).
    inv([[A, B], [0, C]]) = [[iA, -iA B iC], [0, iC]]."""
    n = U.shape[0]
    if n <= _BASE:
        return _upper_inv_base(U)
    if _pow2_blocks(n):
        return _tri_inv_batched(U, upper=True)
    h = (n + 1) // 2
    X = torch.zeros_like(U)
    iA = upper_inverse(U[:h, :h])
    iC = upper_inverse(U[h:, h:])
    X[:h, :h] = iA
    X[h:, h:] = iC
    X[:h, h:] = -(iA @ (U[:h, h:] @ iC))
    return X


def unit_upper_inverse(U: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-upper triangle in ``U``'s strictly upper part."""
    return unit_lower_inverse(U.T).T


def lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of the (non-unit) lower triangle of ``L``."""
    return upper_inverse(L.T).T


def _blocks(n: int, block: int):
    return [(s, min(block, n - s)) for s in range(0, n, block)]


def triangle_inverses(blocks, inverse, upper: bool, transposed: bool):
    """``[inverse(b) for b in blocks]`` for square triangles of one width.
    Several blocks whose width is a power-of-2 multiple of _BASE invert
    together in one batched call (the same arithmetic, fewer launches).
    ``upper``: the batched routine's triangle (non-unit upper, else unit
    lower); ``transposed``: each block is the transpose of that triangle
    (lower_inverse and unit_upper_inverse work on b.T)."""
    if len(blocks) < 2 or not _pow2_blocks(blocks[0].shape[0]):
        return [inverse(b) for b in blocks]
    X = _tri_inv_batched(torch.stack([b.T if transposed else b for b in blocks]), upper=upper)
    return list(X.transpose(-2, -1) if transposed else X)


def _block_inverses(T, block, inverse, upper, transposed):
    """Inverses of the diagonal blocks of the sweep over ``T``: the full
    blocks through :func:`triangle_inverses`, a ragged last block on its
    own."""
    spans = _blocks(T.shape[0], block)
    full = [s for s, w in spans if w == block]
    invs = dict(zip(full, triangle_inverses(
        [T[s : s + block, s : s + block] for s in full], inverse, upper, transposed)))
    for s, w in spans:
        if s not in invs:
            invs[s] = inverse(T[s : s + w, s : s + w])
    return spans, invs


def _forward(L, B, block, inverse, upper, transposed):
    n = L.shape[0]
    if n <= block:
        return inverse(L) @ B
    spans, invs = _block_inverses(L, block, inverse, upper, transposed)
    X = B.clone()
    for s, w in spans:
        Xi = invs[s] @ X[s : s + w]
        X[s : s + w] = Xi
        if s + w < n:
            X[s + w :].sub_(L[s + w :, s : s + w] @ Xi)
    return X


def _backward(U, B, block, inverse, upper, transposed):
    n = U.shape[0]
    if n <= block:
        return inverse(U) @ B
    spans, invs = _block_inverses(U, block, inverse, upper, transposed)
    X = B.clone()
    for s, w in reversed(spans):
        Xi = invs[s] @ X[s : s + w]
        X[s : s + w] = Xi
        if s > 0:
            X[:s].sub_(U[:s, s : s + w] @ Xi)
    return X


@full_matmul_precision()
def solve_unit_lower(L: torch.Tensor, B: torch.Tensor, block: int = 128):
    """Solve ``tril(L, unit diag) @ X = B`` by a blocked forward sweep."""
    return _forward(L, B, block, unit_lower_inverse, False, False)


@full_matmul_precision()
def solve_lower(L: torch.Tensor, B: torch.Tensor, block: int = 128):
    """Solve ``tril(L) @ X = B`` (non-unit diagonal)."""
    return _forward(L, B, block, lower_inverse, True, True)


@full_matmul_precision()
def solve_upper(U: torch.Tensor, B: torch.Tensor, block: int = 128):
    """Solve ``triu(U) @ X = B`` by a blocked backward sweep."""
    return _backward(U, B, block, upper_inverse, True, False)


@full_matmul_precision()
def solve_unit_upper(U: torch.Tensor, B: torch.Tensor, block: int = 128):
    """Solve ``triu(U, unit diag) @ X = B``."""
    return _backward(U, B, block, unit_upper_inverse, False, True)


@full_matmul_precision()
def substitute(T: torch.Tensor, B: torch.Tensor, *, upper: bool, unit: bool = False):
    """Solve ``T @ X = B`` for the lower (``upper=False``) or upper
    triangle of ``T``, with a unit diagonal where ``unit``, by substitution
    (``xTRSM``); ``B`` is a matrix.  The pivot-free paths' solve (module
    docstring)."""
    return torch.linalg.solve_triangular(T, B, upper=upper, unitriangular=unit)
