"""Tensor-parallel LU over a ``torch.distributed`` group: block-cyclic
columns and one panel broadcast per panel.

The PyTorch counterpart of the JAX package's parallel/blockcyclic.py
(``shard_map`` and XLA collectives there), with its call shapes:

* :func:`tp_lu_factor`, :func:`tp_lu_factor_p` and :func:`tp_lu` factor a
  square matrix over the ranks of ``mesh.get_group(axis)``;
* :func:`tp_lu_solve` solves with a square ``LU`` (from :func:`tp_lu` or
  the single-device ``lu``) over the same ranks.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``, and its
dimension ``axis`` plays the JAX mesh axis.  Every rank passes the whole
matrix (the JAX global array) and gets back the whole result; in between
a rank keeps only its own column blocks, block g on rank g % D.

Per panel j of width w, whose owner is rank j % D:

1. the owner copies its live (H, w) panel block to a contiguous buffer;
2. one ``broadcast`` sends it to every rank (the JAX package's masked
   ``psum`` is XLA's idiom for a broadcast from a dynamic root);
3. every rank factors the panel with the offset kernel
   (``ops.panel.offset_panel_factor``): replicating the panel step costs
   less than a second broadcast of its factors and pivots;
4. every rank applies the panel's row swaps to its own columns (no
   communication: rows are not distributed), sparse or dense by bytes;
5. the owner stores the factored panel;
6. every rank runs the TRSM (``unit_lower_inverse`` + matmul, TF32 off)
   and the Schur update on its live blocks: global block > j, rows >=
   s + w.

The panels run in ``STAGES`` stages of shrinking height, as in the JAX
package: a stage that starts at panel j0 broadcasts and factors panels of
height H = n - j0*w at the offset s - j0*w, so the payload and the
kernel's offsets are the JAX ones.  The JAX package masked its updates to
full height to keep XLA's shapes static; here they are sliced to the live
region, with the same arithmetic.  One ``all_reduce`` at the end gives
every rank the whole factors.  A factorization makes nb = n/w panel
broadcasts and that one ``all_reduce``; a solve makes 2*nb broadcasts of
an (n, k) update.

float32 and float64 panels run the offset kernel of csrc/panel_lu.cu on
the card, complex64 and complex128 ones the offset form of
csrc/panel_lu_c64.cu (CABS1 pivots, as the single-device complex ``lu``;
the JAX package's pure-JAX panel pivots by the modulus there).  Half
matrices (bfloat16, float16) take the ``promote`` route of the
single-device ``lu``: the float32 copy is factored and the factors are
rounded back; a half solve runs in float32 and rounds the solution back.
Integer and bool matrices are factored as their float64 copies, as
scipy's ``lu_factor`` does, and the factors stay float64 (the
single-device ``generic`` route).

Compiled programs (utils/graphs.py): the JAX package builds a fresh
``jax.jit(run)`` per call of :func:`tp_lu_factor_p` and
:func:`tp_lu_solve`; here each is a program per rank, keyed on what
``run`` depends on: the matrix's shape, dtype and device, the group (its
name, size and the rank), ``panel_width``, ``pivot`` and ``config`` (the
solve: the factors', right-hand side's and permutation's shapes and
dtypes, the group, ``panel_width`` and ``trans``).  A half or integer
matrix's promotion lies inside its program, one per outer key.
``graphs.capturing()`` captures them on an NCCL group only (a gloo
group raises), and every rank of the group must make the same calls
inside it, in the same order, and replay them together: the warm run and
the capture each issue the program's broadcasts and its ``all_reduce``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.lu import LU, normalize_pivot
from ..models.solve import normalize_trans
from ..ops.blocked import _laswp, _offset_info
from ..ops.panel import offset_panel_factor, offset_panel_route
from ..ops.schur import schur_update_
from ..ops.trsm import (
    lower_inverse,
    triangle_inverses,
    unit_lower_inverse,
    unit_upper_inverse,
    upper_inverse,
)
from ..utils.config import (
    HALF_DTYPES,
    LUConfig,
    default_config,
    full_matmul_precision,
    resolve_device,
)
from ..utils import graphs
from ..utils.perm import invert_perm
from .collectives import axis_group, broadcast, gather_by_sum

# shrinking-height stages of the panel loop (the JAX package's default)
STAGES = 4


def _working_dtype(dtype):
    """The type the panel loop runs in for a matrix of ``dtype``: float32
    for half types, float64 for integer and bool types, the type itself
    otherwise."""
    if dtype in HALF_DTYPES:
        return torch.float32
    if not (dtype.is_floating_point or dtype.is_complex):
        return torch.float64
    return dtype


def _padded(M: torch.Tensor, N: int) -> torch.Tensor:
    """``M`` (n, n) grown to (N, N) with the identity below and right: the
    padded rows cannot win a pivot in the leading n columns, so the
    leading factors and pivots do not change."""
    n = M.shape[0]
    if N == n:
        return M
    P = M.new_zeros(N, N)
    P[:n, :n] = M
    P.diagonal()[n:].fill_(1)
    return P


def _local_blocks(M: torch.Tensor, w: int, D: int, me: int) -> torch.Tensor:
    """A new contiguous (N, N/D) tensor of rank ``me``'s column blocks of
    ``M`` (N, N): global blocks me, me + D, me + 2D, ... in that order."""
    N = M.shape[0]
    out = M.new_empty(N, N // D)
    out.view(N, -1, w).copy_(M.reshape(N, N // w, w)[:, me::D])
    return out


def _tp_factor(A_loc, group, D: int, me: int, w: int, pivot: bool, config: LUConfig):
    """The panel loop on rank ``me``'s blocks ``A_loc`` (N, N/D), in place.
    Returns ``(ipiv, perm, info)``, the same on every rank: each computes
    them from the same broadcast panels."""
    N, nloc = A_loc.shape
    dev = A_loc.device
    nb = N // w
    ipiv = torch.zeros(N, dtype=torch.int32, device=dev)
    perm = torch.arange(N, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    S = max(1, min(STAGES, nb))
    bounds = [nb * t // S for t in range(S)] + [nb]
    for t in range(S):
        h0 = bounds[t] * w  # rows above are final for the whole stage
        buf = A_loc.new_empty(N - h0, w)
        for j in range(bounds[t], bounds[t + 1]):
            owner, s = j % D, j * w
            c = (j // D) * w  # the panel's local columns on its owner
            sl = s - h0  # the panel's first row within the buffer
            if me == owner:
                buf.copy_(A_loc[h0:, c : c + w])
            broadcast(buf, owner, group)
            _, piv_l, perm_l, linfo = offset_panel_factor(buf, sl, pivot, config)
            ipiv[s : s + w] = piv_l + h0
            info = _offset_info(info, linfo, s)
            if pivot:
                cols = [(0, c), (c + w, nloc)] if me == owner else [(0, nloc)]
                _laswp(A_loc, perm, perm_l[sl:] - sl, piv_l - sl, s, cols)
            if me == owner:
                A_loc[s:, c : c + w] = buf[sl:]
            c0 = ((j - me) // D + 1) * w  # first local block with global index > j
            if c0 < nloc:
                A12 = A_loc[s : s + w, c0:]
                A12.copy_(unit_lower_inverse(buf[sl : sl + w]) @ A12)
                if s + w < N:
                    schur_update_(A_loc[s + w :, c0:], buf[sl + w :], A12)
    return ipiv, perm, info


def tp_lu_factor_p(
    A,
    mesh,
    axis: str = "tp",
    panel_width: int = 128,
    pivot=True,
    config: Optional[LUConfig] = None,
    device=None,
):
    """Like :func:`tp_lu_factor` but also returns the composed row
    permutation of the padded matrix: ``(factors, ipiv, perm (N,),
    info)``.  By the replay of the rank's program where one was captured
    (module docstring)."""
    config = config or default_config()
    pivot = normalize_pivot(pivot)
    A = torch.as_tensor(A, device=resolve_device(device))
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"tp_lu_factor expects a square matrix, got {tuple(A.shape)}")
    offset_panel_route(A.device, config)  # raise before any collective
    group = axis_group(mesh, axis)[0]
    return graphs.call("tp_lu_factor", _tp_lu_factor_impl, (A,),
                       (group, panel_width, pivot, config))


def _tp_lu_factor_impl(A, group, w: int, pivot: bool, config: LUConfig):
    """The program of :func:`tp_lu_factor_p` on this rank."""
    work = _working_dtype(A.dtype)
    if work != A.dtype:
        # half: the exact float32 promotion, its factors rounded back;
        # integer and bool: float64, as the single-device generic route
        F, ipiv, perm, info = _tp_lu_factor_impl(A.to(work), group, w, pivot, config)
        return (F.to(A.dtype) if A.dtype in HALF_DTYPES else F), ipiv, perm, info
    D, me = group.size(), group.rank()
    n = A.shape[0]
    N = n + (-n % (D * w))
    A_loc = _local_blocks(_padded(A, N), w, D, me)
    with full_matmul_precision():
        ipiv, perm, info = _tp_factor(A_loc, group, D, me, w, pivot, config)
    F = A_loc.new_zeros(N, N)
    F.view(N, N // w, w)[:, me::D] = A_loc.view(N, -1, w)
    gather_by_sum(F, group)
    return F[:n, :n].contiguous(), ipiv[:n], perm, info


def tp_lu_factor(
    A,
    mesh,
    axis: str = "tp",
    panel_width: int = 128,
    pivot=True,
    config: Optional[LUConfig] = None,
    device=None,
):
    """Tensor-parallel LU of a square matrix over the ranks of
    ``mesh.get_group(axis)``.

    Every rank passes the whole ``A`` and gets back ``(factors, ipiv,
    info)`` with the conventions of :func:`~..models.lu.lu_factor`.  ``A``
    is identity-padded to a multiple of ``D * panel_width`` inside; the
    padding does not show in the result.  ``device=None`` means the
    rank's current CUDA device and raises without one; the CPU runs with
    ``device='cpu'`` (a gloo group).  ``config.tp_panel_backend`` picks
    the panel step (``ops.panel.offset_panel_factor``)."""
    F, ipiv, _, info = tp_lu_factor_p(A, mesh, axis, panel_width, pivot, config, device)
    return F, ipiv, info


def tp_lu(
    A,
    mesh,
    axis: str = "tp",
    panel_width: int = 128,
    pivot=True,
    config: Optional[LUConfig] = None,
    device=None,
) -> LU:
    """Tensor-parallel :func:`~..models.lu.lu`: an :class:`LU` on every
    rank.  No ``check``: the caller reads ``info``."""
    pivot = normalize_pivot(pivot)
    F, ipiv, perm, info = tp_lu_factor_p(A, mesh, axis, panel_width, pivot, config, device)
    n = F.shape[0]
    perm = torch.where(perm[:n] < n, perm[:n], 0)  # padded rows cannot appear
    return LU(F, ipiv, info, pivoted=pivot, perm=perm)


# the diagonal blocks' inverse of each sweep: (function, upper, transposed)
# for triangle_inverses, untransposed and transposed factors
_SWEEP_INVERSES = {
    (True, False): (unit_lower_inverse, False, False),
    (False, False): (upper_inverse, True, False),
    (True, True): (lower_inverse, True, True),  # U^T: non-unit lower
    (False, True): (unit_upper_inverse, False, True),  # L^T: unit upper
}


def _tp_solve(F_loc, r, group, D: int, me: int, w: int, trans: bool) -> None:
    """Both substitution sweeps on the replicated right-hand sides ``r``
    (N, k), in place.  ``F_loc`` holds rank ``me``'s blocks of the factors
    (of their transpose when ``trans``: then tril is the non-unit U^T and
    triu the unit L^T).  Per panel the owner solves its w x w diagonal
    block (the inverses of a sweep's own blocks are formed up front, in
    one batched call) and forms the update of the rows its panel touches;
    one ``broadcast`` of that (N, k) buffer carries both to every rank."""
    N = r.shape[0]
    nb = N // w
    u = torch.empty_like(r)
    for forward in (True, False):
        mine = range(me, nb, D)  # the global blocks of this rank
        invs = dict(zip(mine, triangle_inverses(
            [F_loc[g * w : (g + 1) * w, (g // D) * w : (g // D + 1) * w] for g in mine],
            *_SWEEP_INVERSES[(forward, trans)])))
        for j in range(nb) if forward else range(nb - 1, -1, -1):
            owner, s = j % D, j * w
            rest = slice(s + w, N) if forward else slice(0, s)
            if me == owner:
                blk = F_loc[:, (j // D) * w : (j // D + 1) * w]
                u[s : s + w] = invs[j] @ r[s : s + w]
                u[rest] = blk[rest] @ u[s : s + w]
            broadcast(u, owner, group)
            r[s : s + w] = u[s : s + w]
            r[rest] -= u[rest]


def tp_lu_solve(
    lu_res,
    b,
    mesh,
    axis: str = "tp",
    panel_width: int = 128,
    trans=0,
    device=None,
) -> torch.Tensor:
    """Solve ``A x = b`` over the ranks of ``mesh.get_group(axis)`` with
    the square factorization ``lu_res`` (an :class:`LU` from :func:`tp_lu`
    or from the single-device ``lu``), which every rank holds whole.

    Each rank keeps its block-cyclic columns of the factors; the
    right-hand sides stay replicated and each panel step broadcasts one
    update from its owner (2 * nb broadcasts in all).  ``b`` is (n,) or
    (n, k).  ``trans`` takes 0/'N', 1/'T' and 2/'H' (the same for real
    factors): the transposed factors (conjugated for 2/'H') are
    distributed and the two sweeps swap their triangles, then the result is
    un-permuted.  The semantics are those of
    :func:`~..models.solve.lu_solve`: half factors solve in float32, with
    the right-hand side rounded to the half type first and the solution
    rounded back.  The permutation ``lu_res.p`` is found before the
    rank's program, which replays where one was captured (module
    docstring)."""
    t = normalize_trans(trans)
    dev = resolve_device(device)
    F = torch.as_tensor(lu_res.factors, device=dev)
    n = F.shape[0]
    if F.ndim != 2 or F.shape[1] != n:
        raise ValueError("tp_lu_solve requires a square factorization")
    b = torch.as_tensor(b, device=dev)
    if b.ndim not in (1, 2) or b.shape[0] != n:
        raise ValueError(f"rhs of shape {tuple(b.shape)} does not match factorization size {n}")
    p = torch.as_tensor(lu_res.p, device=dev) if lu_res.pivoted else None
    group = axis_group(mesh, axis)[0]
    return graphs.call("tp_lu_solve", _tp_lu_solve_impl, (F, b, p), (group, panel_width, t))


def _tp_lu_solve_impl(F, b, p, group, w: int, t: int):
    """The program of :func:`tp_lu_solve` on this rank: ``p`` is the
    factorization's permutation, None when it did not pivot."""
    n = F.shape[0]
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    out = F.dtype if F.dtype in HALF_DTYPES else None
    if out is not None:
        B = B.to(out)  # the rhs takes the half type, as in the single-device solve
    F = F.to(_working_dtype(F.dtype))
    B = B.to(F.dtype)
    if p is not None:
        p = p.long()
    if t == 0:
        if p is not None:
            B = B[p]
    else:
        # A = P^T L U  =>  A^T x = b: U^T y = b, L^T z = y, x = P^T z; A^H
        # conjugates the factors
        F = F.mH.resolve_conj() if t == 2 else F.T
    D, me = group.size(), group.rank()
    N = n + (-n % (D * w))
    F_loc = _local_blocks(_padded(F, N), w, D, me)
    r = B.new_zeros(N, B.shape[1])  # zero padding: the padded solve is a no-op
    r[:n] = B
    with full_matmul_precision():
        _tp_solve(F_loc, r, group, D, me, w, t != 0)
    x = r[:n]
    if t != 0 and p is not None:
        x = x[invert_perm(p)]
    if out is not None:
        x = x.to(out)
    return x[:, 0] if vec else x
