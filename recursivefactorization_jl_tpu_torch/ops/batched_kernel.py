"""LU and substitution for batches of small matrices: the Hopper kernels,
their plain versions and the wrappers that choose between them.

The PyTorch counterpart of the JAX package's ops/batched_kernel.py.  Three
functions, each with a plain PyTorch version (the CPU route and the
oracle on the card) and a hand-written kernel (csrc/batched_lu.cu,
csrc/batched_solve.cu):

* :func:`batched_lu` -- LU of a batch (B, m, n) with LAPACK row
  interchanges: factors, the ipiv swap sequence, optionally the composed
  permutation, info (the swap mode of the TPU kernel ``_lane_kernel``);
  on the card one of three kernels by shape (:func:`lu_route`): a warp
  per matrix with its rows in registers at m, n <= 32, a block of 8 x 8
  or 16 x 16 threads with register tiles up to 128, a shared-memory tile
  beyond;
* :func:`batched_lu_noswap` -- LU of a square batch with the rows
  eliminated in physical order under a ``used`` mask and put into pivot
  order once at the end (the noswap mode of ``_lane_kernel``); pivot ties
  break by physical row, so on exact ties its permutation may differ
  from LAPACK's, and a NaN candidate selects row n - 1 even when that row
  is used; on the card the same kernels as the swap mode in their noswap
  mode (:func:`noswap_route`): the warp route at n <= 32 (lane i keeps
  physical row i), the register-tiled block route up to 128 (a used bit
  per row slot);
* :func:`batched_solve` -- unit-lower forward then upper backward
  substitution (``_lane_solve_kernel``) on right-hand sides in pivot
  order: already there, or brought there from the factorization's
  ``perm`` or ``ipiv``, which the Hopper kernel does itself; on the card
  one of two kernels by shape (:func:`solve_route`): a warp per matrix
  with its factor rows in registers at n <= 32, a warp per matrix with
  rows l + 32 r of x in lane l and the factors streamed through shared
  memory 32 columns at a time up to 128.

A CPU tensor goes to the plain version, a CUDA tensor launches the
kernel or raises; there is no fallback between the two.

Semantics shared by the plain versions and the kernels, per matrix:

* the pivot is the largest ``|a|`` among the candidate rows, the
  smallest row among equals; a NaN among the candidates selects row
  m - 1, as the TPU kernel's max/equality formulation does;
* a zero pivot means no swap and no scale, the rank-1 update still runs
  with the unscaled column, and info records the first such step,
  1-based, negated without pivoting;
* the composed permutation swaps its entries on the stored pivot row at
  every step, so it equals ``ipiv_to_perm(ipiv)``;
* rows that are already final are left untouched (the TPU kernel
  subtracts a masked zero product from them, which differs only where a
  pivot row holds inf or NaN);
* rounding: the column is scaled by ``col * (1/p)``, every product and
  difference is rounded on its own, and the solve divides ``r / u``.
  The plain versions and the kernels therefore agree bitwise on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.perm import batched_ipiv_to_perm
from . import _kernels

# min(m, n) up to which the kernels take a batch.  At 128 the kernels are
# still ahead of batched torch.linalg.lu_factor_ex on an H100
# (chip_smoke.py's timing, PERF.md); beyond it nothing was measured.
KERNEL_MAX_N = 128
# dynamic shared memory a block may ask for: the 227 KB a Hopper block
# can use, less room for the kernels' static reduction buffers
SMEM_LIMIT = 232448 - 1024
_FLOATS = (torch.float32, torch.float64)

# The swap kernel's routes (csrc/batched_lu.cu), by shape:
#   "warp"   m, n <= 32: a warp (half a warp when m <= 16) per matrix, rows
#            in registers, four warps per block;
#   "block"  otherwise max(m, n) <= 128: 8 x 8 threads per matrix up to
#            max(m, n) = 64, 16 x 16 beyond, each with an S x S register
#            tile (S = 6 or 8);
#   "tile"   the rest (tall or wide batches): one block per matrix, the
#            matrix in a shared-memory tile.
LU_ROUTES = ("warp", "block", "tile")
WARP_MAX_N = 32
BLOCK_MAX_N = 128
_WARP_THREADS = 128


def _block_grid(m: int, n: int) -> Tuple[int, int]:
    """The block route's thread grid side and register slots per thread
    and dimension (csrc/batched_lu.cu block_grid): 8 x 8 threads up to
    max(m, n) = 64, 16 x 16 beyond; 6 or 8 slots."""
    big = max(m, n)
    if big <= 64:
        return 8, (6 if big <= 48 else 8)
    return 16, (6 if big <= 96 else 8)


def _warp_grid(m: int, n: int) -> Tuple[int, int]:
    """The warp route's lanes per matrix and columns held per lane
    (csrc/batched_lu.cu warp_lanes, warp_cols)."""
    return (16 if m <= 16 else 32), (8 if n <= 8 else 16 if n <= 16 else 32)


def lu_route(m: int, n: int) -> str:
    """The route the swap kernel takes for (m, n) matrices."""
    if m <= WARP_MAX_N and n <= WARP_MAX_N:
        return "warp"
    if m <= BLOCK_MAX_N and n <= BLOCK_MAX_N:
        return "block"
    return "tile"


def _route_takes(route: str, m: int, n: int) -> bool:
    """Each route also takes the shapes of the routes before it."""
    return route in LU_ROUTES and LU_ROUTES.index(route) >= LU_ROUTES.index(lu_route(m, n))


# The noswap kernel takes the swap kernel's first two routes on its square
# (n, n) matrices (csrc/batched_lu.cu, the same kernel functions in their
# noswap mode): "warp" at n <= 32, "block" up to 128.
NOSWAP_ROUTES = LU_ROUTES[:2]


def noswap_route(n: int) -> str:
    """The route the noswap kernel takes for (n, n) matrices."""
    return lu_route(n, n)


# The solve kernel's routes (csrc/batched_solve.cu), by shape:
#   "warp"   n <= 32: 8, 16 or 32 lanes per matrix (the fewest that hold n),
#            row i of the factors and of x in lane i's registers, four
#            warps per block;
#   "wide"   32 < n <= 128: a warp per matrix, rows l + 32 r of x in lane
#            l's registers, the factors through a shared-memory tile of 32
#            columns at a time; 1, 2 or 4 warps per block.
SOLVE_ROUTES = ("warp", "wide")
SOLVE_WARP_MAX_N = 32
SOLVE_WIDE_LD = 33


def solve_route(n: int, nrhs: int) -> str:
    """The route the solve kernel takes for (n, n) factors and ``nrhs``
    right-hand sides: the warp route at n <= 32 whatever nrhs (it takes
    them four at a time; with 8 of them it still took a quarter to a
    third of the block route's time at n = 16 and 32 on the H100,
    PERF.md), the wide route beyond, up to 128 (four at a time as
    well)."""
    return "warp" if n <= SOLVE_WARP_MAX_N else "wide"


def _solve_route_takes(route: str, n: int) -> bool:
    if route == "warp":
        return n <= SOLVE_WARP_MAX_N
    return route == "wide" and SOLVE_WARP_MAX_N < n <= KERNEL_MAX_N


def wide_group(n: int, itemsize: int) -> int:
    """Matrices (warps) per block of the solve's wide route
    (csrc/batched_solve.cu wide_group): 1, 2 or 4, whichever leaves the
    most warps resident per SM by the n x 33 tile each one holds (32
    blocks, 64 warps and 228 KB of shared memory per SM, 1 KB of it per
    block kept by the runtime); the fewest on a tie."""
    tile = n * SOLVE_WIDE_LD * itemsize
    best, best_warps = 1, 0
    for g in (1, 2, 4):
        warps = min(64, min(32, 233472 // (g * tile + 1024)) * g)
        if warps > best_warps:
            best, best_warps = g, warps
    return best


def _solve_lanes(n: int) -> int:
    return 8 if n <= 8 else 16 if n <= 16 else 32


def tile_smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the swap kernel's tile route:
    the (m, n + 1) padded tile, a column of m multipliers, and 2 * m int32
    of bookkeeping."""
    return (m * (n + 1) + m) * itemsize + 8 * m


def lu_smem_bytes(m: int, n: int, itemsize: int, route: Optional[str] = None) -> int:
    """Dynamic shared memory of one swap-kernel block for (m, n) matrices
    under ``route`` (default: the shape's own, :func:`lu_route`).  The
    kernel refuses a launch whose count differs from its own."""
    route = route or lu_route(m, n)
    if route == "warp":
        lanes, cols = _warp_grid(m, n)
        # per matrix (128 / lanes per block): two (row k, row kp) exchange
        # buffers of the column capacity, and the m x (n | 1) staging tile
        return (_WARP_THREADS // lanes) * (4 * cols + m * (n | 1)) * itemsize
    if route == "block":
        side, slots = _block_grid(m, n)
        cap = side * slots
        # rows k and kp, the multipliers, the candidates' values, a[m - 1, k]
        # and a[k, k]; the candidates' rows and the permutation
        return (3 * cap + side + 2) * itemsize + 4 * (side + cap)
    return tile_smem_bytes(m, n, itemsize)


def noswap_smem_bytes(n: int, itemsize: int, route: Optional[str] = None) -> int:
    """Dynamic shared memory of one noswap-kernel block for (n, n)
    matrices under ``route`` (default: :func:`noswap_route`).  The warp
    route: per matrix two row-kp exchange buffers of the column capacity
    and the n x (n | 1) staging tile.  The block route: row kp, the
    multipliers, the candidates' values and a[n - 1, k]; the candidates'
    rows, the pivot row of each step and the step of each row."""
    route = route or noswap_route(n)
    if route == "warp":
        lanes, cols = _warp_grid(n, n)
        return (_WARP_THREADS // lanes) * (2 * cols + n * (n | 1)) * itemsize
    if route != "block":
        raise ValueError(f"the noswap kernel has no route {route!r}: {NOSWAP_ROUTES}")
    side, slots = _block_grid(n, n)
    cap = side * slots
    return (2 * cap + side + 1) * itemsize + 4 * (side + 2 * cap)


def solve_smem_bytes(n: int, nrhs: int, itemsize: int, route: Optional[str] = None) -> int:
    """Dynamic shared memory of one solve block under ``route`` (default:
    the shape's own, :func:`solve_route`).  The warp route: per matrix of
    the block (128 / lanes of them) the factors' staging tile, n x (n |
    1), whatever nrhs.  The wide route: per matrix of the block
    (:func:`wide_group`) an n x 33 tile, whatever nrhs.  The kernel
    refuses a launch whose count differs from its own."""
    route = route or solve_route(n, nrhs)
    if route == "warp":
        return (128 // _solve_lanes(n)) * n * (n | 1) * itemsize
    if route != "wide":
        raise ValueError(f"the solve kernel has no route {route!r}: {SOLVE_ROUTES}")
    return wide_group(n, itemsize) * n * SOLVE_WIDE_LD * itemsize


def lu_kernel_takes(dtype, m: int, n: int) -> bool:
    """Can the LU kernels run a batch of (m, n) matrices of ``dtype``?
    The shared-memory tile must fit a block: every route's shapes lie
    inside that set."""
    return (
        dtype in _FLOATS
        and 0 < min(m, n) <= KERNEL_MAX_N
        and tile_smem_bytes(m, n, dtype.itemsize) <= SMEM_LIMIT
    )


def solve_kernel_takes(dtype, n: int, nrhs: int) -> bool:
    """Can the solve kernel run (n, n) factors with ``nrhs`` columns on
    their own route (:func:`solve_route`)?  The warp and wide routes hold
    a tile of the factors only, so every nrhs fits."""
    return (
        dtype in _FLOATS
        and 0 < n <= KERNEL_MAX_N
        and nrhs > 0
        and solve_smem_bytes(n, nrhs, dtype.itemsize) <= SMEM_LIMIT
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _pick_pivot(col, avail, rows, m):
    """Pivot row per matrix among the ``avail`` rows of ``col`` (B, m):
    largest magnitude, smallest row among equals, m - 1 on a NaN."""
    neg = torch.full((), float("-inf"), dtype=col.dtype, device=col.device)
    abscol = torch.where(avail, col.abs(), neg)
    maxv = abscol.amax(dim=1, keepdim=True)
    kp = torch.where(abscol == maxv, rows, m).amin(dim=1)
    return kp.clamp(max=m - 1)


def _pivot_value(col, kp):
    """(pivot value, is it nonzero, its reciprocal or 1) per matrix."""
    pv = col.gather(1, kp[:, None])[:, 0]
    nonzero = pv != 0
    inv = torch.reciprocal(torch.where(nonzero, pv, torch.ones_like(pv)))
    return pv, nonzero, inv


def _note_info(info, nonzero, k, pivot):
    code = k + 1 if pivot else -(k + 1)
    return torch.where(~nonzero & (info == 0), code, info)


def _check_batch(A, square=False):
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("expected a (B, m, n) tensor")
    if square and A.shape[1] != A.shape[2]:
        raise ValueError(f"expected square matrices, got {tuple(A.shape)}")
    if not A.dtype.is_floating_point:
        raise ValueError(f"expected a floating dtype, got {A.dtype}")


def batched_lu_plain(
    A: torch.Tensor, pivot: bool = True, with_perm: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the swap kernel: ``A`` (B, m, n) ->
    ``(factors (B, m, n), ipiv (B, min(m, n)), perm (B, m) or None,
    info (B,))``, int32 indices.  One step per column, vectorised over
    the batch, no host read."""
    _check_batch(A)
    A = A.clone()
    B, m, n = A.shape
    minmn = min(m, n)
    dev = A.device
    rows = torch.arange(m, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    ipiv = torch.empty((B, minmn), dtype=torch.int32, device=dev)
    perm = torch.arange(m, dtype=torch.int32, device=dev).repeat(B, 1)
    info = torch.zeros(B, dtype=torch.int32, device=dev)
    for k in range(minmn):
        col = A[:, :, k]
        if pivot:
            kp = _pick_pivot(col, rows >= k, rows, m)
        else:
            kp = torch.full((B,), k, dtype=torch.long, device=dev)
        ipiv[:, k] = kp
        _, nonzero, inv = _pivot_value(col, kp)
        info = _note_info(info, nonzero, k, pivot)
        # interchange rows k <-> kp (skipped on a zero pivot)
        do_swap = (nonzero & (kp != k))[:, None]
        rowk = A[:, k, :].clone()
        rowkp = A[bidx, kp, :]
        A[bidx, kp, :] = torch.where(do_swap, rowk, rowkp)
        A[:, k, :] = torch.where(do_swap, rowkp, rowk)
        # the permutation swaps on the stored pivot row, zero pivot or not
        pk = perm[:, k].clone()
        pkp = perm[bidx, kp]
        perm[bidx, kp] = pk
        perm[:, k] = pkp
        if k + 1 < m:
            sub = A[:, k + 1 :, k]
            l = torch.where(nonzero[:, None], sub * inv[:, None], sub)
            A[:, k + 1 :, k] = l
            if k + 1 < n:
                A[:, k + 1 :, k + 1 :] -= l[:, :, None] * A[:, k, None, k + 1 :]
    return A, ipiv, (perm if with_perm else None), info


def batched_lu_noswap_plain(
    A: torch.Tensor, pivot: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the noswap kernel: ``A`` (B, n, n) ->
    ``(factors, perm (B, n), info (B,))`` with ``L @ U == A[perm, :]``.
    Rows stay where they are during the elimination; one gather puts them
    into pivot order at the end."""
    _check_batch(A, square=True)
    A = A.clone()
    B, n, _ = A.shape
    dev = A.device
    rows = torch.arange(n, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    used = torch.zeros((B, n), dtype=torch.bool, device=dev)
    perm = torch.empty((B, n), dtype=torch.int32, device=dev)
    info = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=A.dtype, device=dev)
    for k in range(n):
        col = A[:, :, k]
        avail = ~used
        if pivot:
            kp = _pick_pivot(col, avail, rows, n)
        else:
            kp = torch.full((B,), k, dtype=torch.long, device=dev)
        perm[:, k] = kp
        _, nonzero, inv = _pivot_value(col, kp)
        info = _note_info(info, nonzero, k, pivot)
        is_kp = rows == kp[:, None]
        used = used | is_kp
        elim = avail & ~is_kp
        newcol = torch.where(elim & nonzero[:, None], col * inv[:, None], col)
        if k + 1 < n:
            lcol = torch.where(elim, newcol, zero)
            urow = A[bidx, kp, k + 1 :]
            trail = A[:, :, k + 1 :]
            upd = trail - lcol[:, :, None] * urow[:, None, :]
            A[:, :, k + 1 :] = torch.where(elim[:, :, None], upd, trail)
        A[:, :, k] = newcol
    factors = A.gather(1, perm.long()[:, :, None].expand(B, n, n))
    return factors, perm, info


def _as_rhs(factors, b):
    """``b`` (B, n) or (B, n, k) as a (B, n, k) tensor of the factors'
    dtype, and whether it was a batch of vectors."""
    if factors.dim() != 3 or factors.shape[1] != factors.shape[2]:
        raise ValueError(
            f"expected square factors (B, n, n), got {tuple(factors.shape)}"
        )
    vec = b.dim() == 2
    rhs = (b[:, :, None] if vec else b).to(factors.dtype)
    if rhs.dim() != 3 or rhs.shape[:2] != factors.shape[:2]:
        raise ValueError(
            f"right-hand sides {tuple(b.shape)} do not match factors "
            f"{tuple(factors.shape)}"
        )
    return rhs, vec


def _row_order(factors, perm, ipiv):
    """Checks of the optional ``perm`` / ``ipiv`` (B, n) of a solve."""
    if perm is not None and ipiv is not None:
        raise ValueError("give perm or ipiv, not both")
    idx = perm if perm is not None else ipiv
    if idx is not None and (idx.dim() != 2 or idx.shape != factors.shape[:2]):
        raise ValueError(
            f"perm/ipiv {tuple(idx.shape)} does not match factors "
            f"{tuple(factors.shape)}"
        )
    return idx


def batched_solve_plain(factors: torch.Tensor, b: torch.Tensor,
                        perm: Optional[torch.Tensor] = None,
                        ipiv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the solve kernel: ``L y = b`` (unit lower) then
    ``U x = y`` per matrix.  ``b`` is gathered by ``perm`` (B, n), or
    exchanged by the swap sequence ``ipiv`` (B, n), or taken as already in
    pivot order when neither is given.  A zero on U's diagonal gives
    inf/nan in that matrix only."""
    _check_batch(factors, square=True)
    rhs, vec = _as_rhs(factors, b)
    _row_order(factors, perm, ipiv)
    f = factors
    n = f.shape[1]
    if ipiv is not None:
        perm = batched_ipiv_to_perm(ipiv, n)
    if perm is not None:
        x = rhs.gather(1, perm.long()[:, :, None].expand_as(rhs))
    else:
        x = rhs.clone()
    for k in range(n - 1):
        x[:, k + 1 :, :] -= f[:, k + 1 :, k, None] * x[:, k : k + 1, :]
    for k in range(n - 1, -1, -1):
        xk = x[:, k, :] / f[:, k, k, None]
        x[:, k, :] = xk
        if k > 0:
            x[:, :k, :] -= f[:, :k, k, None] * xk[:, None, :]
    return x[:, :, 0] if vec else x


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _cuda_batch(A, what, square=False):
    """Checks shared by the kernel wrappers; returns ``A`` contiguous (a
    strided batch is copied, not refused)."""
    if not isinstance(A, torch.Tensor) or A.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor")
    if A.dtype not in _FLOATS:
        raise ValueError(f"{what}: dtype must be float32/float64, got {A.dtype}")
    if A.dim() != 3:
        raise ValueError(f"{what}: expected (B, m, n), got {tuple(A.shape)}")
    if square and A.shape[1] != A.shape[2]:
        raise ValueError(f"{what}: expected square matrices, got {tuple(A.shape)}")
    if A.shape[0] >= 2**31:
        raise ValueError(f"{what}: batch of {A.shape[0]} exceeds the grid limit")
    return A.contiguous()


def _refuse_lu_shape(A, what):
    _, m, n = A.shape
    if not lu_kernel_takes(A.dtype, m, n):
        raise ValueError(
            f"{what}: ({m}, {n}) {A.dtype} matrices do not fit the kernel "
            f"(0 < min(m, n) <= {KERNEL_MAX_N} and "
            f"{tile_smem_bytes(m, n, A.dtype.itemsize)} <= {SMEM_LIMIT} bytes "
            "of shared memory)"
        )


def _launch_args(t):
    dev = t.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def batched_lu_cuda(A: torch.Tensor, pivot: bool = True, with_perm: bool = True,
                    route: Optional[str] = None):
    """Launch the swap kernel: ``A`` (B, m, n) CUDA f32/f64 -> ``(factors,
    ipiv, perm or None, info)``, all allocated here.  ``A`` is read, not
    written.  ``route`` (default: the shape's own, :func:`lu_route`)
    forces "warp", "block" or "tile" where that route takes the shape, and
    raises where it does not.  Launches once on the current stream and
    does not synchronise; ``batched_lu_cuda.launches`` counts the launches,
    ``batched_lu_cuda.route_launches`` the launches by route."""
    A = _cuda_batch(A, "batched_lu_cuda")
    _refuse_lu_shape(A, "batched_lu_cuda")
    B, m, n = A.shape
    route = route or lu_route(m, n)
    if not _route_takes(route, m, n):
        raise ValueError(f"batched_lu_cuda: route {route!r} does not take ({m}, {n})")
    dev = A.device
    out = torch.empty_like(A)
    ipiv = torch.empty((B, min(m, n)), dtype=torch.int32, device=dev)
    perm = torch.empty((B, m), dtype=torch.int32, device=dev) if with_perm else None
    info = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, ipiv, perm, info
    lib = _kernels.load("batched_lu")
    fn = lib.rf_batched_lu_swap_f64 if A.element_size() == 8 else lib.rf_batched_lu_swap_f32
    index, stream = _launch_args(A)
    batched_lu_cuda.launches += 1
    batched_lu_cuda.route_launches[route] += 1
    code = fn(
        A.data_ptr(), out.data_ptr(), ipiv.data_ptr(),
        perm.data_ptr() if with_perm else None, info.data_ptr(),
        B, m, n, int(bool(pivot)), LU_ROUTES.index(route) + 1,
        lu_smem_bytes(m, n, A.element_size(), route), index, stream,
    )
    _kernels.check(lib, code, "batched_lu swap launch")
    return out, ipiv, perm, info


batched_lu_cuda.launches = 0
batched_lu_cuda.route_launches = dict.fromkeys(LU_ROUTES, 0)


def reset_lu_launches() -> None:
    """Set the swap kernel's launch counts (all and by route) to 0."""
    batched_lu_cuda.launches = 0
    batched_lu_cuda.route_launches = dict.fromkeys(LU_ROUTES, 0)


def lu_plan(m: int, n: int, dtype=torch.float32, route: Optional[str] = None,
            device=None, swap: bool = True) -> dict:
    """The launch plan of the swap kernel (``swap=False``: the noswap
    kernel, m == n) for (m, n) matrices of ``dtype`` on a CUDA device:
    route, threads and matrices per block, dynamic shared memory, and the
    compiled kernel's registers, local memory (spills) and resident
    blocks per SM as the CUDA runtime reports them."""
    route = route or lu_route(m, n)
    if not _route_takes(route, m, n) or not (swap or (m == n and route in NOSWAP_ROUTES)):
        raise ValueError(f"lu_plan: route {route!r} does not take ({m}, {n})")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _kernels.load("batched_lu")
    out = (ctypes.c_int * 10)()
    itemsize = torch.empty((), dtype=dtype).element_size()
    r = LU_ROUTES.index(route) + 1
    if swap:
        code = lib.rf_batched_lu_swap_plan(m, n, itemsize, r, index, ctypes.addressof(out))
        want = lu_smem_bytes(m, n, itemsize, route)
    else:
        code = lib.rf_batched_lu_noswap_plan(n, itemsize, r, index, ctypes.addressof(out))
        want = noswap_smem_bytes(n, itemsize, route)
    _kernels.check(lib, code, "batched_lu plan")
    keys = ("route", "threads", "per_block", "smem", "blocks_per_sm", "registers",
            "local_bytes", "static_smem", "capacity", "max_threads")
    plan = dict(zip(keys, list(out)))
    plan["route"] = LU_ROUTES[plan["route"] - 1]
    if plan["smem"] != want:
        raise RuntimeError("lu_plan: the kernel's shared memory differs from the wrapper's count")
    return plan


def batched_lu_noswap_cuda(A: torch.Tensor, pivot: bool = True, route: Optional[str] = None):
    """Launch the noswap kernel: ``A`` (B, n, n) CUDA f32/f64 ->
    ``(factors, perm, info)``.  The kernel writes the rows back in pivot
    order, so no gather follows it.  ``route`` (default:
    :func:`noswap_route`) forces "warp" or "block" where that route takes
    n, and raises where it does not.  One launch on the
    current stream, no synchronisation; ``batched_lu_noswap_cuda.launches``
    counts them, ``.route_launches`` counts them by route."""
    if route is not None and isinstance(A, torch.Tensor) and A.dim() == 3:
        if route not in NOSWAP_ROUTES or not _route_takes(route, A.shape[1], A.shape[2]):
            raise ValueError(f"batched_lu_noswap_cuda: route {route!r} does not take "
                             f"{tuple(A.shape[1:])}")
    A = _cuda_batch(A, "batched_lu_noswap_cuda", square=True)
    _refuse_lu_shape(A, "batched_lu_noswap_cuda")
    B, n, _ = A.shape
    route = route or noswap_route(n)
    dev = A.device
    out = torch.empty_like(A)
    perm = torch.empty((B, n), dtype=torch.int32, device=dev)
    info = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, perm, info
    lib = _kernels.load("batched_lu")
    fn = (lib.rf_batched_lu_noswap_f64 if A.element_size() == 8
          else lib.rf_batched_lu_noswap_f32)
    index, stream = _launch_args(A)
    batched_lu_noswap_cuda.launches += 1
    batched_lu_noswap_cuda.route_launches[route] += 1
    code = fn(
        A.data_ptr(), out.data_ptr(), perm.data_ptr(), info.data_ptr(),
        B, n, int(bool(pivot)), LU_ROUTES.index(route) + 1,
        noswap_smem_bytes(n, A.element_size(), route), index, stream,
    )
    _kernels.check(lib, code, "batched_lu noswap launch")
    return out, perm, info


batched_lu_noswap_cuda.launches = 0
batched_lu_noswap_cuda.route_launches = dict.fromkeys(NOSWAP_ROUTES, 0)


def reset_noswap_launches() -> None:
    """Set the noswap kernel's launch counts (all and by route) to 0."""
    batched_lu_noswap_cuda.launches = 0
    batched_lu_noswap_cuda.route_launches = dict.fromkeys(NOSWAP_ROUTES, 0)


def batched_solve_cuda(factors: torch.Tensor, b: torch.Tensor,
                       perm: Optional[torch.Tensor] = None,
                       ipiv: Optional[torch.Tensor] = None,
                       route: Optional[str] = None) -> torch.Tensor:
    """Launch the solve kernel: ``factors`` (B, n, n) CUDA f32/f64, ``b``
    (B, n) or (B, n, k) -> x of ``b``'s shape, allocated here.  ``perm``
    or ``ipiv`` (B, n) integer tensors on the same device, when given,
    are applied to ``b``'s rows inside the kernel; their entries must lie
    in [0, n), which is not checked (that would need a host read).
    ``route`` (default: the shape's own, :func:`solve_route`) forces
    "warp" or "wide" where that route takes the shape (the warp route
    n <= 32, the wide route 32 < n <= 128), and raises where it does not.  One
    launch on the current stream, no synchronisation;
    ``batched_solve_cuda.launches`` counts them,
    ``batched_solve_cuda.route_launches`` counts them by route."""
    if route is not None and isinstance(factors, torch.Tensor) and factors.dim() == 3:
        if not _solve_route_takes(route, factors.shape[1]):
            raise ValueError(f"batched_solve_cuda: route {route!r} does not take "
                             f"n={factors.shape[1]}")
    f = _cuda_batch(factors, "batched_solve_cuda", square=True)
    if not isinstance(b, torch.Tensor) or b.device != f.device:
        raise ValueError("batched_solve_cuda: b must lie on the factors' device")
    rhs, vec = _as_rhs(f, b)
    rhs = rhs.contiguous()
    B, n, nrhs = rhs.shape
    idx = _row_order(f, perm, ipiv)
    if idx is not None:
        if idx.device != f.device:
            raise ValueError("batched_solve_cuda: perm/ipiv must lie on the factors' device")
        idx = idx.to(torch.int32).contiguous()
    if not solve_kernel_takes(f.dtype, n, nrhs):
        raise ValueError(
            f"batched_solve_cuda: n={n}, nrhs={nrhs} {f.dtype} does not fit "
            f"the kernel (0 < n <= {KERNEL_MAX_N})"
        )
    route = route or solve_route(n, nrhs)
    smem = solve_smem_bytes(n, nrhs, f.element_size(), route)
    x = torch.empty_like(rhs)
    if B > 0:
        lib = _kernels.load("batched_solve")
        fn = lib.rf_batched_solve_f64 if f.element_size() == 8 else lib.rf_batched_solve_f32
        index, stream = _launch_args(f)
        batched_solve_cuda.launches += 1
        batched_solve_cuda.route_launches[route] += 1
        code = fn(
            f.data_ptr(), rhs.data_ptr(), x.data_ptr(),
            idx.data_ptr() if perm is not None else None,
            idx.data_ptr() if ipiv is not None else None,
            B, n, nrhs, SOLVE_ROUTES.index(route) + 1, smem, index, stream,
        )
        _kernels.check(lib, code, "batched_solve launch")
    return x[:, :, 0] if vec else x


batched_solve_cuda.launches = 0
batched_solve_cuda.route_launches = dict.fromkeys(SOLVE_ROUTES, 0)


def solve_plan(n: int, nrhs: int = 1, dtype=torch.float32, route: Optional[str] = None,
               device=None) -> dict:
    """The solve kernel's launch plan for (n, n) factors and ``nrhs``
    right-hand sides of ``dtype`` on a CUDA device, with the keys of
    :func:`lu_plan` ("capacity": lanes per matrix on the warp route,
    rows per lane on the wide route)."""
    route = route or solve_route(n, nrhs)
    if not _solve_route_takes(route, n):
        raise ValueError(f"solve_plan: route {route!r} does not take n={n}")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _kernels.load("batched_solve")
    out = (ctypes.c_int * 10)()
    itemsize = torch.empty((), dtype=dtype).element_size()
    code = lib.rf_batched_solve_plan(n, nrhs, itemsize, SOLVE_ROUTES.index(route) + 1, index,
                                     ctypes.addressof(out))
    _kernels.check(lib, code, "batched_solve plan")
    keys = ("route", "threads", "per_block", "smem", "blocks_per_sm", "registers",
            "local_bytes", "static_smem", "capacity", "max_threads")
    plan = dict(zip(keys, list(out)))
    plan["route"] = SOLVE_ROUTES[plan["route"] - 1]
    if plan["smem"] != solve_smem_bytes(n, nrhs, itemsize, route):
        raise RuntimeError("solve_plan: the kernel's shared memory differs from solve_smem_bytes")
    return plan


def reset_solve_launches() -> None:
    """Set the solve kernel's launch counts (all and by route) to 0."""
    batched_solve_cuda.launches = 0
    batched_solve_cuda.route_launches = dict.fromkeys(SOLVE_ROUTES, 0)


# ---------------------------------------------------------------------------
# the layer's entry points: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------


def batched_lu(A: torch.Tensor, pivot: bool = True, with_perm: bool = True):
    """LU with row interchanges of a batch (B, m, n): ``(factors, ipiv,
    perm or None, info)``."""
    if A.device.type == "cuda":
        return batched_lu_cuda(A, pivot, with_perm)
    return batched_lu_plain(A, pivot, with_perm)


def batched_lu_noswap(A: torch.Tensor, pivot: bool = True):
    """Physical-order LU of a square batch: ``(factors, perm, info)``."""
    if A.device.type == "cuda":
        return batched_lu_noswap_cuda(A, pivot)
    return batched_lu_noswap_plain(A, pivot)


def batched_solve(factors: torch.Tensor, b: torch.Tensor,
                  perm: Optional[torch.Tensor] = None,
                  ipiv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both substitutions; ``b``'s rows are taken by ``perm``, exchanged
    by ``ipiv``, or used as they are."""
    if factors.device.type == "cuda":
        return batched_solve_cuda(factors, b, perm, ipiv)
    return batched_solve_plain(factors, b, perm, ipiv)
