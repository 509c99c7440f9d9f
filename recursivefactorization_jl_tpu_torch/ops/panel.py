"""Tall-panel LU factorization: the Hopper kernels and their routing.

``panel_factor`` factors an (m, w) panel, or a whole matrix, in place.
A CUDA tensor goes to a hand-written kernel.  float32/float64 panels:
``config.panel_variant`` picks csrc/panel_lu.cu (``'fori'`` / ``'fori2'``
/ ``'fori3'``, the port of the TPU kernel ``_panel_kernel_fori``) or one
of the two micro-blocked kernels of csrc/panel_lu_micro.cu (``'shadow'``:
the port of ``_panel_kernel_shadow``, the micro block staged in shared
memory; ``'basic'``: the port of ``_panel_kernel``, in place).
complex64/complex128 panels go to csrc/panel_lu_c64.cu (the port of
``_panel_kernel_fori_c64``) whatever the variant: the JAX package has no
other complex kernel either.  Both csrc/panel_lu.cu and
csrc/panel_lu_c64.cu run a panel on the cluster route (the pivot chain of
each block of b columns on one thread-block cluster, then a delayed pass)
or, for panels too tall for a cluster, on the grid route; ``panel_plan``
shows the plan.  A CPU tensor goes to the kernel's plain
version in ops/unblocked.py: ``unblocked_lu``, ``micro_blocked_lu`` or,
for complex panels, ``unblocked_lu_cabs1``.

Under ``panel_boundary_precision='bf16x3'`` a float32 panel of a fori
variant runs csrc/panel_lu.cu in blocks of exactly ``panel_micro`` steps
on the cluster route, each block's trailing update split into bf16 halves
on the tensor cores (``panel_factor_cuda(..., precision='bf16x3')``,
``bf16x3_plan``, ``bf16x3_updates``; the update alone:
``panel_update_bf16x3_cuda``, its tile ``bf16x3_update_plan``); its plain
version is ``micro_blocked_lu(..., 'bf16x3')``.  It takes any block width
and any panel height: a block whose live rows do not fit a cluster (or
wider than 512 columns) runs its pivot chain on the grid instead
(``panel_grid_chain_kernel`` of csrc/panel_cluster.cuh, the same bits),
and the block boundaries stay where they are.

The micro-blocked kernels run on the same cluster route with blocks of
exactly ``micro`` steps and their own order of the trailing update
(``micro_plan`` shows the plan); both variants compute the same bits
there, and each keeps its grid-barrier kernel as the grid route for
panels too tall for a cluster at ``micro`` <= ``PANEL_MICRO_MAX``.  A
wider ``micro`` on such a panel keeps the cluster route with its leading
blocks' chains on the grid, as the bf16x3 form does.

``panel_factor_noswap`` is the panel layer of ``schedule='physical'``:
csrc/panel_lu_noswap.cu (the port of ``_panel_kernel_noswap``) on the
card, ``unblocked_lu_noswap`` on the CPU.  On the card it runs a cluster
route of its own (the available rows compacted per block, no row moves;
``noswap_plan``) or, for panels too tall for a cluster, its grid route.

``offset_panel_factor`` is the panel layer of the tensor-parallel LU
(parallel/blockcyclic.py): the offset kernel of csrc/panel_lu.cu (the
port of ``_offset_panel_kernel``) on the card, ``offset_panel_lu`` on the
CPU; complex panels take the offset form of csrc/panel_lu_c64.cu on the
card and ``offset_panel_lu_cabs1`` on the CPU.

There is no fallback between kernel and plain version: a CUDA tensor
launches the kernel or raises.  A route is chosen by the panel's shape or
by an explicit ``block`` (``block=-1``: the grid route); every wrapper
counts its launches and, apart, those on the grid route; the blocked forms
count the blocks whose chain ran on the grid (``.grid_block_launches``).
Every wrapper of a kernel that runs ``panel_chain_kernel`` counts the chain
launches that took its look-ahead step, on a cluster of more than one CTA
(``.lookahead_chain_launches``), those whose candidate exchange ran on the
per-parity mbarriers (``.mbarrier_exchange_launches``: the same launches),
and every chain launch on a cluster by its
plan (``.chain_launches_by_plan``: a dict keyed (dtype name, b, C)), so a
run shows which rule of csrc/panel_cluster.cuh's ``Auto<T>`` its chains
took.
Their private ``_chain='grid'`` puts every block's chain on the grid, to
hold the grid chain against the cluster chain.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.config import DEFAULT_PANEL_MICRO, FORI_VARIANTS, PANEL_MICRO_MAX, LUConfig
from . import _kernels
from .unblocked import (
    micro_blocked_lu,
    offset_panel_lu,
    offset_panel_lu_cabs1,
    unblocked_lu,
    unblocked_lu_cabs1,
    unblocked_lu_noswap,
)

_REAL = (torch.float32, torch.float64)
_COMPLEX = (torch.complex64, torch.complex128)

def panel_route(m: int, w: int, dtype, config: LUConfig, device="cuda") -> str:
    """Which implementation factors an (m, w) panel of ``dtype`` on
    ``device``:

    * ``"kernel"``: csrc/panel_lu.cu (CUDA; f32/f64, a fori variant) or
      csrc/panel_lu_c64.cu (complex64/complex128, any variant; the JAX
      package says ``"pallas-c64"``);
    * ``"kernel-shadow"`` / ``"kernel-basic"``: the staged / in-place
      micro-blocked kernel of csrc/panel_lu_micro.cu (CUDA; f32/f64,
      ``panel_variant`` ``'shadow'`` / ``'basic'``);
    * ``"unblocked"``: the plain version (CPU tensors, or
      ``backend='xla'`` on the CPU): the CABS1 one for complex panels;
    * ``"micro-blocked"``: the plain version of the micro-blocked
      kernels (CPU tensors, f32/f64, ``'shadow'`` or ``'basic'``);
    * ``"kernel-bf16x3"`` / ``"micro-blocked-bf16x3"``: a float32 panel of
      a fori variant under ``panel_boundary_precision='bf16x3'``, on the
      card (csrc/panel_lu.cu's bf16x3 form) / on the CPU
      (``micro_blocked_lu(..., 'bf16x3')``).  Other types and variants
      ignore the knob.

    Complex panels ignore the variant.  The TPU package's ``"split"``
    route answers the program size of its statically unrolled kernels;
    it is not ported: the Hopper kernels take any width.
    """
    config.check_variants()
    fori = config.panel_variant in FORI_VARIANTS
    micro = not fori and dtype in _REAL
    bf16x3 = (fori and dtype == torch.float32
              and config.resolved_panel_boundary_precision() == "bf16x3")
    if torch.device(device).type != "cuda":
        if bf16x3:
            return "micro-blocked-bf16x3"
        return "micro-blocked" if micro else "unblocked"
    if dtype not in _REAL + _COMPLEX:
        raise NotImplementedError(
            "the Hopper panel kernels take float32/float64/complex64/"
            f"complex128, not {dtype} (half types reach them promoted to "
            "float32, integer and bool types converted to float64)"
        )
    if config.backend == "xla":
        raise ValueError(
            "backend='xla' selects the plain panel, which runs only on "
            "CPU tensors"
        )
    if bf16x3:
        return "kernel-bf16x3"
    return f"kernel-{config.panel_variant}" if micro else "kernel"


def _check_panel(what, panel, dtypes):
    """The argument checks the panel kernels share.  Returns ``(m, w,
    lda, device index, real dtype, bytes per real)``."""
    if not isinstance(panel, torch.Tensor) or panel.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor")
    if panel.dtype not in dtypes:
        names = "/".join(str(d)[6:] for d in dtypes)
        raise ValueError(f"panel dtype must be {names}, got {panel.dtype}")
    if panel.dim() != 2:
        raise ValueError(f"panel must be 2-D, got shape {tuple(panel.shape)}")
    if panel.is_conj():
        raise ValueError("panel must not be a lazily conjugated view")
    m, w = panel.shape
    if m < 1 or w < 1:
        raise ValueError(f"empty panel {tuple(panel.shape)}")
    if w > 1 and panel.stride(1) != 1:
        raise ValueError("panel rows must be contiguous (column stride 1)")
    lda = panel.stride(0) if m > 1 else w
    if lda < w or lda >= 2**31:
        raise ValueError(f"unsupported panel row stride {panel.stride(0)}")
    dev = panel.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    real = panel.real.dtype if panel.is_complex() else panel.dtype
    return m, w, lda, index, real, torch.finfo(real).bits // 8


@functools.lru_cache(maxsize=256)
def _plan(cplx, m, w, size, ofs, block, cluster, index):
    """The plan of csrc/panel_lu.cu (``cplx`` False) or csrc/panel_lu_c64.cu
    as a tuple (route, b, C or G, blocks, ws reals, iws int32s); ``size``
    is the element's bytes, ``ofs`` None for the main-path kernel.  Cached:
    the plan is a function of its arguments on one card."""
    name = "panel_lu_c64" if cplx else "panel_lu"
    lib = _kernels.load(name)
    out = (ctypes.c_int * 6)()
    if cplx:
        fn = lib.rf_panel_lu_c_plan if ofs is None else lib.rf_offset_panel_lu_c_plan
    else:
        fn = lib.rf_panel_lu_plan if ofs is None else lib.rf_offset_panel_lu_plan
    code = fn(m, w, size, ofs or 0, block, cluster, index, out)
    _kernels.check(lib, code, f"{name} plan")
    return tuple(out)


def _check_plan_request(dtype, block, cluster):
    if dtype not in _REAL + _COMPLEX:
        raise ValueError(
            f"panel dtype must be float32/float64/complex64/complex128, got {dtype}")
    _check_block_cluster(block, cluster)


def _device_index(device):
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _plan_dict(plan) -> dict:
    route, b, c, blocks, ws, iws = plan[:6]
    out = {"route": "cluster" if route == 1 else "grid",
           "block": b if route == 1 else None, "cluster": c if route == 1 else None,
           "grid": c if route == 0 else None, "blocks": blocks,
           "ws_reals": ws, "iws_ints": iws}
    if len(plan) > 6:  # the blocked forms: blocks whose chain runs on the grid
        out["grid_blocks"] = plan[6]
    return out


def _count_chains(wrapper, dtype, route, b, cluster, chains):
    """Add ``chains`` chain launches of plan (b, C) to
    ``wrapper.chain_launches_by_plan``, on the cluster route only."""
    if route == 1 and cluster > 0 and chains > 0:
        key = (str(dtype)[6:], b, cluster)
        counts = wrapper.chain_launches_by_plan
        counts[key] = counts.get(key, 0) + chains


# the blocked forms' chains: "auto" (on a cluster where the block's live
# rows fit one, else on the grid) or "grid" (every block's, forced)
CHAINS = ("auto", "grid")


def _check_chain(chain):
    if chain not in CHAINS:
        raise ValueError(f"_chain must be one of {CHAINS}, got {chain!r}")
    return int(chain == "grid")


def panel_plan(m: int, w: int, dtype, ofs=None, block: int = 0,
               cluster: int = 0, device=None) -> dict:
    """How the panel kernel of ``dtype`` factors an (m, w) panel on the
    card: csrc/panel_lu.cu for float32/float64, as the main-path kernel
    (``ofs=None``) or as the offset kernel from row ``ofs``;
    csrc/panel_lu_c64.cu for complex64/complex128, likewise.
    Returns ``{"route": "cluster" | "grid", "block": b, "cluster": C,
    "grid": G, "blocks": launches of the chain kernel, "ws_reals",
    "iws_ints"}`` (workspace sizes).  ``block`` and ``cluster`` 0 ask for
    the launcher's choice (what the main path runs); ``block < 0`` forces
    the grid route and ``block >= w`` one block.  Raises ValueError for a
    dtype the kernels do not take, RuntimeError for an offset outside
    [0, m - w] and where the card cannot run an explicit choice."""
    _check_plan_request(dtype, block, cluster)
    size = torch.empty((), dtype=dtype).element_size()
    return _plan_dict(_plan(dtype in _COMPLEX, m, w, size, ofs, block, cluster,
                            _device_index(device)))


@functools.lru_cache(maxsize=256)
def _micro_plan(m, w, size, micro, shadow, block, cluster, chain, index):
    """The plan of csrc/panel_lu_micro.cu, as :func:`_plan`'s tuple and the
    blocks whose chain runs on the grid."""
    lib = _kernels.load("panel_lu_micro")
    out = (ctypes.c_int * 7)()
    code = lib.rf_panel_lu_micro_plan(m, w, size, micro, int(shadow), block, cluster, chain,
                                      index, out)
    _kernels.check(lib, code, "panel_lu_micro plan")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _noswap_plan(m, w, size, live, block, cluster, index):
    """The plan of csrc/panel_lu_noswap.cu, as :func:`_plan`'s tuple."""
    lib = _kernels.load("panel_lu_noswap")
    out = (ctypes.c_int * 6)()
    code = lib.rf_panel_lu_noswap_plan(m, w, size, live, block, cluster, index, out)
    _kernels.check(lib, code, "panel_lu_noswap plan")
    return tuple(out)


def _check_micro_request(micro, block, cluster, chain="auto"):
    """The micro-blocked kernels' own checks: ``micro`` a positive int,
    ``block`` 0 (the launcher's choice: blocks of ``micro`` steps) or
    negative (the grid route, which takes ``micro`` <= PANEL_MICRO_MAX
    after the cut to the panel), ``cluster`` a non-negative int, ``chain``
    one of CHAINS (with block 0).  Returns the chain's C value."""
    if not isinstance(micro, int) or isinstance(micro, bool) or micro < 1:
        raise ValueError(f"micro must be a positive int, got {micro!r}")
    _check_block_cluster(block, cluster)
    if block > 0:
        raise ValueError(
            f"the micro-blocked kernels' blocks are micro steps wide: block takes 0 "
            f"(the launcher's choice) or -1 (the grid route), got {block}")
    chain = _check_chain(chain)
    if chain and block < 0:
        raise ValueError("_chain='grid' runs the cluster route's blocks; block=-1 picks the "
                         "grid route, which has none")
    return chain


def _check_grid_micro(micro, block):
    """The grid route (block=-1) takes blocks of at most PANEL_MICRO_MAX
    steps (``micro`` already cut to the panel)."""
    if block < 0 and micro > PANEL_MICRO_MAX:
        raise ValueError(f"the micro-blocked kernels' grid route (block=-1) takes blocks of "
                         f"at most {PANEL_MICRO_MAX} steps, got micro={micro}; the cluster "
                         f"route (block=0) takes any")


def _check_block_cluster(block, cluster):
    for name, v in (("block", block), ("cluster", cluster)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(f"{name} must be an int, got {v!r}")
    if cluster < 0:
        raise ValueError(f"cluster must be 0 (the launcher's choice) or a cluster size, "
                         f"got {cluster}")


def micro_plan(m: int, w: int, dtype, micro: int, variant: str = "shadow",
               block: int = 0, cluster: int = 0, device=None, _chain: str = "auto") -> dict:
    """How csrc/panel_lu_micro.cu factors an (m, w) float32/float64 panel
    with blocks of ``micro`` steps (cut to min(m, w)): the cluster route
    with b = micro where the panel fits a cluster, else the grid route of
    ``variant`` (``'shadow'`` or ``'basic'``; the cluster route is the same
    for both) up to ``PANEL_MICRO_MAX`` steps, and past that the cluster
    route with its leading blocks' chains on the grid.  ``block=-1`` forces
    the grid route; ``cluster`` 0 picks the cluster size; ``_chain='grid'``
    puts every block's chain on the grid.  Returns :func:`panel_plan`'s
    dict with ``grid_blocks``, the blocks whose chain runs on the grid."""
    chain = _check_micro_request(micro, block, cluster, _chain)
    if dtype not in _REAL:
        raise ValueError(f"the micro-blocked kernels take float32/float64, got {dtype}")
    if variant not in ("shadow", "basic"):
        raise ValueError(f"variant must be 'shadow' or 'basic', got {variant!r}")
    micro = min(micro, m, w)
    _check_grid_micro(micro, block)
    size = torch.empty((), dtype=dtype).element_size()
    return _plan_dict(_micro_plan(m, w, size, micro, variant == "shadow", block, cluster,
                                  chain, _device_index(device)))


def _check_live(live, m):
    if live is None:
        return m
    if not isinstance(live, int) or isinstance(live, bool) or not 0 <= live <= m:
        raise ValueError(f"live must be an int in [0, {m}] (the rows the mask leaves), "
                         f"got {live!r}")
    return live


def noswap_plan(m: int, w: int, dtype, live=None, block: int = 0, cluster: int = 0,
                device=None) -> dict:
    """How csrc/panel_lu_noswap.cu factors an (m, w) float32/float64 panel
    of which ``live`` rows are available (None: m): its cluster route,
    the slab sized for ``live`` rows, or the grid route for panels too
    tall for a cluster.  ``block`` / ``cluster`` as for
    :func:`panel_plan`.  Returns :func:`panel_plan`'s dict."""
    _check_block_cluster(block, cluster)
    if dtype not in _REAL:
        raise ValueError(f"the no-swap kernel takes float32/float64, got {dtype}")
    live = _check_live(live, m)
    size = torch.empty((), dtype=dtype).element_size()
    return _plan_dict(_noswap_plan(m, w, size, live, block, cluster, _device_index(device)))


def _launch_panel_lu(wrapper, panel, pivot, ofs, block, cluster, dtypes=_REAL):
    """The checks, plan, allocations and launch of csrc/panel_lu.cu (the
    offset kernel unless ``ofs`` is None) or, for ``dtypes`` ``_COMPLEX``,
    csrc/panel_lu_c64.cu.  Adds one to ``wrapper.launches`` at the launch,
    one to ``wrapper.grid_route_launches`` when the panel takes the grid
    route, and to ``wrapper.lookahead_chain_launches`` and
    ``wrapper.mbarrier_exchange_launches`` the chain launches that took the
    look-ahead step and the mbarrier exchange, as the C launcher reports
    them; counts
    the chain launches in ``wrapper.chain_launches_by_plan``.  piv, perm,
    info and the integer workspace share one allocation."""
    m, w, lda, index, real, size = _check_panel(wrapper.__name__, panel, dtypes)
    cplx = panel.is_complex()
    _check_plan_request(panel.dtype, block, cluster)
    route, b, c, blocks, ws_reals, iws_ints = _plan(cplx, m, w, panel.element_size(), ofs,
                                                    block, cluster, index)
    dev = panel.device
    npiv = min(m - (ofs or 0), w)
    ints = torch.empty(npiv + m + 1 + iws_ints, dtype=torch.int32, device=dev)
    piv, perm, info = ints[:npiv], ints[npiv:npiv + m], ints[npiv + m]
    ws = torch.empty(ws_reals, dtype=real, device=dev) if route == 0 else None
    lib = _kernels.load("panel_lu_c64" if cplx else "panel_lu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    wrapper.launches += 1
    if route == 0:
        wrapper.grid_route_launches += 1
    kind = ("c64" if size == 4 else "c128") if cplx else ("f32" if size == 4 else "f64")
    prefix = "rf_panel_lu" if ofs is None else "rf_offset_panel_lu"
    fn = getattr(lib, f"{prefix}_{kind}")
    extra = () if ofs is None else (ofs,)
    lookaheads, mbarriers = ctypes.c_int(0), ctypes.c_int(0)
    code = fn(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), *extra, block, cluster,
        piv.data_ptr(), perm.data_ptr(), info.data_ptr(),
        None if ws is None else ws.data_ptr(), ints[npiv + m + 1:].data_ptr(),
        ctypes.byref(lookaheads), ctypes.byref(mbarriers), index, stream,
    )
    wrapper.lookahead_chain_launches += lookaheads.value
    wrapper.mbarrier_exchange_launches += mbarriers.value
    _kernels.check(lib, code, f"{'panel_lu_c64' if cplx else 'panel_lu'} launch")
    _count_chains(wrapper, panel.dtype, route, b, c, blocks)
    return piv, perm, info


@functools.lru_cache(maxsize=256)
def _bf16x3_plan(m, w, b, cluster, chain, index):
    """The plan of csrc/panel_lu.cu's bf16x3 form, as :func:`_plan`'s tuple
    and the blocks whose chain runs on the grid."""
    lib = _kernels.load("panel_lu")
    out = (ctypes.c_int * 7)()
    code = lib.rf_panel_lu_bf16x3_plan(m, w, b, cluster, chain, index, out)
    _kernels.check(lib, code, "panel_lu bf16x3 plan")
    return tuple(out)


def _bf16x3_block(block, m, w):
    """The bf16x3 form's steps per block: ``block`` (0: DEFAULT_PANEL_MICRO),
    any positive width, cut to min(m, w)."""
    if not isinstance(block, int) or isinstance(block, bool) or block < 0:
        raise ValueError(f"the bf16x3 form takes block 0 (DEFAULT_PANEL_MICRO) or a "
                         f"positive block width, got {block!r}; it has no grid route")
    return min(block or DEFAULT_PANEL_MICRO, m, w)


def bf16x3_plan(m: int, w: int, block: int = 0, cluster: int = 0, device=None,
                _chain: str = "auto") -> dict:
    """How csrc/panel_lu.cu factors an (m, w) float32 panel under
    ``panel_boundary_precision='bf16x3'``: the cluster route with blocks of
    ``block`` steps (0: ``DEFAULT_PANEL_MICRO``; cut to min(m, w); one block
    when that reaches w), ``cluster`` 0 picking the cluster size.  The
    leading blocks whose live rows do not fit a cluster at that width (every
    block past 512 columns, or every block with ``_chain='grid'``) run their
    chain on the grid.  Returns :func:`panel_plan`'s dict with
    ``grid_blocks``, the count of those blocks."""
    _check_block_cluster(block, cluster)
    chain = _check_chain(_chain)
    b = _bf16x3_block(block, m, w)
    return _plan_dict(_bf16x3_plan(m, w, b, cluster, chain, _device_index(device)))


# the bf16x3 form's update kernels: the tiled one, or the simple one where
# forced (the `simple` argument of its C entry points)
BF16X3_UPDATES = ("tiled", "simple")


def bf16x3_updates(m: int, w: int, block: int = 0):
    """The update launches of an (m, w) float32 panel in the bf16x3 form:
    ``(rows, cols, nb)`` of each, in launch order, as csrc/panel_cluster.cuh
    `run_cluster` issues them: one after each block with rows below it and
    columns right of it, on all those rows and columns.  A panel of one
    block has none."""
    b = _bf16x3_block(block, m, w)
    steps = min(m, w)
    out = []
    if b >= w:
        return out
    for k0 in range(0, steps, b):
        nb = min(b, steps - k0)
        rows, cols = m - k0 - nb, w - k0 - nb
        if rows > 0 and cols > 0:
            out.append((rows, cols, nb))
    return out


def bf16x3_update_plan(rows: int, cols: int, nb: int) -> dict:
    """The tile and grid of the tiled bf16x3 update (csrc/panel_cluster.cuh
    `tile_plan`) as the compiled launcher makes them: ``tm`` x ``tn`` C
    elements per CTA, ``kp`` (nb padded to 16), ``grid`` (row tiles, column
    tiles), ``threads`` (a warp per 16 tile rows)."""
    lib = _kernels.load("panel_lu")
    out = (ctypes.c_int * 5)()
    code = lib.rf_panel_update_bf16x3_plan(rows, cols, nb, out)
    _kernels.check(lib, code, "panel_lu bf16x3 update plan")
    return dict(tm=out[0], tn=out[1], kp=out[2], grid=(out[3], out[4]), threads=2 * out[0])


def _launch_bf16x3(panel, pivot, block, cluster, update, chain):
    """The checks, plan, allocations and launch of csrc/panel_lu.cu's
    bf16x3 form, for :func:`panel_factor_cuda`."""
    wrapper = panel_factor_cuda
    _check_block_cluster(block, cluster)
    if update not in BF16X3_UPDATES:
        raise ValueError(f"_update must be one of {BF16X3_UPDATES}, got {update!r}")
    chain = _check_chain(chain)
    m, w, lda, index, _, _ = _check_panel(wrapper.__name__, panel, (torch.float32,))
    b = _bf16x3_block(block, m, w)
    route, _, c, blocks, _, iws_ints, _ = _bf16x3_plan(m, w, b, cluster, chain, index)
    dev = panel.device
    npiv = min(m, w)
    ints = torch.empty(npiv + m + 1 + iws_ints, dtype=torch.int32, device=dev)
    piv, perm, info = ints[:npiv], ints[npiv:npiv + m], ints[npiv + m]
    lib = _kernels.load("panel_lu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    updates, grids, lookaheads, mbarriers = (ctypes.c_int(0) for _ in range(4))
    wrapper.launches += 1
    wrapper.bf16x3_launches += 1
    code = lib.rf_panel_lu_bf16x3_f32(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), b, cluster,
        int(update == "simple"), chain,
        piv.data_ptr(), perm.data_ptr(), info.data_ptr(), ints[npiv + m + 1:].data_ptr(),
        ctypes.byref(updates), ctypes.byref(grids), ctypes.byref(lookaheads),
        ctypes.byref(mbarriers), index, stream,
    )
    # the update and chain kernels the launcher issued (one update per block
    # boundary with rows and columns below and right of the block:
    # bf16x3_updates; one grid chain per block of the plan's grid_blocks; a
    # look-ahead chain per other block on a cluster of C > 1, each on the
    # mbarrier exchange)
    wrapper.bf16x3_update_launches += updates.value
    wrapper.grid_block_launches += grids.value
    wrapper.lookahead_chain_launches += lookaheads.value
    wrapper.mbarrier_exchange_launches += mbarriers.value
    if update == "simple":
        wrapper.bf16x3_simple_update_launches += updates.value
    _kernels.check(lib, code, "panel_lu bf16x3 launch")
    _count_chains(wrapper, panel.dtype, route, b, c, blocks - grids.value)
    return piv, perm, info


def panel_factor_cuda(panel: torch.Tensor, pivot: bool, *, block: int = 0,
                      cluster: int = 0, precision: str = "float32",
                      _update: str = "tiled", _chain: str = "auto"):
    """Launch the Hopper panel kernel on ``panel`` in place.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous (unit
    column stride, row stride >= w, as for a column block of a row-major
    matrix).  Returns ``(piv, perm, info)``: int32 (min(m, w),) 0-based
    pivot rows, int32 (m,) composed row permutation and a 0-d int32
    info, all on ``panel``'s device, allocated here.  Launches on the
    current stream and does not synchronise.  ``block`` / ``cluster``
    pick the cluster route's block width and cluster size (0: the
    launcher's choice; see :func:`panel_plan`).
    ``panel_factor_cuda.launches`` counts the launches,
    ``panel_factor_cuda.grid_route_launches`` those that took the grid
    route (panels too tall for a cluster),
    ``panel_factor_cuda.lookahead_chain_launches`` the chain launches
    (one per block) that took the look-ahead step on a cluster of C > 1,
    ``panel_factor_cuda.mbarrier_exchange_launches`` those whose candidate
    exchange ran on the per-parity mbarriers (every one of them),
    ``panel_factor_cuda.chain_launches_by_plan`` every chain launch on a
    cluster by its plan, ``{(dtype name, b, C): launches}``; every wrapper
    of ``panel_chain_kernel`` keeps all three.

    ``precision='bf16x3'`` (float32 panels): the form of
    ``panel_boundary_precision='bf16x3'``, blocks of exactly ``block`` steps
    (0: ``DEFAULT_PANEL_MICRO``; any width, cut to min(m, w)) on the
    cluster route, each block's trailing update split into bf16 halves on
    the tensor cores (see :func:`bf16x3_plan`).  It agrees with
    ``micro_blocked_lu(panel, pivot, block, 'bf16x3')`` to the bf16x3
    class, not bitwise.  A block whose live rows do not fit a cluster runs
    its chain on the grid (``_chain='grid'``: every block's, bit for bit
    the cluster chain's result, for comparison).  Each block's trailing
    update runs on the tiled update kernel (:func:`bf16x3_updates` lists
    the launches); ``_update='simple'`` forces the simple update kernel,
    bit for bit the same result, for comparison.  ``.bf16x3_launches``
    counts these launches (``.launches`` counts them too),
    ``.bf16x3_update_launches`` the update kernels they issued,
    ``.bf16x3_simple_update_launches`` those on the simple kernel,
    ``.grid_block_launches`` the blocks whose chain ran on the grid."""
    if precision == "bf16x3":
        return _launch_bf16x3(panel, pivot, block, cluster, _update, _chain)
    if _chain != "auto":
        raise ValueError("_chain applies to precision='bf16x3' (the float32 form has no "
                         "grid chain: its tall panels take the grid route)")
    if precision != "float32":
        raise ValueError(f"precision must be 'float32' or 'bf16x3', got {precision!r}")
    return _launch_panel_lu(panel_factor_cuda, panel, pivot, None, block, cluster)


panel_factor_cuda.launches = 0
panel_factor_cuda.grid_route_launches = 0
panel_factor_cuda.bf16x3_launches = 0
panel_factor_cuda.bf16x3_update_launches = 0
panel_factor_cuda.bf16x3_simple_update_launches = 0
panel_factor_cuda.grid_block_launches = 0
panel_factor_cuda.lookahead_chain_launches = 0
panel_factor_cuda.mbarrier_exchange_launches = 0
panel_factor_cuda.chain_launches_by_plan = {}


def _rows_stride(t):
    """The row stride of a 2-D tensor whose rows are contiguous."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def panel_update_bf16x3_cuda(C: torch.Tensor, L: torch.Tensor, U: torch.Tensor, *,
                             _update: str = "tiled"):
    """``C -= hh + (hl + lh)``, the bf16x3 split of ``L @ U``, in place on
    the tensor cores: one launch of the update kernel of csrc/panel_lu.cu's
    bf16x3 form (``panel_update_bf16x3_tiled_kernel`` on the tile of
    :func:`bf16x3_update_plan`), alone.

    ``C`` (rows, cols), ``L`` (rows, nb), ``U`` (nb, cols): CUDA float32 on
    one device, rows contiguous, nb >= 1 (past 64 through K in chunks of
    64); ``C`` must share no memory
    with ``L`` or ``U``.  The plain version is ``C.sub_(schur_product(L, U,
    'bf16x3'))`` (ops/schur.py); the tensor cores sum in their own order,
    so the two agree to the bf16x3 class, not bitwise.  ``_update='simple'``
    forces the simple kernel (64 x 64 tiles; bit for bit the tiled kernel's
    result), for comparison.  Returns ``C``; launches on the current stream
    and does not synchronise.  ``panel_update_bf16x3_cuda.launches`` counts
    the launches, ``.simple_launches`` those on the simple kernel."""
    if _update not in BF16X3_UPDATES:
        raise ValueError(f"_update must be one of {BF16X3_UPDATES}, got {_update!r}")
    for name, t in (("C", C), ("L", L), ("U", U)):
        if (not isinstance(t, torch.Tensor) or t.device.type != "cuda"
                or t.dtype != torch.float32 or t.dim() != 2):
            raise ValueError(f"{name} must be a 2-D CUDA float32 tensor")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}'s rows must be contiguous")
        if not t.shape[1] <= _rows_stride(t) < 2**31:
            raise ValueError(f"unsupported row stride {t.stride(0)} of {name}")
    rows, cols = C.shape
    nb = L.shape[1]
    if L.shape[0] != rows or U.shape != (nb, cols):
        raise ValueError(f"shapes do not match: C {tuple(C.shape)}, L {tuple(L.shape)}, "
                         f"U {tuple(U.shape)}")
    if nb < 1:
        raise ValueError(f"nb must be at least 1, got {nb}")
    if not C.device == L.device == U.device:
        raise ValueError("C, L and U must lie on one device")
    dev = C.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _kernels.load("panel_lu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    wrapper = panel_update_bf16x3_cuda
    wrapper.launches += 1
    wrapper.simple_launches += _update == "simple"
    code = lib.rf_panel_update_bf16x3_f32(
        L.data_ptr(), _rows_stride(L), U.data_ptr(), _rows_stride(U), C.data_ptr(),
        _rows_stride(C), rows, cols, nb, int(_update == "simple"), index, stream)
    _kernels.check(lib, code, "panel_lu bf16x3 update")
    return C


panel_update_bf16x3_cuda.launches = 0
panel_update_bf16x3_cuda.simple_launches = 0


def offset_panel_factor_cuda(panel: torch.Tensor, ofs: int, pivot: bool, *,
                             block: int = 0, cluster: int = 0):
    """Launch the Hopper offset kernel on the full-height ``panel`` in
    place: column k eliminates row ``ofs + k``; rows above ``ofs`` are
    neither read nor written.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous, H x w with
    ``0 <= ofs <= H - w``.  ``ofs`` is a kernel argument: one build serves
    every offset and height.  Returns ``(piv, perm, info)``: int32 (w,)
    GLOBAL pivot rows, int32 (H,) composed permutation of all H rows, 0-d
    int32 signed panel-local info, all allocated here.  Computes
    ``offset_panel_lu(panel, ofs, pivot)`` bitwise.  Launches on the
    current stream and does not synchronise.  ``block`` / ``cluster`` as
    for :func:`panel_factor_cuda`.  ``offset_panel_factor_cuda.launches``
    counts the launches, ``.grid_route_launches`` those on the grid
    route, ``.lookahead_chain_launches`` the chain launches that took the
    look-ahead step."""
    _check_offset(offset_panel_factor_cuda, panel, ofs, _REAL)
    return _launch_panel_lu(offset_panel_factor_cuda, panel, pivot, ofs, block, cluster)


offset_panel_factor_cuda.launches = 0
offset_panel_factor_cuda.grid_route_launches = 0
offset_panel_factor_cuda.lookahead_chain_launches = 0
offset_panel_factor_cuda.mbarrier_exchange_launches = 0
offset_panel_factor_cuda.chain_launches_by_plan = {}


def _check_offset(wrapper, panel, ofs, dtypes):
    H, w = _check_panel(wrapper.__name__, panel, dtypes)[:2]
    if not isinstance(ofs, int) or isinstance(ofs, bool) or not 0 <= ofs <= H - w:
        raise ValueError(f"offset {ofs!r} outside [0, {H - w}] for a {H} x {w} panel")


def panel_factor_c64_cuda(panel: torch.Tensor, pivot: bool, *, block: int = 0,
                          cluster: int = 0):
    """Launch the Hopper complex panel kernel on ``panel`` in place, on
    its interleaved (re, im) storage.

    ``panel``: CUDA, complex64 or complex128, 2-D, rows contiguous (unit
    column stride, row stride >= w in complex elements), not a lazily
    conjugated view.  Pivots by CABS1 (``|re| + |im|``, first occurrence,
    LAPACK ``cgetrf``'s rule); a NaN among a step's candidates makes the
    pivot row m - 1.  The scale multiplies by ``conj(p) / |p|^2``, whose
    denominator overflows or underflows for pivots beyond the square
    root of the type's range (LAPACK's ``cladiv`` would not); the TPU
    kernel has the same limit.  Computes ``unblocked_lu_cabs1(panel,
    pivot)`` bitwise.  Returns ``(piv, perm, info)`` as
    :func:`panel_factor_cuda` does, launches on the current stream and
    does not synchronise.  ``block`` / ``cluster`` pick the cluster
    route's block width and cluster size as for :func:`panel_factor_cuda`
    (0: the launcher's choice; ``block < 0``: the grid route).
    ``panel_factor_c64_cuda.launches`` counts the launches,
    ``panel_factor_c64_cuda.grid_route_launches`` those on the grid
    route, ``.lookahead_chain_launches`` the chain launches that took the
    look-ahead step."""
    return _launch_panel_lu(panel_factor_c64_cuda, panel, pivot, None, block, cluster,
                            _COMPLEX)


panel_factor_c64_cuda.launches = 0
panel_factor_c64_cuda.grid_route_launches = 0
panel_factor_c64_cuda.lookahead_chain_launches = 0
panel_factor_c64_cuda.mbarrier_exchange_launches = 0
panel_factor_c64_cuda.chain_launches_by_plan = {}


def offset_panel_factor_c64_cuda(panel: torch.Tensor, ofs: int, pivot: bool, *,
                                 block: int = 0, cluster: int = 0):
    """Launch the offset form of the Hopper complex panel kernel on the
    full-height ``panel`` in place: column k eliminates row ``ofs + k``;
    rows above ``ofs`` are neither read nor written.

    ``panel``: CUDA, complex64 or complex128, 2-D, rows contiguous, not a
    lazily conjugated view, H x w with ``0 <= ofs <= H - w``.  Pivots by
    CABS1 as :func:`panel_factor_c64_cuda` does; a NaN among a step's
    candidates makes the pivot row H - 1.  Returns ``(piv, perm, info)``
    as :func:`offset_panel_factor_cuda` does (global pivot rows, the
    permutation of all H rows, the signed panel-local info) and computes
    ``offset_panel_lu_cabs1(panel, ofs, pivot)`` bitwise.  Launches on the
    current stream and does not synchronise.  ``block`` / ``cluster`` as
    for :func:`panel_factor_cuda` (``block=-1``: the grid route).
    ``offset_panel_factor_c64_cuda.launches`` counts the launches,
    ``.grid_route_launches`` those on the grid route,
    ``.lookahead_chain_launches`` the chain launches that took the
    look-ahead step."""
    _check_offset(offset_panel_factor_c64_cuda, panel, ofs, _COMPLEX)
    return _launch_panel_lu(offset_panel_factor_c64_cuda, panel, pivot, ofs, block, cluster,
                            _COMPLEX)


offset_panel_factor_c64_cuda.launches = 0
offset_panel_factor_c64_cuda.grid_route_launches = 0
offset_panel_factor_c64_cuda.lookahead_chain_launches = 0
offset_panel_factor_c64_cuda.mbarrier_exchange_launches = 0
offset_panel_factor_c64_cuda.chain_launches_by_plan = {}


def micro_max_cuda() -> int:
    """The widest micro block of the built csrc/panel_lu_micro.cu's grid
    route; raises if it is not the ``PANEL_MICRO_MAX`` the wrappers check."""
    limit = _kernels.load("panel_lu_micro").rf_panel_lu_micro_max()
    if limit != PANEL_MICRO_MAX:
        raise RuntimeError(
            f"csrc/panel_lu_micro.cu takes blocks of {limit} steps, "
            f"utils/config.py says {PANEL_MICRO_MAX}"
        )
    return limit


def _launch_micro(wrapper, panel, pivot, micro, shadow, block, cluster, chain):
    """The checks, plan, allocations and launch of the two micro-blocked
    kernels.  Adds one to ``wrapper.launches`` at the launch, one to
    ``wrapper.grid_route_launches`` when the panel takes the grid route,
    and to ``wrapper.grid_block_launches`` and
    ``wrapper.lookahead_chain_launches`` the grid-chain launches and the
    look-ahead chain launches the C launcher reports; counts the cluster
    chain launches in ``wrapper.chain_launches_by_plan``.  piv, perm, info
    and the integer workspace share one allocation."""
    chain = _check_micro_request(micro, block, cluster, chain)
    m, w, lda, index, real, size = _check_panel(wrapper.__name__, panel, _REAL)
    micro = min(micro, m, w)  # one block spans the whole panel
    _check_grid_micro(micro, block)
    route, b, c, blocks, ws_reals, iws_ints, _ = _micro_plan(
        m, w, size, micro, shadow, block, cluster, chain, index)
    dev = panel.device
    npiv = min(m, w)
    ints = torch.empty(npiv + m + 1 + iws_ints, dtype=torch.int32, device=dev)
    piv, perm, info = ints[:npiv], ints[npiv:npiv + m], ints[npiv + m]
    ws = torch.empty(ws_reals, dtype=real, device=dev) if route == 0 else None
    lib = _kernels.load("panel_lu_micro")
    which = "shadow" if shadow else "basic"
    fn = getattr(lib, f"rf_panel_lu_{which}_{'f32' if size == 4 else 'f64'}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    grids, lookaheads, mbarriers = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    wrapper.launches += 1
    if route == 0:
        wrapper.grid_route_launches += 1
    code = fn(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), micro, block, cluster, chain,
        piv.data_ptr(), perm.data_ptr(), info.data_ptr(),
        None if ws is None else ws.data_ptr(), ints[npiv + m + 1:].data_ptr(),
        ctypes.byref(grids), ctypes.byref(lookaheads), ctypes.byref(mbarriers), index, stream,
    )
    wrapper.grid_block_launches += grids.value
    wrapper.lookahead_chain_launches += lookaheads.value
    wrapper.mbarrier_exchange_launches += mbarriers.value
    _kernels.check(lib, code, "panel_lu_micro launch")
    _count_chains(wrapper, panel.dtype, route, b, c, blocks - grids.value)
    return piv, perm, info


def panel_factor_shadow_cuda(panel: torch.Tensor, pivot: bool, micro: int, *,
                             block: int = 0, cluster: int = 0, _chain: str = "auto"):
    """Launch the micro-blocked kernel of ``panel_variant='shadow'`` on
    ``panel`` in place.  Arguments, returns and stream rule as
    :func:`panel_factor_cuda`; ``micro`` (any positive int) is cut to
    min(m, w).  Computes ``micro_blocked_lu(panel, pivot, micro)`` bitwise.
    A panel that fits a thread-block cluster takes the cluster route with
    blocks of ``micro`` steps (``cluster``: 0 picks the size); taller
    panels, and ``block=-1``, take the grid route, the grid-barrier kernel
    that stages each thread block's rows of the current block in shared
    memory, up to ``PANEL_MICRO_MAX`` steps; past that a taller panel keeps
    the cluster route with its leading blocks' chains on the grid (see
    :func:`micro_plan`; ``_chain='grid'`` puts every block's there).
    ``panel_factor_shadow_cuda.launches`` counts the launches,
    ``.grid_route_launches`` those on the grid route,
    ``.grid_block_launches`` the blocks whose chain ran on the grid,
    ``.lookahead_chain_launches`` those whose chain took the look-ahead
    step on a cluster."""
    return _launch_micro(panel_factor_shadow_cuda, panel, pivot, micro, True, block, cluster,
                         _chain)


panel_factor_shadow_cuda.launches = 0
panel_factor_shadow_cuda.grid_route_launches = 0
panel_factor_shadow_cuda.grid_block_launches = 0
panel_factor_shadow_cuda.lookahead_chain_launches = 0
panel_factor_shadow_cuda.mbarrier_exchange_launches = 0
panel_factor_shadow_cuda.chain_launches_by_plan = {}


def panel_factor_basic_cuda(panel: torch.Tensor, pivot: bool, micro: int, *,
                            block: int = 0, cluster: int = 0, _chain: str = "auto"):
    """Launch the micro-blocked kernel of ``panel_variant='basic'``: as
    :func:`panel_factor_shadow_cuda`, the same cluster route, and on the
    grid route the grid-barrier kernel that reads and writes the current
    block in device memory.  ``panel_factor_basic_cuda.launches`` counts the
    launches, ``.grid_route_launches`` those on the grid route,
    ``.grid_block_launches`` the blocks whose chain ran on the grid,
    ``.lookahead_chain_launches`` those whose chain took the look-ahead
    step on a cluster."""
    return _launch_micro(panel_factor_basic_cuda, panel, pivot, micro, False, block, cluster,
                         _chain)


panel_factor_basic_cuda.launches = 0
panel_factor_basic_cuda.grid_route_launches = 0
panel_factor_basic_cuda.grid_block_launches = 0
panel_factor_basic_cuda.lookahead_chain_launches = 0
panel_factor_basic_cuda.mbarrier_exchange_launches = 0
panel_factor_basic_cuda.chain_launches_by_plan = {}


def panel_factor_noswap_cuda(panel: torch.Tensor, used0: torch.Tensor,
                             pivot: bool, *, live=None, block: int = 0,
                             cluster: int = 0):
    """Launch the physical-order kernel on the full-height ``panel`` in
    place: no row moves.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous.
    ``used0``: (m,) on the same device, nonzero where an earlier panel
    consumed the row; at least min(m, w) rows should be free (a step
    that finds none writes -1 and does nothing).  ``live``: how many rows
    ``used0`` leaves (None: m), which sizes the cluster route's slab; a
    mask that leaves more rows than the plan for ``live`` holds makes the
    launch fail at the next synchronisation (a trap on the card, which
    ends the process's CUDA context), never a result on part of the rows.
    ``block`` / ``cluster`` as for :func:`panel_factor_cuda` (``block=-1``:
    the grid route; see :func:`noswap_plan`).  Returns ``(prow, used,
    info)``: int32 (min(m, w),) pivot row of each step, int32 (m,) 0/1
    mask of the rows consumed so far, 0-d int32 info, all allocated
    here.  Computes ``unblocked_lu_noswap(panel, used0, pivot)`` bitwise.
    Launches on the current stream and does not synchronise.
    ``panel_factor_noswap_cuda.launches`` counts the launches,
    ``.grid_route_launches`` those on the grid route."""
    _check_block_cluster(block, cluster)
    if isinstance(panel, torch.Tensor) and panel.dim() == 2:
        live = _check_live(live, panel.shape[0])
    m, w, lda, index, real, size = _check_panel(
        "panel_factor_noswap_cuda", panel, _REAL)
    dev = panel.device
    if (not isinstance(used0, torch.Tensor) or used0.device != dev
            or used0.shape != (m,) or used0.dtype.is_floating_point
            or used0.dtype.is_complex):
        raise ValueError(
            f"used0 must be an integer or bool ({m},) tensor on {dev}")
    route, _, _, _, ws_reals, iws_ints = _noswap_plan(m, w, size, live, block, cluster, index)
    used0 = used0.to(torch.int32).contiguous()
    npiv = min(m, w)
    ints = torch.empty(npiv + m + 1 + iws_ints, dtype=torch.int32, device=dev)
    prow, used, info = ints[:npiv], ints[npiv:npiv + m], ints[npiv + m]
    ws = torch.empty(ws_reals, dtype=real, device=dev) if route == 0 else None
    lib = _kernels.load("panel_lu_noswap")
    fn = lib.rf_panel_lu_noswap_f32 if size == 4 else lib.rf_panel_lu_noswap_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    panel_factor_noswap_cuda.launches += 1
    if route == 0:
        panel_factor_noswap_cuda.grid_route_launches += 1
    code = fn(
        panel.data_ptr(), m, w, lda, int(bool(pivot)), live, block, cluster,
        used0.data_ptr(), used.data_ptr(), prow.data_ptr(), info.data_ptr(),
        None if ws is None else ws.data_ptr(), ints[npiv + m + 1:].data_ptr(), index, stream,
    )
    _kernels.check(lib, code, "panel_lu_noswap launch")
    return prow, used, info


panel_factor_noswap_cuda.launches = 0
panel_factor_noswap_cuda.grid_route_launches = 0


def panel_factor(
    panel: torch.Tensor, pivot: bool, config: LUConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor a panel (m x w) **in place**.  Returns ``(panel, piv_local,
    perm_local, info_local)``: the factored panel itself, 0-based
    panel-local pivot rows, the composed panel-local row permutation and
    the 1-based (sign-carrying) panel-local info."""
    m, w = panel.shape
    route = panel_route(m, w, panel.dtype, config, panel.device)
    if route == "kernel":
        cplx = panel.dtype.is_complex
        launch = panel_factor_c64_cuda if cplx else panel_factor_cuda
        piv, perm, info = launch(panel, pivot)
    elif route == "kernel-bf16x3":
        piv, perm, info = panel_factor_cuda(
            panel, pivot, block=config.resolved_panel_micro(), precision="bf16x3")
    elif route == "kernel-shadow":
        piv, perm, info = panel_factor_shadow_cuda(
            panel, pivot, config.resolved_panel_micro())
    elif route == "kernel-basic":
        piv, perm, info = panel_factor_basic_cuda(
            panel, pivot, config.resolved_panel_micro())
    else:
        if route == "micro-blocked":
            f, piv, perm, info = micro_blocked_lu(
                panel, pivot, config.resolved_panel_micro())
        elif route == "micro-blocked-bf16x3":
            f, piv, perm, info = micro_blocked_lu(
                panel, pivot, config.resolved_panel_micro(), "bf16x3")
        elif panel.dtype.is_complex:
            f, piv, perm, info = unblocked_lu_cabs1(panel, pivot)
        else:
            f, piv, perm, info = unblocked_lu(panel, pivot)
        panel.copy_(f)
    return panel, piv, perm, info


def panel_factor_noswap(panel: torch.Tensor, used0: torch.Tensor, pivot: bool,
                        live=None):
    """Factor the full-height real ``panel`` **in place** in physical row
    order, skipping the rows ``used0`` marks.  Returns ``(prow, used,
    info)``.  CUDA tensors launch csrc/panel_lu_noswap.cu (``live``, the
    rows ``used0`` leaves, sizes its plan; None: m), CPU tensors run
    ``unblocked_lu_noswap``."""
    if panel.device.type == "cuda":
        return panel_factor_noswap_cuda(panel, used0, pivot, live=live)
    _check_live(live, panel.shape[0])
    f, prow, used, info = unblocked_lu_noswap(panel, used0, pivot)
    panel.copy_(f)
    return prow, used, info


def offset_panel_route(device, config: LUConfig) -> str:
    """Which implementation runs the offset panel step on ``device``:
    ``"kernel"`` (CUDA: the offset kernel of csrc/panel_lu.cu, or for
    complex panels that of csrc/panel_lu_c64.cu) or ``"plain"`` (CPU:
    ``offset_panel_lu``, or ``offset_panel_lu_cabs1``).  ``config.tp_panel_backend``
    ``'auto'`` and ``'pallas'`` mean the kernel on CUDA; ``'jax'`` names
    the plain version, which runs on the CPU only, and raises for CUDA, as
    ``backend='xla'`` does in :func:`panel_route`."""
    backend = config.resolved_tp_panel_backend()
    if torch.device(device).type != "cuda":
        return "plain"
    if backend == "jax":
        raise ValueError(
            "tp_panel_backend='jax' selects the plain panel, which runs only "
            "on CPU tensors")
    return "kernel"


def offset_panel_factor(panel: torch.Tensor, ofs: int, pivot: bool, config: LUConfig):
    """Factor the full-height panel from row ``ofs`` **in place** (the
    panel step of the tensor-parallel LU).  Returns ``(panel, piv, perm,
    info)`` as :func:`offset_panel_factor_cuda` describes them; the route
    is :func:`offset_panel_route`'s."""
    cplx = panel.is_complex()
    if offset_panel_route(panel.device, config) == "kernel":
        launch = offset_panel_factor_c64_cuda if cplx else offset_panel_factor_cuda
        piv, perm, info = launch(panel, ofs, pivot)
        return panel, piv, perm, info
    plain = offset_panel_lu_cabs1 if cplx else offset_panel_lu
    f, piv, perm, info = plain(panel, ofs, pivot)
    panel.copy_(f)
    return panel, piv, perm, info
