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
by an explicit ``block`` (``block=-1``: the grid route).  Every wrapper
launches through one path (``_launch``) and keeps its counts in
``wrapper.counts`` (:class:`LaunchCounts`; :func:`reset_counts` zeroes every
wrapper's): its launches, those on the grid route, the blocks whose chain
ran on the grid, the chain launches that took the look-ahead step and the
mbarrier exchange on a cluster of more than one CTA, those that took the
previous block's delayed pass at load (the rest of it running beside them),
and every chain launch on a cluster by its plan (a dict keyed (dtype name, b, C)), so a run shows
which rule of csrc/panel_cluster.cuh's ``Auto<T>`` its chains took.  The
blocked forms' private ``_chain='grid'`` puts every block's chain on the
grid, to hold the grid chain against the cluster chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from ..utils.config import DEFAULT_PANEL_MICRO, FORI_VARIANTS, PANEL_MICRO_MAX, LUConfig
from . import _counts, _kernels
from ._counts import device_index as _device_index
from ._counts import reset_counts  # noqa: F401  (ops.panel.reset_counts, its callers' name)
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
# the suffix of each dtype's entry points
_KIND = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
         torch.complex128: "c128"}


@dataclasses.dataclass
class LaunchCounts:
    """What one panel wrapper launched since the last :func:`reset_counts`
    (``wrapper.counts``): ``launches``; those on the grid route
    (``grid_route_launches``); the blocks whose chain ran on the grid
    (``grid_block_launches``); the chain launches on a cluster of C > 1,
    each of which takes the look-ahead step and the mbarrier exchange
    (``lookahead_chain_launches``); the chain launches that took the
    previous block's delayed pass in their own columns at load while the
    rest of that pass ran beside them (``carried_update_launches``); every
    chain launch on a cluster by its plan (``chain_launches_by_plan``,
    ``{(dtype name, b, C): launches}``);
    of :func:`panel_factor_cuda`, the bf16x3 form's launches, the update
    kernels they issued and those on the simple kernel (``bf16x3_*``); of
    :func:`panel_update_bf16x3_cuda`, the launches on the simple kernel
    (``simple_launches``).  A count no kernel of the wrapper takes stays
    0."""

    launches: int = 0
    grid_route_launches: int = 0
    grid_block_launches: int = 0
    lookahead_chain_launches: int = 0
    carried_update_launches: int = 0
    chain_launches_by_plan: dict = dataclasses.field(default_factory=dict)
    bf16x3_launches: int = 0
    bf16x3_update_launches: int = 0
    bf16x3_simple_update_launches: int = 0
    simple_launches: int = 0


def _counted(wrapper):
    """Give ``wrapper`` its :class:`LaunchCounts`, which
    :func:`reset_counts` zeroes."""
    return _counts.counted(wrapper, LaunchCounts)


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


def _call_plan(lib, fn, *args):
    """The plan ``fn`` of library ``lib`` makes for ``args``: a tuple of
    ``_kernels.PLAN_INTS`` ints (route, b, C or G, blocks, ws reals, iws
    int32s, blocks whose chain runs on the grid; csrc/panel_cluster.cuh
    ``write_plan``).  The callers cache it: a plan is a function of its
    arguments on one card."""
    library = _kernels.load(lib)
    out = (ctypes.c_int * _kernels.PLAN_INTS)()
    _kernels.check(library, getattr(library, fn)(*args, out), f"{lib} plan")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _plan(cplx, m, w, size, ofs, block, cluster, index):
    """The plan of csrc/panel_lu.cu (``cplx`` False) or csrc/panel_lu_c64.cu;
    ``size`` is the element's bytes, ``ofs`` None for the main-path
    kernel."""
    fn = ("rf_panel_lu" if ofs is None else "rf_offset_panel_lu") + ("_c_plan" if cplx else "_plan")
    return _call_plan("panel_lu_c64" if cplx else "panel_lu", fn, m, w, size, ofs or 0, block,
                      cluster, index)


def _plan_dict(plan) -> dict:
    route, b, c, blocks, ws, iws, grid_blocks = plan
    cluster = route == 1
    return {"route": "cluster" if cluster else "grid",
            "block": b if cluster else None, "cluster": c if cluster else None,
            "grid": None if cluster else c, "blocks": blocks,
            "ws_reals": ws, "iws_ints": iws, "grid_blocks": grid_blocks}


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
    "iws_ints"`` (workspace sizes), ``"grid_blocks"}`` (0 here: the blocks
    whose chain runs on the grid, in the blocked forms).  ``block`` and
    ``cluster`` 0 ask for the launcher's choice (what the main path runs);
    ``block < 0`` forces the grid route and ``block >= w`` one block.
    Raises ValueError for a dtype the kernels do not take, RuntimeError for
    an offset outside [0, m - w] and where the card cannot run an explicit
    choice."""
    if dtype not in _REAL + _COMPLEX:
        raise ValueError(
            f"panel dtype must be float32/float64/complex64/complex128, got {dtype}")
    _check_block_cluster(block, cluster)
    size = torch.empty((), dtype=dtype).element_size()
    return _plan_dict(_plan(dtype in _COMPLEX, m, w, size, ofs, block, cluster,
                            _device_index(device)))


@functools.lru_cache(maxsize=256)
def _micro_plan(m, w, size, micro, shadow, block, cluster, chain, index):
    """The plan of csrc/panel_lu_micro.cu."""
    return _call_plan("panel_lu_micro", "rf_panel_lu_micro_plan", m, w, size, micro,
                      int(shadow), block, cluster, chain, index)


@functools.lru_cache(maxsize=256)
def _noswap_plan(m, w, size, live, block, cluster, index):
    """The plan of csrc/panel_lu_noswap.cu."""
    return _call_plan("panel_lu_noswap", "rf_panel_lu_noswap_plan", m, w, size, live, block,
                      cluster, index)


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


def _cut_micro(micro, block, m, w):
    """``micro`` cut to min(m, w) (one block spans the whole panel); the
    grid route (block=-1) takes blocks of at most PANEL_MICRO_MAX steps."""
    micro = min(micro, m, w)
    if block < 0 and micro > PANEL_MICRO_MAX:
        raise ValueError(f"the micro-blocked kernels' grid route (block=-1) takes blocks of "
                         f"at most {PANEL_MICRO_MAX} steps, got micro={micro}; the cluster "
                         f"route (block=0) takes any")
    return micro


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
    micro = _cut_micro(micro, block, m, w)
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


def _launch(wrapper, panel, pivot, dtypes, lib, prefix, plan_of, ofs=0):
    """The launch path of every panel wrapper: checks ``panel`` (one of
    ``dtypes``), takes the cached plan and the family's own arguments from
    ``plan_of(m, w, device index)``, allocates piv, perm, info and the
    integer workspace in one int32 tensor (and the real workspace on the
    grid route), calls ``{prefix}_{dtype}`` of library ``lib``, adds the
    launch and its PanelStats to ``wrapper.counts``, raises on the returned
    code and counts the cluster chain launches by plan.  A tensor among the
    own arguments goes as its pointer and lives until the call returns.
    ``ofs``: the offset kernel's first row (min(m - ofs, w) pivots).
    Returns ``(piv, perm, info, stats)``."""
    m, w, lda, index, real, _ = _check_panel(wrapper.__name__, panel, dtypes)
    plan, own = plan_of(m, w, index)
    route, b, c, blocks, ws_reals, iws_ints, _ = plan
    dev = panel.device
    npiv = min(m - ofs, w)
    ints = torch.empty(npiv + m + 1 + iws_ints, dtype=torch.int32, device=dev)
    ws = torch.empty(ws_reals, dtype=real, device=dev) if route == 0 else None
    library = _kernels.load(lib)
    stats = _kernels.PanelStats()
    counts = wrapper.counts
    counts.launches += 1
    counts.grid_route_launches += int(route == 0)
    code = getattr(library, f"{prefix}_{_KIND[panel.dtype]}")(
        panel.data_ptr(), m, w, lda, int(bool(pivot)),
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in own),
        ints.data_ptr(), ints[npiv:].data_ptr(), ints[npiv + m:].data_ptr(),
        None if ws is None else ws.data_ptr(), ints[npiv + m + 1:].data_ptr(),
        ctypes.byref(stats), index, torch.cuda.current_stream(dev).cuda_stream,
    )
    counts.grid_block_launches += stats.grid_blocks
    counts.lookahead_chain_launches += stats.lookaheads
    counts.carried_update_launches += stats.carried
    _kernels.check(library, code, f"{lib} launch")
    chains = blocks - stats.grid_blocks
    if route == 1 and c > 0 and chains > 0:
        key = (str(panel.dtype)[6:], b, c)
        counts.chain_launches_by_plan[key] = counts.chain_launches_by_plan.get(key, 0) + chains
    return ints[:npiv], ints[npiv:npiv + m], ints[npiv + m], stats


def _launch_panel_lu(wrapper, panel, pivot, ofs, block, cluster, dtypes=_REAL):
    """:func:`_launch` of csrc/panel_lu.cu (the offset kernel unless ``ofs``
    is None) or, for ``dtypes`` ``_COMPLEX``, csrc/panel_lu_c64.cu."""
    cplx = dtypes is _COMPLEX

    def plan_of(m, w, index):
        if ofs is not None and (not isinstance(ofs, int) or isinstance(ofs, bool)
                                or not 0 <= ofs <= m - w):
            raise ValueError(f"offset {ofs!r} outside [0, {m - w}] for a {m} x {w} panel")
        _check_block_cluster(block, cluster)
        plan = _plan(cplx, m, w, panel.element_size(), ofs, block, cluster, index)
        return plan, (() if ofs is None else (ofs,)) + (block, cluster)

    lib = "panel_lu_c64" if cplx else "panel_lu"
    prefix = "rf_panel_lu" if ofs is None else "rf_offset_panel_lu"
    return _launch(wrapper, panel, pivot, dtypes, lib, prefix, plan_of, ofs or 0)[:3]


@functools.lru_cache(maxsize=256)
def _bf16x3_plan(m, w, b, cluster, chain, index):
    """The plan of csrc/panel_lu.cu's bf16x3 form."""
    return _call_plan("panel_lu", "rf_panel_lu_bf16x3_plan", m, w, b, cluster, chain, index)


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
    """:func:`_launch` of csrc/panel_lu.cu's bf16x3 form, for
    :func:`panel_factor_cuda`."""
    _check_block_cluster(block, cluster)
    if update not in BF16X3_UPDATES:
        raise ValueError(f"_update must be one of {BF16X3_UPDATES}, got {update!r}")
    chain = _check_chain(chain)

    def plan_of(m, w, index):
        b = _bf16x3_block(block, m, w)
        return (_bf16x3_plan(m, w, b, cluster, chain, index),
                (b, cluster, int(update == "simple"), chain))

    piv, perm, info, stats = _launch(panel_factor_cuda, panel, pivot, (torch.float32,),
                                     "panel_lu", "rf_panel_lu_bf16x3", plan_of)
    # one update per block boundary with rows and columns below and right of
    # the block (bf16x3_updates)
    counts = panel_factor_cuda.counts
    counts.bf16x3_launches += 1
    counts.bf16x3_update_launches += stats.updates
    if update == "simple":
        counts.bf16x3_simple_update_launches += stats.updates
    return piv, perm, info


@_counted
def panel_factor_cuda(panel: torch.Tensor, pivot: bool, *, block: int = 0,
                      cluster: int = 0, precision: str = "float32",
                      _update: str = "tiled", _chain: str = "auto"):
    """Launch the Hopper panel kernel on ``panel`` in place.

    ``panel``: CUDA, float32 or float64, 2-D, rows contiguous (unit
    column stride, row stride >= w, as for a column block of a row-major
    matrix).  Returns ``(piv, perm, info)``: int32 (min(m, w),) 0-based
    pivot rows, int32 (m,) composed row permutation and a 0-d int32
    info, all on ``panel``'s device, allocated here.  Launches on the
    current stream and does not synchronise (most of each block's delayed
    pass runs on a side stream beside the next block's chain, joined back
    into the current stream before the call returns).  ``block`` / ``cluster``
    pick the cluster route's block width and cluster size (0: the
    launcher's choice; see :func:`panel_plan`).  ``.counts``
    (:class:`LaunchCounts`) counts the launches, those on the grid route
    (panels too tall for a cluster) and the chain launches.

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
    bit for bit the same result, for comparison.  ``.counts.bf16x3_*``
    count these launches (``.counts.launches`` counts them too), the update
    kernels they issued and those on the simple kernel."""
    if precision == "bf16x3":
        return _launch_bf16x3(panel, pivot, block, cluster, _update, _chain)
    if _chain != "auto":
        raise ValueError("_chain applies to precision='bf16x3' (the float32 form has no "
                         "grid chain: its tall panels take the grid route)")
    if precision != "float32":
        raise ValueError(f"precision must be 'float32' or 'bf16x3', got {precision!r}")
    return _launch_panel_lu(panel_factor_cuda, panel, pivot, None, block, cluster)


def _rows_stride(t):
    """The row stride of a 2-D tensor whose rows are contiguous."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


@_counted
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
    and does not synchronise.  ``panel_update_bf16x3_cuda.counts`` counts
    the launches and those on the simple kernel (``.simple_launches``)."""
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
    counts = panel_update_bf16x3_cuda.counts
    counts.launches += 1
    counts.simple_launches += int(_update == "simple")
    code = lib.rf_panel_update_bf16x3_f32(
        L.data_ptr(), _rows_stride(L), U.data_ptr(), _rows_stride(U), C.data_ptr(),
        _rows_stride(C), rows, cols, nb, int(_update == "simple"), index, stream)
    _kernels.check(lib, code, "panel_lu bf16x3 update")
    return C


@_counted
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
    for :func:`panel_factor_cuda`, and so is ``.counts``."""
    return _launch_panel_lu(offset_panel_factor_cuda, panel, pivot, ofs, block, cluster)


@_counted
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
    (0: the launcher's choice; ``block < 0``: the grid route), and so is
    ``.counts``."""
    return _launch_panel_lu(panel_factor_c64_cuda, panel, pivot, None, block, cluster,
                            _COMPLEX)


@_counted
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
    for :func:`panel_factor_cuda` (``block=-1``: the grid route), and so is
    ``.counts``."""
    return _launch_panel_lu(offset_panel_factor_c64_cuda, panel, pivot, ofs, block, cluster,
                            _COMPLEX)


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
    """:func:`_launch` of the two micro-blocked kernels."""
    chain = _check_micro_request(micro, block, cluster, chain)

    def plan_of(m, w, index):
        mc = _cut_micro(micro, block, m, w)
        plan = _micro_plan(m, w, panel.element_size(), mc, shadow, block, cluster, chain, index)
        return plan, (mc, block, cluster, chain)

    prefix = "rf_panel_lu_shadow" if shadow else "rf_panel_lu_basic"
    return _launch(wrapper, panel, pivot, _REAL, "panel_lu_micro", prefix, plan_of)[:3]


@_counted
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
    ``.counts`` as for :func:`panel_factor_cuda`."""
    return _launch_micro(panel_factor_shadow_cuda, panel, pivot, micro, True, block, cluster,
                         _chain)


@_counted
def panel_factor_basic_cuda(panel: torch.Tensor, pivot: bool, micro: int, *,
                            block: int = 0, cluster: int = 0, _chain: str = "auto"):
    """Launch the micro-blocked kernel of ``panel_variant='basic'``: as
    :func:`panel_factor_shadow_cuda`, the same cluster route, and on the
    grid route the grid-barrier kernel that reads and writes the current
    block in device memory.  ``.counts`` as for :func:`panel_factor_cuda`."""
    return _launch_micro(panel_factor_basic_cuda, panel, pivot, micro, False, block, cluster,
                         _chain)


@_counted
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
    ``.counts`` counts the launches and those on the grid route."""
    _check_block_cluster(block, cluster)
    if isinstance(panel, torch.Tensor) and panel.dim() == 2:
        live = _check_live(live, panel.shape[0])

    def plan_of(m, w, index):
        if (not isinstance(used0, torch.Tensor) or used0.device != panel.device
                or used0.shape != (m,) or used0.dtype.is_floating_point
                or used0.dtype.is_complex):
            raise ValueError(f"used0 must be an integer or bool ({m},) tensor on "
                             f"{panel.device}")
        plan = _noswap_plan(m, w, panel.element_size(), live, block, cluster, index)
        return plan, (live, block, cluster, used0.to(torch.int32).contiguous())

    return _launch(panel_factor_noswap_cuda, panel, pivot, _REAL, "panel_lu_noswap",
                   "rf_panel_lu_noswap", plan_of)[:3]


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
