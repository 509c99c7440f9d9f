"""Configuration of the LU schedule, the device rule and the precision context.

The field names are those of the JAX package's ``LUConfig``, so that a
configuration crosses between the two packages as a plain mapping
(:func:`config_from_mapping`).  The TPU package's constants (the XLA
delegation crossover, the VMEM budgets, the micro-64 band, the bf16x3
size gates) are facts of the TPU and its compiler and are not carried
over: on the H100 every ``'auto'`` knob resolves to the full-precision,
no-delegation choice, and the routing widths come from measurements on
the card (``PERF.md``, ``chip_smoke.py``).  Complex matrices use the
same ``panel_width`` and ``small_threshold`` as real ones; the TPU
package's complex64 window (its delegation crossover and native ceiling)
is not carried over either.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Optional

import torch

# Routing defaults from chip_smoke.py's sweep on an H100 (PERF.md): 512-wide
# panels were the fastest blocked schedule at n = 1024..4096 of the widths
# 64..512, and the whole-matrix route lost to it at every n >= 1024, so
# the whole route covers only the sizes one panel spans anyway.
DEFAULT_PANEL_WIDTH = 512
DEFAULT_SMALL_THRESHOLD = 512

# Matrices of these types are factored as their float32 copies (the
# ``promote`` route), and solves with their factors run in float32.
HALF_DTYPES = (torch.bfloat16, torch.float16)

# Variants of the TPU panel kernel that csrc/panel_lu.cu stands for, and
# the micro-blocked ones of csrc/panel_lu_micro.cu.
FORI_VARIANTS = ("fori", "fori2", "fori3")
MICRO_VARIANTS = ("shadow", "basic")

# What ``panel_micro='auto'`` means for the micro-blocked kernels (the
# width of the block whose trailing update is delayed).  From
# chip_smoke.py's ``--sweep`` over 8/16/32/64 on an H100 (PERF.md).
DEFAULT_PANEL_MICRO = 32
# The widest block they take (kMicroMax of csrc/panel_lu_micro.cu, which
# exports it as ``rf_panel_lu_micro_max``; the launcher holds the two
# together).  The limit is checked on both devices, so that one
# configuration factors on both or on neither.
PANEL_MICRO_MAX = 64


@dataclasses.dataclass(frozen=True)
class LUConfig:
    """Configuration of the LU schedule (same field names as the JAX one).

    * ``panel_width``: panel width of the blocked schedule; None means
      ``DEFAULT_PANEL_WIDTH``.
    * ``small_threshold``: min(m, n) at or below which one whole-matrix
      panel-kernel call factors a tall or square matrix.
    * ``schur_precision``: ``'float32'`` (TF32 off), ``'bf16x3'`` (the
      hand split ``ah@bh + ah@bl + al@bh``), ``'bf16'`` (one bf16
      product, f32 accumulation); ``'auto'`` means ``'float32'``.
    * ``backend``: ``'auto'``/``'pallas'`` run the panel kernel; ``'xla'``
      runs the plain panel (the CPU route; on CUDA tensors it raises).
    * ``trsm_block``: block size of the blocked triangular solves.
    * ``panel_variant``: ``'fori'``, ``'fori2'`` and ``'fori3'`` run the
      unblocked kernel (csrc/panel_lu.cu computes the same function for
      all three); ``'shadow'`` and ``'basic'`` run the micro-blocked
      kernels of csrc/panel_lu_micro.cu (rank-1 updates inside a
      ``panel_micro``-wide block, one delayed update of the trailing
      columns per block), staged in shared memory or in place.  Complex
      panels have one kernel and ignore the variant.
    * ``blocked_panel_variant``: the variant of the blocked schedule's
      panels; None means ``panel_variant``.
    * ``panel_micro``: block width of the micro-blocked kernels; an int
      from 1 to ``PANEL_MICRO_MAX`` (64) is taken as given, a larger one
      raises on either device; ``'auto'`` means ``DEFAULT_PANEL_MICRO``.
      The fori variants ignore it.
    * ``inner_panel_width``, ``panel_outer``, ``panel_unroll``,
      ``tp_panel_backend``: kept for the mapping's sake; they shaped the
      TPU kernels' blocking and the Hopper kernels ignore them.
    * ``panel_boundary_precision``: ``'auto'``/``'float32'``; ``'bf16x3'``
      raises until a blocked kernel has boundary matmuls.
    * ``xla_threshold``: ``'auto'``/None never delegate; an int routes
      pivoted factorizations with min(m, n) at or below it to
      ``torch.linalg.lu_factor_ex``.
    * ``schedule``: ``'swap'`` moves rows into pivot order as it goes;
      ``'physical'`` (f32/f64, m >= n) never moves a row until one final
      gather: the no-swap panel kernel (csrc/panel_lu_noswap.cu) and
      full-height masked trailing updates.  Its ``ipiv`` is the sequence
      of pivot rows (the prefix of ``perm``), not a swap sequence.
    * ``tail_threshold``: finish the blocked schedule in one whole-block
      call once the trailing block is this narrow; ``'auto'``/None off.
    """

    panel_width: Optional[int] = None
    small_threshold: int = DEFAULT_SMALL_THRESHOLD
    schur_precision: str = "auto"
    backend: str = "auto"
    trsm_block: int = 128
    inner_panel_width: int = 256
    panel_micro: Any = "auto"
    panel_variant: str = "fori3"
    panel_outer: int = 256
    tp_panel_backend: str = "auto"
    panel_boundary_precision: str = "auto"
    panel_unroll: int = 2
    blocked_panel_variant: Optional[str] = None
    xla_threshold: Any = "auto"
    schedule: str = "swap"
    tail_threshold: Any = "auto"

    def resolved_tail_threshold(self) -> Optional[int]:
        if self.tail_threshold == "auto":
            return None
        return self.tail_threshold

    def resolved_schur_precision(self) -> str:
        if self.schur_precision == "auto":
            return "float32"
        if self.schur_precision not in ("float32", "bf16x3", "bf16"):
            raise ValueError(
                f"unknown schur_precision {self.schur_precision!r}"
            )
        return self.schur_precision

    def resolved_panel_boundary_precision(self) -> str:
        bp = self.panel_boundary_precision
        if bp in ("auto", "float32"):
            return "float32"
        if bp == "bf16x3":
            raise NotImplementedError(
                "panel_boundary_precision='bf16x3' splits the boundary "
                "matmuls of the fori kernels (ROADMAP.md Queue 1 item 15); "
                "the Hopper fori kernel is unblocked and has none"
            )
        raise ValueError(f"unknown panel_boundary_precision {bp!r}")

    def resolved_xla_threshold(self) -> Optional[int]:
        if self.xla_threshold == "auto":
            return None
        return self.xla_threshold

    def resolved_panel_width(self) -> int:
        if self.panel_width is None:
            return DEFAULT_PANEL_WIDTH
        return self.panel_width

    def resolved_panel_micro(self) -> int:
        if self.panel_micro == "auto":
            return DEFAULT_PANEL_MICRO
        if not isinstance(self.panel_micro, int) or self.panel_micro < 1:
            raise ValueError(
                f"panel_micro must be 'auto' or a positive int, got "
                f"{self.panel_micro!r}"
            )
        if self.panel_micro > PANEL_MICRO_MAX:
            raise ValueError(
                f"panel_micro is at most {PANEL_MICRO_MAX} (the widest block "
                f"of the micro-blocked kernels), got {self.panel_micro}"
            )
        return self.panel_micro

    def resolved_blocked_variant(self) -> str:
        return self.blocked_panel_variant or self.panel_variant

    def check_variants(self) -> None:
        """Raise for an unknown panel variant (whole-matrix or blocked)."""
        known = FORI_VARIANTS + MICRO_VARIANTS
        for variant in (self.panel_variant, self.blocked_panel_variant):
            if variant is not None and variant not in known:
                raise ValueError(
                    f"unknown panel variant {variant!r}; use one of "
                    + ", ".join(known)
                )


def default_config() -> LUConfig:
    return LUConfig()


def config_from_mapping(d: Mapping[str, Any]) -> LUConfig:
    """Build an :class:`LUConfig` from a mapping of field names, such as
    ``dataclasses.asdict`` of the JAX package's config.  Unknown keys
    raise ``ValueError``."""
    names = {f.name for f in dataclasses.fields(LUConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown LUConfig fields: {unknown}")
    return LUConfig(**dict(d))


@contextlib.contextmanager
def full_matmul_precision():
    """Run the block with TF32 off for CUDA matmuls and convolutions,
    restoring the caller's settings afterwards.

    The port's accuracy contract is ~n*eps(f32); a TF32 product keeps
    about three decimal digits.  The setting governs complex64 products
    as well (cuBLAS may run them in TF32 when it is allowed).  The deliberate reduced modes are the
    explicit ``schur_precision`` knobs (ops/schur.py), which build their
    bf16 operands by hand."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def resolve_device(device=None) -> torch.device:
    """The device of a public entry point: ``None`` means CUDA, and raises
    when CUDA is absent; the CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
