"""Public LU API: ``lu``, ``lu_factor``, ``lu_factor_p``, ``lu_inplace``.

The PyTorch counterpart of the JAX package's models/lu.py, with the same
conventions: ``ipiv`` is the 0-based swap sequence, ``perm`` the composed
row permutation (``L @ U == A[perm, :]``), ``info`` 0 on success or the
1-based first zero-pivot step, negative on the no-pivot path.  Under
``LUConfig(schedule='physical')`` ``ipiv`` is instead the sequence of
pivot rows, the prefix of ``perm``; solves, ``det`` and ``inv`` go by
``perm`` on every route.

Device rule: every entry point takes ``device=None``, which means CUDA
and raises when CUDA is absent.  The CPU runs only with ``device='cpu'``.
There is no tracing, so ``check='auto'`` always checks.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.blocked import blocked_lu, blocked_lu_physical
from ..ops.panel import panel_factor
from ..utils.config import (
    HALF_DTYPES,
    LUConfig,
    default_config,
    full_matmul_precision,
    resolve_device,
)
from ..utils.perm import ipiv_to_perm, perm_to_matrix


class SingularMatrixError(Exception):
    """Raised by ``check`` when the factorization hit an exactly-zero
    pivot (the analog of ``LinearAlgebra.checknonsingular``)."""


def normalize_pivot(pivot) -> bool:
    """Normalize the pivot selector: bool, None (no pivoting), or the
    strings 'partial'/'rowmaximum' (pivoted) and 'none'/'nopivot'."""
    if isinstance(pivot, bool):
        return pivot
    if pivot is None:
        return False
    if isinstance(pivot, str):
        key = pivot.replace("_", "").lower()
        if key in ("partial", "row", "rowmaximum", "rowmax"):
            return True
        if key in ("none", "nopivot", "no"):
            return False
    raise ValueError(
        f"unrecognized pivot selector {pivot!r}; use True/False, None, "
        "'partial'/'rowmaximum', or 'none'/'nopivot'"
    )


@dataclasses.dataclass(frozen=True)
class LU:
    """LU factorization result.

    ``factors`` packs unit-lower L and upper U; ``ipiv`` is the 0-based
    swap sequence (min(m, n),); ``info`` a 0-d int32 tensor; ``perm`` the
    composed row permutation, or None to recompose it from ``ipiv``."""

    factors: torch.Tensor
    ipiv: torch.Tensor
    info: torch.Tensor
    pivoted: bool = True
    perm: Optional[torch.Tensor] = None

    @classmethod
    def from_numpy(cls, factors, ipiv, info, perm=None, pivoted=True,
                   device=None) -> "LU":
        """Build an ``LU`` from numpy arrays (for example the JAX package's
        factorization), on ``device`` (None means CUDA).

        Without ``perm`` the permutation is recomposed from ``ipiv`` as a
        swap sequence.  A factorization made under ``schedule='physical'``
        therefore needs its ``perm``: its ``ipiv`` is the sequence of
        pivot rows (``prow``), the prefix of ``perm`` and, for a square
        matrix, the whole of it, so that ``perm=ipiv`` is enough there."""
        dev = resolve_device(device)
        return cls(
            torch.as_tensor(np.array(factors), device=dev),
            torch.as_tensor(np.array(ipiv, dtype=np.int32), device=dev),
            torch.as_tensor(np.array(info, dtype=np.int32), device=dev),
            pivoted=bool(pivoted),
            perm=None if perm is None else torch.as_tensor(
                np.array(perm, dtype=np.int32), device=dev
            ),
        )

    @property
    def shape(self):
        return self.factors.shape

    @property
    def L(self) -> torch.Tensor:
        m, n = self.factors.shape
        k = min(m, n)
        eye = torch.eye(m, k, dtype=self.factors.dtype, device=self.factors.device)
        return torch.tril(self.factors[:, :k], diagonal=-1) + eye

    @property
    def U(self) -> torch.Tensor:
        m, n = self.factors.shape
        return torch.triu(self.factors[: min(m, n), :])

    @property
    def p(self) -> torch.Tensor:
        """Row permutation vector: ``L @ U == A[p, :]`` (0-based)."""
        if self.perm is not None:
            return self.perm
        return ipiv_to_perm(self.ipiv, self.factors.shape[0])

    @property
    def P(self) -> torch.Tensor:
        """Dense permutation matrix with ``P @ A == L @ U``."""
        return perm_to_matrix(self.p, self.factors.dtype)

    def solve(self, b, trans=0) -> torch.Tensor:
        """Solve ``A x = b`` (``trans`` 0/'N'), ``A^T x = b`` (1/'T') or
        ``A^H x = b`` (2/'H')."""
        from .solve import lu_solve

        return lu_solve(self, b, trans=trans)

    def _perm_sign(self) -> torch.Tensor:
        """Sign of the row permutation, (-1)^(n - #cycles) of ``p``."""
        p = self.p.detach().to("cpu", torch.int64).numpy()
        seen = np.zeros(p.shape[0], dtype=bool)
        cycles = 0
        for i in range(p.shape[0]):
            if not seen[i]:
                cycles += 1
                j = i
                while not seen[j]:
                    seen[j] = True
                    j = p[j]
        odd = (p.shape[0] - cycles) % 2 != 0
        return torch.tensor(-1.0 if odd else 1.0, dtype=self.factors.dtype,
                            device=self.factors.device)

    def det(self) -> torch.Tensor:
        """Determinant: prod(diag(U)) * sign(P)."""
        m, n = self.factors.shape
        if m != n:
            raise ValueError("det requires a square factorization")
        return torch.prod(torch.diagonal(self.factors)) * self._perm_sign()

    def logabsdet(self):
        """Returns ``(log|det A|, sign(det A))``, overflow-safe."""
        m, n = self.factors.shape
        if m != n:
            raise ValueError("logabsdet requires a square factorization")
        diag = torch.diagonal(self.factors)
        logabs = torch.sum(torch.log(torch.abs(diag)))
        # torch.sgn is z/|z| for complex (torch.sign rejects complex)
        sign = torch.prod(torch.sgn(diag)) * self._perm_sign()
        return logabs, sign

    def inv(self) -> torch.Tensor:
        """A^{-1} by solving against the identity."""
        from .solve import lu_solve

        n = self.factors.shape[0]
        eye = torch.eye(n, dtype=self.factors.dtype, device=self.factors.device)
        return lu_solve(self, eye)


def from_numpy(factors, ipiv, info, perm=None, pivoted=True, device=None) -> LU:
    """A factorization held in numpy arrays (for example one made by the
    JAX package, complex included) as an :class:`LU` on ``device`` (None
    means CUDA), ready for ``lu_solve``.  One made under
    ``schedule='physical'`` needs its ``perm`` (for a square matrix its
    ``ipiv``, the pivot rows, is that ``perm``).  The single-matrix twin
    of :func:`batched_from_numpy`."""
    return LU.from_numpy(factors, ipiv, info, perm=perm, pivoted=pivoted,
                         device=device)


def batched_from_numpy(factors, ipiv_or_perm, info, device=None):
    """A batched factorization held in numpy arrays (for example one made
    by the JAX package) as tensors on ``device`` (None means CUDA):
    ``(factors (B, m, n), ipiv or perm int32, info int32)``, ready for
    ``batched_lu_solve`` or ``batched_lu_solve_perm``."""
    dev = resolve_device(device)
    return (
        torch.as_tensor(np.array(factors), device=dev),
        torch.as_tensor(np.array(ipiv_or_perm, dtype=np.int32), device=dev),
        torch.as_tensor(np.array(info, dtype=np.int32), device=dev),
    )


_FAST = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def dispatch_route(shape, dtype, pivot: bool = True,
                   config: Optional[LUConfig] = None) -> str:
    """Which path :func:`lu_factor` takes for a matrix of this
    ``(shape, dtype, pivot, config)``:

    * ``"promote"``: bfloat16/float16 -- the float32 copy is factored by
      the route of its own shape, and the factors are cast back;
    * ``"xla"``: ``torch.linalg.lu_factor_ex`` (only with an explicit int
      ``xla_threshold``, pivoted, min(m, n) at or below it);
    * ``"whole"``: one whole-matrix panel call (m >= n, min(m, n) <=
      ``small_threshold``);
    * ``"blocked"``: the blocked right-looking schedule;
    * ``"physical"``: the physical-order blocked schedule
      (``schedule='physical'``, float32/float64, m >= n, any size; half
      matrices reach it promoted).  Fat matrices fall through to the swap
      schedule, as in the JAX package, and so do complex ones: the
      no-swap kernel is real, as the TPU's is float32;
    * ``"generic"``: integer and other types, which raise
      ``NotImplementedError`` until they are ported.

    Complex matrices take ``"whole"`` / ``"blocked"`` by the same rule as
    real ones (the JAX package's ``"complex-unblocked"`` /
    ``"complex-blocked"`` and its native c64 window): the panel layer
    picks the complex kernel on the card and its plain version on the
    CPU, and both pivot by CABS1."""
    m, n = shape
    minmn = min(m, n)
    config = config or default_config()
    if dtype in HALF_DTYPES:
        return "promote"
    if dtype not in _FAST:
        return "generic"
    if minmn == 0:
        return "whole"
    thresh = config.resolved_xla_threshold()
    if thresh is not None and pivot and minmn <= thresh:
        return "xla"
    if config.schedule not in ("swap", "physical"):
        raise ValueError(f"unknown schedule {config.schedule!r}")
    if config.schedule == "physical" and m >= n and not dtype.is_complex:
        return "physical"
    if minmn <= config.small_threshold and m >= n:
        return "whole"
    return "blocked"


# the ROADMAP.md item that will port each deferred route
_DEFERRED = {
    "generic": "Queue 1 item 14 (integer and generic dtypes)",
}


def _empty_factorization(A):
    m, n = A.shape
    dev = A.device
    return (
        A,
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.arange(m, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )


def _dispatch_factor(A: torch.Tensor, pivot: bool, config: LUConfig):
    """Factor ``A`` **in place**. Returns ``(factors, ipiv, perm, info)``
    where ``factors`` is ``A`` itself."""
    if config.schur_precision == "bf16":
        warnings.warn(
            "schur_precision='bf16' (single-pass) loses ~3 decimal "
            "digits in the factors; pair it with lu_solve_refined, or "
            "use 'bf16x3' for near-f32 accuracy at most of the speedup",
            stacklevel=3,
        )
    config.resolved_panel_boundary_precision()
    config.check_variants()
    return _factor_by_route(A, pivot, config)


def _factor_by_route(A: torch.Tensor, pivot: bool, config: LUConfig):
    route = dispatch_route(A.shape, A.dtype, pivot, config)
    if route in _DEFERRED:
        raise NotImplementedError(
            f"route {route!r} for {A.dtype} is not ported yet: ROADMAP.md "
            f"{_DEFERRED[route]}"
        )
    if route == "promote":
        # Half inputs: factor the exact float32 promotion, round the
        # factors back.  ipiv, perm and info are those of the float32 run.
        f, ipiv, perm, info = _factor_by_route(A.float(), pivot, config)
        A.copy_(f)
        return A, ipiv, perm, info
    with full_matmul_precision():
        if min(A.shape) == 0:
            return _empty_factorization(A)
        if route == "xla":
            LUf, piv, linfo = torch.linalg.lu_factor_ex(A)
            A.copy_(LUf)
            ipiv = (piv - 1).to(torch.int32)
            perm = ipiv_to_perm(ipiv, A.shape[0])
            return A, ipiv, perm, linfo.to(torch.int32)
        if route == "whole":
            return panel_factor(A, pivot, config)
        if route == "physical":
            return blocked_lu_physical(A, pivot, config)
        return blocked_lu(A, pivot, config)


def _as_matrix(A, device) -> torch.Tensor:
    A = torch.as_tensor(A, device=resolve_device(device))
    if A.ndim != 2:
        raise ValueError(f"lu_factor expects a matrix, got shape {tuple(A.shape)}")
    return A


def lu_factor_p(A, pivot=True, *, config: Optional[LUConfig] = None,
                device=None):
    """Factor a copy of ``A``: returns ``(factors, ipiv, perm, info)``
    with ``L @ U == A[perm, :]``.  ``A`` is left unchanged."""
    A = _as_matrix(A, device).clone(memory_format=torch.contiguous_format)
    return _dispatch_factor(A, normalize_pivot(pivot), config or default_config())


def lu_factor(A, pivot=True, *, config: Optional[LUConfig] = None,
              device=None):
    """Factor a copy of ``A``: returns ``(factors, ipiv, info)``."""
    factors, ipiv, _, info = lu_factor_p(A, pivot, config=config, device=device)
    return factors, ipiv, info


def _check_info(info, pivot: bool) -> None:
    value = int(info)
    if value != 0:
        raise SingularMatrixError(
            f"matrix is singular: zero pivot at factorization step "
            f"{abs(value)} (info={value}, pivoted={pivot})"
        )


def _resolve_check(check) -> bool:
    if check in ("auto", True):
        return True
    if check is False:
        return False
    raise ValueError(f"check must be True/False/'auto', got {check!r}")


def lu(A, pivot=True, *, check="auto", config: Optional[LUConfig] = None,
       device=None) -> LU:
    """Out-of-place LU. Returns an :class:`LU`; ``check`` ('auto' or
    True) raises :class:`SingularMatrixError` on an exactly-zero pivot."""
    pivot = normalize_pivot(pivot)
    factors, ipiv, perm, info = lu_factor_p(A, pivot, config=config, device=device)
    if _resolve_check(check):
        _check_info(info, pivot)
    return LU(factors, ipiv, info, pivoted=pivot, perm=perm)


def lu_inplace(A: torch.Tensor, pivot=True, *, check="auto",
               config: Optional[LUConfig] = None, device=None) -> LU:
    """In-place LU, the ``lu!`` analog: ``A`` is overwritten with the
    packed factors, and the returned ``LU.factors`` is ``A`` itself.

    ``A`` must be a contiguous floating or complex tensor on the device the call
    runs on (``device=None`` means CUDA)."""
    pivot = normalize_pivot(pivot)
    dev = resolve_device(device)
    if not isinstance(A, torch.Tensor):
        raise TypeError("lu_inplace needs a torch.Tensor to overwrite")
    if A.device.type != dev.type or (
        dev.index is not None and A.device.index != dev.index
    ):
        raise ValueError(f"lu_inplace: A lies on {A.device}, the call runs on {dev}")
    if A.ndim != 2 or not A.is_contiguous():
        raise ValueError("lu_inplace needs a contiguous matrix")
    factors, ipiv, perm, info = _dispatch_factor(
        A, pivot, config or default_config()
    )
    if _resolve_check(check):
        _check_info(info, pivot)
    return LU(factors, ipiv, info, pivoted=pivot, perm=perm)
