"""Schur-complement update ``C <- C - A @ B``: the O(n^3) bulk of LU.

Precision modes (``LUConfig.schur_precision``):

* ``'float32'``: one product in the input's type with TF32 off (callers
  run inside ``utils.config.full_matmul_precision``);
* ``'bf16x3'``: the hand split ``ah@bh + ah@bl + al@bh`` with
  ``a = ah + al``, ``ah = bf16(a)``, ``al = bf16(a - ah)``; each product
  is bf16 x bf16 with f32 accumulation, and the ``al@bl`` term (below
  2^-16 relative) is dropped;
* ``'bf16'``: one bf16 product with f32 accumulation; it loses about
  three decimal digits, so pair it with ``lu_solve_refined``.

The reduced modes apply to f32 inputs; other dtypes use the full product.
"""

from __future__ import annotations

import torch


def _bf16_product(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    bf = torch.bfloat16
    if A.device.type == "cuda":
        return torch.mm(A.to(bf), B.to(bf), out_dtype=torch.float32)
    # the CPU has no bf16 product with an f32 output; the f32 product of
    # the bf16-exact operands is the same arithmetic
    return torch.matmul(A.to(bf).float(), B.to(bf).float())


def schur_product(
    A: torch.Tensor, B: torch.Tensor, precision: str = "float32"
) -> torch.Tensor:
    """``A @ B`` in the requested precision, in ``A``'s dtype."""
    if A.dtype == torch.float32 and precision == "bf16":
        return _bf16_product(A, B)
    if A.dtype == torch.float32 and precision == "bf16x3":
        bf = torch.bfloat16
        ah = A.to(bf)
        al = (A - ah.float()).to(bf)
        bh = B.to(bf)
        bl = (B - bh.float()).to(bf)
        return _bf16_product(ah, bh) + (
            _bf16_product(ah, bl) + _bf16_product(al, bh)
        )
    return torch.matmul(A, B)


def schur_update(
    C: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    precision: str = "float32",
) -> torch.Tensor:
    """Return ``C - A @ B`` with the requested product precision."""
    return C - schur_product(A, B, precision).to(C.dtype)


def schur_update_(
    C: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    precision: str = "float32",
) -> torch.Tensor:
    """``C -= A @ B`` in place, and return ``C``: at full precision (every
    dtype but float32 takes it) with the subtraction in the product's
    epilogue (one ``addmm_``), in the reduced modes by
    :func:`schur_product`."""
    if C.dtype != torch.float32 or precision == "float32":
        return C.addmm_(A, B, alpha=-1)
    return C.sub_(schur_product(A, B, precision).to(C.dtype))
