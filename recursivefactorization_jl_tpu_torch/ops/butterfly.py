"""The depth-2 random butterfly transform on the card: csrc/butterfly.cu.

:func:`butterfly_mul_cuda` computes ``U^T A V`` of a float32 or float64
matrix in one launch, bit for bit the tensor code of
``models.butterfly.butterfly_mul`` (its plain version, which the CPU and
the other types run).  ``models.butterfly.butterfly_mul`` picks between
the two.  The kernel replaces no TPU kernel: the JAX package leaves the
transform to XLA, which fuses it.

Counts (:class:`ButterflyCounts`, ``butterfly_mul_cuda.counts``, zeroed by
``ops._counts.reset_counts()``, also ``ops.panel.reset_counts()``, with the
panel wrappers'): the launches by
``(dtype name, padded n)`` and the transforms that took the tensor code.
Like the panel counts they count eager calls and captures, never the
replays of a captured program.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _counts, _kernels

_KIND = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass
class ButterflyCounts:
    """``launches``: kernel launches by ``(dtype name, padded n)``;
    ``tensor_transforms``: depth-2 transforms that ran the tensor code (CPU
    tensors, other types, or butterfly values of another type than the
    matrix's)."""

    launches: dict = dataclasses.field(default_factory=dict)
    tensor_transforms: int = 0


def takes(A: torch.Tensor, uv: torch.Tensor) -> bool:
    """Does the kernel compute ``U^T A V`` for these operands (a CUDA
    float32 / float64 matrix with butterfly values of its own type)?"""
    return A.is_cuda and A.dtype in _KIND and uv.dtype == A.dtype and uv.device == A.device


def butterfly_mul_cuda(A: torch.Tensor, uv: torch.Tensor, *, width: bool = False):
    """``U^T A V`` for the square ``A`` (n a multiple of 4) and its 4n
    butterfly values ``uv``, on the card, into a new tensor.  ``width=True``
    also returns the elements each thread reads per access (1, 2 or 4)."""
    if not takes(A, uv):
        raise ValueError(
            f"butterfly_mul_cuda takes a CUDA float32/float64 matrix with butterfly values "
            f"of its type, got {A.dtype} on {A.device} with {uv.dtype} on {uv.device}")
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n or n % 4 != 0 or tuple(uv.shape) != (4 * n,):
        raise ValueError(f"a square matrix of order 4k and 4 x that many values are needed, "
                         f"got {tuple(A.shape)} and {tuple(uv.shape)}")
    A, uv = A.contiguous(), uv.contiguous()
    out = torch.empty_like(A)
    lib = _kernels.load("butterfly")
    got = ctypes.c_int(0)
    code = getattr(lib, f"rf_butterfly_depth2_{_KIND[A.dtype]}")(
        A.data_ptr(), out.data_ptr(), uv.data_ptr(), n, ctypes.byref(got),
        _counts.device_index(A.device), torch.cuda.current_stream(A.device).cuda_stream)
    _kernels.check(lib, code, "butterfly launch")
    key = (str(A.dtype)[6:], n)
    counts = butterfly_mul_cuda.counts
    counts.launches[key] = counts.launches.get(key, 0) + 1
    return (out, got.value) if width else out


_counts.counted(butterfly_mul_cuda, ButterflyCounts)
