"""Batch-parallel entry points of the port."""

from .batched import (
    batched_lu_factor,
    batched_lu_factor_perm,
    batched_lu_solve,
    batched_lu_solve_perm,
)

__all__ = [
    "batched_lu_factor",
    "batched_lu_factor_perm",
    "batched_lu_solve",
    "batched_lu_solve_perm",
]
