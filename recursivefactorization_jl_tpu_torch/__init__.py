"""recursivefactorization_jl_tpu_torch: the PyTorch and CUDA port of
recursivefactorization_jl_tpu for NVIDIA Hopper (H100).

Dense LU with partial pivoting or none, and solves with it, with the JAX
package's API and numerical contracts: ``ipiv`` is the 0-based swap
sequence, ``perm`` the composed permutation (``L @ U == A[perm, :]``),
``info`` 0 or the 1-based first zero-pivot step (negative unpivoted).

The panel factorization runs a hand-written Hopper kernel, built with
``nvcc`` at first use: ``csrc/panel_lu.cu`` for float32/float64 and
``csrc/panel_lu_c64.cu`` for complex64/complex128 (CABS1 pivoting, as
LAPACK ``cgetrf``).  bfloat16/float16 matrices are factored as their
float32 copies and the factors rounded back.  Triangular solves and
Schur updates are matmuls with TF32 off.  Entry points take
``device=None``, which means CUDA and raises without it; the CPU runs
only with ``device='cpu'``, on the kernel's plain PyTorch version.

    F = lu(A)                      # LU object: F.L, F.U, F.p, F.ipiv, F.info
    x = lu_solve(F, b)             # or F.solve(b), ldiv(F, b)
    x = lu_solve(F, b, trans="T")  # A^T x = b;  trans="H" for A^H x = b
    x = lu_solve_refined(F, A, b)  # iterative refinement
    x = solve(A, b)                # one-shot: [A|b] factors as one fat LU
    f, ipiv, info = lu_factor(A)
    F = lu_inplace(A)              # overwrites A with the factors
    F = from_numpy(f, ipiv, info)  # a factorization made elsewhere (numpy)

Opt-in schedules of the single-matrix path (``LUConfig``):
``schedule='physical'`` never moves a row until one final gather (the
no-swap kernel ``csrc/panel_lu_noswap.cu``; ``ipiv`` is then the pivot-row
sequence), and ``panel_variant='shadow'`` / ``'basic'`` run the
micro-blocked panel kernels of ``csrc/panel_lu_micro.cu``.  The Random
Butterfly Transform solves without pivoting:

    F = lu(A, config=LUConfig(schedule="physical"))
    F = lu(A, config=LUConfig(panel_variant="shadow", panel_micro=32))
    x = butterfly_solve(butterfly_workspace(A, b), refine=1)

Batches of small matrices (B, m, n), min(m, n) <= 128, run one more pair
of hand-written kernels (``csrc/batched_lu.cu``, ``csrc/batched_solve.cu``):

    f, perm, info = batched_lu_factor_perm(A)    # L @ U == A[perm] per matrix
    x = batched_lu_solve_perm(f, perm, b)        # b: (B, n) or (B, n, k)
    f, ipiv, info = batched_lu_factor(A)         # the exact LAPACK ipiv
    x = batched_lu_solve(f, ipiv, b)
"""

from .models.butterfly import (
    BWorkspace,
    butterfly_from_numpy,
    butterfly_mul,
    butterfly_solve,
    butterfly_workspace,
    generate_butterfly_values,
)
from .models.lu import (
    LU,
    SingularMatrixError,
    batched_from_numpy,
    dispatch_route,
    from_numpy,
    lu,
    lu_factor,
    lu_factor_p,
    lu_inplace,
    normalize_pivot,
)
from .models.solve import ldiv, lu_solve, lu_solve_refined, normalize_trans, solve
from .parallel import (
    batched_lu_factor,
    batched_lu_factor_perm,
    batched_lu_solve,
    batched_lu_solve_perm,
)
from .utils.config import LUConfig, config_from_mapping, default_config
from .utils.perm import (
    batched_ipiv_to_perm,
    invert_perm,
    ipiv_to_perm,
    perm_to_matrix,
)

__version__ = "0.1.0"

__all__ = [
    "BWorkspace",
    "butterfly_from_numpy",
    "butterfly_mul",
    "butterfly_solve",
    "butterfly_workspace",
    "generate_butterfly_values",
    "LU",
    "SingularMatrixError",
    "batched_from_numpy",
    "batched_ipiv_to_perm",
    "batched_lu_factor",
    "batched_lu_factor_perm",
    "batched_lu_solve",
    "batched_lu_solve_perm",
    "dispatch_route",
    "from_numpy",
    "lu",
    "lu_factor",
    "lu_factor_p",
    "lu_inplace",
    "normalize_pivot",
    "ldiv",
    "lu_solve",
    "lu_solve_refined",
    "normalize_trans",
    "solve",
    "LUConfig",
    "config_from_mapping",
    "default_config",
    "invert_perm",
    "ipiv_to_perm",
    "perm_to_matrix",
]
