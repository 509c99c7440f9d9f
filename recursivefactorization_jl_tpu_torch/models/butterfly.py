"""Random Butterfly Transform (RBT) pivot-free LU solver.

The PyTorch counterpart of the JAX package's models/butterfly.py:

* 4n diagonal values ``exp(U(-0.05, 0.1)) / 2``, clustered near 0.5, from
  a seed (default 888);
* the depth-1 butterfly ``B_u^T A B_v`` as a quadrant combine, and the
  depth-2 apply ``A <- U^T A V`` built from it: O(n^2) work beside the
  O(n^3) factorization;
* dense ``U = Bu2 @ Bu1`` and ``V = Bv2 @ Bv1`` from the 4n values, and
  the implicit ``U^T b`` / ``V y`` the solve uses instead;
* padding to a multiple of 4 with an identity block;
* the workspace and the solve: ``A~ = U^T A V``, LU without pivoting,
  ``x = V (A~)^-1 U^T b``, optionally refined;
* the same solve in two parts, at the seam where the Julia reference's
  butterfly solve calls ``lu!(A, Val(false))`` and then ``ldiv!``:
  :func:`butterfly_factor` keeps the factorization (:class:`BFactor`) and
  :func:`butterfly_factor_solve` solves with it, for any number of
  right-hand sides.

The pivot-free LU is ``lu_factor(A~, pivot=False)`` on the transform's
own output, which on the card runs the panel kernel of csrc/panel_lu.cu
with ``pivot=False``.  On the card a float32 / float64 transform is one
launch of csrc/butterfly.cu (``ops/butterfly.py``), bit for bit
:func:`butterfly_mul`'s tensor code, which the CPU and the other types
run (the JAX package leaves the transform to XLA, which fuses it).

The random stream is not part of the API, and ``torch`` cannot reproduce
JAX's: the values come from an explicit ``torch.Generator`` on the CPU
(the same stream whatever the device), and ``butterfly_workspace`` also
takes ``uv=`` so that a caller, or a test, supplies them.

Compiled programs (utils/graphs.py), the counterparts of the JAX
package's jitted ``_workspace_arrays``, ``_butterfly_solve_impl`` and
``_materialize_uv_jit``, keyed as they are and captured by
``graphs.capturing()``:

* ``butterfly_workspace`` (without ``uv=``): keyed on the shapes, dtypes
  and device of ``A`` and ``b`` and on ``seed``.  The values depend on
  the padded size, the seed, the dtype and the device alone, and their
  copy from the CPU generator cannot be recorded, so the program makes
  them once, outside its graph, and holds them as its constant; the
  graph pads ``A`` and ``b``;
* ``butterfly_solve``: keyed on the padded shapes, ``config`` and
  ``refine``; the cut to ``ws.n`` and ``return_info`` stay outside, so
  the sizes that pad alike share a program.  Its graph is the two
  programs below in turn; the nested pivot-free ``lu_factor`` runs its
  eager code inside the capture;
* ``butterfly_factor``: keyed on the padded shape, dtype and device and
  ``config``; ``butterfly_factor_solve``: on the shapes of the
  factorization and of the right-hand side, and ``refine``;
* ``BWorkspace.UV``: keyed on ``uv`` and the padded size.

Spans (``utils/profiling.py``), inside the programs: ``rbt.transform``
(``U^T A V``), ``rbt.factor`` (the pivot-free LU), ``rbt.apply`` (``U^T
b``, both substitutions, ``V y``) and ``rbt.refine`` (each refinement
step: the residual's product with ``A`` and one more apply).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.butterfly import butterfly_mul_cuda, takes
from ..utils import graphs
from ..utils.config import (
    LUConfig,
    default_config,
    full_matmul_precision,
    resolve_device,
)
from ..utils.profiling import span

DEFAULT_SEED = 888


def generate_butterfly_values(n: int, seed: int = DEFAULT_SEED,
                              dtype=torch.float64, device=None) -> torch.Tensor:
    """4n butterfly diagonal values ``exp(U(-0.05, 0.1)) / 2`` on
    ``device`` (None means CUDA), drawn in float64 from a CPU generator
    seeded with ``seed`` and cast to ``dtype``: one seed gives one set of
    values, whatever the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.rand(4 * n, generator=gen, dtype=torch.float64) * 0.15 - 0.05
    return (torch.exp(u) * 0.5).to(device=dev, dtype=dtype)


def butterfly_level(A: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Depth-1 butterfly: returns ``B_u^T @ A @ B_v`` where ``B_x`` is the
    ``[[diag(xu), diag(xl)], [diag(xu), -diag(xl)]]`` butterfly built from
    ``x``."""
    M, N = A.shape
    mh, nh = M // 2, N // 2
    A11, A12 = A[:mh, :nh], A[:mh, nh:]
    A21, A22 = A[mh:, :nh], A[mh:, nh:]
    T1, T2 = A11 + A12, A21 + A22
    T3, T4 = A11 - A12, A21 - A22
    u1, u2 = u[:mh, None], u[mh:, None]
    v1, v2 = v[None, :nh], v[None, nh:]
    C11 = u1 * (T1 + T2) * v1
    C21 = u2 * (T1 - T2) * v1
    C12 = u1 * (T3 + T4) * v2
    C22 = u2 * (T3 - T4) * v2
    return torch.cat([torch.cat([C11, C12], dim=1),
                      torch.cat([C21, C22], dim=1)], dim=0)


def butterfly_mul(A: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Depth-2 RBT apply: returns ``U^T A V`` with two levels of
    butterflies.  ``A`` must be square with a size divisible by 4.  A CUDA
    float32 / float64 matrix with values of its own type goes to the
    kernel (``ops.butterfly.butterfly_mul_cuda``), everything else to the
    tensor code, its plain version (``_butterfly_mul_tensor``; counted in
    ``butterfly_mul_cuda.counts.tensor_transforms``)."""
    M, N = A.shape
    if M != N or M % 4 != 0:
        raise ValueError(
            f"butterfly_mul needs a square matrix with n % 4 == 0 (pad "
            f"first), got {tuple(A.shape)}"
        )
    if takes(A, uv):
        return butterfly_mul_cuda(A, uv)
    butterfly_mul_cuda.counts.tensor_transforms += 1
    return _butterfly_mul_tensor(A, uv)


def _butterfly_mul_tensor(A: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """:func:`butterfly_mul` in tensor code, on any device (the kernel's
    plain version)."""
    M = A.shape[0]
    h = M // 2
    U1, V1 = uv[:h], uv[h:M]
    U2, V2 = uv[M : M + h], uv[M + h : 2 * M]
    A11 = butterfly_level(A[:h, :h], U1, V1)
    A21 = butterfly_level(A[h:, :h], U2, V1)
    A12 = butterfly_level(A[:h, h:], U1, V2)
    A22 = butterfly_level(A[h:, h:], U2, V2)
    A = torch.cat([torch.cat([A11, A12], dim=1),
                   torch.cat([A21, A22], dim=1)], dim=0)
    return butterfly_level(A, uv[2 * M : 3 * M], uv[3 * M : 4 * M])


def _butterfly_matrix(x: torch.Tensor) -> torch.Tensor:
    """Dense ``[[diag(xu), diag(xl)], [diag(xu), -diag(xl)]]`` from the
    2h-vector ``x``."""
    h = x.shape[0] // 2
    du, dl = torch.diag(x[:h]), torch.diag(x[h:])
    return torch.cat([torch.cat([du, dl], dim=1),
                      torch.cat([du, -dl], dim=1)], dim=0)


@full_matmul_precision()
def materialize_uv(uv: torch.Tensor, M: int):
    """Dense ``U = Bu2 @ Bu1`` and ``V = Bv2 @ Bv1`` from the 4M values."""
    h = M // 2
    U1, V1 = uv[:h], uv[h:M]
    U2, V2 = uv[M : M + h], uv[M + h : 2 * M]
    Bu2 = torch.block_diag(_butterfly_matrix(U1), _butterfly_matrix(U2))
    Bv2 = torch.block_diag(_butterfly_matrix(V1), _butterfly_matrix(V2))
    Bu1 = _butterfly_matrix(uv[2 * M : 3 * M])
    Bv1 = _butterfly_matrix(uv[3 * M : 4 * M])
    return Bu2 @ Bu1, Bv2 @ Bv1


def _colvec(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The diagonal values shaped to broadcast against a vector (n,) or a
    matrix (n, k) of right-hand sides."""
    return x if like.ndim == 1 else x[:, None]


def _butterfly_t_vec(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``B_x^T @ y`` implicitly (``B^T = [[Du, Du], [Dl, -Dl]]``); ``y``
    is a vector or a matrix of right-hand sides."""
    h = y.shape[0] // 2
    y1, y2 = y[:h], y[h:]
    return torch.cat([_colvec(x[:h], y) * (y1 + y2), _colvec(x[h:], y) * (y1 - y2)])


def _butterfly_vec(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``B_x @ y`` implicitly; ``y`` is a vector or a matrix."""
    h = y.shape[0] // 2
    t = _colvec(x[:h], y) * y[:h]
    s = _colvec(x[h:], y) * y[h:]
    return torch.cat([t + s, t - s])


def apply_ut(uv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Implicit ``U^T @ b`` = ``Bu1^T (Bu2^T b)``."""
    M = b.shape[0]
    h = M // 2
    t = torch.cat([_butterfly_t_vec(uv[:h], b[:h]),
                   _butterfly_t_vec(uv[M : M + h], b[h:])])
    return _butterfly_t_vec(uv[2 * M : 3 * M], t)


def apply_v(uv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Implicit ``V @ y`` = ``Bv2 (Bv1 y)``."""
    M = y.shape[0]
    h = M // 2
    t = _butterfly_vec(uv[3 * M : 4 * M], y)
    return torch.cat([_butterfly_vec(uv[h:M], t[:h]),
                      _butterfly_vec(uv[M + h : 2 * M], t[h:])])


def pad_to_multiple_of_4(A: torch.Tensor) -> torch.Tensor:
    """Zero-pad ``A`` to the next multiple of 4, with the identity on the
    new diagonal block."""
    n = A.shape[0]
    xn = (-n) % 4
    if xn == 0:
        return A
    Ap = torch.zeros(n + xn, n + xn, dtype=A.dtype, device=A.device)
    Ap[:n, :n] = A
    Ap.diagonal()[n:].fill_(1)  # no host scalar copied in: capture-safe
    return Ap


@dataclasses.dataclass(frozen=True)
class BWorkspace:
    """RBT solve state: the padded matrix, the padded right-hand side,
    the 4n butterfly values (n the padded size) and the original size.
    Dense U and V are not kept: the solve applies the butterflies
    implicitly; :meth:`UV` builds them when they are wanted."""

    A: torch.Tensor
    b: torch.Tensor
    uv: torch.Tensor
    n: int

    def UV(self):
        """The dense ``(U, V)`` butterfly factors of the padded size."""
        return graphs.call("materialize_uv", materialize_uv, (self.uv,), (self.A.shape[0],))


def _workspace_arrays(A, b, uv, seed):
    """The program of :func:`butterfly_workspace`: ``A`` and ``b`` padded
    to a multiple of 4, and ``uv`` (the program's constant) as it is."""
    Ap = pad_to_multiple_of_4(A)
    n, np_ = A.shape[0], Ap.shape[0]
    if np_ != n:
        pad = torch.zeros((np_ - n,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
        b = torch.cat([b, pad])
    return Ap, b, uv


def butterfly_workspace(A, b, seed: int = DEFAULT_SEED, *, uv=None,
                        device=None) -> BWorkspace:
    """Build the RBT workspace on ``device`` (None means CUDA): pad ``A``
    to a multiple of 4 (the right-hand side, a vector or a matrix, with
    zeros: the pad block is the identity and its part of the solution is
    dropped) and draw the 4n butterfly values from ``seed``, or take them
    from ``uv`` (4 x the padded size).  Without ``uv`` this is the
    ``butterfly_workspace`` program of its key (module docstring)."""
    dev = resolve_device(device)
    A = torch.as_tensor(A, device=dev)
    b = torch.as_tensor(b, device=dev)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"RBT needs a square matrix, got {tuple(A.shape)}")
    n = A.shape[0]
    if b.shape[0] != n:
        raise ValueError(f"right-hand side has {b.shape[0]} rows, A has {n}")
    np_ = n + (-n) % 4
    if uv is None:
        Ap, bp, uv = graphs.call(
            "butterfly_workspace", _workspace_arrays, (A, b), (seed,),
            constants=lambda: (generate_butterfly_values(np_, seed, A.dtype, dev),))
        return BWorkspace(A=Ap, b=bp, uv=uv, n=n)
    if not isinstance(uv, torch.Tensor):
        uv = np.array(uv)  # a writable copy: numpy views of JAX arrays are not
    uv = torch.as_tensor(uv, device=dev).to(A.dtype)
    if uv.shape != (4 * np_,):
        raise ValueError(f"uv must hold 4 x {np_} values, got shape {tuple(uv.shape)}")
    Ap, bp, _ = _workspace_arrays(A, b, uv, seed)
    return BWorkspace(A=Ap, b=bp, uv=uv, n=n)


def butterfly_from_numpy(A, b, uv, n: int, device=None) -> BWorkspace:
    """A workspace held in numpy arrays (for example the JAX package's:
    its padded ``A`` and ``b``, its ``uv`` and the original size ``n``)
    as a :class:`BWorkspace` on ``device`` (None means CUDA), ready for
    :func:`butterfly_solve`."""
    dev = resolve_device(device)
    A = torch.as_tensor(np.array(A), device=dev)
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] % 4 != 0:
        raise ValueError(f"a padded square matrix is expected, got {tuple(A.shape)}")
    uv = torch.as_tensor(np.array(uv), device=dev).to(A.dtype)
    if uv.shape != (4 * A.shape[0],) or not 0 <= A.shape[0] - int(n) < 4:
        raise ValueError("uv or n does not fit the padded matrix")
    return BWorkspace(A=A, b=torch.as_tensor(np.array(b), device=dev), uv=uv,
                      n=int(n))


@dataclasses.dataclass(frozen=True)
class BFactor:
    """A kept RBT factorization (:func:`butterfly_factor`): the packed
    pivot-free LU of ``A~ = U^T A V`` at the padded size (``factors``), its
    ``ipiv`` (the identity: no row moves) and ``info`` (0, or minus the
    1-based first zero pivot), the butterfly values ``uv``, the padded
    matrix ``A`` that refinement takes residuals against, and the original
    size ``n``."""

    factors: torch.Tensor
    ipiv: torch.Tensor
    info: torch.Tensor
    uv: torch.Tensor
    A: torch.Tensor
    n: int


def butterfly_factor(ws: BWorkspace, *, config: Optional[LUConfig] = None) -> BFactor:
    """The first half of :func:`butterfly_solve`: ``A~ = U^T A V`` and its
    LU without pivoting, kept for :func:`butterfly_factor_solve`.  Runs on
    the workspace's device, by the replay of the ``butterfly_factor``
    program of its key where one was captured."""
    config = config or default_config()
    factors, ipiv, info = graphs.call("butterfly_factor", _butterfly_factor_impl,
                                      (ws.A, ws.uv), (config,))
    return BFactor(factors=factors, ipiv=ipiv, info=info, uv=ws.uv, A=ws.A, n=ws.n)


def butterfly_factor_solve(F: BFactor, b, *, refine: int = 0, return_info: bool = False):
    """Solve ``A x = b`` with a kept factorization: ``U^T b``, both
    triangular solves, ``V y`` and ``refine`` steps of iterative refinement
    against the padded ``A``, cut back to ``F.n`` rows.  ``b`` (a vector
    or a matrix of right-hand sides) has the matrix's ``F.n`` rows, which
    are padded with zeros, or already the padded size (``BWorkspace.b``).
    Runs by the replay of the ``butterfly_factor_solve`` program of its key
    where one was captured; :func:`butterfly_solve` of the same workspace
    gives the same bits."""
    b = torch.as_tensor(b, device=F.factors.device)
    np_ = F.factors.shape[0]
    if b.shape[0] != np_:
        if b.shape[0] != F.n:
            raise ValueError(f"right-hand side has {b.shape[0]} rows, A has {F.n}")
        pad = torch.zeros((np_ - F.n,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
        b = torch.cat([b, pad])
    x = graphs.call("butterfly_factor_solve", _butterfly_factor_solve_impl,
                    (F.factors, F.ipiv, F.A, F.uv, b), (refine,))
    x = x[: F.n]
    return (x, F.info) if return_info else x


def butterfly_solve(ws: BWorkspace, *, config: Optional[LUConfig] = None,
                    return_info: bool = False, refine: int = 0):
    """Pivot-free RBT solve: ``A~ = U^T A V``, LU without pivoting,
    ``x = V (A~)^-1 U^T b``, cut back to the original size.  Runs on the
    workspace's device, by the replay of the ``butterfly_solve`` program
    of its key where one was captured.  It is :func:`butterfly_factor`
    and :func:`butterfly_factor_solve` of ``ws.b`` in turn, in one
    program, with the same bits.

    ``refine`` adds that many steps of iterative refinement on the padded
    system with the same factorization (``r = b - A x``, ``x += V A~^-1
    U^T r``).  Without pivoting the growth of a generic matrix costs
    accuracy; in float32 prefer the pivoted ``lu_solve`` unless the
    matrix suits the transform."""
    config = config or default_config()
    x, info = graphs.call("butterfly_solve", _butterfly_solve_impl, (ws.A, ws.b, ws.uv),
                          (config, refine))
    x = x[: ws.n]
    return (x, info) if return_info else x


@full_matmul_precision()
def _butterfly_factor_impl(A, uv, config: LUConfig):
    """The program of :func:`butterfly_factor` on the padded matrix:
    ``(factors, ipiv, info)`` of the transformed matrix, factored in place
    (it is the transform's own output)."""
    from .lu import lu_factor

    with span("rbt.transform", A):
        At = butterfly_mul(A, uv)
    # an integer matrix's factors are float64 and cannot overwrite it
    donate = At.dtype.is_floating_point or At.dtype.is_complex
    with span("rbt.factor", A):
        return lu_factor(At, pivot=False, config=config, donate=donate, device=At.device)


@full_matmul_precision()
def _butterfly_factor_solve_impl(factors, ipiv, A, uv, b, refine: int):
    """The program of :func:`butterfly_factor_solve` on the padded system:
    ``x``."""
    from .solve import _lu_solve_impl

    dtype = torch.promote_types(A.dtype, uv.dtype)  # the transformed matrix's

    def rbt_apply(rhs):
        tmp = apply_ut(uv, rhs.to(dtype))
        y = _lu_solve_impl(factors, ipiv, tmp, pivoted=False, trans=0)
        return apply_v(uv, y)

    with span("rbt.apply", A):
        x = rbt_apply(b)
    for _ in range(refine):
        with span("rbt.refine", A):
            r = b.to(x.dtype) - A @ x
            x = x + rbt_apply(r)
    return x


def _butterfly_solve_impl(A, b, uv, config: LUConfig, refine: int):
    """The program of :func:`butterfly_solve` on the padded system:
    ``(x, info)``."""
    factors, ipiv, info = _butterfly_factor_impl(A, uv, config)
    return _butterfly_factor_solve_impl(factors, ipiv, A, uv, b, refine), info
