"""Mixed-precision iterative refinement: f32 assembled inner solves with
an f64 matrix-free residual (port of :mod:`petiga_tpu.solve.refine`).

The f64 *residual* only needs the per-axis 1-D tables (sum-factorized
apply — :class:`~petiga_tpu_torch.sparse.matfree.MatFreeOperator` on an
f64 clone of the space), while the inner solves run the f32 stencil
kernel.  Classic iterative refinement (Wilkinson; Carson–Higham SIAM
2018):

    x_{k+1} = x_k + solve_f32(b_f64 - A_f64 x_k)

contracts the error by ~cond(A)·eps_f32 per pass, so a few passes leave
the solution at the f64/discretization floor instead of the f32 rounding
floor.

Dirichlet semantics match the assembled post-fix exactly (fixed rows
``mult·u``): ``MatFreeOperator`` implements the same elimination, so the
f64 residual of the f32-assembled, post-fixed operator is consistent.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..assembly.assemble import _node_multiplicity, assemble_vector
from ..sparse.matfree import MatFreeOperator
from .krylov import cg

__all__ = ["clone_f64", "assemble_rhs_f64", "refined_solve"]


def clone_f64(space):
    """f64 clone sharing the discretization, BCs, and geometry (and the
    device)."""
    sp64 = space.clone(dtype=torch.float64)
    sp64.bc = space.bc
    sp64.bc_visit = space.bc_visit
    sp64.fix_table = space.fix_table
    sp64.geometry = space.geometry
    sp64.rational = space.rational
    sp64.property = space.property
    return sp64


def _fix_rhs(sp64, A64, b):
    """Dirichlet elimination on an f64 load vector, mirroring the
    assembled post-fix (b -= A·lift; fixed rows = mult·v).

    The lift goes through the operator WITHOUT its own elimination
    (``matvec_unfixed``).  The reference lifts through ``A64.matvec``,
    which zeroes the fixed columns first, so its inhomogeneous values
    never reach the free rows; the port deliberately differs there and
    equals the assembled right-hand side instead."""
    mask, vals = sp64.tensor("dirichlet")
    mult = _node_multiplicity(sp64).to(b.dtype)
    vals = vals.to(b.dtype)
    keep = 1.0 - mask.to(b.dtype)
    # homogeneous BCs (the common case): the lift is identically zero,
    # so skip the A·lift matvec entirely
    if bool(torch.any(vals != 0)):
        b = b - A64.matvec_unfixed(mask * vals).reshape(b.shape)
    return torch.where(mask, mult[:, None] * vals, b * keep)


def assemble_rhs_f64(sp64, A64, forcing: Callable, *, chunk=None):
    """f64 load vector ``b_a = ∫ f N_a`` with assembled-style Dirichlet
    elimination; ``forcing(x)`` takes physical points ``(..., dim)`` and
    returns ``(...)``.

    Identity-map dof = 1 spaces ride the matrix-free operator's windowed
    sum-factorized load (``MatFreeOperator.load_vector``); the rest the
    tabulated :func:`~petiga_tpu_torch.assembly.assemble.assemble_vector`
    in chunks of ``chunk`` elements."""
    if (not sp64.collocation and not (sp64.has_geometry or sp64.is_rational)
            and sp64.dof == 1):
        b = A64.load_vector(forcing)
    else:
        def vecform(pt, ctx):
            return forcing(pt.x) * pt.shape0

        b = assemble_vector(sp64, vecform, order=0, chunk=chunk)
    return _fix_rhs(sp64, A64, b)


def refined_solve(
    space,
    op,
    b64,
    *,
    c: float = 0.0,
    kappa: float = 1.0,
    C=None,
    Kmat=None,
    rtol_inner: float = 1e-6,
    rtol: float = 1e-12,
    max_refine: int = 6,
    maxiter_inner: int = 2000,
    zchunk: Optional[int] = None,
    A64: Optional[MatFreeOperator] = None,
    sp64=None,
):
    """Solve ``A x = b`` to f64 accuracy with f32 inner solves.

    Args:
      space: the (f32) space the operator was assembled on.
      op: f32 :class:`~petiga_tpu_torch.sparse.spmv.StencilOperator`
        (Dirichlet post-fixed).  Each inner solve is Jacobi-CG on packed
        vectors through ``op.matvec_xb``: one stencil-kernel launch per
        iteration on a CUDA device.
      b64: f64 load vector (``assemble_rhs_f64``).
      c/kappa/C/Kmat: the coefficient(s) of the assembled form, passed
        to the f64 matrix-free residual operator.
      rtol: outer stopping criterion on ||r||/||b|| in f64.

    Returns ``(x64, info)`` with per-pass residual history.
    """
    if sp64 is None:
        sp64 = clone_f64(space)
    if A64 is None:
        A64 = MatFreeOperator(sp64, c=c, kappa=kappa, C=C, Kmat=Kmat, zchunk=zchunk)
    dinv = op.packed_diag_inv()
    low = op.DT.dtype

    def inner(r):
        res = cg(
            lambda v: op.matvec_xb(op.DT, v),
            op.pack_vec(r.to(low)),
            M=lambda z: z * dinv,
            rtol=rtol_inner,
            maxiter=maxiter_inner,
        )
        return op.unpack_vec(res.x), res.iters

    def residual(x64):
        r = b64 - A64.matvec(x64).reshape(b64.shape)
        return r, float(torch.linalg.vector_norm(r))

    bnorm = float(torch.linalg.vector_norm(b64))
    x = torch.zeros_like(b64)
    x_good, rn_good = x, float("inf")
    hist = []
    iters = []
    for _ in range(max_refine):
        r, rn = residual(x)
        hist.append(rn)
        if not math.isfinite(rn):
            # guard: a non-finite residual evaluation must not poison the
            # converged iterate — stop and keep the last good x
            break
        if rn < rn_good:
            x_good, rn_good = x, rn
        if rn <= rtol * bnorm:
            break
        e, it = inner(r)
        iters.append(int(it))
        x = x + e.to(b64.dtype)
    r, rn = residual(x)
    if math.isfinite(rn) and rn < rn_good:
        x_good, rn_good = x, rn
    hist.append(rn)
    return x_good, {
        "residuals": hist,
        "inner_iters": iters,
        "relative_residual": rn_good / bnorm,
    }
