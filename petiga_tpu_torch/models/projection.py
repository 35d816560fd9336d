"""L2 projection (port of :mod:`petiga_tpu.models.projection`), PetIGA's
demo/L2Projection.c: mass-matrix projection of a function onto the
spline space, with the `-check_error`-style error norm."""

from __future__ import annotations

import torch

from ..assembly.assemble import assemble_system, compute_error_norm
from ..solve.krylov import cg, jacobi_preconditioner

__all__ = ["l2_project", "projection_error"]


def l2_project(space, f, *, rtol=1e-12, chunk=None):
    """Project ``f(x) -> (dof,)`` onto the space: solve M u = (f, N) by
    Jacobi-CG on the stencil kernel.  Returns (nnodes, dof)."""
    dof = space.dof

    def form(pt, ctx):
        eye = torch.eye(dof, dtype=pt.shape0.dtype, device=pt.shape0.device)
        K = torch.einsum("ab,ij->aibj", torch.outer(pt.shape0, pt.shape0), eye)
        return K, pt.shape0[:, None] * torch.atleast_1d(f(pt.x))[None, :]

    A, b = assemble_system(space, form, apply_fix=False, chunk=chunk)
    return cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=rtol).x


def projection_error(space, U, f):
    """‖U − f‖ in L² (a float); ``f`` written with ``x[..., i]`` takes a
    batch of points here and one point in :func:`l2_project`."""
    return float(compute_error_norm(
        space, U, lambda x: f(x).reshape(x.shape[:-1] + (space.dof,)), k=0))
