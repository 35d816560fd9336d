"""Boundary-form models (port of :mod:`petiga_tpu.models.boundary`),
PetIGA's demo/NitscheMethod.c (weak Dirichlet by Nitsche's method) and
demo/BoundaryIntegral.c / Neumann.c (natural conditions by surface
integrals through ``set_boundary_form``).  Both solve with Jacobi-CG on
``A.fast_operator()``, the stencil kernel on the card."""

from __future__ import annotations

import torch

from ..assembly.assemble import assemble_system
from ..core.axis import Axis
from ..core.space import Space
from ..solve.krylov import cg, jacobi_preconditioner

__all__ = ["nitsche_poisson", "boundary_integral_poisson", "make_open_space"]


def make_open_space(dim=2, p=2, nel=8, dtype=torch.float64, device=None) -> Space:
    """Space with no strong BCs; all faces flagged for boundary forms."""
    sp = Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], dtype=dtype, device=device)
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_form(d, s)
    return sp


def _solve(A, b, rtol):
    res = cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=rtol)
    return res.x, {"iters": int(res.iters), "residual": float(res.residual)}


def nitsche_poisson(space, exact, forcing, *, C=None, rtol=1e-12):
    """-Δu = f with Dirichlet u = g imposed weakly
    (NitscheMethod.c:69-112):

      interior: K_ab = ∇N_a·∇N_b,             F_a = N_a f
      boundary: K_ab += -N_a ∂n N_b - N_b ∂n N_a + α N_a N_b
                F_a  += -∂n N_a g + α N_a g,   α = C(p+1)/h_n

    ``exact(x) -> (1,)`` and ``forcing(x)`` take one point.  Returns
    ``(U, {"iters", "residual"})``."""
    p = max(space.degrees)
    Cpen = 5.0 * (p + 1) if C is None else C
    alpha = Cpen / (1.0 / max(space.elem_shape))

    def interior(pt, ctx):
        return pt.shape1 @ pt.shape1.T, forcing(pt.x) * pt.shape0

    def bnd(pt, ctx):
        g = exact(pt.x)[0]
        dn = pt.shape1 @ pt.normal  # ∂n N_a
        N0 = pt.shape0
        K = -torch.outer(N0, dn) - torch.outer(dn, N0) + alpha * torch.outer(N0, N0)
        return K, -dn * g + alpha * N0 * g

    A, b = assemble_system(space, interior, boundary=bnd, apply_fix=False)
    return _solve(A, b, rtol)


def boundary_integral_poisson(space, forcing, flux, fixed_faces, *, rtol=1e-12):
    """-Δu = f with the natural condition ∂n u = t(x) imposed by a
    surface integral (BoundaryIntegral.c): F_a += N_a t(x) on the faces
    flagged for boundary forms; ``fixed_faces`` is a list of (axis,
    side, value) strong conditions to pin the solution.  Returns ``(U,
    {"iters", "residual"})``."""
    for d, s, v in fixed_faces:
        space.set_boundary_value(d, s, 0, v)

    def interior(pt, ctx):
        return pt.shape1 @ pt.shape1.T, forcing(pt.x) * pt.shape0

    def bnd(pt, ctx):
        N0 = pt.shape0
        return torch.zeros((pt.nen, pt.nen), dtype=N0.dtype, device=N0.device), \
            flux(pt.x, pt.normal) * N0

    A, b = assemble_system(space, interior, boundary=bnd)
    return _solve(A, b, rtol)
