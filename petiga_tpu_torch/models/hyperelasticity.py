"""Finite-strain hyperelasticity (port of
:mod:`petiga_tpu.models.hyperelasticity`), PetIGA's demo/HyperElasticity.c:
Neo-Hookean, St-Venant–Kirchhoff and Mooney–Rivlin materials behind a
material function, the total-Lagrangian residual, and Newton with the
tangent by forward-mode AD (the reference's demo derives it by hand).

det, inverse and log of F are the explicit small-matrix formulas
(``det_small``, ``inv_small``), which compose with ``torch.func``'s
``vmap``, ``jvp`` and ``grad`` at every depth; the Mooney–Rivlin stress is
``torch.func.grad`` of its energy, nested inside the Jacobian's ``jvp``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..assembly.tabulation import det_small, inv_small
from ..core.axis import Axis
from ..core.space import Space
from ..solve.newton import newton

__all__ = ["neo_hookean", "st_venant", "mooney_rivlin", "residual", "make_space", "solve"]


def neo_hookean(lam, mu) -> Callable:
    """First Piola–Kirchhoff stress P(F) of compressible Neo-Hooke
    (HyperElasticity.c NeoHookeanModel)."""

    def P(F):
        J = det_small(F)
        FinvT = inv_small(F, J).T
        return mu * (F - FinvT) + lam * torch.log(J) * FinvT

    return P


def st_venant(lam, mu) -> Callable:
    """P = F S with S = λ tr(E) I + 2 μ E, E = (FᵀF − I)/2
    (StVenantModel)."""

    def P(F):
        eye = torch.eye(F.shape[0], dtype=F.dtype, device=F.device)
        E = 0.5 * (F.T @ F - eye)
        return F @ (lam * torch.trace(E) * eye + 2 * mu * E)

    return P


def mooney_rivlin(c1, c2, lam) -> Callable:
    """Compressible Mooney–Rivlin through its energy density and AD:
    W = c1 (I1 − 3) + c2 (I2 − 3) − (2c1 + 4c2) ln J + λ/2 (ln J)²;
    P = dW/dF (MooneyRivlinModel, by ``torch.func.grad``)."""

    def W(F):
        C = F.T @ F
        I1 = torch.trace(C)
        I2 = 0.5 * (I1**2 - torch.trace(C @ C))
        lnJ = torch.log(det_small(F))
        return c1 * (I1 - 3) + c2 * (I2 - 3) - (2 * c1 + 4 * c2) * lnJ + 0.5 * lam * lnJ**2

    return torch.func.grad(W)


def residual(pt, Ue, ctx):
    """Total-Lagrangian residual R[a, i] = P_ij(F) ∂N_a/∂X_j − N_a b_i
    with F = I + ∇u (HyperElasticity.c Residual)."""
    gu = pt.grad(Ue)  # (dim, dim): du_i/dX_j
    F = torch.eye(gu.shape[0], dtype=gu.dtype, device=gu.device) + gu
    R = pt.shape1 @ ctx["material"](F).T  # (nen, dim)
    if "body_force" in ctx:
        R = R - pt.shape0[:, None] * ctx["body_force"](pt.x)[None, :]
    return R


def make_space(dim=3, p=2, nel=4, dtype=torch.float32, stretch=0.1, device=None) -> Space:
    """Clamped-left, stretched-right block (the reference's canonical
    run): u = 0 at x = 0, u_x = ``stretch`` at x = 1."""
    sp = Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], dof=dim, dtype=dtype,
               device=device)
    for c in range(dim):
        sp.set_boundary_value(0, 0, c, 0.0)
    sp.set_boundary_value(0, 1, 0, stretch)
    return sp


def solve(space, *, material=None, lam=1.0, mu=1.0, rtol=1e-8, maxit=20, chunk=None,
          continuation=1, **newton_kw):
    """Newton–CG solve from U = 0 (Neo-Hooke with ``lam``, ``mu`` unless
    ``material`` is given).  ``continuation`` > 1 ramps the boundary
    values in that many equal load steps, each a Newton solve from the
    last step's state (the reference documents this load stepping but
    re-runs Newton at the full values); the space's boundary values are
    restored after.  Every inner CG product runs on the stencil kernel
    (``operator="fast"``); other keywords go to
    :func:`~petiga_tpu_torch.solve.newton.newton`.  Returns ``(U,
    NewtonResult)`` of the last step."""
    ctx = {"material": material or neo_hookean(lam, mu)}
    U = torch.zeros((space.nnodes, space.dof), dtype=space.dtype, device=space.device)
    kw = {"linear_solver": "cg", "operator": "fast", **newton_kw}
    full = [[list(face.value) for face in faces] for faces in space.bc]
    res = None
    try:
        for step in range(continuation):
            scale = (step + 1) / continuation
            for faces, values in zip(space.bc, full):
                for face, vals in zip(faces, values):
                    face.value = [(f, v * scale) for f, v in vals]
            space._tensor_cache.clear()
            res = newton(space, residual, U, ctx, rtol=rtol, maxit=maxit, chunk=chunk, **kw)
            U = res.U
    finally:
        for faces, values in zip(space.bc, full):
            for face, vals in zip(faces, values):
                face.value = vals
        space._tensor_cache.clear()
    return U, res
