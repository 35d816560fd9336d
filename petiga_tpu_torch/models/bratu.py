"""Bratu equation -Δu = λ exp(u) (port of :mod:`petiga_tpu.models.bratu`:
Galerkin steady and transient forms, and the collocation residual):
Newton–Krylov with the AD or the hand-written Jacobian (:func:`solve_bratu`), and Newton with the Jacobian
assembled by the conv engine from a state-field coefficient
(:func:`solve_bratu_conv`).
"""

from __future__ import annotations

import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.newton import newton

__all__ = ["bratu_residual", "bratu_jacobian", "bratu_collocation_residual",
           "bratu_ifunction",
           "bratu_jacobian_coefficients", "make_space", "solve_bratu",
           "solve_bratu_conv"]


def bratu_residual(pt, Ue, ctx):
    """Galerkin residual: F_a = ∇N_a·∇u - λ N_a exp(u)."""
    lam = ctx["lambda"]
    u = pt.value(Ue)[0]
    gu = pt.grad(Ue)[0]
    return pt.shape1 @ gu - lam * torch.exp(u) * pt.shape0


def bratu_jacobian(pt, Ue, ctx):
    """Hand-written Jacobian — the cross-check of the AD Jacobian."""
    lam = ctx["lambda"]
    u = pt.value(Ue)[0]
    J = pt.shape1 @ pt.shape1.T
    return J - lam * torch.exp(u) * torch.outer(pt.shape0, pt.shape0)


def bratu_collocation_residual(pt, Ue, ctx):
    """Collocation residual: -Δu - λ exp(u) at the collocation point."""
    lam = ctx["lambda"]
    u = pt.value(Ue)[0]
    return -pt.del2(Ue)[0] - lam * torch.exp(u)


def bratu_ifunction(pt, a, Ve, t, Ue, ctx):
    """Transient residual: N_a u_t + ∇N_a·∇u - λ N_a exp(u)."""
    lam = ctx["lambda"]
    u = pt.value(Ue)[0]
    ut = pt.value(Ve)[0]
    gu = pt.grad(Ue)[0]
    return ut * pt.shape0 + pt.shape1 @ gu - lam * torch.exp(u) * pt.shape0


def make_space(dim=2, p=2, nel=8, dtype=torch.float32, device=None, **kw) -> Space:
    """Open uniform p-spline space with u = 0 on every face."""
    axes = [Axis.uniform(p=p, nel=nel) for _ in range(dim)]
    sp = Space(axes, dof=1, dtype=dtype, device=device, **kw)
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def solve_bratu(space, lam=6.80, *, use_ad: bool = True, rtol=1e-8, chunk=None, **newton_kw):
    """Newton–Krylov solve of the steady Bratu problem from U = 0 (the
    AD Jacobian, or :func:`bratu_jacobian` when ``use_ad`` is False);
    ``newton_kw`` go to :func:`~petiga_tpu_torch.solve.newton.newton`."""
    U0 = torch.zeros((space.nnodes, space.dof), dtype=space.dtype, device=space.device)
    return newton(space, bratu_residual, U0, {"lambda": lam},
                  jacobian=None if use_ad else bratu_jacobian, rtol=rtol, chunk=chunk,
                  **newton_kw)


def bratu_jacobian_coefficients(x, ctx, fields):
    """The Bratu Newton-step Jacobian as a coefficient spec with a
    state-dependent reaction channel: J(w, v) = ∫ ∇w·∇v − λ eᵘ w v; the
    (0,0) channel is a pointwise function of the iterate
    (``fields["u"]``)."""
    lam = ctx["lambda"]
    dim = x.shape[-1]
    ch = {(d + 1, d + 1): 1.0 for d in range(dim)}
    ch[(0, 0)] = -lam * torch.exp(fields["u"])
    return ch


def solve_bratu_conv(space, lam=6.80, *, rtol=1e-8, max_newton=20, rtol_inner=1e-8,
                     chunk=None):
    """Newton solve with the Jacobian assembled by the conv engine each
    iteration (the iterate is a state field of the coefficient spec) and
    Jacobi-CG in the packed kernel layout, so every inner product
    launches the stencil kernel.

    Returns ``(U, info)`` with ``info = {"iters", "residuals",
    "cg_iters"}``."""
    from ..assembly.assemble import assemble_function, dirichlet_post_fix_homogeneous
    from ..assembly.convform import assemble_coefficient_planes
    from ..solve.krylov import cg

    mask, vals = space.tensor("dirichlet")
    U = torch.where(mask, vals, torch.zeros_like(vals))
    ctx = {"lambda": lam}
    hist, cg_iters = [], []
    it = 0
    for it in range(max_newton):
        R = assemble_function(space, bratu_residual, U, ctx, chunk=chunk)
        rnorm = torch.linalg.vector_norm(R).item()
        hist.append(rnorm)
        if it == 0:
            r0 = max(rnorm, 1e-30)
        if rnorm <= rtol * r0:
            break
        J, _ = assemble_coefficient_planes(space, bratu_jacobian_coefficients, ctx,
                                           fields={"u": U.reshape(-1)}, apply_fix=False)
        J, rhs = dirichlet_post_fix_homogeneous(space, J, -R)
        dv = J.packed_diag_inv()
        res = cg(lambda v: J.matvec_xb(J.DT, v), J.pack_vec(rhs), M=lambda z: z * dv,
                 rtol=rtol_inner, maxiter=2000)
        cg_iters.append(res.iters)
        U = U + J.unpack_vec(res.x)
    return U, {"iters": it, "residuals": hist, "cg_iters": cg_iters}
