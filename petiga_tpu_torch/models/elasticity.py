"""Linear elasticity (port of :mod:`petiga_tpu.models.elasticity`), the
dof = dim vector problem of PetIGA's demo/Elasticity.c and
Elasticity3D.c: an isotropic Lamé material, a blocked (dof × dof)
operator that runs through the stencil kernels at dof = dim, and the
rigid-body null space (IGACreateRigidBody, petigansp.c:119-131).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import assemble_system
from ..core.axis import Axis
from ..core.space import Space
from ..solve.krylov import block_jacobi_preconditioner, cg

__all__ = ["elasticity_system", "make_space", "solve", "rigid_body_modes",
           "body_force_system"]


def elasticity_system(pt, ctx):
    """K[a,i][b,j] = λ ∂_i N_a ∂_j N_b + μ ∂_j N_a ∂_i N_b
    + μ δ_ij ∇N_a·∇N_b (Elasticity3D.c:13-47); ``ctx["body_force"](x)
    -> (dim,)`` adds the load ``F[a, i] = N_a f_i``."""
    lam, mu = ctx["lambda"], ctx["mu"]
    N1 = pt.shape1  # (nen, dim)
    dim = N1.shape[1]
    eye = torch.eye(dim, dtype=N1.dtype, device=N1.device)
    K = (lam * torch.einsum("ai,bj->aibj", N1, N1)
         + mu * torch.einsum("aj,bi->aibj", N1, N1)
         + mu * torch.einsum("ab,ij->aibj", N1 @ N1.T, eye))
    if "body_force" in ctx:
        F = pt.shape0[:, None] * ctx["body_force"](pt.x)[None, :]
    else:
        F = N1.new_zeros((pt.nen, dim))
    return K, F


def body_force_system(exact):
    """Manufactured-solution wrapper: for ``exact(x) -> (dim,)`` the
    system form whose body force ``f = -div σ(u)``, ``σ = λ tr(ε) I +
    2 μ ε``, is computed by forward-mode AD (``torch.func.jacfwd``
    twice)."""
    jac = torch.func.jacfwd

    def form(pt, ctx):
        lam, mu = ctx["lambda"], ctx["mu"]

        def sigma(x):
            J = jac(exact)(x)  # (dim, dim): du_i/dx_j
            eps = 0.5 * (J + J.T)
            eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
            return lam * torch.trace(eps) * eye + 2 * mu * eps

        f = -torch.einsum("ijj->i", jac(sigma)(pt.x))  # dσ_ij/dx_k
        K, _ = elasticity_system(pt, ctx)
        return K, pt.shape0[:, None] * f[None, :]

    return form


def make_space(dim=3, p=2, nel=8, dtype=torch.float32, clamp_axis=0, device=None) -> Space:
    """Uniform open patch, dof = dim, both faces of ``clamp_axis``
    clamped (every displacement component zero)."""
    sp = Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], dof=dim, dtype=dtype,
               device=device)
    for s in range(2):
        for c in range(dim):
            sp.set_boundary_value(clamp_axis, s, c, 0.0)
    return sp


def solve(space, lam=1.0, mu=1.0, *, ctx_extra=None, rtol=1e-8, chunk=None):
    """Pointwise assembly, block-Jacobi CG through the stencil kernel
    (``A.fast_operator()``).  Returns ``(U, info)`` with the iteration
    count, the final residual norm, ``A`` and ``b``."""
    ctx = {"lambda": lam, "mu": mu, **(ctx_extra or {})}
    A, b = assemble_system(space, elasticity_system, ctx, chunk=chunk)
    res = cg(A.fast_operator(), b, M=block_jacobi_preconditioner(A), rtol=rtol)
    return res.x, {"iters": res.iters, "residual": float(res.residual), "A": A, "b": b}


def rigid_body_modes(space) -> np.ndarray:
    """Rigid-body null-space vectors from the node coordinates
    (MatNullSpaceCreateRigidBody analog, petigansp.c:119-131): dim
    translations and dim(dim-1)/2 rotations, (nmodes, nnodes, dim), host
    numpy."""
    dim = space.dim
    X = space.geometry if space.has_geometry else space.greville_coordinates()
    n = space.nnodes
    modes = []
    for i in range(dim):
        t = np.zeros((n, dim))
        t[:, i] = 1.0
        modes.append(t)
    if dim >= 2:
        r = np.zeros((n, dim))
        r[:, 0] = -X[:, 1]
        r[:, 1] = X[:, 0]
        modes.append(r)
    if dim == 3:
        r = np.zeros((n, dim))
        r[:, 1] = -X[:, 2]
        r[:, 2] = X[:, 1]
        modes.append(r)
        r = np.zeros((n, dim))
        r[:, 0] = X[:, 2]
        r[:, 2] = -X[:, 0]
        modes.append(r)
    return np.stack(modes)
