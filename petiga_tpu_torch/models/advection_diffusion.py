"""Advection–diffusion, Galerkin and SUPG-stabilized (port of
:mod:`petiga_tpu.models.advection_diffusion`), PetIGA's
demo/AdvectionDiffusion.c: a skew wind, a boundary layer set by
Dirichlet data, and the SUPG stabilization the VMS demos use."""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import assemble_system
from ..core.axis import Axis
from ..core.space import Space
from ..solve.krylov import bicgstab, jacobi_preconditioner

__all__ = ["galerkin_system", "supg_system", "make_space", "solve"]


def _wind(pt, ctx):
    return torch.as_tensor(ctx["wind"], dtype=pt.shape0.dtype, device=pt.shape0.device)


def galerkin_system(pt, ctx):
    """K_ab = κ ∇N_a·∇N_b + N_a w·∇N_b (AdvectionDiffusion.c:26-46)."""
    w = _wind(pt, ctx)
    N0, N1 = pt.shape0, pt.shape1
    K = ctx.get("kappa", 1.0) * (N1 @ N1.T) + torch.outer(N0, N1 @ w)
    return K, ctx.get("source", 0.0) * N0


def supg_system(pt, ctx):
    """Galerkin + SUPG: test functions augmented with τ w·∇N_a on the
    advective residual; τ = h/(2|w|) ξ(Pe_h) with the optimal coth rule."""
    w = _wind(pt, ctx)
    kappa, h = ctx.get("kappa", 1.0), ctx["h"]
    N0, N1 = pt.shape0, pt.shape1
    wn = torch.sqrt(torch.sum(w * w)) + 1e-30
    peclet = wn * h / (2 * kappa)
    tau = h / (2 * wn) * (1.0 / torch.tanh(peclet) - 1.0 / peclet)
    adv_test = N1 @ w  # w·∇N_a
    K = (kappa * (N1 @ N1.T) + torch.outer(N0, adv_test)
         + tau * torch.outer(adv_test, adv_test))
    return K, ctx.get("source", 0.0) * (N0 + tau * adv_test)


def make_space(dim=2, p=1, nel=16, dtype=torch.float64, device=None):
    return Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], dof=1, dtype=dtype,
                 device=device)


def solve(space, wind, *, kappa=1.0, supg=False, source=0.0, rtol=1e-10):
    """Assemble and solve by Jacobi-BiCGStab on the stencil kernel;
    returns ``(U, {"iters", "residual"})``."""
    ctx = {"wind": np.asarray(wind, float), "kappa": kappa,
           "h": 1.0 / space.elem_shape[0], "source": source}
    A, b = assemble_system(space, supg_system if supg else galerkin_system, ctx)
    res = bicgstab(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=rtol,
                   maxiter=5000)
    return res.x, {"iters": res.iters, "residual": float(res.residual)}
