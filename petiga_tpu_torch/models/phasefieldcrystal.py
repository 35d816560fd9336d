"""Phase-field crystal in mixed form (port of
:mod:`petiga_tpu.models.phasefieldcrystal`), PetIGA's
demo/PhaseFieldCrystal/Mixed222Stable.c:

  φ_t = Δμ,   μ = φ³ + (1-ε)φ + 2Δφ + Δ²φ

as a dof-2 system on periodic C¹ splines on [0, 16π]², the 4th-order
term by the symmetric ∫ΔN Δφ form (order-2 tables).

:func:`run` starts from V0 = 0.  The μ row is algebraic (no time
derivative), so the consistent-velocity solve F(t, U0, V0) = 0 of
:meth:`~petiga_tpu_torch.solve.ts.AlphaStepper.initial_velocity` has
zero rows and no solution; the reference calls it anyway, its BiCGStab
divides by zero, V0 is NaN and every step's Newton stops at 0
iterations with U unchanged.  With μ0 = 0, φ_t = Δμ0 = 0, and V's μ
component never enters the residual."""

from __future__ import annotations

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import AlphaStepper, integrate

__all__ = ["ifunction", "make_space", "initial_condition", "run"]


def ifunction(pt, shift, Ve, t, Ue, ctx):
    eps = ctx.get("epsilon", 0.1)
    phi, mu = pt.value(Ue)
    phi_t = pt.value(Ve)[0]
    gphi, gmu = pt.grad(Ue)
    lap_phi = pt.del2(Ue)[0]
    N0, N1 = pt.shape0, pt.shape1
    lapN = torch.diagonal(pt.shape2, dim1=-2, dim2=-1).sum(-1)
    # φ_t = Δμ  (weak: N φ_t + ∇N·∇μ = 0)
    R1 = N0 * phi_t + N1 @ gmu
    # weak μ = φ³ + (1-ε)φ + 2Δφ + Δ²φ:
    # N μ - N(φ³+(1-ε)φ) + 2∇N·∇φ - ΔN Δφ = 0
    R2 = N0 * (mu - phi**3 - (1 - eps) * phi) + 2 * (N1 @ gphi) - lapN * lap_phi
    return torch.stack([R1, R2], dim=-1)


def make_space(nel=24, L=16 * np.pi, dtype=torch.float64, device=None) -> Space:
    """Periodic C¹ p=2 on [0, L]², dof 2, order-2 tables."""
    axes = [Axis.uniform(p=2, nel=nel, u0=0.0, u1=L, periodic=True) for _ in range(2)]
    return Space(axes, dof=2, dtype=dtype, order=2, device=device)


def initial_condition(space, phibar=0.07, noise=0.02, seed=0):
    """φ = φ̄ + uniform noise, μ = 0, drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    phi = phibar + noise * (rng.random((space.nnodes, 1)) - 0.5)
    return torch.as_tensor(np.concatenate([phi, np.zeros_like(phi)], axis=1),
                           dtype=space.dtype, device=space.device)


def run(space, U0, *, dt=0.1, nsteps=3, epsilon=0.25, newton_kw=None):
    """Generalized-α from V0 = 0 (module docstring); Newton–BiCGStab on
    the kernel operator unless ``newton_kw`` replaces the default.
    Returns U."""
    st = AlphaStepper(space, ifunction, ctx={"epsilon": epsilon},
                      newton_kw=newton_kw or dict(rtol=1e-6, linear_solver="bicgstab",
                                                  maxit=15, operator="fast"))
    U, _ = integrate(st, U0, 0.0, dt, nsteps, V0=torch.zeros_like(U0))
    return U
