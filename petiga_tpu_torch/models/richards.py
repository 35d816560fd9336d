"""Richards equation (port of :mod:`petiga_tpu.models.richards`), PetIGA's
demo/Richards.c: variably saturated flow, a nonlinear transient scalar

  C(ψ) ψ_t = ∇·(K(ψ) ∇(ψ + z))

with the Gardner exponential constitutive model
K(ψ) = Ks e^{α min(ψ,0)}, θ(ψ) = θr + (θs-θr) e^{α min(ψ,0)}.

``min(ψ, 0)`` is ``torch.minimum`` against a zero tensor: its
forward-mode derivative at a tie is ½, as ``jnp.minimum``'s is
(``torch.clamp`` would give 1)."""

from __future__ import annotations

import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import ThetaStepper, integrate

__all__ = ["ifunction", "make_space", "run"]


def _model(psi, ctx):
    Ks = ctx.get("Ks", 1.0)
    alpha = ctx.get("alpha", 2.0)
    ths, thr = ctx.get("theta_s", 0.4), ctx.get("theta_r", 0.05)
    pneg = torch.minimum(psi, torch.zeros_like(psi))
    K = Ks * torch.exp(alpha * pneg)
    C = (ths - thr) * alpha * torch.exp(alpha * pneg)  # dθ/dψ
    return K, C


def ifunction(pt, shift, Ve, t, Ue, ctx):
    psi = pt.value(Ue)[0]
    psi_t = pt.value(Ve)[0]
    gpsi = pt.grad(Ue)[0]
    K, C = _model(psi, ctx)
    # gravity along the last axis: ∇(ψ+z) adds e_z (built out of place)
    ez = torch.cat([torch.zeros_like(gpsi[:-1]), torch.ones_like(gpsi[-1:])])
    return pt.shape0 * C * psi_t + pt.shape1 @ (K * (gpsi + ez))


def make_space(nel=16, dim=1, dtype=torch.float64, device=None) -> Space:
    """p=2 on the unit interval/square; ψ = 0 (ponded) on the top face."""
    axes = [Axis.uniform(p=2, nel=nel) for _ in range(dim)]
    sp = Space(axes, dof=1, dtype=dtype, device=device)
    # ponded infiltration at the top (psi = 0), free drainage bottom
    sp.set_boundary_value(dim - 1, 1, 0, 0.0)
    return sp


def run(space, *, dt=1e-3, nsteps=5, psi0=-2.0, newton_kw=None):
    """Backward Euler (θ = 1) from a uniform ψ0; Newton–BiCGStab on the
    kernel operator unless ``newton_kw`` replaces the default.  Returns
    ``(U0, U)``."""
    U0 = torch.full((space.nnodes, 1), psi0, dtype=space.dtype, device=space.device)
    st = ThetaStepper(
        space, ifunction, theta=1.0, ctx={},
        newton_kw=newton_kw or dict(rtol=1e-8, linear_solver="bicgstab", maxit=30,
                                    operator="fast"),
    )
    return U0, integrate(st, U0, 0.0, dt, nsteps)
