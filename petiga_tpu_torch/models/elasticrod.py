"""Second-order-in-time elastic rod (port of
:mod:`petiga_tpu.models.elasticrod`), PetIGA's demo/ElasticRod.c:
ρ ü = E u'' on a 1-D rod, integrated with generalized-α2 (TSALPHA2,
ρ∞ = 0.5)."""

from __future__ import annotations

import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import Alpha2Stepper, integrate

__all__ = ["i2function", "make_space", "run"]


def i2function(pt, shiftA, Ae, shiftV, Ve, t, Ue, ctx):
    """R_a = ρ N_a ü + E N_a' u' (ElasticRodFJ.F90 IFunction)."""
    rho, E = ctx["rho"], ctx["E"]
    return rho * pt.value(Ae)[0] * pt.shape0 + E * (pt.shape1 @ pt.grad(Ue)[0])


def make_space(nel=64, p=2, dtype=torch.float64, device=None) -> Space:
    """Both ends clamped (u = 0)."""
    sp = Space([Axis.uniform(p=p, nel=nel)], dof=1, dtype=dtype, device=device)
    sp.set_boundary_value(0, 0, 0, 0.0)
    sp.set_boundary_value(0, 1, 0, 0.0)
    return sp


def run(space, *, rho=1.0, E=1.0, dt=0.01, nsteps=10, rho_inf=0.5, U0=None, V0=None,
        newton_kw=None):
    """Pluck the center (U[n/2] = 1, ElasticRod.c:73-78) and integrate;
    Newton on the kernel operator unless ``newton_kw`` replaces the
    default.  Returns ``(U, V, A)``."""
    ctx = {"rho": rho, "E": E}
    if U0 is None:
        U0 = torch.zeros((space.nnodes, 1), dtype=space.dtype, device=space.device)
        U0[space.nnodes // 2, 0] = 1.0
    if V0 is None:
        V0 = torch.zeros_like(U0)
    st = Alpha2Stepper(space, i2function, rho_inf=rho_inf, ctx=ctx,
                       newton_kw=newton_kw or dict(rtol=1e-10, operator="fast"))
    return integrate(st, U0, 0.0, dt, nsteps, V0=V0, A0=torch.zeros_like(U0))
