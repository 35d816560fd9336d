"""Two-phase two-component porous-media flow (port of
:mod:`petiga_tpu.models.twophase`), PetIGA's
demo/TwoPhaseTwoComponent.c: liquid pressure Pl and dissolved-gas density
ρ_lh, a transient nonlinear IFunction with a boundary-integral injection
residual, under the reference's simplified smooth saturation law.

``max(Pc, 0)`` is ``torch.maximum`` against a zero tensor (its
forward-mode derivative at a tie is ½, as ``jnp.maximum``'s is); the
boundary residual is stacked, not written into a slice, so batched AD
sees no in-place write."""

from __future__ import annotations

import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import ThetaStepper, integrate

__all__ = ["ifunction", "injection_boundary", "make_space", "run"]


def _eos(Pl, rholh, ctx):
    """Saturation + mobilities from a smooth capillary law."""
    H = ctx.get("H", 1.0)  # Henry constant (scaled)
    Pc = rholh / H - Pl  # capillary pressure proxy
    Sl = 1.0 / (1.0 + torch.maximum(Pc, torch.zeros_like(Pc)) ** 2)
    return Sl, Sl**2, (1 - Sl) ** 2


def ifunction(pt, shift, Ve, t, Ue, ctx):
    phi = ctx.get("porosity", 0.3)
    k = ctx.get("k", 1.0)
    D = ctx.get("D", 0.05)
    mul, mug = ctx.get("mul", 1.0), ctx.get("mug", 0.1)
    H = ctx.get("H", 1.0)

    Pl, rholh = pt.value(Ue)
    Pl_t, rholh_t = pt.value(Ve)
    gPl, grholh = pt.grad(Ue)

    Sl, krl, krg = _eos(Pl, rholh, ctx)
    gPg = grholh / H  # gas pressure via Henry: Pg ~ rholh / H
    N0, N1 = pt.shape0, pt.shape1
    # ∂t(Sl) by a forward difference along (Pl_t, rholh_t), as the
    # reference does (it amplifies rounding by about 1/eps)
    eps = 1e-6
    Sl_p, _, _ = _eos(Pl + eps * Pl_t, rholh + eps * rholh_t, ctx)
    Sl_t = (Sl_p - Sl) / eps
    # water component: φ ∂t(Sl) + ∇·(−k krl/μl ∇Pl)
    Rw = N0 * phi * Sl_t + (k * krl / mul) * (N1 @ gPl)
    # hydrogen component: φ ∂t(Sl ρ_lh) + diffusion + gas Darcy flux
    Rh = (N0 * phi * (Sl_t * rholh + Sl * rholh_t) + D * phi * Sl * (N1 @ grholh)
          + (k * krg / mug) * rholh * (N1 @ gPg))
    return torch.stack([Rw, Rh], dim=-1)


def injection_boundary(pt, Ue, aux_e, ctx):
    """Boundary injection flux (LeftInjectionResidual analog): constant
    hydrogen inflow on the flagged face."""
    q = ctx.get("inflow", 0.1)
    return torch.stack([torch.zeros_like(pt.shape0), -q * pt.shape0], dim=-1)


def make_space(nel=16, dtype=torch.float64, device=None) -> Space:
    """p=1 on [0, 1], dof 2: the state fixed at the right, injection at
    the left."""
    sp = Space([Axis.uniform(p=1, nel=nel)], dof=2, dtype=dtype, device=device)
    sp.set_boundary_value(0, 1, 0, 1.0)  # Pl
    sp.set_boundary_value(0, 1, 1, 0.0)  # rholh
    sp.set_boundary_form(0, 0)
    return sp


def run(space, *, dt=0.01, nsteps=5, ctx=None, newton_kw=None):
    """Backward Euler from Pl = 1, ρ_lh = 0, the injection form as
    Newton's ``boundary=``; ``newton_kw`` updates the default (as in the
    reference), which runs Newton–BiCGStab on the kernel operator.
    Returns ``(U0, U)``."""
    c = {"inflow": 0.1, **(ctx or {})}
    U0 = torch.zeros((space.nnodes, 2), dtype=space.dtype, device=space.device)
    U0[:, 0] = 1.0
    st = ThetaStepper(
        space, ifunction, theta=1.0, ctx=c,
        newton_kw=dict(
            rtol=1e-8, linear_solver="bicgstab", maxit=30, operator="fast",
            # stage residuals carry aux closures, so the boundary form
            # takes the (pt, Xe, aux_e, ctx) signature
            boundary=injection_boundary,
            **(newton_kw or {}),
        ),
    )
    return U0, integrate(st, U0, 0.0, dt, nsteps)
