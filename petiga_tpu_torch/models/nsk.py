"""Isothermal Navier–Stokes–Korteweg (port of :mod:`petiga_tpu.models.nsk`),
PetIGA's demo/NavierStokesKorteweg2D.c: compressible two-phase flow with
capillarity, dof 3 (ρ, u, v) on periodic C¹ splines, van der Waals
pressure, the Korteweg stress through Hessians of ρ."""

from __future__ import annotations

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import AlphaStepper, integrate

__all__ = ["residual", "make_space", "vdw_bubble_ic", "run"]


def residual(pt, shift, Ve, t, Ue, ctx):
    """NSK residual (NavierStokesKorteweg2D.c:26-94)."""
    Ca2 = ctx["Ca"] ** 2
    rRe = 1.0 / ctx["Re"]
    theta = ctx["theta"]
    sol = pt.value(Ue)  # (ρ, u, v)
    sol_t = pt.value(Ve)
    grads = pt.grad(Ue)  # (3, 2)
    hess = pt.hess(Ue)  # (3, 2, 2)

    rho, rho_t = sol[0], sol_t[0]
    grho = grads[0]
    lap_rho = hess[0, 0, 0] + hess[0, 1, 1]
    u = sol[1:]
    u_t = sol_t[1:]
    gu = grads[1:, :]  # (2, 2)
    p = 8.0 / 27.0 * theta * rho / (1.0 - rho) - rho * rho  # van der Waals

    N0, N1 = pt.shape0, pt.shape1
    adv = N1 @ u  # (nen,)

    Rc = N0 * rho_t - rho * adv
    Rm = []
    for i in range(2):
        r = N0 * (rho_t * u[i] + rho * u_t[i])
        r = r - rho * u[i] * adv
        r = r - N1[:, i] * p
        r = r + rRe * (N1 @ gu[i])
        r = r + rRe * (N1 @ gu[:, i])
        r = r - (2.0 / 3.0) * rRe * N1[:, i] * (gu[0, 0] + gu[1, 1])
        r = r + Ca2 * N1[:, i] * rho * lap_rho
        r = r + 0.5 * Ca2 * N1[:, i] * (grho @ grho)
        r = r - Ca2 * grho[i] * (N1 @ grho)
        Rm.append(r)
    return torch.stack([Rc, Rm[0], Rm[1]], dim=-1)


def make_space(nel=16, dtype=torch.float64, device=None) -> Space:
    """Periodic C¹ p=2 on the unit square, dof 3, order-2 tables."""
    axes = [Axis.uniform(p=2, nel=nel, periodic=True) for _ in range(2)]
    return Space(axes, dof=3, dtype=dtype, order=2, device=device)


def vdw_bubble_ic(space, rho_in=0.15, rho_out=0.6, r0=0.2):
    """A vapor bubble in liquid (smooth tanh interface)."""
    G = space.greville_coordinates()
    r = np.sqrt(np.sum((G - 0.5) ** 2, axis=1))
    U = np.zeros((space.nnodes, 3))
    U[:, 0] = rho_out + (rho_in - rho_out) * 0.5 * (1 - np.tanh((r - r0) / 0.05))
    return torch.as_tensor(U, dtype=space.dtype, device=space.device)


def run(space, U0, *, Ca=0.05, Re=100.0, theta=0.85, dt=1e-4, nsteps=2, newton_kw=None):
    """Generalized-α; Newton–BiCGStab on the kernel operator unless
    ``newton_kw`` replaces the default.  Returns U."""
    st = AlphaStepper(space, residual, ctx={"Ca": Ca, "Re": Re, "theta": theta},
                      newton_kw=newton_kw or dict(rtol=1e-6, linear_solver="bicgstab",
                                                  maxit=15, operator="fast"))
    U, _ = integrate(st, U0, 0.0, dt, nsteps)
    return U
