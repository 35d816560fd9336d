"""Shallow-water equations (port of :mod:`petiga_tpu.models.shallowwater`),
PetIGA's demo/ShallowWater.c: dof-3 (h, u, v) in non-conservative form,

  h_t + ∇·(h u) = 0
  u_t + u·∇u + g ∇h = 0

integrated with generalized-α on a periodic C¹ space."""

from __future__ import annotations

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import AlphaStepper, integrate

__all__ = ["ifunction", "make_space", "run"]


def ifunction(pt, shift, Ve, t, Ue, ctx):
    g = ctx.get("gravity", 1.0)
    h, u, v = pt.value(Ue)
    h_t, u_t, v_t = pt.value(Ve)
    gh, gu, gv = pt.grad(Ue)  # (2,) each
    uvec = torch.stack([u, v])
    div_hu = gh @ uvec + h * (gu[0] + gv[1])
    N0 = pt.shape0
    Rh = N0 * (h_t + div_hu)
    Ru = N0 * (u_t + uvec @ gu + g * gh[0])
    Rv = N0 * (v_t + uvec @ gv + g * gh[1])
    return torch.stack([Rh, Ru, Rv], dim=-1)


def make_space(nel=16, dtype=torch.float64, device=None) -> Space:
    """Periodic C¹ p=2 on the unit square, dof 3."""
    axes = [Axis.uniform(p=2, nel=nel, periodic=True) for _ in range(2)]
    return Space(axes, dof=3, dtype=dtype, device=device)


def run(space, *, dt=0.01, nsteps=5, amp=0.05, newton_kw=None):
    """Gaussian hump release on a periodic basin; Newton–BiCGStab on the
    kernel operator unless ``newton_kw`` replaces the default.  Returns
    ``(U0, U)``."""
    G = space.greville_coordinates()
    U0 = np.zeros((space.nnodes, 3))
    U0[:, 0] = 1.0 + amp * np.exp(-100 * np.sum((G - 0.5) ** 2, axis=1))
    U0 = torch.as_tensor(U0, dtype=space.dtype, device=space.device)
    st = AlphaStepper(space, ifunction, ctx={"gravity": 1.0},
                      newton_kw=newton_kw or dict(rtol=1e-8, linear_solver="bicgstab",
                                                  operator="fast"))
    U, _ = integrate(st, U0, 0.0, dt, nsteps)
    return U0, U
