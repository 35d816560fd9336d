"""Time integration (port of the generalized-α half of
:mod:`petiga_tpu.solve.ts`): the analog of the reference's TS layer
(IFunction forms into TSALPHA).

Each step is a Newton solve of a *stage residual* that is affine in the
unknown end-of-step state; the affine states (U0, V0) travel through the
assembly's ``aux`` closures and the Jacobian (including the shift
structure a·dF/dV + dF/dU) comes from forward-mode AD of the composed
residual.

User forms:
  ifunction(pt, shift, Ve, t, Ue, ctx) -> R
  iefunction(pt, shift, Ve, t, Ue, t0, U0e, ctx) -> R   (energy-stable)

The θ-method, TSALPHA2, explicit steppers and adaptive stepping are not
ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .newton import newton

__all__ = ["AlphaStepper", "integrate"]


@dataclasses.dataclass
class AlphaStepper:
    """Generalized-α for first-order systems (PETSc TSALPHA).  ρ∞ ∈ [0,1]
    controls high-frequency damping: α_m = ½(3-ρ)/(1+ρ), α_f = 1/(1+ρ),
    γ = ½ + α_m - α_f."""

    space: object
    ifunction: Callable = None
    rho_inf: float = 0.5
    ctx: Optional[dict] = None
    newton_kw: dict = dataclasses.field(default_factory=dict)
    iefunction: Callable = None  # IEFunction variant carrying (t0, U0)

    def __post_init__(self):
        if self.ifunction is None and self.iefunction is None:
            raise ValueError("need ifunction or iefunction")

    def coeffs(self):
        r = self.rho_inf
        am = 0.5 * (3 - r) / (1 + r)
        af = 1.0 / (1 + r)
        g = 0.5 + am - af
        return am, af, g

    def _call(self, pt, shift, Ve, t, Ue, t0, U0e, c):
        if self.iefunction is not None:
            return self.iefunction(pt, shift, Ve, t, Ue, t0, U0e, c)
        return self.ifunction(pt, shift, Ve, t, Ue, c)

    def step(self, U, V, t, dt):
        """One step from (U, V) at t: returns ``(U1, V1, (iters, fnorm,
        converged))``."""
        am, af, g = self.coeffs()

        def form(pt, Xe, aux_e, c):
            U0e, V0e = aux_e["U0"], aux_e["V0"]
            # V1 = (X - U0)/(γ dt) + (1 - 1/γ) V0
            V1e = (Xe - U0e) / (g * dt) + (1 - 1 / g) * V0e
            Uaf = U0e + af * (Xe - U0e)
            Vam = V0e + am * (V1e - V0e)
            return self._call(pt, am * af / (g * dt), Vam, t + af * dt, Uaf, t, U0e, c)

        res = newton(self.space, form, U, self.ctx, aux={"U0": U, "V0": V}, **self.newton_kw)
        U1 = res.U
        V1 = (U1 - U.reshape(U1.shape)) / (g * dt) + (1 - 1 / g) * V.reshape(U1.shape)
        return U1, V1, (res.iters, res.fnorm, res.converged)

    def initial_velocity(self, U, t):
        """Consistent V0: solve F(t, U0, V0) = 0 for V0 by one Newton
        solve in V.  Fix rows give V0 = 0 on Dirichlet dofs — correct for
        constant boundary values."""
        def form(pt, Xe, aux_e, c):
            return self._call(pt, 1.0, Xe, t, aux_e["U0"], t, aux_e["U0"], c)

        sp = self.space
        V0 = torch.zeros((sp.nnodes, sp.dof), dtype=sp.dtype, device=sp.device)
        return newton(sp, form, V0, self.ctx, aux={"U0": U}, **self.newton_kw).U


def integrate(stepper, U0, t0: float, dt: float, nsteps: int, *, V0=None,
              monitor: Optional[Callable] = None):
    """Fixed-step host loop (TSSolve analog) for an :class:`AlphaStepper`;
    ``monitor(step, t, U)`` is called after each step.  Returns
    ``(U, V)``."""
    U, V = U0, V0
    t = t0
    if V is None:
        V = stepper.initial_velocity(U0, t0)
    for k in range(nsteps):
        U, V, _ = stepper.step(U, V, t, dt)
        t += dt
        if monitor is not None:
            monitor(k + 1, t, U)
    return U, V
