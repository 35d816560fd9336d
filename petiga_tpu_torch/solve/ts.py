"""Time integration (port of :mod:`petiga_tpu.solve.ts`): the analog of
the reference's TS layer — IFunction forms into TSTHETA/TSALPHA,
I2Function forms into TSALPHA2, RHS forms for explicit stepping, and
error-controlled generalized-α stepping (TSADAPTBASIC).

Each implicit step is a Newton solve of a *stage residual* that is affine
in the unknown end-of-step state; the affine states (U0, V0, A0) travel
through the assembly's ``aux`` closures and the Jacobian (including the
shift structure a·dF/dV + dF/dU) comes from forward-mode AD of the
composed residual.  ``t`` and ``dt`` may be Python floats or 0-d tensors
(the device-side adaptive controller passes tensors).

User forms:
  ifunction(pt, shift, Ve, t, Ue, ctx) -> R                 [TSTHETA/TSALPHA]
  iefunction(pt, shift, Ve, t, Ue, t0, U0e, ctx) -> R       [energy-stable]
  i2function(pt, shiftA, Ae, shiftV, Ve, t, Ue, ctx) -> R   [TSALPHA2]
  rhsfunction(pt, t, Ue, ctx) -> R                          [explicit]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..assembly.assemble import assemble_function, assemble_system
from .krylov import cg, jacobi_preconditioner
from .newton import newton

__all__ = [
    "ThetaStepper",
    "AlphaStepper",
    "Alpha2Stepper",
    "ExplicitStepper",
    "integrate",
    "integrate_adaptive",
    "integrate_adaptive_device",
    "AdaptResult",
]


def _info(res):
    return res.iters, res.fnorm, res.converged


@dataclasses.dataclass
class ThetaStepper:
    """θ-method (PETSc TSTHETA, non-endpoint): solve
    F(t+θdt, U0+θ(U1-U0), (U1-U0)/dt) = 0 for U1.
    θ=1 → backward Euler; θ=0.5 → midpoint (2nd order)."""

    space: object
    ifunction: Callable
    theta: float = 0.5
    ctx: Optional[dict] = None
    newton_kw: dict = dataclasses.field(default_factory=dict)

    def step(self, U, t, dt):
        """One step from U at t: returns ``(U1, (iters, fnorm,
        converged))``."""
        th, ifn = self.theta, self.ifunction

        def form(pt, Xe, aux_e, c):
            U0e = aux_e["U0"]
            return ifn(pt, th / dt, (Xe - U0e) / dt, t + th * dt, U0e + th * (Xe - U0e), c)

        res = newton(self.space, form, U, self.ctx, aux={"U0": U}, **self.newton_kw)
        return res.U, _info(res)


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
        return U1, V1, _info(res)

    def initial_velocity(self, U, t):
        """Consistent V0: solve F(t, U0, V0) = 0 for V0 by one Newton
        solve in V.  Fix rows give V0 = 0 on Dirichlet dofs — correct for
        constant boundary values."""
        def form(pt, Xe, aux_e, c):
            return self._call(pt, 1.0, Xe, t, aux_e["U0"], t, aux_e["U0"], c)

        sp = self.space
        V0 = torch.zeros((sp.nnodes, sp.dof), dtype=sp.dtype, device=sp.device)
        return newton(sp, form, V0, self.ctx, aux={"U0": U}, **self.newton_kw).U


@dataclasses.dataclass
class Alpha2Stepper:
    """Generalized-α for second-order-in-time systems (PETSc TSALPHA2).
    α_m = (2-ρ)/(1+ρ), α_f = 1/(1+ρ), γ = ½+α_m-α_f, β = ¼(1+α_m-α_f)²."""

    space: object
    i2function: Callable
    rho_inf: float = 0.5
    ctx: Optional[dict] = None
    newton_kw: dict = dataclasses.field(default_factory=dict)

    def coeffs(self):
        r = self.rho_inf
        am = (2 - r) / (1 + r)
        af = 1.0 / (1 + r)
        g = 0.5 + am - af
        b = 0.25 * (1 + am - af) ** 2
        return am, af, g, b

    def step(self, U, V, A, t, dt):
        """One step from (U, V, A) at t: returns ``(U1, V1, A1, (iters,
        fnorm, converged))``."""
        am, af, g, b = self.coeffs()

        def newmark(Xe, U0e, V0e, A0e):
            A1 = (Xe - U0e) / (b * dt * dt) - V0e / (b * dt) - (0.5 / b - 1) * A0e
            return V0e + dt * ((1 - g) * A0e + g * A1), A1

        def form(pt, Xe, aux_e, c):
            U0e, V0e, A0e = aux_e["U0"], aux_e["V0"], aux_e["A0"]
            V1e, A1e = newmark(Xe, U0e, V0e, A0e)
            return self.i2function(pt, am / (b * dt * dt), A0e + am * (A1e - A0e),
                                   af * g / (b * dt), V0e + af * (V1e - V0e), t + af * dt,
                                   U0e + af * (Xe - U0e), c)

        res = newton(self.space, form, U, self.ctx, aux={"U0": U, "V0": V, "A0": A},
                     **self.newton_kw)
        U1 = res.U
        V1, A1 = newmark(U1, *(Z.reshape(U1.shape) for Z in (U, V, A)))
        return U1, V1, A1, _info(res)


class ExplicitStepper:
    """Explicit stepping for RHS forms M u̇ = R(t, u) (the reference's
    TSRHSFunction path): consistent-mass Jacobi-CG solves each stage on
    ``M.fast_operator()`` (the stencil kernel on the card); forward Euler
    and SSP-RK3."""

    def __init__(self, space, rhsfunction, scheme="rk3", ctx=None, mass_rtol=1e-10):
        self.space = space
        self.rhsfunction = rhsfunction
        self.scheme = scheme
        self.ctx = ctx
        self.mass_rtol = mass_rtol
        dof = space.dof

        def mass(pt, c):
            eye = torch.eye(dof, dtype=pt.shape0.dtype, device=pt.shape0.device)
            K = torch.einsum("ab,ij->aibj", torch.outer(pt.shape0, pt.shape0), eye)
            return K, torch.zeros((pt.nen, dof), dtype=K.dtype, device=K.device)

        # the mass matrix gets the same symmetric Dirichlet elimination as
        # the residual (fixed rows of R are u - v), so fixed dofs decouple
        # and du/dt = v - u there (→ 0 once the BC is satisfied)
        M, _ = assemble_system(space, mass, apply_fix=True)
        self._Mprec = jacobi_preconditioner(M)
        self._Mop = M.fast_operator()

    def rhs(self, U, t):
        """M⁻¹ R(t, U): the assembled RHS form, then one mass solve."""
        def form(pt, Ue, c):
            return self.rhsfunction(pt, t, Ue, c)

        R = assemble_function(self.space, form, U, self.ctx)
        return cg(self._Mop, R, M=self._Mprec, rtol=self.mass_rtol).x

    def step(self, U, t, dt):
        """One step: returns ``(U1, None)``."""
        U = U.reshape(self.space.nnodes, self.space.dof)
        if self.scheme == "euler":
            return U + dt * self.rhs(U, t), None
        k1 = U + dt * self.rhs(U, t)
        k2 = 0.75 * U + 0.25 * (k1 + dt * self.rhs(k1, t + dt))
        return U / 3 + 2 / 3 * (k2 + dt * self.rhs(k2, t + 0.5 * dt)), None


def integrate(stepper, U0, t0: float, dt: float, nsteps: int, ctx=None, *, V0=None,
              A0=None, monitor: Optional[Callable] = None):
    """Fixed-step host loop (TSSolve analog).  ``monitor(step, t, U)`` is
    called after each step.  ``ctx`` is accepted for compatibility, as in
    the reference; the stepper's own ctx reaches the forms.  Returns
    ``(U, V, A)`` for an :class:`Alpha2Stepper`, ``(U, V)`` for an
    :class:`AlphaStepper` (V0 from :meth:`AlphaStepper.initial_velocity`
    when not given) and ``U`` otherwise."""
    U, V, A = U0, V0, A0
    t = t0
    if isinstance(stepper, AlphaStepper) and V is None:
        V = stepper.initial_velocity(U0, t0)
    for k in range(nsteps):
        if isinstance(stepper, AlphaStepper):
            U, V, _ = stepper.step(U, V, t, dt)
        elif isinstance(stepper, Alpha2Stepper):
            U, V, A, _ = stepper.step(U, V, A, t, dt)
        else:
            U, _ = stepper.step(U, t, dt)
        t += dt
        if monitor is not None:
            monitor(k + 1, t, U)
    if isinstance(stepper, Alpha2Stepper):
        return U, V, A
    if isinstance(stepper, AlphaStepper):
        return U, V
    return U


class AdaptResult(NamedTuple):
    t: float
    steps: int
    rejections: int
    dt_final: float


def _wlte_fn(stepper, rtol, atol):
    """The weighted local-error estimate of one α step against the
    embedded backward-Euler solution ``U0 + dt·V1``, in the weighted RMS
    norm over the free dofs (a 0-d tensor)."""
    sp = stepper.space
    if not isinstance(stepper, AlphaStepper):
        raise TypeError("adaptive stepping requires an AlphaStepper "
                        "(the reference hook targets TSALPHA only)")
    # Fixed (Dirichlet) dofs are algebraic, not evolved: the first-step
    # BC-enforcement jump would otherwise put a dt-independent floor
    # under the estimate, so they are excluded from the norm.
    mask, _ = sp.dirichlet_mask()
    free = torch.as_tensor(~mask, device=sp.device)
    nfree = max(int(free.sum()), 1)

    def wlte(Uold, Unew, Vnew, dt):
        Uold = Uold.reshape(Unew.shape)
        U_be = Uold + dt * Vnew
        w = atol + rtol * torch.maximum(Uold.abs(), Unew.abs())
        d = torch.where(free, (Unew - U_be) / w, torch.zeros_like(w))
        return torch.sqrt(torch.sum(d * d) / nfree)

    return wlte


def integrate_adaptive(stepper, U0, t0: float, dt0: float, t_end: float, *, V0=None,
                       rtol: float = 1e-2, atol: float = 1e-2, safety: float = 0.9,
                       clip: tuple = (0.1, 10.0), dt_min: float = 1e-12,
                       max_steps: int = 100000, monitor: Optional[Callable] = None,
                       attempt_monitor: Optional[Callable] = None):
    """Error-controlled generalized-α stepping — the analog of the
    reference's ``TSAlphaUseAdapt`` + PETSc ``TSADAPTBASIC``.

    The local-error estimate compares the α solution U1 (2nd order) with
    the embedded backward-Euler solution ``U0 + dt·V1`` (1st order) in
    the weighted RMS norm with weights ``atol + rtol·max(|U0|,|U1|)``,
    Dirichlet dofs left out.  The basic controller accepts when
    wlte < 1 and proposes ``dt·clip(safety·wlte^(-1/3))``.  One host read
    of the estimate per step; ``monitor(steps, t, U)`` after each
    accepted step; ``attempt_monitor(t, dt, wlte, accepted)`` after each
    attempt, accepted or rejected, with the estimate already read.
    Returns ``(U, V, AdaptResult)``."""
    wlte = _wlte_fn(stepper, rtol, atol)
    U, V = U0, V0
    if V is None:
        V = stepper.initial_velocity(U0, t0)
    t, dt = float(t0), float(dt0)
    steps = rejections = 0
    lo, hi = clip
    while t < t_end - 1e-14 * max(1.0, abs(t_end)) and steps < max_steps:
        dt_try = min(dt, t_end - t)
        U1, V1, _ = stepper.step(U, V, t, dt_try)
        err = float(wlte(U, U1, V1, dt_try))
        fac = safety * err ** (-1.0 / 3.0) if err > 0 else hi
        dt = dt_try * min(max(fac, lo), hi)
        if attempt_monitor is not None:
            attempt_monitor(t, dt_try, err, err < 1.0)
        if err < 1.0:
            U, V = U1, V1
            t += dt_try
            steps += 1
            if monitor is not None:
                monitor(steps, t, U)
        else:
            rejections += 1
            if dt < dt_min:
                raise RuntimeError(f"adaptive dt underflow at t={t}")
    return U, V, AdaptResult(t, steps, rejections, dt)


def integrate_adaptive_device(stepper, U0, t0: float, dt0: float, t_end: float, *,
                              V0=None, rtol: float = 1e-2, atol: float = 1e-2,
                              safety: float = 0.9, clip: tuple = (0.1, 10.0),
                              dt_min: float = 1e-12, max_steps: int = 100000):
    """:func:`integrate_adaptive` with the controller on the device.

    The reference runs the whole adaptive run as one ``lax.while_loop``
    with no host round trip.  Torch has no such loop, and each Newton
    iteration already reads its residual norm on the host, so here the
    controller's state — t, dt, the accepted and rejected counts — lives
    in 0-d tensors of U's dtype on U's device, acceptance is a
    ``torch.where`` on U and V, and the host reads only the loop
    condition, once per step.  The step sequence is the host variant's
    (in f32, t and dt round as tensors of U's dtype, so equality with the
    host variant holds in f64).  Returns ``(U, V, AdaptResult)``."""
    wlte = _wlte_fn(stepper, rtol, atol)
    sp = stepper.space
    U = U0.reshape(sp.nnodes, sp.dof)
    V = stepper.initial_velocity(U, t0) if V0 is None else V0.reshape(U.shape)
    lo, hi = clip
    eps_end = 1e-14 * max(1.0, abs(t_end))

    def scalar(v):
        return torch.tensor(float(v), dtype=U.dtype, device=U.device)

    t, dt, steps, rej = scalar(t0), scalar(dt0), scalar(0), scalar(0)
    # the loop ends where the host variant raises (a step below dt_min);
    # the reference's loop also ends on a step equal to dt_min
    while bool((t < t_end - eps_end) & (steps < max_steps) & (dt >= dt_min)):
        dt_try = torch.minimum(dt, t_end - t)
        U1, V1, _ = stepper.step(U, V, t, dt_try)
        err = wlte(U, U1, V1, dt_try)
        fac = torch.where(err > 0, safety * err ** (-1.0 / 3.0), scalar(hi))
        dt = dt_try * torch.clamp(fac, lo, hi)
        accept = err < 1.0
        U = torch.where(accept, U1, U)
        V = torch.where(accept, V1, V)
        t = torch.where(accept, t + dt_try, t)
        steps = steps + accept.to(U.dtype)
        rej = rej + (~accept).to(U.dtype)
    return U, V, AdaptResult(float(t), int(steps), int(rej), float(dt))
