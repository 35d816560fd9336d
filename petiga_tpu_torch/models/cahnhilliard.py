"""Cahn–Hilliard phase-field model (port of
:mod:`petiga_tpu.models.cahnhilliard`): 4th-order operator in primal form
on periodic C¹ quadratic B-splines, degenerate mobility, logarithmic
chemical potential, generalized-α stepping, Ginzburg–Landau free-energy
monitor.

Two integrations: :func:`run` (the AlphaStepper with the AD Jacobian of the
pointwise residual) and :func:`run_conv`, the large-scale route: the
Jacobian is conv-assembled every Newton iteration from order-2 channels
with value/gradient/Hessian state fields, the residual is conv-assembled
from test channels, and BiCGStab runs in the packed kernel layout, so
every inner product launches the periodic stencil kernel.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..assembly.assemble import compute_scalar
from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import AlphaStepper, integrate

__all__ = [
    "mobility",
    "dmobility",
    "ddmobility",
    "chemical_potential_d",
    "chemical_potential_dd",
    "residual",
    "free_energy_stats",
    "jacobian_coefficients",
    "residual_channels",
    "make_space",
    "initial_condition",
    "run",
    "run_conv",
]


def mobility(c):
    """M(c) = c(1-c)."""
    return c * (1 - c)


def dmobility(c):
    return 1 - 2 * c


def ddmobility(c):
    return -2.0 * torch.ones_like(c)


def chemical_potential_d(c, theta, alpha):
    """dμ/dc = 3α (1/(2θ c(1-c)) - 2)."""
    return 3 * alpha * (0.5 / theta / (c * (1 - c)) - 2.0)


def chemical_potential_dd(c, theta, alpha):
    """d²μ/dc² = -3α/(2θ) · (1-2c)/(c(1-c))²."""
    return -3 * alpha / (2 * theta) * (1 - 2 * c) / (c * (1 - c)) ** 2


def _trace(h):
    return torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)


def residual(pt, shift, Ve, t, Ue, ctx):
    """R_a = N_a c_t + (∇N_a·∇c)(M μ' + M' Δc) + ΔN_a M Δc."""
    theta, alpha = ctx["theta"], ctx["alpha"]
    c = pt.value(Ue)[0]
    c_t = pt.value(Ve)[0]
    gc = pt.grad(Ue)[0]
    d2c = pt.del2(Ue)[0]
    M = mobility(c)
    dM = dmobility(c)
    dmu = chemical_potential_d(c, theta, alpha)
    t1 = M * dmu + dM * d2c
    lapN = _trace(pt.shape2)  # (nen,)
    return pt.shape0 * c_t + (pt.shape1 @ gc) * t1 + lapN * M * d2c


def free_energy_stats(pt, Ue, ctx):
    """[free energy density, 2nd moment, 3rd moment] of c - cbar."""
    theta, alpha = ctx["theta"], ctx["alpha"]
    cbar = ctx["cbar"]
    c = pt.value(Ue)[0]
    gc = pt.grad(Ue)[0]
    E = (
        c * torch.log(c)
        + (1 - c) * torch.log(1 - c)
        + 2 * theta * c * (1 - c)
        + theta / (3 * alpha) * torch.sum(gc * gc)
    )
    diff = c - cbar
    return torch.stack([E, diff * diff, diff * diff * diff])


def make_space(dim=2, nel=32, dtype=torch.float64, device=None) -> Space:
    """Periodic C¹ quadratic space, order-2 tabulation."""
    axes = [Axis.uniform(p=2, nel=nel, periodic=True) for _ in range(dim)]
    return Space(axes, dof=1, dtype=dtype, order=2, device=device)


def initial_condition(space, cbar=0.63, noise=0.05, seed=0):
    """cbar + uniform noise, drawn by ``numpy.random.default_rng(seed)``
    exactly as the reference draws it."""
    rng = np.random.default_rng(seed)
    u = cbar + noise * (rng.random((space.nnodes, 1)) - 0.5)
    return torch.as_tensor(u, dtype=space.dtype, device=space.device)


def _stats(space, U, ctx, chunk=None):
    s = compute_scalar(space, free_energy_stats, U, ctx, order=1, chunk=chunk)
    return s.cpu().numpy()


def run(space, U0, *, theta=1.5, alpha=3000.0, cbar=0.63, dt=1e-11, nsteps=2,
        rho_inf=0.5, newton_kw=None, monitor=None):
    """Generalized-α integration with the free-energy/statistics monitor.
    Returns ``(U, stats_log)``, one ``(step, t, E, m2, m3)`` per step."""
    ctx = {"theta": theta, "alpha": alpha, "cbar": cbar}
    stepper = AlphaStepper(space, residual, rho_inf=rho_inf, ctx=ctx,
                           newton_kw=newton_kw or dict(rtol=1e-6, linear_solver="bicgstab"))
    stats_log = []

    def mon(step, t, U):
        s = _stats(space, U, ctx)
        stats_log.append((step, t, *s))
        if monitor is not None:
            monitor(step, t, U, s)

    U, _ = integrate(stepper, U0, 0.0, dt, nsteps, monitor=mon)
    return U, stats_log


def jacobian_coefficients(x, ctx, fields):
    """The time-stepper Jacobian as a coefficient spec with
    second-derivative channels and state (value/gradient/Hessian)
    dependent coefficients.  Pass ``fields={"c": (C, 2)}``;
    ``ctx["shift"]`` adds the ∂/∂c_t mass term of the α scheme and
    ``ctx["scale"]`` is the α-scheme chain factor α_f of the spatial
    terms.

    J(w, v) = shift·w v + s·[∇w·∇v t1 + (∇v·∇c)(∂t1/∂c) w
              + (∇v·∇c) M' Δw + Δv M Δw + Δv M' Δc w]
    with t1 = Mμ' + M'Δc (rows = test v, cols = trial w)."""
    theta, alpha = ctx["theta"], ctx["alpha"]
    shift = ctx.get("shift", 0.0)
    scale = ctx.get("scale", 1.0)
    dim = x.shape[-1]
    c = fields["c"]
    gc = fields["c_grad"]
    d2c = _trace(fields["c_hess"])
    M = mobility(c)
    dM = dmobility(c)
    ddM = ddmobility(c)
    dmu = chemical_potential_d(c, theta, alpha)
    ddmu = chemical_potential_dd(c, theta, alpha)
    t1 = M * dmu + dM * d2c
    dt1 = dM * dmu + M * ddmu + ddM * d2c  # ∂t1/∂c
    ch = {}
    if not isinstance(shift, (int, float)) or shift != 0.0:
        ch[(0, 0)] = shift
    for d in range(dim):
        ch[(d + 1, d + 1)] = scale * t1
        ch[(d + 1, 0)] = scale * gc[..., d] * dt1
        ch[((d, d), 0)] = scale * dM * d2c
        for e in range(dim):
            ch[(d + 1, (e, e))] = scale * gc[..., d] * dM
            ch[((d, d), (e, e))] = scale * M
    return ch


def _mass_coef(x, ctx):
    return {(0, 0): 1.0}


def residual_channels(x, ctx, fe):
    """The residual as conv TEST channels with state fields ``c`` (order
    2) and ``ct`` (order 0): R_a = N_a·ct + ∇N_a·(∇c·t1) + ΔN_a·(M Δc),
    t1 = Mμ' + M'Δc — the algebra of :func:`residual`, test side
    factored out."""
    theta, alpha = ctx["theta"], ctx["alpha"]
    c = fe["c"]
    gc = fe["c_grad"]
    d2c = _trace(fe["c_hess"])
    M = mobility(c)
    dM = dmobility(c)
    dmu = chemical_potential_d(c, theta, alpha)
    t1 = M * dmu + dM * d2c
    ch = {0: fe["ct"]}
    for d in range(x.shape[-1]):
        ch[d + 1] = gc[..., d] * t1
        ch[(d, d)] = M * d2c
    return ch


def _true_rel_residual(J, R, dX):
    """``‖−R − J·dX‖ / ‖R‖`` of a Newton correction, in float64: the
    planes copied to f64 and applied by the same kernel."""
    R64 = R.double()
    r = R64 + J.matvec_packed(J.DT.double(), dX.double())
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(R64))


def run_conv(space, U0, *, theta=1.5, alpha=3000.0, cbar=0.63, dt=1e-11, nsteps=2,
             rho_inf=0.5, rtol_newton=1e-6, max_newton=8, rtol_inner=1e-8, monitor=None,
             counters=None, chunk=None, stol=0.0, conv_residual=True):
    """Generalized-α integration with the Jacobian conv-assembled each
    Newton iteration (order-2 channels + value/grad/Hessian state
    fields); the same α-scheme algebra as
    :class:`~petiga_tpu_torch.solve.ts.AlphaStepper`.  The residual is
    conv-assembled from test channels (``conv_residual``; identity map,
    dof 1, unit-step axes) or else assembled pointwise.  Each Newton
    correction is a Jacobi-BiCGStab solve in the packed kernel layout.

    ``stol > 0`` adds the increment test: a Newton step with ‖dX‖ ≤
    stol·‖X‖ ends the step at once, skipping the final residual
    assembly (the recorded ``fnorm`` is then the one before that
    correction, as in the reference).  ``counters`` (a dict) collects per
    step ``newton_iters``, ``fnorm``, ``rhist``, the BiCGStab iterations
    ``lin_iters``, each solve's true relative residual ``‖−R − J·dX‖/‖R‖``
    in float64 (``lin_true_rel``: an f64 copy of the planes and one more
    product through the kernel, outside the timed spans) and the seconds of
    each residual, Jacobian assembly and linear solve (``residual_s``,
    ``jacobian_s``, ``solve_s``; with counters the device is synchronised
    before each reading).  ``chunk``
    bounds the element chunk of the pointwise assemblies and of the
    statistics.

    Returns ``(U, stats_log)`` like :func:`run`."""
    from ..assembly.assemble import assemble_function
    from ..assembly.convform import assemble_coefficient_planes, assemble_residual_conv
    from ..assembly.fastpath import is_unit_step
    from ..solve.krylov import bicgstab, cg

    sp = space
    am, af, g = AlphaStepper(sp, residual, rho_inf=rho_inf).coeffs()
    ctx = {"theta": theta, "alpha": alpha, "cbar": cbar}

    def alpha_form(pt, Xe, aux_e, c):
        U0e, V0e = aux_e["U0"], aux_e["V0"]
        V1e = (Xe - U0e) / (g * c["dt"]) + (1 - 1 / g) * V0e
        Uaf = U0e + af * (Xe - U0e)
        Vam = V0e + am * (V1e - V0e)
        return residual(pt, am * af / (g * c["dt"]), Vam, c["t"], Uaf, c)

    use_conv_res = (conv_residual and sp.dof == 1 and not sp.has_geometry
                    and not sp.is_rational and is_unit_step(sp))

    def packed_solve(op, rhs, solver, rtol, maxiter):
        dv = op.packed_diag_inv()
        res = solver(lambda v: op.matvec_xb(op.DT, v), op.pack_vec(rhs),
                     M=lambda z: z * dv, rtol=rtol, maxiter=maxiter)
        return op.unpack_vec(res.x), res.iters

    def stamp(times, t0):
        """Seconds since ``t0`` into ``times``, the device synchronised;
        returns the new time origin."""
        if counters is None:
            return t0
        if sp.device.type == "cuda":
            torch.cuda.synchronize(sp.device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        return t1

    def newton_step(U, V, t, dts):
        cstep = dict(ctx, t=t, dt=dts)
        # dR/dX of the mass term is dVam/dX = αm/(γ·dt), with NO α_f
        # factor: the α_f chain applies only to the spatial terms
        # evaluated at U_αf, carried by the `scale` channel coefficient.
        jctx = {"theta": theta, "alpha": alpha, "shift": am / (g * dts), "scale": af}
        X = U
        rnorm0 = None
        nit = 0
        rhist, lin, lin_rel, t_res, t_jac, t_sol = [], [], [], [], [], []
        for _ in range(max_newton):
            t0 = stamp([], 0.0)
            if use_conv_res:
                # Vam and Uaf are nodal-linear in (X, U, V): their point
                # values are field evaluations of these node vectors
                V1v = (X - U) / (g * dts) + (1 - 1 / g) * V
                R = assemble_residual_conv(
                    sp, residual_channels, cstep,
                    fields={"c": ((U + af * (X - U)).reshape(-1), 2),
                            "ct": ((V + am * (V1v - V)).reshape(-1), 0)})
            else:
                R = assemble_function(sp, alpha_form, X, cstep, aux={"U0": U, "V0": V},
                                      chunk=chunk)
            rn = torch.linalg.vector_norm(R).item()
            t0 = stamp(t_res, t0)
            rhist.append(rn)
            if rnorm0 is None:
                rnorm0 = max(rn, 1e-30)
            if rn <= rtol_newton * rnorm0:
                break
            J, _ = assemble_coefficient_planes(
                sp, jacobian_coefficients, jctx,
                fields={"c": ((U + af * (X - U)).reshape(-1), 2)}, apply_fix=False)
            t0 = stamp(t_jac, t0)
            dX, its = packed_solve(J, -R, bicgstab, rtol_inner, 2000)
            stamp(t_sol, t0)
            if counters is not None:
                lin_rel.append(_true_rel_residual(J, R, dX))
            del J
            lin.append(its)
            X = X + dX
            nit += 1
            if stol > 0.0:
                sn = (torch.linalg.vector_norm(dX) / torch.linalg.vector_norm(X)).item()
                if sn <= stol:
                    break
        if counters is not None:
            counters.setdefault("newton_iters", []).append(nit)
            counters.setdefault("fnorm", []).append(rn)
            counters.setdefault("rhist", []).append(rhist)
            counters.setdefault("lin_iters", []).append(lin)
            counters.setdefault("lin_true_rel", []).append(lin_rel)
            for key, times in (("residual_s", t_res), ("jacobian_s", t_jac),
                               ("solve_s", t_sol)):
                counters.setdefault(key, []).append(times)
        return X, (X - U) / (g * dts) + (1 - 1 / g) * V

    # consistent initial velocity: M V0 = -R_spatial(U0) (linear in V)
    def v0_res(pt, Xe, aux_e, c):
        return residual(pt, 1.0, torch.zeros_like(Xe), 0.0, aux_e["U0"], c)

    Rsp = assemble_function(sp, v0_res, torch.zeros_like(U0), ctx, aux={"U0": U0},
                            chunk=chunk)
    Mop, _ = assemble_coefficient_planes(sp, _mass_coef, apply_fix=False)
    # dtype-matched tolerance: rtol 1e-12 is out of reach in f32
    rtol_m = 1e-12 if sp.dtype == torch.float64 else 1e-6
    V, _ = packed_solve(Mop, -Rsp, cg, rtol_m, 500)
    del Mop
    U = U0
    t = 0.0
    stats_log = []
    for step in range(nsteps):
        U, V = newton_step(U, V, t, dt)
        t += dt
        s = _stats(sp, U, ctx, chunk)
        stats_log.append((step + 1, t, *s))
        if monitor is not None:
            monitor(step + 1, t, U, s)
    return U, stats_log
