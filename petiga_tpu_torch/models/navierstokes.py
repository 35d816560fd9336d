"""Incompressible Navier–Stokes with VMS/SUPG-PSPG stabilization (port of
:mod:`petiga_tpu.models.navierstokes`), PetIGA's demo/NavierStokesVMS.c:
residual-based variational multiscale, equal-order velocity and pressure
on one spline space (dof = dim + 1): the steady stabilized lid-driven
cavity and the transient RBVMS formulation (fine-scale closure and
generalized-α).  Unknowns per node: (u_1, …, u_dim, p).

Newton's linear solves are BiCGStab on the stencil kernel
(``operator="fast"``); the Jacobians are forward-mode AD of these
residuals.
"""

from __future__ import annotations

import math

import torch

from ..assembly.assemble import compute_scalar
from ..core.axis import Axis
from ..core.space import Space
from ..solve.newton import newton
from ..solve.ts import AlphaStepper

__all__ = [
    "vms_residual",
    "make_cavity_space",
    "solve_cavity",
    "vms_ifunction",
    "taylor_green_space",
    "taylor_green_exact",
    "taylor_green_init",
    "solve_transient_vms",
    "kinetic_energy",
    "divergence_l2",
]


def vms_residual(pt, Ue, ctx):
    """Residual of steady incompressible NS with RBVMS-style SUPG/PSPG
    stabilization (NavierStokesVMS.c Residual, steady part):

      momentum: (u·∇u, w) + ν(∇u, ∇w) − (p, ∇·w) + SUPG + grad-div
      mass:     (∇·u, q) + PSPG
    """
    nu, h = ctx["nu"], ctx["h"]
    dim = pt.dim
    vals = pt.value(Ue)  # (dim+1,)
    grads = pt.grad(Ue)  # (dim+1, nsd)
    u, p = vals[:dim], vals[dim]
    gu, gp = grads[:dim, :], grads[dim, :]
    N0, N1 = pt.shape0, pt.shape1

    conv = gu @ u  # u·∇u
    divu = torch.trace(gu)
    # strong momentum residual (the viscous term dropped, as the
    # reference does: its τ absorbs it)
    rm = conv + gp
    tau_m = 1.0 / torch.sqrt(4 * torch.sum(u * u) / h**2 + 36 * (nu / h**2) ** 2 + 1e-12)
    tau_c = h**2 / (12 * tau_m + 1e-12)
    adv_test = N1 @ u  # u·∇N_a
    rows = [N0 * conv[i] + nu * (N1 @ gu[i]) - N1[:, i] * p
            + tau_m * adv_test * rm[i]  # SUPG
            + tau_c * N1[:, i] * divu  # grad-div (LSIC)
            for i in range(dim)]
    rows.append(N0 * divu + tau_m * (N1 @ rm))  # continuity + PSPG
    return torch.stack(rows, dim=-1)


def make_cavity_space(nel=16, p=2, dtype=torch.float64, lid=1.0, device=None) -> Space:
    """Lid-driven cavity on [0, 1]²: u = (lid, 0) on the top face,
    no slip elsewhere; the pressure is left free (its constant null
    space is removed after the solve)."""
    sp = Space([Axis.uniform(p=p, nel=nel)] * 2, dof=3, dtype=dtype, device=device)
    for d in range(2):
        for s in range(2):
            for c in range(2):
                sp.set_boundary_value(d, s, c, 0.0)
    sp.set_boundary_value(1, 1, 0, lid)
    return sp


def solve_cavity(space, *, nu=0.1, rtol=1e-6, maxit=30, chunk=None, **newton_kw):
    """Newton–BiCGStab from rest (other keywords go to
    :func:`~petiga_tpu_torch.solve.newton.newton`); returns ``(U,
    NewtonResult)`` with the zero-mean pressure representative in
    ``U[:, 2]``."""
    ctx = {"nu": nu, "h": 1.0 / space.elem_shape[0]}
    U0 = torch.zeros((space.nnodes, space.dof), dtype=space.dtype, device=space.device)
    kw = {"linear_solver": "bicgstab", "linear_rtol": 1e-8, "operator": "fast", **newton_kw}
    res = newton(space, vms_residual, U0, ctx, rtol=rtol, maxit=maxit, chunk=chunk, **kw)
    U = res.U.clone()
    U[:, 2] = U[:, 2] - U[:, 2].mean()
    return U, res


# --------------------------------------------------------- transient RBVMS


def vms_ifunction(pt, a, Ve, t, Ue, ctx):
    """Transient residual-based VMS residual (NavierStokesVMS.c:80-165,
    Bazilevs et al. 2007):

      fine scales  u' = −τ_M (u_t + u·∇u + ∇p − ν Δu − f),  p' = −τ_C ∇·u
      τ_M = (4/dt² + u·G·u + C_I ν² G:G)^{-1/2},  τ_C = (τ_M g·g)^{-1}

    with the diagonal element metric G = diag(1/h_d²) of a uniform
    identity-geometry mesh.  ``ctx``: nu, dt, hvec (per-axis element
    widths), optional force."""
    dim = pt.dim
    nu, dt = ctx["nu"], ctx["dt"]
    opts = dict(dtype=pt.shape0.dtype, device=pt.shape0.device)
    f = torch.as_tensor(ctx.get("force", (0.0,) * dim), **opts)
    hvec = torch.as_tensor(ctx["hvec"], **opts)
    vals, grads, H = pt.value(Ue), pt.grad(Ue), pt.hess(Ue)
    ut = pt.value(Ve)[:dim]
    u, p = vals[:dim], vals[dim]
    gu, gp = grads[:dim, :], grads[dim, :]  # gu[i, j] = d u_i / d x_j
    lap = torch.einsum("ijj->i", H[:dim])
    divu = torch.trace(gu)

    Ginv = 1.0 / (hvec * hvec)  # diag of G = J Jᵀ
    C_I = 1.0 / 12.0
    tauM = 1.0 / torch.sqrt(4.0 / (dt * dt) + torch.sum(u * u * Ginv)
                            + C_I * nu * nu * torch.sum(Ginv * Ginv))
    tauC = 1.0 / (tauM * torch.sum(Ginv))

    rm = ut + gu @ u + gp - nu * lap - f
    us = -tauM * rm  # fine-scale velocity
    ps = -tauC * divu  # fine-scale pressure
    ue = u + us  # advective velocity
    N0, N1 = pt.shape0, pt.shape1
    adv_test = N1 @ ue
    rows = [N0 * (ut[i] - f[i]) - N1[:, i] * p
            + nu * (N1 @ (gu[i, :] + gu[:, i]))  # symmetric stress
            - N1[:, i] * ps  # B̃_1
            + N0 * (ue @ gu[i, :])  # B_2(W, U, U + U')
            - adv_test * us[i]  # B_2(W, U', U + U')
            for i in range(dim)]
    rows.append(N0 * divu - N1 @ us)  # PSPG fine scale
    return torch.stack(rows, dim=-1)


def taylor_green_space(nel=8, p=2, dtype=torch.float64, device=None) -> Space:
    """Fully periodic [0, 1]² space for the Taylor–Green vortex (dof 3:
    u, v, p); C^{p-1} continuity supplies the Laplacian of the fine-scale
    residual."""
    return Space([Axis.uniform(p=p, nel=nel, periodic=True) for _ in range(2)], dof=3,
                 dtype=dtype, device=device)


def taylor_green_exact(x, t, nu):
    """u = (sin cos, −cos sin)·e^{−8π²νt} (period 1), p = (cos 4πx + cos
    4πy)/4·e^{−16π²νt}: (..., 3)."""
    decay = math.exp(-8 * math.pi**2 * nu * t)
    s, c = torch.sin(2 * math.pi * x[..., 0]), torch.cos(2 * math.pi * x[..., 0])
    sy, cy = torch.sin(2 * math.pi * x[..., 1]), torch.cos(2 * math.pi * x[..., 1])
    pp = 0.25 * (torch.cos(4 * math.pi * x[..., 0]) + torch.cos(4 * math.pi * x[..., 1]))
    return torch.stack([s * cy * decay, -c * sy * decay, pp * decay**2], dim=-1)


def taylor_green_init(space, nu):
    """Greville interpolation of the t = 0 field (O(h²); the energy-decay
    oracle uses ratios, insensitive to this error)."""
    G = torch.as_tensor(space.greville_coordinates(), dtype=space.dtype, device=space.device)
    return taylor_green_exact(G, 0.0, nu)


def _energy(pt, Ue, ctx):
    u = pt.value(Ue)[:2]
    return 0.5 * torch.sum(u * u)


def _div2(pt, Ue, ctx):
    return torch.trace(pt.grad(Ue)[:2, :]) ** 2


def kinetic_energy(space, U):
    """½ ∫ |u|² (0-d tensor)."""
    return compute_scalar(space, _energy, U)[0]


def divergence_l2(space, U):
    """‖∇·u‖ in L² (0-d tensor)."""
    return torch.sqrt(compute_scalar(space, _div2, U)[0])


def solve_transient_vms(space, U0, *, nu=0.01, dt=1e-2, nsteps=2, rho_inf=0.5,
                        newton_kw=None, V0=None):
    """March the RBVMS system with generalized-α (the reference runs
    TSALPHA, NavierStokesVMS.c:320-360); returns ``(U, V, t)``.

    The incompressible system is an index-2 DAE (no time derivative of
    the pressure), so the generic consistent-V0 solve is singular: V0
    defaults to 0, and an analytic V0 may be passed.  Newton runs
    BiCGStab on the stencil kernel unless ``newton_kw`` says otherwise."""
    ctx = {"nu": nu, "dt": dt, "hvec": tuple(1.0 / n for n in space.elem_shape)}
    kw = {"rtol": 1e-8, "linear_solver": "bicgstab", "operator": "fast", **(newton_kw or {})}
    stepper = AlphaStepper(space, vms_ifunction, rho_inf=rho_inf, ctx=ctx, newton_kw=kw)
    U = U0.reshape(space.nnodes, space.dof)
    V = torch.zeros_like(U) if V0 is None else V0.reshape(U.shape)
    t = 0.0
    for _ in range(nsteps):
        U, V, _ = stepper.step(U, V, t, dt)
        t += dt
    return U, V, t
