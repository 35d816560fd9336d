"""Reaction-diffusion pattern formation (port of
:mod:`petiga_tpu.models.patternformation`), PetIGA's
demo/PatternFormation.c: two species on a periodic square,

    u_t = δ D1 ∇²u + f(u,v),   v_t = δ D2 ∇²v + g(u,v),

with the reference's implicit/explicit split: the reaction at the new or
the old state through the IEFunction's (t0, U0) arguments."""

from __future__ import annotations

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space
from ..solve.ts import AlphaStepper, integrate

__all__ = ["iefunction", "make_space", "initial_condition", "run"]


def _reaction(u, v, ctx):
    a, b, g = ctx["alpha"], ctx["beta"], ctx["gamma"]
    t1, t2 = ctx["tau1"], ctx["tau2"]
    f = a * u * (1 - t1 * v * v) + v * (1 - t2 * u)
    gg = b * v * (1 + a * t1 / b * u * v) + u * (g + t2 * v)
    return f, gg


def iefunction(pt, shift, Ve, t, U1e, t0, U0e, ctx):
    """IE residual (PatternFormation.c:26-77): diffusion implicit,
    reaction at U1 (implicit) or U0 (semi-explicit)."""
    delta, D1, D2 = ctx["delta"], ctx["D1"], ctx["D2"]
    uv_t = pt.value(Ve)
    uv = pt.value(U1e) if ctx.get("implicit", True) else pt.value(U0e)
    g1 = pt.grad(U1e)  # (2, dim)
    f, g = _reaction(uv[0], uv[1], ctx)
    N0, N1 = pt.shape0, pt.shape1
    Ru = N0 * uv_t[0] + delta * D1 * (N1 @ g1[0]) - N0 * f
    Rv = N0 * uv_t[1] + delta * D2 * (N1 @ g1[1]) - N0 * g
    return torch.stack([Ru, Rv], dim=-1)


def make_space(nel=32, dtype=torch.float64, device=None) -> Space:
    """Periodic C¹ p=2 on the unit square, dof 2."""
    axes = [Axis.uniform(p=2, nel=nel, periodic=True) for _ in range(2)]
    return Space(axes, dof=2, dtype=dtype, device=device)


def initial_condition(space, seed=0):
    """u = 1 ± 0.05, v ∈ [0, 0.1), drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    u = 1.0 + 0.1 * (rng.random((space.nnodes, 1)) - 0.5)
    v = 0.1 * rng.random((space.nnodes, 1))
    return torch.as_tensor(np.concatenate([u, v], axis=1), dtype=space.dtype,
                           device=space.device)


def run(space, U0, *, dt=0.01, nsteps=2, implicit=True, ctx=None, newton_kw=None):
    """Generalized-α with the IE form; Newton–BiCGStab on the kernel
    operator unless ``newton_kw`` replaces the default.  Returns U."""
    c = {
        "delta": 0.0045, "D1": 0.5, "D2": 1.0,
        "alpha": 0.899, "beta": -0.91, "gamma": -0.899,
        "tau1": 0.02, "tau2": 0.2, "implicit": implicit,
        **(ctx or {}),
    }
    st = AlphaStepper(space, iefunction=iefunction, ctx=c,
                      newton_kw=newton_kw or dict(rtol=1e-6, linear_solver="bicgstab",
                                                  maxit=12, operator="fast"))
    U, _ = integrate(st, U0, 0.0, dt, nsteps)
    return U
