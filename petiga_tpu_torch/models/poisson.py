"""Poisson / reaction-diffusion model (port of :mod:`petiga_tpu.models.poisson`,
conv engine).

The manufactured solution is ``u = prod_i sin(pi x_i)`` with forcing
``(c + k dim pi^2) u`` for the operator ``c u - k Δu``; homogeneous
Dirichlet on all faces.  :func:`solve_poisson` is the main path: plane
assembly -> Dirichlet post-fix -> Jacobi-CG on packed vectors through the
stencil kernel -> unpack.
"""

from __future__ import annotations

import math

import torch

from ..assembly.assemble import compute_error_norm
from ..assembly.convform import assemble_coefficient_planes, poisson_coefficients
from ..core.axis import Axis
from ..core.space import Space
from ..solve.krylov import cg

__all__ = [
    "exact_solution",
    "make_space",
    "poisson_forcing",
    "assemble_poisson",
    "solve_system",
    "solve_poisson",
    "l2_error",
]


def exact_solution(x):
    """u(x) = prod_i sin(pi x_i), shape (..., 1)."""
    return torch.prod(torch.sin(math.pi * x), dim=-1, keepdim=True)


def make_space(dim, p=2, nel=8, continuity=None, dtype=torch.float32,
               device="cpu", **kw) -> Space:
    """Uniform open space with homogeneous Dirichlet on every face;
    ``nel`` may be a scalar or a per-axis sequence."""
    nels = list(nel) if isinstance(nel, (tuple, list)) else [nel] * dim
    axes = [Axis.uniform(p=p, nel=n, continuity=continuity) for n in nels]
    sp = Space(axes, dof=1, dtype=dtype, device=device, **kw)
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def poisson_forcing(c=0.0, k=1.0):
    """Manufactured forcing for the coefficient-form engine."""

    def forcing(x, ctx):
        dim = x.shape[-1]
        return (c + k * dim * math.pi**2) * torch.prod(torch.sin(math.pi * x), dim=-1)

    return forcing


def assemble_poisson(space: Space, *, c: float = 0.0, k: float = 1.0,
                     symmetric: bool = False):
    """Constant-coefficient planes (full or ``symmetric`` upper-slot
    storage) and the load vector of the manufactured problem, Dirichlet
    post-fixed; returns ``(op, b)``."""
    return assemble_coefficient_planes(
        space, poisson_coefficients, {"c": c, "k": k},
        forcing=poisson_forcing(c, k), symmetric=symmetric,
    )


def solve_system(op, b, *, rtol: float = 1e-10, maxiter: int = 10000):
    """Jacobi-CG on packed vectors through the stencil kernel; returns
    ``(U, res)`` with ``U`` of shape (nnodes, 1) and ``res`` the
    :class:`~petiga_tpu_torch.solve.krylov.KrylovResult` on packed
    vectors."""
    dinv = op.packed_diag_inv()
    res = cg(lambda v: op.matvec_xb(op.DT, v), op.pack_vec(b),
             M=lambda r: r * dinv, rtol=rtol, maxiter=maxiter)
    return op.unpack_vec(res.x), res


def solve_poisson(space: Space, *, c: float = 0.0, k: float = 1.0,
                  rtol: float = 1e-10, symmetric: bool = False,
                  maxiter: int = 10000):
    """:func:`assemble_poisson` then :func:`solve_system`; returns
    ``(U, info)`` with ``U`` of shape (nnodes, 1)."""
    op, b = assemble_poisson(space, c=c, k=k, symmetric=symmetric)
    U, res = solve_system(op, b, rtol=rtol, maxiter=maxiter)
    return U, {
        "iters": res.iters,
        "residual": float(res.residual),
        "A": op,
        "b": b,
        "engine": "conv",
    }


def l2_error(space, U) -> float:
    return float(compute_error_norm(space, U, exact_solution, k=0))
