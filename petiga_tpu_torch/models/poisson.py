"""Poisson / reaction-diffusion model (port of :mod:`petiga_tpu.models.poisson`).

The manufactured solution is ``u = prod_i sin(pi x_i)`` with forcing
``(c + k dim pi^2) u`` for the operator ``c u - k Δu``; homogeneous
Dirichlet on all faces.  :func:`solve_poisson` is the main path: plane
assembly (the coefficient-form ``conv`` engine on eligible spaces, the
generic ``pointwise`` engine otherwise) -> Dirichlet fix -> Jacobi-CG
through the stencil kernel.  Mixed-precision refinement of its solution
is :func:`petiga_tpu_torch.solve.refine.refined_solve`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..assembly import fastpath
from ..assembly.assemble import assemble_system, compute_error_norm
from ..assembly.convform import assemble_coefficient_planes, poisson_coefficients
from ..core.axis import Axis
from ..core.space import Space
from ..solve.krylov import cg, jacobi_preconditioner

__all__ = [
    "exact_solution",
    "exact_gradient",
    "make_space",
    "poisson_system",
    "poisson_system_q",
    "poisson_forcing",
    "assemble_poisson",
    "solve_system",
    "solve_poisson",
    "l2_error",
    "h1_error",
]


def exact_solution(x):
    """u(x) = prod_i sin(pi x_i), shape (..., 1)."""
    return torch.prod(torch.sin(math.pi * x), dim=-1, keepdim=True)


def exact_gradient(x):
    """Gradient of the manufactured solution, shape (..., 1, dim)."""
    dim = x.shape[-1]
    s = torch.sin(math.pi * x)
    c = torch.cos(math.pi * x)
    cols = []
    for i in range(dim):
        g = math.pi * c[..., i]
        for j in range(dim):
            if j != i:
                g = g * s[..., j]
        cols.append(g)
    return torch.stack(cols, dim=-1).unsqueeze(-2)


def poisson_system(pt, ctx):
    """Galerkin reaction-diffusion system form at one quadrature point:
    K_ab = c N_a N_b + k ∇N_a·∇N_b, F_a = f N_a."""
    c = ctx.get("c", 0.0)
    k = ctx.get("k", 1.0)
    f = (c + k * pt.dim * math.pi**2) * torch.prod(torch.sin(math.pi * pt.x))
    N0, N1 = pt.shape0, pt.shape1
    K = c * torch.outer(N0, N0) + k * (N1 @ N1.T)
    F = f * N0
    return K, F


def poisson_system_q(pt, w, ctx):
    """q-batched variant: Point leaves carry a leading quadrature axis;
    the q-contraction is one matmul (the fast pointwise assembly)."""
    c = ctx.get("c", 0.0)
    k = ctx.get("k", 1.0)
    dim = pt.u.shape[-1]
    f = (c + k * dim * math.pi**2) * torch.prod(torch.sin(math.pi * pt.x), dim=-1)
    N0, N1 = pt.shape0, pt.shape1  # (Q, nen), (Q, nen, dim)
    K = k * torch.einsum("q,qai,qbi->ab", w, N1, N1)
    if c != 0.0:
        K = K + c * torch.einsum("q,qa,qb->ab", w, N0, N0)
    F = torch.einsum("q,qa->a", w * f, N0)
    return K, F


poisson_system_q.qbatched = True


def make_space(dim, p=2, nel=8, continuity=None, dtype=torch.float32,
               device=None, **kw) -> Space:
    """Uniform open space with homogeneous Dirichlet on every face;
    ``nel`` may be a scalar or a per-axis sequence.  ``device=None`` is
    the CUDA device (:func:`petiga_tpu_torch.default_device`)."""
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
                  rtol: float = 1e-10, chunk: Optional[int] = None,
                  engine: str = "auto", symmetric: bool = False,
                  maxiter: int = 10000):
    """Assemble + Jacobi-CG solve; returns ``(U, info)`` with ``U`` of
    shape (nnodes, 1).

    ``engine="auto"`` uses the coefficient-form (``conv``) assembler on
    eligible spaces (open, regular, unit-step, ``nsd == dim``) and the
    generic pointwise path otherwise; "conv"/"pointwise" force a choice.
    The pointwise engine assembles a node-major
    :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix` in chunks of
    ``chunk`` elements and solves through its ``fast_operator()``.
    ``symmetric`` (conv engine) stores the upper slots only."""
    if engine not in ("auto", "conv", "pointwise"):
        raise ValueError(f"unknown engine {engine!r}")
    use_conv = engine == "conv" or (
        engine == "auto"
        and not any(space.periodic)
        and fastpath.is_unit_step(space)
        and (not (space.has_geometry or space.is_rational) or space.nsd == space.dim)
    )
    if use_conv:
        op, b = assemble_poisson(space, c=c, k=k, symmetric=symmetric)
        U, res = solve_system(op, b, rtol=rtol, maxiter=maxiter)
        A = op
    else:
        A, b = assemble_system(space, poisson_system, {"c": c, "k": k}, chunk=chunk)
        res = cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=rtol,
                 maxiter=maxiter)
        U = res.x
    return U, {
        "iters": res.iters,
        "residual": float(res.residual),
        "A": A,
        "b": b,
        "engine": "conv" if use_conv else "pointwise",
    }


def l2_error(space, U, chunk: Optional[int] = None) -> float:
    """L2 error against the manufactured solution; ``chunk`` bounds the
    element batch of the tabulated route (mapped or rational spaces)."""
    return float(compute_error_norm(space, U, exact_solution, k=0, chunk=chunk))


def h1_error(space, U, chunk: Optional[int] = None) -> float:
    return float(compute_error_norm(space, U, exact_gradient, k=1, chunk=chunk))
