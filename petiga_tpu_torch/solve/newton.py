"""Newton–Krylov nonlinear solver (port of :mod:`petiga_tpu.solve.newton`):
the analog of the reference's SNES glue (IGAComputeFunction/Jacobian
wired into a Newton solver).

The reference's ``lax.while_loop`` is a host loop here with the same
stopping test, ``‖F‖ > max(rtol·‖F₀‖, atol)`` and ``k < maxit``, so the
iteration counts are the reference's; each iteration reads ``‖F‖`` once.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from ..assembly.assemble import assemble_function, assemble_jacobian
from ..utils import profiling
from .krylov import bicgstab, cg, gmres, jacobi_preconditioner

__all__ = ["newton", "NewtonResult"]


class NewtonResult(NamedTuple):
    U: torch.Tensor
    iters: int
    fnorm: float
    converged: bool


def newton(
    space,
    function: Callable,
    U0: torch.Tensor,
    ctx=None,
    *,
    jacobian: Optional[Callable] = None,
    aux=None,
    boundary: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 1e-50,
    maxit: int = 50,
    linear_rtol: float = 1e-8,
    linear_solver: str = "cg",
    order: Optional[int] = None,
    chunk: Optional[int] = None,
    damping: float = 1.0,
    operator: str = "stencil",
    jfnk_pc: Optional[Callable] = None,
    monitor: Optional[Callable] = None,
    counters: Optional[dict] = None,
) -> NewtonResult:
    """Solve F(U) = 0 by Newton's method with an inner Krylov solve.

    ``function(pt, Ue, ctx) -> R (nen, dof)`` is the pointwise residual;
    the Jacobian defaults to forward-mode AD of the element residual.
    Dirichlet dofs are driven to their boundary values through the
    fix-value residual semantics.

    ``operator``: ``"stencil"`` solves with the assembled node-major
    :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix`; ``"fast"``
    with its ``fast_operator()``, so every inner product launches the
    CUDA stencil kernel; ``"jfnk"`` never assembles the Jacobian: inner
    products are exact AD Jacobian actions
    (:class:`~petiga_tpu_torch.sparse.matfree.JacobianFreeOperator`),
    preconditioned by ``jfnk_pc(U) -> (r -> M⁻¹r)`` when given.
    ``linear_solver``: ``"cg"``, ``"bicgstab"`` or ``"gmres"``.
    ``monitor(k, fnorm, linear_iters)`` is called after the initial
    residual (``linear_iters`` None) and after each iteration.
    ``counters`` (a dict) collects per call the residual norms ``rhist``,
    the linear iterations ``lin_iters`` and the seconds of each residual,
    Jacobian assembly and linear solve (``residual_s``, ``jacobian_s``,
    ``solve_s``); with counters the device is synchronised before each
    reading."""
    profiling.count("SNESSolve")
    shape = (space.nnodes, space.dof)
    U = U0.reshape(shape)
    solver = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}[linear_solver]
    if operator not in ("stencil", "fast", "jfnk"):
        raise ValueError(f"unknown operator {operator!r}")

    def resid(V):
        return assemble_function(space, function, V, ctx, aux=aux, order=order,
                                 chunk=chunk, boundary=boundary)

    t_res, t_jac, t_sol, rhist, lin = [], [], [], [], []

    def stamp(times, t0):
        """Seconds since ``t0`` into ``times``, the device synchronised;
        returns the new time origin."""
        if counters is None:
            return t0
        if U.device.type == "cuda":
            torch.cuda.synchronize(U.device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        return t1

    t0 = stamp([], 0.0)
    F = resid(U)
    fnorm = torch.linalg.vector_norm(F).item()
    t0 = stamp(t_res, t0)
    rhist.append(fnorm)
    tol = max(rtol * fnorm, atol)
    if monitor is not None:
        monitor(0, fnorm, None)
    k = 0
    while fnorm > tol and k < maxit:
        if operator == "jfnk":
            from ..sparse.matfree import JacobianFreeOperator

            A = JacobianFreeOperator(space, function, U, ctx, aux=aux, order=order,
                                     chunk=chunk, boundary=boundary)
            M = jfnk_pc(U) if jfnk_pc is not None else None
        else:
            A = assemble_jacobian(space, function, U, ctx, jacobian=jacobian, aux=aux,
                                  order=order, chunk=chunk, boundary=boundary)
            M = jacobi_preconditioner(A)
            if operator == "fast":
                A = A.fast_operator()
        t0 = stamp(t_jac, t0)
        res = solver(A, F, M=M, rtol=linear_rtol)
        t0 = stamp(t_sol, t0)
        U = U - damping * res.x.reshape(shape)
        F = resid(U)
        fnorm = torch.linalg.vector_norm(F).item()
        t0 = stamp(t_res, t0)
        rhist.append(fnorm)
        lin.append(res.iters)
        k += 1
        if monitor is not None:
            monitor(k, fnorm, res.iters)
    if counters is not None:
        for key, val in (("rhist", rhist), ("lin_iters", lin), ("residual_s", t_res),
                         ("jacobian_s", t_jac), ("solve_s", t_sol)):
            counters.setdefault(key, []).append(val)
    return NewtonResult(U=U, iters=k, fnorm=fnorm, converged=fnorm <= tol)
