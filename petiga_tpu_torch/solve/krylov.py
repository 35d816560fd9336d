"""Krylov solvers on stencil operators (port of
:mod:`petiga_tpu.solve.krylov`): CG, BiCGStab, restarted GMRES, and the
point- and block-Jacobi preconditioners.

``A`` is an object with ``.matvec`` or a callable ``x -> A@x``; ``M`` an
optional preconditioner ``r -> M^{-1} r``.  Vectors may be node-ordered
or packed (``StencilOperator.pack_vec``): the solvers only need dots and
axpys.  ``dot(a, b) -> 0-d tensor`` replaces the local inner product: the
distributed layer passes its all-reduced dot, so every rank iterates on
the same scalars (:class:`~petiga_tpu_torch.parallel.dist.DistSpace`).

The loops run on the host and read ``‖r‖²`` every iteration (every
restart cycle for GMRES) to test convergence, which synchronises with the
device once per iteration; that keeps the iteration counts identical to
the reference's ``while_loop``.  BiCGStab restarts at a breakdown
``rho = (r̂, r) = 0`` with ``r̂`` the current residual, where the reference
divides by zero: on a mirror-symmetric problem (the Navier–Stokes
lid-driven cavity) the products of that dot cancel in pairs once the
residual picks up the mirror-odd part, and the sum is an exact zero.
Exact zeros of ``(r̂, v)``, ``(t, t)`` and ``omega`` give ``alpha = 0``,
``omega = 0`` and ``beta = 0`` in place of the reference's division by
zero, with no extra host read: the other half-step still reduces the
residual, and ``t = 0`` means ``s = 0``, which ends the loop as
converged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import profiling

__all__ = ["cg", "bicgstab", "gmres", "KrylovResult", "jacobi_preconditioner",
           "block_jacobi_preconditioner"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # final residual norm (0-d tensor)


def _as_matvec(A) -> Callable:
    return A.matvec if hasattr(A, "matvec") else A


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def jacobi_preconditioner(A):
    """Point-Jacobi M^{-1} = 1/diag(A) (zero diagonals map to 1)."""
    d = A.scalar_diagonal()  # (nnodes, dof)
    inv = torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.ones_like(d))

    def M(r):
        return (r.reshape(inv.shape) * inv).reshape(r.shape)

    return M


def block_jacobi_preconditioner(A):
    """Block-Jacobi with the dof×dof diagonal blocks (the BAIJ-style
    point-block preconditioner natural for dof > 1 problems)."""
    D = A.diagonal()  # (nnodes, dof, dof)
    Dinv = torch.linalg.inv(D)

    def M(r):
        shape = r.shape
        r = r.reshape(D.shape[0], D.shape[1])
        return torch.einsum("nab,nb->na", Dinv, r).reshape(shape)

    return M


def cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10000,
    dot: Optional[Callable] = None,
) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD operators).

    Stops when ``‖r‖ <= max(rtol·‖b‖, atol)`` or after ``maxiter``
    iterations, like PETSc's default KSP test; ``iters`` counts the
    operator applications inside the loop."""
    dot = _dot if dot is None else dot
    profiling.count("KSPSolve")
    matvec = _as_matvec(A)
    Mv = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = Mv(r)
    p = z
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b)).item()
    tol2 = max(rtol * bnorm, atol) ** 2
    k = 0
    while k < maxiter and dot(r, r).item() > tol2:
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Mv(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return KrylovResult(x=x, iters=k, residual=torch.sqrt(dot(r, r)))


def bicgstab(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10000,
    dot: Optional[Callable] = None,
) -> KrylovResult:
    """Preconditioned BiCGStab for nonsymmetric operators; same stopping
    test as :func:`cg`, and it restarts at a breakdown ``(r̂, r) = 0`` (see
    the module docstring).  The scalars stay on the device: ``‖r‖²`` and
    ``(r̂, r)`` are read together once per iteration."""
    dot = _dot if dot is None else dot
    matvec = _as_matvec(A)
    Mv = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    bnorm = torch.sqrt(dot(b, b)).item()
    tol2 = max(rtol * bnorm, atol) ** 2
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    k = 0
    while k < maxiter:
        rho_new = dot(rhat, r)
        rr, rho_h = torch.stack([dot(r, r), rho_new]).tolist()
        if not rr > tol2:
            break
        if rho_h == 0.0:  # breakdown: restart from the current residual
            rhat, rho_new = r, dot(r, r)
            rho = alpha = omega = one
            v = p = torch.zeros_like(b)
        beta = torch.where(omega != 0, (rho_new / rho) * (alpha / omega),
                           torch.zeros_like(omega))
        p = r + beta * (p - omega * v)
        phat = Mv(p)
        v = matvec(phat)
        rv = dot(rhat, v)
        alpha = torch.where(rv != 0, rho_new / rv, torch.zeros_like(rv))
        s = r - alpha * v
        shat = Mv(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = torch.where(tt != 0, dot(t, s) / tt, torch.zeros_like(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return KrylovResult(x=x, iters=k, residual=torch.sqrt(dot(r, r)))


def gmres(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 1000,
    dot: Optional[Callable] = None,
) -> KrylovResult:
    """Restarted GMRES(m) with left preconditioning.

    Each cycle builds a ``restart``-column Arnoldi basis by modified
    Gram–Schmidt and solves the small least-squares problem
    ``min ‖β e₁ − H y‖`` on the host by LAPACK's rank-revealing QR
    (minimum norm, like the reference's ``lstsq``).  ``maxiter`` counts inner iterations and is
    converted to ``ceil(maxiter/restart)`` cycles; ``iters`` reports
    ``cycles·restart``, an upper bound, as in the reference."""
    dot = _dot if dot is None else dot
    cycles = -(-int(maxiter) // int(restart))
    matvec = _as_matvec(A)
    Mv = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    shape = b.shape
    dt = b.dtype
    tol = max(rtol * torch.sqrt(dot(b, b)).item(), atol)

    def arnoldi_cycle(x):
        r = Mv(b - matvec(x)).reshape(-1)
        beta = torch.sqrt(dot(r, r))
        V = torch.zeros((restart + 1, r.numel()), dtype=dt, device=b.device)
        H = torch.zeros((restart + 1, restart), dtype=dt, device=b.device)
        V[0] = torch.where(beta > 0, r / beta, torch.zeros_like(r))
        for j in range(restart):
            w = Mv(matvec(V[j].reshape(shape))).reshape(-1)
            for i in range(j + 1):  # modified Gram-Schmidt
                h = dot(V[i], w)
                H[i, j] = h
                w = w - h * V[i]
            hn = torch.sqrt(dot(w, w))
            H[j + 1, j] = hn
            V[j + 1] = torch.where(hn > 1e-30, w / hn, torch.zeros_like(w))
        e1 = torch.zeros(restart + 1, dtype=dt)
        e1[0] = beta.cpu()
        y = torch.linalg.lstsq(H.cpu(), e1[:, None]).solution[:, 0]
        return x + (y.to(b.device) @ V[:restart]).reshape(shape)

    def rnorm(x):
        r = b - matvec(x)
        return torch.sqrt(dot(r, r))

    k = 0
    while k < cycles and rnorm(x).item() > tol:
        x = arnoldi_cycle(x)
        k += 1
    return KrylovResult(x=x, iters=k * restart, residual=rnorm(x))
