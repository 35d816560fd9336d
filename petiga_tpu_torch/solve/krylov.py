"""Conjugate gradients on stencil operators (port of the ``cg`` half of
:mod:`petiga_tpu.solve.krylov`).

``A`` is an object with ``.matvec`` or a callable ``x -> A@x``; ``M`` an
optional preconditioner ``r -> M^{-1} r``.  Vectors may be node-ordered
or packed (``StencilOperator.pack_vec``): CG only needs dots and axpys.

The loop runs on the host and reads ``‖r‖²`` every iteration to test
convergence, which synchronises with the device once per iteration; that
keeps the iteration count identical to the reference's ``while_loop``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["cg", "KrylovResult", "jacobi_preconditioner"]


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


def cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10000,
) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD operators).

    Stops when ``‖r‖ <= max(rtol·‖b‖, atol)`` or after ``maxiter``
    iterations, like PETSc's default KSP test; ``iters`` counts the
    operator applications inside the loop."""
    matvec = _as_matvec(A)
    Mv = M if M is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = Mv(r)
    p = z
    rz = _dot(r, z)
    bnorm = torch.sqrt(_dot(b, b)).item()
    tol2 = max(rtol * bnorm, atol) ** 2
    k = 0
    while k < maxiter and _dot(r, r).item() > tol2:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Mv(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return KrylovResult(x=x, iters=k, residual=torch.sqrt(_dot(r, r)))
