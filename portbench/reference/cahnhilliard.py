"""Plain reference of the Cahn–Hilliard cells, in float64 PyTorch: the
residual of one generalized-α step of PetIGA's ``demo/CahnHilliard2D.c``
on a periodic 2-D mesh of C¹ quadratic B-splines, and the consistent
initial velocity.

Primal form with degenerate mobility ``M(c) = c(1-c)`` and the logarithmic
chemical potential, ``μ'(c) = 3α (1/(2θ c(1-c)) - 2)``:

    R_a = ∫ N_a c_t + (∇N_a·∇c)(M μ' + M' Δc) + ΔN_a M Δc

Generalized-α for first-order systems (PETSc TSALPHA): ``α_m = ½(3-ρ)/(1+ρ)``,
``α_f = 1/(1+ρ)``, ``γ = ½ + α_m - α_f``; the stage residual is taken at
``U_αf = U_n + α_f (U_{n+1} - U_n)`` and ``V_αm = V_n + α_m (V_{n+1} - V_n)``
with ``V_{n+1} = (U_{n+1} - U_n)/(γ dt) + (1 - 1/γ) V_n``.

Node grids are ``(N, N)`` tensors, axis 0 (x) fastest in the flat index.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bspline

__all__ = ["CahnHilliard"]


class CahnHilliard:
    def __init__(self, nel, *, p=2, q=3, theta, alpha, rho_inf, dt, device="cpu",
                 dtype=torch.float64):
        self.N = nel
        self.theta, self.alpha, self.dt = theta, alpha, dt
        r = rho_inf
        self.am = 0.5 * (3 - r) / (1 + r)
        self.af = 1.0 / (1 + r)
        self.g = 0.5 + self.am - self.af
        _, w, B, nodes = bspline.element_tables(p, nel, q, 2, periodic=True)
        self.dtype = dtype
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.B = t(B)  # (3, nel, q, p+1): value, d/dx, d²/dx²
        self.W = t(w[:, :, None, None] * w[None, None, :, :])  # (ey, qy, ex, qx)
        self.nodes = torch.as_tensor(nodes, device=device)
        # the periodic 1-D mass matrix, dense
        M1 = np.zeros((nel, nel))
        Me = np.einsum("eq,eqa,eqb->eab", w, B[0], B[0])
        for a in range(p + 1):
            for b in range(p + 1):
                np.add.at(M1, (nodes[:, a], nodes[:, b]), Me[:, a, b])
        self.M1 = t(M1)

    def _patches(self, U):
        n = self.nodes
        return U[n[:, :, None, None], n[None, None, :, :]]  # (ey, b, ex, a)

    def _eval(self, Ue, dy, dx):
        B = self.B
        return torch.einsum("yqb,xra,ybxa->yqxr", B[dy], B[dx], Ue)

    def _test(self, F, dy, dx):
        B = self.B
        return torch.einsum("yqb,xra,yqxr->ybxa", B[dy], B[dx], F)

    def _scatter(self, Re):
        n = self.nodes
        R = torch.zeros((self.N, self.N), dtype=Re.dtype, device=Re.device)
        R.index_put_((n[:, :, None, None].expand_as(Re), n[None, None, :, :].expand_as(Re)),
                     Re, accumulate=True)
        return R

    def _residual(self, U, V):
        """``R(U, c_t = V)`` on node grids."""
        Ue = self._patches(U)
        c = self._eval(Ue, 0, 0)
        cx, cy = self._eval(Ue, 0, 1), self._eval(Ue, 1, 0)
        lap = self._eval(Ue, 0, 2) + self._eval(Ue, 2, 0)
        M = c * (1 - c)
        dM = 1 - 2 * c
        dmu = 3 * self.alpha * (0.5 / self.theta / (c * (1 - c)) - 2.0)
        t1 = (M * dmu + dM * lap) * self.W
        ml = M * lap * self.W
        Re = (self._test(cx * t1, 0, 1) + self._test(cy * t1, 1, 0)
              + self._test(ml, 0, 2) + self._test(ml, 2, 0))
        if V is not None:
            Re = Re + self._test(self._eval(self._patches(V), 0, 0) * self.W, 0, 0)
        return self._scatter(Re)

    def initial_velocity(self, U0):
        """``V0`` with ``R(U0, V0) = 0``: ``M V0 = -R(U0, 0)``, solved
        exactly with the dense 1-D mass matrices (``M = M_y ⊗ M_x``)."""
        R = -self._residual(U0, None)
        Y = torch.linalg.solve(self.M1, R)  # M_y⁻¹ R
        return torch.linalg.solve(self.M1, Y.T).T  # ... M_x⁻ᵀ

    def step_residual(self, X, U, V):
        """Stage residual of the step from ``(U, V)`` with end state ``X``."""
        V1 = self.velocity(X, U, V)
        return self._residual(U + self.af * (X - U), V + self.am * (V1 - V))

    def velocity(self, X, U, V):
        return (X - U) / (self.g * self.dt) + (1 - 1 / self.g) * V

    def newton_reduction(self, X, U, V):
        """``‖R(X)‖ / ‖R(U)‖``: how far the step's end state reduces the
        stage residual from its start, the Newton iteration's own start."""
        r0 = torch.linalg.vector_norm(self.step_residual(U, U, V))
        r1 = torch.linalg.vector_norm(self.step_residual(X, U, V))
        return float(r1 / r0)
