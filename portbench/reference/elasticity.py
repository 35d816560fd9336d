"""Plain reference of the elasticity cell: the Galerkin system of isotropic
linear elasticity of PetIGA's ``demo/Elasticity3D.c`` on the unit cube, in
float64 PyTorch.

With test functions ``N_a`` and displacement components ``i, j`` the
stiffness is

    K[a,i][b,j] = ∫ λ ∂_i N_a ∂_j N_b + μ ∂_j N_a ∂_i N_b + μ δ_ij ∇N_a·∇N_b,

the demo's element form.  On a tensor-product space every such integral
is a product of one-dimensional integrals, so each component block
``(i, j)`` is a short sum of Kronecker products of the banded 1-D matrices
``∫ D^da N D^db N`` (``bspline.band_matrix``) with derivative orders
(1, 1), (1, 0), (0, 1) and (0, 0):

* ``i = j``: ``(λ + 2μ) K_i + μ Σ_{k≠i} K_k``, where ``K_k`` takes (1, 1)
  on axis ``k`` and (0, 0) on the others;
* ``i ≠ j``: ``λ`` times (1, 0) on axis ``i`` and (0, 1) on axis ``j``, plus
  ``μ`` times (1, 0) on axis ``j`` and (0, 1) on axis ``i``.

The Dirichlet elimination is the Poisson reference's, per component:
rows and columns of fixed nodes zeroed in every block, the diagonal of a
fixed row in the ``(i, i)`` block set to the number of elements that
share the node, the load zero there.

Vectors are ``(N2, N1, N0, 3)`` float64 grids, axis 0 fastest, the
component last (the program's ``(nnodes, 3)`` reshaped).  An operator
plane ``(s·3 + a)·3 + b`` holds ``K[(n, a), (n + c_s, b)]``.

The solve is CG preconditioned by the exact inverse of each component's
diagonal block: each is an anisotropic Laplacian ``Σ_k c_k K_k``, which
the fast diagonalisation of the 1-D stiffness and mass on the free
nodes inverts exactly (``Vᵀ M V = I``, ``Vᵀ K V = diag(λ)``), independent
of the program's multigrid.

Departures from ``Elasticity3D.c``:

* every face clamped (all three components zero), as the port's
  ``examples/elasticity.py`` clamps them, not the demo's own boundary
  conditions;
* the load is a body force of separable modes drawn by the traffic, not
  the demo's own load;
* λ = μ = 1, the port's example values, on the unit cube;
* a uniform mesh of ``nel`` elements per axis of degree ``p`` and
  continuity C^(p-1), ``q`` Gauss points per axis, as the configuration
  states;
* the elimination is the global form of PetIGA's per-element
  ``FixSystem`` summed over elements.
"""

from __future__ import annotations

import torch

from . import bspline
from .poisson import System as Poisson

__all__ = ["Elasticity"]

ORDERS = ((1, 1), (1, 0), (0, 1), (0, 0))


class Elasticity:
    """The fixed system on ``nel³`` elements of degree ``p`` with ``q``
    Gauss points per axis and Lamé constants ``lam``, ``mu``."""

    dim = dof = 3

    def __init__(self, p, nel, q, lam=1.0, mu=1.0, device="cpu"):
        self.p, self.nel, self.q = p, nel, q
        self.lam, self.mu = lam, mu
        self.N = nel + p
        self.device = device
        # the scalar system's masks, multiplicities, slots and 1-D products
        self.P = Poisson(3, p, nel, q, device=device)
        bands = {o: torch.as_tensor(bspline.band_matrix(p, nel, q, *o), dtype=torch.float64,
                                    device=device) for o in ORDERS}

        def kron(orders):  # orders[d]: the (da, db) of spatial axis d
            return [bands[o] for o in orders]

        self.blocks = {}
        for i in range(3):
            for j in range(3):
                if i == j:
                    terms = [((lam + 2 * mu) if k == i else mu,
                              kron([(1, 1) if d == k else (0, 0) for d in range(3)]))
                             for k in range(3)]
                else:
                    o1 = [(0, 0)] * 3
                    o1[i], o1[j] = (1, 0), (0, 1)
                    o2 = [(0, 0)] * 3
                    o2[j], o2[i] = (1, 0), (0, 1)
                    terms = [(lam, kron(o1)), (mu, kron(o2))]
                self.blocks[(i, j)] = terms

    @property
    def grid(self):
        return (self.N,) * 3 + (3,)

    @property
    def nslots(self):
        return self.P.nslots

    @property
    def nplanes(self):
        return self.P.nslots * 9

    # ------------------------------------------------------------ entries

    def slot_block(self, s, a, b, z0, z1):
        """``K_fixed[(n, a), (n + c_s, b)]`` for the nodes of grid rows
        ``z0:z1`` of the slowest axis: a ``(z1-z0, N, N)`` float64
        tensor."""
        P, p = self.P, self.p
        off = P.slot_offsets(s)
        kp = torch.nn.functional.pad(P.keep1, (p, p))
        kcol = [P.keep1 * kp[p + off[d]:p + off[d] + self.N] for d in range(3)]
        out = None
        for c, bands in self.blocks[(a, b)]:
            v = None
            for g in range(3):
                d = 2 - g
                col = bands[d][:, off[d] + p] * kcol[d]
                if g == 0:
                    col = col[z0:z1]
                shape = [1, 1, 1]
                shape[g] = col.shape[0]
                col = col.reshape(shape)
                v = col if v is None else v * col
            out = c * v if out is None else out + c * v
        if s == P.diag_slot and a == b:
            out = out + P.fixed_diag[z0:z1]
        return out

    # ------------------------------------------------------------ products

    def _block_apply(self, terms, x):
        y = torch.zeros_like(x)
        for c, bands in terms:
            v = x
            for g in range(3):
                v = self.P._band_apply(bands[2 - g], v, g)
            y += c * v
        return y

    def apply(self, x):
        """``K_fixed @ x`` for a float64 ``(N, N, N, 3)`` grid ``x``."""
        keep = self.P.keep
        xk = x * keep[..., None]
        y = torch.zeros_like(x)
        for (i, j), terms in self.blocks.items():
            y[..., i] += self._block_apply(terms, xk[..., j])
        return y * keep[..., None] + self.P.fixed_diag[..., None] * x

    def load(self, modes):
        """Fixed load vector of the body force ``modes``, a list of
        ``(component, amp, [(k_d, phi_d)] * 3)`` for ``f = Σ amp e_c Π_d
        sin(k_d x_d + phi_d)``: a float64 ``(N, N, N, 3)`` grid."""
        b = torch.zeros(self.grid, dtype=torch.float64, device=self.device)
        for c in range(3):
            mine = [(amp, axes) for comp, amp, axes in modes if comp == c]
            if mine:
                b[..., c] = self.P.load(mine)
        return b

    # ------------------------------------------------------------ solves

    def block_solve(self, r):
        """The exact inverse of each component's diagonal block applied to
        ``r``: the fast diagonalisation of ``Σ_k c_k K_k`` on the free
        nodes, the fixed diagonal on the others."""
        P = self.P
        _, V, lam = P._fd()
        out = torch.where(P.mask[..., None], r / torch.where(P.mask, P.fixed_diag, 1.0)[..., None],
                          r)
        inner = (slice(1, self.N - 1),) * 3
        for i in range(3):
            y = out[..., i][inner]
            for g in range(3):
                y = torch.movedim(torch.tensordot(y, V, dims=([g], [0])), -1, g)
            c = [(self.lam + 2 * self.mu) if 2 - g == i else self.mu for g in range(3)]
            d = (c[0] * lam.reshape(-1, 1, 1) + c[1] * lam.reshape(1, -1, 1)
                 + c[2] * lam.reshape(1, 1, -1))
            y = y / d
            for g in range(3):
                y = torch.movedim(torch.tensordot(y, V.T, dims=([g], [0])), -1, g)
            out[..., i][inner] = y
        return out

    def solve(self, b, rtol=1e-12, maxiter=1000):
        """``K⁻¹ b`` in float64 by CG preconditioned with
        :meth:`block_solve`, to ``rtol``."""
        x = torch.zeros_like(b)
        r = b.clone()
        z = self.block_solve(r)
        d = z.clone()
        rz = float((r * z).sum())
        nb = float(torch.linalg.vector_norm(b))
        for _ in range(maxiter):
            if float(torch.linalg.vector_norm(r)) <= rtol * nb:
                return x
            Ad = self.apply(d)
            a = rz / float((d * Ad).sum())
            x += a * d
            r -= a * Ad
            z = self.block_solve(r)
            rz, rz0 = float((r * z).sum()), rz
            d = z + (rz / rz0) * d
        raise RuntimeError(f"reference CG did not reach rtol {rtol} in {maxiter} iterations")

    def rel_residual(self, b, u):
        """``‖b - K u‖ / ‖b‖`` in float64."""
        r = b - self.apply(u)
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
