"""Plain reference of the Poisson cells: the Galerkin system of
``-div(k grad u) = f`` with homogeneous Dirichlet values on every face of
the unit cube, in float64 PyTorch.

Every coefficient and forcing the traffic draws is a sum of products of
one-dimensional functions, so the operator is a short sum of Kronecker
products of banded 1-D matrices (``terms``), each integrated with the same
Gauss rule per axis as a tensor-product element loop would use.  From
those the reference builds the stiffness entries slot by slot, the load
vector, and products with any vector, without forming the 3-D matrix.

The Dirichlet elimination is the one of PetIGA's ``FixSystem`` summed over
elements: rows and columns of fixed nodes are zeroed, a fixed row's
diagonal holds the number of elements that share the node, and the load
is zero there.

Node grids are ``(N2, N1, N0)`` tensors, axis 0 fastest in the flat
index.  A stencil slot is numbered with axis 0 fastest over the offsets
``-p..p`` of every axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bspline

__all__ = ["System", "forcing_modes_1d"]


def _sin(k, phi):
    return lambda x: np.sin(k * x + phi)


def forcing_modes_1d(p, nel, q, modes):
    """Per mode ``(amp, [(k_d, phi_d)] * dim)`` of ``f = Σ amp Π_d sin(k_d x_d
    + phi_d)``: the amplitude and the per-axis 1-D loads."""
    return [(amp, [bspline.load_1d(p, nel, q, _sin(k, ph)) for k, ph in axes])
            for amp, axes in modes]


class System:
    """The fixed system on ``nel^dim`` elements of degree ``p`` with ``q``
    Gauss points per axis.

    ``coef``: None for ``k = 1``, or ``(amp, [(k_d, phi_d)] * dim)`` for
    ``k = 1 + amp Π_d sin(k_d x_d + phi_d)``."""

    def __init__(self, dim, p, nel, q, coef=None, device="cpu"):
        self.dim, self.p, self.nel, self.q = dim, p, nel, q
        self.N = nel + p
        self.device = device
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
        K1 = t(bspline.band_matrix(p, nel, q, 1, 1))
        M1 = t(bspline.band_matrix(p, nel, q, 0, 0))
        self.terms = []
        for d in range(dim):
            self.terms.append((1.0, [K1 if e == d else M1 for e in range(dim)]))
        if coef is not None:
            amp, axes = coef
            Ks = [t(bspline.band_matrix(p, nel, q, 1, 1, _sin(k, ph))) for k, ph in axes]
            Ms = [t(bspline.band_matrix(p, nel, q, 0, 0, _sin(k, ph))) for k, ph in axes]
            for d in range(dim):
                self.terms.append((amp, [Ks[e] if e == d else Ms[e] for e in range(dim)]))
        m1 = bspline.multiplicity(p, nel)
        fixed1 = np.zeros(self.N, dtype=bool)
        fixed1[[0, -1]] = True
        grid = (self.N,) * dim
        mask = np.zeros(grid, dtype=bool)
        mult = np.ones(grid)
        for g in range(dim):  # grid axis g is spatial axis dim-1-g
            shape = [1] * dim
            shape[g] = self.N
            mask = mask | fixed1.reshape(shape)
            mult = mult * m1.reshape(shape)
        self.keep1 = t(~fixed1)
        self.mask = torch.as_tensor(mask, device=device)
        self.keep = (~self.mask).to(torch.float64)
        self.fixed_diag = torch.where(self.mask, t(mult), torch.zeros((), dtype=torch.float64,
                                                                       device=device))

    @property
    def grid(self):
        return (self.N,) * self.dim

    @property
    def nslots(self):
        return (2 * self.p + 1) ** self.dim

    @property
    def diag_slot(self):
        return (self.nslots - 1) // 2

    def slot_offsets(self, s):
        """Per-axis offsets of slot ``s`` (axis 0 fastest)."""
        w = 2 * self.p + 1
        return [(s // w**d) % w - self.p for d in range(self.dim)]

    # ------------------------------------------------------------ entries

    def slot_block(self, s, z0, z1):
        """``A_fixed[n, n + c_s]`` for the nodes of grid rows ``z0:z1`` of
        the slowest axis: a ``(z1-z0, N, ..., N)`` float64 tensor."""
        p, dim = self.p, self.dim
        off = self.slot_offsets(s)
        # a fixed row or column zeroes the entry: keep[i]·keep[i + o] per axis
        k1 = self.keep1
        kp = torch.nn.functional.pad(k1, (p, p))
        kcol = [k1 * kp[p + off[d]:p + off[d] + self.N] for d in range(dim)]
        out = None
        for c, bands in self.terms:
            v = None
            for g in range(dim):
                d = dim - 1 - g
                col = bands[d][:, off[d] + p] * kcol[d]
                if g == 0:
                    col = col[z0:z1]
                shape = [1] * dim
                shape[g] = col.shape[0]
                col = col.reshape(shape)
                v = col if v is None else v * col
            v = c * v
            out = v if out is None else out + v
        if s == self.diag_slot:
            out = out + self.fixed_diag[z0:z1]
        return out

    # ------------------------------------------------------------ products

    def _band_apply(self, band, x, g):
        """``y_i = Σ_o band[i, o] x_{i+o-p}`` along grid axis ``g``."""
        p = self.p
        xm = torch.movedim(x, g, -1)
        xp = torch.nn.functional.pad(xm, (p, p))
        y = torch.zeros_like(xm)
        for o in range(2 * p + 1):
            y += band[:, o] * xp[..., o:o + self.N]
        return torch.movedim(y, -1, g)

    def apply(self, x):
        """``A_fixed @ x`` for a float64 grid ``x``."""
        xk = x * self.keep
        y = torch.zeros_like(x)
        for c, bands in self.terms:
            v = xk
            for g in range(self.dim):
                v = self._band_apply(bands[self.dim - 1 - g], v, g)
            y += c * v
        return y * self.keep + self.fixed_diag * x

    def load(self, modes):
        """Fixed load vector of the forcing ``modes`` (see
        :func:`forcing_modes_1d`), float64 grid."""
        b = torch.zeros(self.grid, dtype=torch.float64, device=self.device)
        for amp, loads in forcing_modes_1d(self.p, self.nel, self.q, modes):
            v = None
            for g in range(self.dim):
                col = torch.as_tensor(loads[self.dim - 1 - g], dtype=torch.float64,
                                      device=self.device)
                shape = [1] * self.dim
                shape[g] = self.N
                v = col.reshape(shape) if v is None else v * col.reshape(shape)
            b += amp * v
        return b * self.keep

    # ------------------------------------------------------------ solves

    def _fd(self):
        """The fast diagonalisation of the constant-coefficient operator on
        the free nodes: ``V`` and ``lam`` with ``Vᵀ M V = I`` and
        ``Vᵀ K V = diag(lam)`` for the 1-D stiffness ``K`` and mass ``M``
        restricted to the free nodes (every axis has the same ones)."""
        if not hasattr(self, "_fd_pair"):
            free = slice(1, self.N - 1)  # fixed1 holds the two end nodes
            K1, M1 = (self._dense(self.terms[0][1][d]) for d in (0, 1))
            K = K1[free][:, free]
            M = M1[free][:, free]
            L = torch.linalg.cholesky(M)
            C = torch.linalg.solve_triangular(L, K, upper=False)
            C = torch.linalg.solve_triangular(L, C.T, upper=False)
            lam, W = torch.linalg.eigh((C + C.T) / 2)
            V = torch.linalg.solve_triangular(L.T, W, upper=True)
            self._fd_pair = (free, V, lam)
        return self._fd_pair

    def _dense(self, band):
        p, N = self.p, self.N
        A = torch.zeros((N, N), dtype=torch.float64, device=self.device)
        for o in range(2 * p + 1):
            i = torch.arange(max(0, p - o), min(N, N + p - o), device=self.device)
            A[i, i + o - p] = band[i, o]
        return A

    def fd_solve(self, r):
        """``A0⁻¹ r`` for the constant-coefficient operator ``A0`` (the
        ``k = 1`` terms with the fixed rows): exact, by the fast
        diagonalisation on the free nodes and the fixed diagonal on the
        others."""
        _, V, lam = self._fd()
        x = torch.where(self.mask, r / torch.where(self.mask, self.fixed_diag, 1.0), r)
        inner = (slice(1, self.N - 1),) * self.dim  # the free nodes
        y = x[inner]
        for g in range(self.dim):
            y = torch.movedim(torch.tensordot(y, V, dims=([g], [0])), -1, g)
        d = lam
        for g in range(1, self.dim):
            d = d.unsqueeze(-1) + lam.reshape((1,) * g + (-1,))
        y = y / d
        for g in range(self.dim):
            y = torch.movedim(torch.tensordot(y, V.T, dims=([g], [0])), -1, g)
        x[inner] = y
        return x

    def solve(self, b, rtol=1e-13, maxiter=500):
        """``A⁻¹ b`` in float64: exact for ``k = 1`` (:meth:`fd_solve`);
        otherwise CG preconditioned with the ``k = 1`` operator, to
        ``rtol``."""
        if len(self.terms) == self.dim:
            return self.fd_solve(b)
        x = self.fd_solve(b)
        r = b - self.apply(x)
        z = self.fd_solve(r)
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
            z = self.fd_solve(r)
            rz, rz0 = float((r * z).sum()), rz
            d = z + (rz / rz0) * d
        raise RuntimeError(f"reference CG did not reach rtol {rtol} in {maxiter} iterations")

    def rel_residual(self, b, u):
        """``‖b - A u‖ / ‖b‖`` in float64."""
        r = b - self.apply(u)
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))

