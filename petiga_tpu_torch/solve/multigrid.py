"""Geometric multigrid for IGA (port of :mod:`petiga_tpu.solve.multigrid`):
the analog of the reference's PCMG preparation (petigapcmg.c: per-axis
coarsening factors and a DMDA shell for PETSc's PCMG).

Spline spaces are nested under uniform refinement, so prolongation is
exact knot insertion (Boehm's algorithm), applied as separable per-axis
contractions (``torch.tensordot`` on the node grid, dof last); coarse
operators are re-assembled on each level; the V-cycle smooths with
weighted Jacobi and solves the coarsest level by CG with a fixed budget.
Every smoother, residual and coarse product goes through
``A.fast_operator()``, that is, through the stencil SpMV kernel on the
card.  :func:`mg_local_preconditioner` is the distributed variant for
:class:`~petiga_tpu_torch.parallel.dist.DistSpace`'s solvers.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.axis import Axis
from ..core.bspline import bspline_ders
from ..core.space import Space

__all__ = [
    "knot_insertion_matrix",
    "prolongation_1d",
    "MGHierarchy",
    "mg_preconditioner",
    "mg_local_preconditioner",
]


def knot_insertion_matrix(p: int, U_coarse: np.ndarray, U_fine: np.ndarray) -> np.ndarray:
    """Global knot-insertion (subdivision) matrix T with
    ``N_c_j(u) = Σ_i T[i, j] N_f_i(u)``: the coarse basis expressed in the
    fine space.  Boehm insertion of one knot at a time; exact for nested
    knot vectors.  Returns (n_fine, n_coarse), host numpy."""
    U = np.asarray(U_coarse, dtype=np.float64).copy()
    n = len(U) - p - 1
    T = np.eye(n)
    # multiset difference: fine knots missing from the coarse vector
    missing = []
    j = 0
    Uc_sorted = sorted(U)
    for u in sorted(U_fine):
        if j < len(Uc_sorted) and abs(u - Uc_sorted[j]) < 1e-12:
            j += 1
        else:
            missing.append(u)
    for u in missing:
        m = len(U) - 1
        k = int(np.searchsorted(U, u, side="right") - 1)
        k = min(max(k, p), m - p - 1)
        nold = len(U) - p - 1
        # Boehm: new control values c'_i = a_i c_i + (1 - a_i) c_{i-1}
        A = np.zeros((nold + 1, nold))
        for i in range(nold + 1):
            if i <= k - p:
                A[i, i] = 1.0
            elif i <= k:
                denom = U[i + p] - U[i]
                a = (u - U[i]) / denom if denom > 0 else 0.0
                A[i, i] = a
                A[i, i - 1] = 1.0 - a
            else:
                A[i, i - 1] = 1.0
        T = A @ T
        U = np.insert(U, k + 1, u)
    return T


def prolongation_1d(coarse: Axis, fine: Axis) -> np.ndarray:
    """(nnp_fine, nnp_coarse) prolongation between nested axes, with the
    periodic wrap of the duplicate basis functions (host numpy)."""
    if fine.p != coarse.p:
        raise ValueError("degrees must match")
    if not coarse.periodic:
        return knot_insertion_matrix(coarse.p, coarse.U, fine.U)
    # periodic: the unwrapped shadow knots differ structurally, so Boehm
    # does not apply; the spaces are still nested on the torus, so the
    # exact coefficients come from interpolation at the fine Greville
    # points (a square, well-conditioned system)

    def wrapped_basis(ax, u):
        u0, u1 = ax.limits
        uu = u0 + np.mod(u - u0, u1 - u0)
        spans = ax.find_span(uu)
        ders = bspline_ders(ax.U, ax.p, spans, uu, 0)
        B = np.zeros((len(u), ax.nnp))
        for j in range(ax.p + 1):
            cols = (spans - ax.p + j) % ax.nnp
            B[np.arange(len(u)), cols] += ders[:, 0, j]
        return B

    shift = (fine.nbasis - fine.nnp) // 2
    g = fine.greville()[shift:shift + fine.nnp]
    P = np.linalg.solve(wrapped_basis(fine, g), wrapped_basis(coarse, g))
    P[np.abs(P) < 1e-12] = 0.0
    return P


class MGHierarchy:
    """Spaces and operators from coarse to fine, with separable
    prolongations (``prolongs[lvl][d]``: (N_fine_d, N_coarse_d) tensors
    on the finest space's device, in its dtype)."""

    def __init__(self, spaces, operators, prolongs):
        self.spaces = spaces  # coarse -> fine
        self.operators = operators
        self.prolongs = prolongs

    @staticmethod
    def build(
        space: Space,
        assemble: Callable,
        levels: Optional[int] = None,
        min_nel: int = 4,
    ) -> "MGHierarchy":
        """``assemble(space) -> StencilMatrix`` (or a kernel operator)
        called per level.  Coarsening halves each axis while it is even
        and the half is at least ``min_nel`` (DMDAComputeCoarsenFactor
        analog, petigapcmg.c:96-114); ``levels`` caps the count."""
        spaces = [space]
        while (levels is None or len(spaces) < levels) and all(
            n % 2 == 0 and n // 2 >= min_nel for n in spaces[-1].elem_shape
        ):
            cur = spaces[-1]
            axes = [
                Axis.uniform(p=ax.p, nel=ax.nel // 2, u0=ax.limits[0], u1=ax.limits[1],
                             continuity=ax.continuity, periodic=ax.periodic)
                for ax in cur.axes
            ]
            cs = Space(axes, dof=cur.dof, basis_type=cur.basis_type, order=cur.order,
                       dtype=cur.dtype, device=cur.device)
            cs.bc = cur.bc
            cs.bc_visit = cur.bc_visit
            spaces.append(cs)
        spaces = spaces[::-1]  # coarse -> fine
        operators = [assemble(s) for s in spaces]
        prolongs = [
            [torch.as_tensor(prolongation_1d(spaces[lvl].axes[d], spaces[lvl + 1].axes[d]),
                             dtype=space.dtype, device=space.device)
             for d in range(space.dim)]
            for lvl in range(len(spaces) - 1)
        ]
        return MGHierarchy(spaces, operators, prolongs)

    # ----------------------------------------------------------- transfer

    @staticmethod
    def _tensor_apply(Ps, x, shape_in, dof):
        """Apply the separable operator ``⊗_d Ps[d]`` to a node vector:
        one contraction per axis of the reversed-axis grid, dof last."""
        dim = len(Ps)
        g = x.reshape(tuple(shape_in[::-1]) + (dof,))
        for d in range(dim):
            gax = dim - 1 - d
            g = torch.movedim(torch.tensordot(Ps[d], g, dims=([1], [gax])), 0, gax)
        return g.reshape(-1, dof)

    def prolong(self, lvl, xc):
        """coarse ``lvl`` -> ``lvl + 1``: (nnodes_fine, dof)."""
        cs = self.spaces[lvl]
        return self._tensor_apply(self.prolongs[lvl], xc, cs.node_shape, cs.dof)

    def restrict(self, lvl, xf):
        """fine ``lvl + 1`` -> ``lvl`` (the transpose): (nnodes_coarse,
        dof)."""
        fs = self.spaces[lvl + 1]
        return self._tensor_apply([P.T for P in self.prolongs[lvl]], xf, fs.node_shape,
                                  fs.dof)


def mg_preconditioner(
    hier: MGHierarchy,
    *,
    nsmooth: int = 2,
    omega: float = 0.6,
    coarse_iters: int = 50,
):
    """V-cycle preconditioner ``M(r) ≈ A⁻¹ r``.

    Weighted-Jacobi smoothing (``nsmooth`` sweeps before and after);
    the coarsest level solved by Jacobi-CG to rtol 1e-10 within a fixed
    budget of ``coarse_iters`` iterations, as the reference's static
    shapes require (in f32 the budget, not the tolerance, ends it).
    Every product runs on the levels' kernel operators
    (``fast_operator()``)."""
    from .krylov import cg, jacobi_preconditioner

    nlev = len(hier.spaces)
    diags = []
    for A in hier.operators:
        d = A.scalar_diagonal()
        diags.append(torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                                 torch.ones_like(d)))
    fastops = [A if not hasattr(A, "fast_operator") else A.fast_operator()
               for A in hier.operators]
    coarse_M = jacobi_preconditioner(hier.operators[0])

    def smooth(lvl, x, b):
        A, dinv = fastops[lvl], diags[lvl]
        for _ in range(nsmooth):
            x = x + omega * dinv * (b - A.matvec(x))
        return x

    def vcycle(lvl, b):
        if lvl == 0:
            return cg(fastops[0], b, M=coarse_M, rtol=1e-10, maxiter=coarse_iters).x
        x = smooth(lvl, torch.zeros_like(b), b)
        rc = hier.restrict(lvl - 1, b - fastops[lvl].matvec(x))
        x = x + hier.prolong(lvl - 1, vcycle(lvl - 1, rc))
        return smooth(lvl, x, b)

    dof = hier.spaces[-1].dof

    def M(r):
        return vcycle(nlev - 1, r.reshape(-1, dof)).reshape(r.shape)

    return M


def mg_local_preconditioner(
    assemble: Callable,
    *,
    levels: Optional[int] = None,
    nsmooth: int = 2,
    omega: float = 0.6,
    min_nel: int = 4,
    coarse_rtol: float = 1e-8,
    coarse_maxiter: int = 200,
):
    """Multigrid under domain decomposition — the role PCMG plays when
    the reference runs parallel (petigapcmg.c + PETSc's distributed MG).

    Returns a ``pc`` callable for ``DistSpace.cg/bicgstab/gmres``'s
    ``pc=`` argument.  The finest level is smoothed distributed
    (weighted Jacobi through the halo-exchange ``matvec_local``); the
    residual is restricted straight to the next level by the exact
    knot-insertion transfer, as per-rank partial contractions
    all-reduced into a *replicated* coarse vector (the agglomeration
    endgame of parallel MG).  Every rank then solves the same coarse
    problem by CG preconditioned with the serial V-cycle over the
    remaining levels, and prolongs the result into its block.

    ``assemble(space) -> StencilMatrix`` builds the coarse operators
    (Galerkin-by-reassembly, as in :meth:`MGHierarchy.build`)."""
    from .krylov import cg, jacobi_preconditioner

    def pc(ds, data_loc):
        sp = ds.space
        dim, dof = sp.dim, sp.dof
        L = tuple(int(n) for n in ds.L)
        dev, dt = data_loc.device, data_loc.dtype
        # the finest operator already lives distributed in data_loc
        sentinel = object()
        hier = MGHierarchy.build(sp, lambda s: sentinel if s is sp else assemble(s),
                                 levels=levels, min_nel=min_nel)
        if len(hier.spaces) < 2:
            raise ValueError("grid too coarse for a multigrid hierarchy")
        sub = MGHierarchy(hier.spaces[:-1], hier.operators[:-1], hier.prolongs[:-1])
        Ac = sub.operators[-1]
        coarse_M = (mg_preconditioner(sub, nsmooth=nsmooth, omega=omega)
                    if len(sub.spaces) > 1 else jacobi_preconditioner(Ac))
        Ac_op = Ac.fast_operator() if hasattr(Ac, "fast_operator") else Ac
        cs = sub.spaces[-1]
        Nc = cs.node_shape
        # this rank's rows of the finest transfer, padded to the rank
        # grid (rows past the real nodes are zero: padding stays decoupled)
        P_loc = []
        for d in range(dim):
            P = prolongation_1d(cs.axes[d], sp.axes[d])
            Pp = np.zeros((ds.Np[d], Nc[d]))
            Pp[: P.shape[0]] = P
            start = ds.coords[d] * L[d]
            P_loc.append(torch.as_tensor(Pp[start:start + L[d]], dtype=dt, device=dev))
        dinv = ds._jacobi_inv(data_loc)

        def Av(v):
            return ds.matvec_local(data_loc, v)

        def transfer(Ps, x):
            for d in range(dim):
                gax = dim - 1 - d
                x = torch.movedim(torch.tensordot(Ps[d], x, dims=([1], [gax])), 0, gax)
            return x

        def smooth(x, b):
            for _ in range(nsmooth):
                x = x + omega * dinv * (b - Av(x))
            return x

        def M(r_loc):
            x = smooth(torch.zeros_like(r_loc), r_loc)
            rc = ds._psum(transfer([P.T for P in P_loc], r_loc - Av(x)))
            res = cg(Ac_op, rc.reshape(-1, dof), M=coarse_M, rtol=coarse_rtol,
                     maxiter=coarse_maxiter)
            x = x + transfer(P_loc, res.x.reshape(tuple(Nc[::-1]) + (dof,)))
            return smooth(x, r_loc)

        return M

    return pc
