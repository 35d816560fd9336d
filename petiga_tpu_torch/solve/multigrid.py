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
card.  The V-cycle carries PCMG's log events as named ranges, counters
and optional CUDA-event spans (:class:`MGPreconditioner`).
:func:`mg_local_preconditioner` is the distributed variant for
:class:`~petiga_tpu_torch.parallel.dist.DistSpace`'s solvers.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..core.axis import Axis
from ..core.bspline import bspline_ders
from ..core.space import Space
from ..utils import profiling
from ..utils.profiling import Spans

__all__ = [
    "knot_insertion_matrix",
    "prolongation_1d",
    "MGHierarchy",
    "MGPreconditioner",
    "budget_cg",
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


# the coarse CG's relative tolerance
COARSE_RTOL = 1e-10


def budget_cg(A, b, M, rtol: float, maxiter: int):
    """:func:`~petiga_tpu_torch.solve.krylov.cg` from ``x0 = 0`` for a
    budget of ``maxiter`` iterations, with no host read.  The stopping
    test ``‖r‖ <= rtol·‖b‖`` is taken on the device, and from the first
    iteration that passes it ``x``, ``r`` and ``p`` stay as they are: the
    answer and the count of iterations that moved it are ``cg``'s, bit
    for bit, while every call launches the same ``maxiter + 1`` products
    and nothing waits for the device, so a CUDA graph can hold the whole
    solve.  Returns ``(x, iters)``, ``iters`` a 0-d int64 tensor on the
    device of ``b``."""
    from .krylov import _dot as dot

    x = torch.zeros_like(b)
    r = b - A.matvec(x)
    z = M(r)
    p = z
    rz = dot(r, z)
    # cg's host threshold, (rtol·‖b‖)² in float64, on the device
    tol2 = (rtol * torch.sqrt(dot(b, b)).double()) ** 2
    active = torch.ones((), dtype=torch.bool, device=b.device)
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        active = active & (dot(r, r).double() > tol2)
        iters = iters + active
        Ap = A.matvec(p)
        alpha = torch.where(active, rz / dot(p, Ap), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = torch.where(active, z + (rz_new / rz) * p, p)
        rz = rz_new
    return x, iters


class MGPreconditioner:
    """V-cycle preconditioner ``M(r) ≈ A⁻¹ r`` on an :class:`MGHierarchy`.

    Weighted-Jacobi smoothing (``nsmooth`` sweeps before and after);
    the coarsest level solved by Jacobi-CG to rtol 1e-10 within a fixed
    budget of ``coarse_iters`` iterations, as the reference's static
    shapes require: whichever of the two comes first ends it, and
    :func:`budget_cg` still launches the whole budget.
    Every product runs on the levels' kernel operators
    (``fast_operator()``).  The coarse solve is :func:`budget_cg`, which
    reads nothing back to the host; on the card, with ``graph`` (the
    default), it is captured once into a CUDA graph and replayed, so its
    50 iterations of kernels on a few hundred nodes cost one launch
    instead of a host round trip each.  Each replay adds the stencil
    launches the graph holds to ``spmv.LAUNCHES``, as eager calls would.

    Tracing, after PETSc's PCMG log events (level 0 the coarsest):
    ``profiling.annotate`` ranges ``PCMG_VCycle`` around each cycle,
    ``MGSmooth Level k``, ``MGResid Level k`` and ``MGInterp Level k``
    (restriction from and interpolation to level k) on every level above
    the coarsest, and ``MGCoarse`` around the coarse solve.  ``counts``
    gives the counters, always kept: ``vcycles``, ``coarse_iters`` (the
    coarse CG's iterations that moved its answer; counted on the device,
    so reading ``counts`` waits for it) and ``products`` (stencil
    products launched per level, coarse first); the coarse count is added
    up on the device, inside the graph on the card.  ``spans`` is None by
    default; set it to a :class:`~petiga_tpu_torch.utils.profiling.Spans`
    to time each cycle (``"vcycle"``) and coarse solve (``"coarse"``) with
    CUDA events."""

    def __init__(self, hier: MGHierarchy, *, nsmooth: int = 2, omega: float = 0.6,
                 coarse_iters: int = 50, graph: bool = True):
        from .krylov import jacobi_preconditioner

        self.hier = hier
        self.nsmooth, self.omega, self.coarse_iters = nsmooth, omega, coarse_iters
        self.nlev = len(hier.spaces)
        self.dof = hier.spaces[-1].dof
        self.device = hier.spaces[-1].device
        self.diags = []
        for A in hier.operators:
            d = A.scalar_diagonal()
            self.diags.append(torch.where(
                d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d), torch.ones_like(d)))
        self.fastops = [A if not hasattr(A, "fast_operator") else A.fast_operator()
                        for A in hier.operators]
        self.coarse_M = jacobi_preconditioner(hier.operators[0])
        self.spans: Optional[Spans] = None
        self._vcycles = 0
        self._products = [0] * self.nlev
        self._coarse_iters = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graph = graph
        self._graph = None
        self._names = [(f"MGSmooth Level {k}", f"MGResid Level {k}", f"MGInterp Level {k}")
                       for k in range(self.nlev)]

    @property
    def counts(self) -> dict:
        return {"vcycles": self._vcycles, "coarse_iters": int(self._coarse_iters),
                "products": list(self._products)}

    def _span(self, name):
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans(name, self.device)

    def _coarse_solve(self, b):
        """:func:`budget_cg` on the coarsest level, its iterations added to
        the coarse count: eagerly off the card or without ``graph``; on
        it, the graph captured at the first call, replayed on a copy of
        ``b``.  The answer is copied out of the graph's output, which the
        next replay overwrites."""
        from ..sparse import spmv

        A, M, k = self.fastops[0], self.coarse_M, self.coarse_iters
        if b.device.type != "cuda" or not self.graph:
            x, iters = budget_cg(A, b, M, COARSE_RTOL, k)
            self._coarse_iters += iters
            return x
        if self._graph is None:
            self._b = b.clone()
            # the first calls load the kernel library and cuBLAS's handle,
            # which a capture may not do
            side = torch.cuda.Stream(b.device)
            side.wait_stream(torch.cuda.current_stream(b.device))
            with torch.cuda.stream(side):
                budget_cg(A, self._b, M, COARSE_RTOL, k)
            torch.cuda.current_stream(b.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = dict(spmv.LAUNCHES)
            # thread_local: another thread's CUDA calls (a profiler's) do
            # not break this thread's capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._x, iters = budget_cg(A, self._b, M, COARSE_RTOL, k)
                self._coarse_iters += iters
            # the capture counted launches that only its replays make
            self._graph_launches = {n: spmv.LAUNCHES[n] - before[n] for n in before}
            for n, c in self._graph_launches.items():
                spmv.LAUNCHES[n] -= c
            self._graph = graph
        self._b.copy_(b)
        self._graph.replay()
        for n, c in self._graph_launches.items():
            spmv.LAUNCHES[n] += c
        return self._x.clone()

    def _smooth(self, lvl, x, b):
        A, dinv = self.fastops[lvl], self.diags[lvl]
        with profiling.annotate(self._names[lvl][0]):
            for _ in range(self.nsmooth):
                x = x + self.omega * dinv * (b - A.matvec(x))
        self._products[lvl] += self.nsmooth
        return x

    def _vcycle(self, lvl, b):
        if lvl == 0:
            with profiling.annotate("MGCoarse"), self._span("coarse"):
                x = self._coarse_solve(b)
            self._products[0] += self.coarse_iters + 1  # and the initial residual
            return x
        _, resid, interp = self._names[lvl]
        x = self._smooth(lvl, torch.zeros_like(b), b)
        with profiling.annotate(resid):
            r = b - self.fastops[lvl].matvec(x)
        self._products[lvl] += 1
        with profiling.annotate(interp):
            rc = self.hier.restrict(lvl - 1, r)
        xc = self._vcycle(lvl - 1, rc)
        with profiling.annotate(interp):
            x = x + self.hier.prolong(lvl - 1, xc)
        return self._smooth(lvl, x, b)

    def __call__(self, r):
        with profiling.annotate("PCMG_VCycle"), self._span("vcycle"):
            y = self._vcycle(self.nlev - 1, r.reshape(-1, self.dof)).reshape(r.shape)
        self._vcycles += 1
        return y


def mg_preconditioner(
    hier: MGHierarchy,
    *,
    nsmooth: int = 2,
    omega: float = 0.6,
    coarse_iters: int = 50,
) -> MGPreconditioner:
    """The V-cycle preconditioner of ``hier``
    (:class:`MGPreconditioner`)."""
    return MGPreconditioner(hier, nsmooth=nsmooth, omega=omega, coarse_iters=coarse_iters)


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
        # no CUDA graph: every rank would capture its own beside the
        # process group's threads
        coarse_M = (MGPreconditioner(sub, nsmooth=nsmooth, omega=omega, graph=False)
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
