"""Matrix-free sum-factorized operator application (port of
:mod:`petiga_tpu.sparse.matfree`).

For variable-coefficient reaction-diffusion forms

    a(u, v) = ∫ c(x) u v + κ(x) ∇u·∇v

the operator is applied without ever forming element matrices: element
closures are gathered by shifted slices (regular spaces — the same
translation invariance the shift assembly uses), values/gradients at
quadrature points come from per-axis *sum-factorized* contractions
(small batched matmuls: O(p^{d+1}) instead of O(p^{2d}) per dof), and the
transpose chain scatters back with shifted in-place adds
(``yg[window] += block``: sequential, deterministic, no atomics — the
f64 residual of the mixed-precision refinement reads differences of
1e-12 and must not change from run to run).

``JacobianFreeOperator`` applies the exact Jacobian of a nonlinear
residual form by forward-mode AD (``torch.func.jvp``) of the element
residuals, never assembling it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..assembly.fastpath import _steps, is_regular
from ..assembly.tabulation import det_small, inv_small

__all__ = ["MatFreeOperator", "JacobianFreeOperator"]


class MatFreeOperator:
    """y = A x for a(u,v) = ∫ v_a C_ab u_b + ∇v_a · K_ab ∇u_b.

    dof = 1: ``c`` and ``kappa`` are scalars (the classic
    reaction-diffusion form).  dof > 1: pass ``C``/``Kmat`` as (dof,dof)
    coefficient matrices coupling the fields (zero entries are skipped,
    so the cost is one sum-factorized pass per NONZERO block).  Dirichlet
    rows/cols follow the assembled semantics (eliminated, diagonal =
    element multiplicity).

    Supported spaces: any *regular* space — maximal or reduced continuity
    (element steps > 1 become strided slice gathers), open or periodic
    axes, and non-rational mapped geometry (pointwise metric precomputed
    at quadrature points).  Rational (NURBS) weights and manifold
    embeddings (nsd != dim) are refused: use the assembled operator.
    ``scalar_diagonal`` is exact for the identity map and a
    spectrally-equivalent estimate under mapping (fine for Jacobi
    preconditioning).

    ``zchunk`` bounds the gather/eval temporaries to that many element
    slabs of the slowest axis at a time (a loop of windowed
    sum-factorized applies): at 256³ p=2 the unchunked closures alone are
    3.6 GB per field in f64.  Open slowest axis only; rounded down to a
    divisor of E_z.
    """

    def __init__(self, space, c=0.0, kappa=1.0, C=None, Kmat=None,
                 zchunk: Optional[int] = None):
        from ..assembly.assemble import _node_multiplicity

        if not is_regular(space):
            raise ValueError("matrix-free apply requires a regular space")
        self.space = space
        self.steps = _steps(space)
        self.off0 = tuple(int(t.offset[0]) for t in space.tabs)
        self.zchunk = None
        if zchunk is not None and space.dim > 1 and not space.periodic[-1]:
            kz = max(1, min(int(zchunk), space.elem_shape[-1]))
            while space.elem_shape[-1] % kz:
                kz -= 1
            self.zchunk = kz
        dof = space.dof
        self.C = np.asarray(C if C is not None else np.eye(dof) * c,
                            np.float64).reshape(dof, dof)
        self.Kmat = np.asarray(Kmat if Kmat is not None else np.eye(dof) * kappa,
                               np.float64).reshape(dof, dof)
        # dof=1 compatibility attributes
        self.c = float(self.C[0, 0])
        self.kappa = float(self.Kmat[0, 0])
        sp = space
        dim = sp.dim

        def real(a):
            return torch.as_tensor(np.asarray(a), dtype=sp.dtype, device=sp.device)

        # per-axis tables: value/derivative (nel_d, nqp_d, p_d+1)
        self.B0 = [real(t.value[:, :, 0, :]) for t in sp.tabs]
        self.B1 = [real(t.value[:, :, 1, :]) for t in sp.tabs]
        # quadrature weights incl. parametric detJac, separable
        self.w1d = [real(t.weight * t.detJac[:, None]) for t in sp.tabs]
        self.fixed = sp.tensor("dirichlet")[0]  # (nnodes, dof)
        self.mult = _node_multiplicity(sp)

        # mapped geometry: pointwise metric G = J^{-1} J^{-T} detJ and
        # detJ at every quadrature point (computed once by the same
        # sum-factorized pipeline; the per-axis tables stay separable,
        # only these pointwise factors are dense)
        self._G = None
        self._detJ = None
        if sp.has_geometry:
            if sp.is_rational:
                raise ValueError(
                    "rational (NURBS) geometry is not supported "
                    "matrix-free; use the assembled stencil operator"
                )
            if sp.nsd != dim:
                raise ValueError(
                    "matrix-free geometry requires nsd == dim "
                    "(no manifold embedding)"
                )
            X = sp.tensor("geometry")  # (nnodes, dim)
            N = sp.node_shape
            Jcols = []
            for dpar in range(dim):
                tabs = [self.B1[d] if d == dpar else self.B0[d] for d in range(dim)]
                rows = [
                    self._contract(self._gather(X[:, i].reshape(tuple(N[::-1]))), tabs)
                    for i in range(dim)
                ]
                Jcols.append(torch.stack(rows, dim=-1))  # (..., i)
            J = torch.stack(Jcols, dim=-1)  # (E_rev..., q_rev..., i, dpar)
            detJ = det_small(J)
            Jinv = inv_small(J, detJ)
            self._detJ = detJ
            self._G = (torch.einsum("...ik,...jk->...ij", Jinv, Jinv)
                       * detJ[..., None, None])

    # ----------------------------------------------------- gather / scatter

    def _windows(self, amulti, kz=None):
        """Per grid axis: the node window of local index ``amulti``
        (reversed order) — a strided slice, or ``None`` on a periodic
        axis (a rotation by ``a_d``).  With ``kz`` the slowest axis is
        window-local: ``kz`` slabs from row 0."""
        sp = self.space
        dim = sp.dim
        E = sp.elem_shape
        out = []
        for g in range(dim):
            d = dim - 1 - g
            a_d, s = amulti[g], self.steps[d]
            if g == 0 and kz is not None:
                out.append(slice(a_d, a_d + s * (kz - 1) + 1, s))
            elif sp.periodic[d]:  # step-1 wrap (is_regular invariant)
                out.append(None)
            else:
                start = self.off0[d] + a_d
                out.append(slice(start, start + s * (E[d] - 1) + 1, s))
        return out

    def _gather(self, xg, kz=None):
        """Element closures from the node grid by (strided) shifted
        slices: out[(e_rev...), (a_rev...)] = x[off0 + s*e + a] — the
        arithmetic-progression offset structure of any regular axis
        (step s > 1 = repeated interior knots / reduced continuity).
        With ``kz``, ``xg`` is the window of ``kz`` element slabs of the
        slowest axis (rows ``[off0_z + ci·kz·s_z, + s_z(kz-1)+p_z+1)``
        of the node grid)."""
        sp = self.space
        E = sp.elem_shape
        nsh = sp.nen_shape
        parts = []
        for amulti in np.ndindex(*nsh[::-1]):  # reversed order (a_z, a_y, a_x)
            block = xg
            for g, win in enumerate(self._windows(amulti, kz)):
                if win is None:
                    block = torch.roll(block, -amulti[g], dims=g).narrow(
                        g, 0, E[sp.dim - 1 - g])
                else:
                    block = block[(slice(None),) * g + (win,)]
            parts.append(block)
        out = torch.stack(parts, dim=-1)  # (E_rev..., nen) a-rev-flat
        return out.reshape(out.shape[:-1] + tuple(nsh[::-1]))

    def _scatter(self, ye, kz=None, Wz=None):
        """Transpose of :meth:`_gather`: node grid (or, with ``kz``, the
        (Wz, N_rev[1:]...) node window) from per-(element, a) values,
        by in-place slice adds in a fixed order."""
        sp = self.space
        N_rev = tuple(sp.node_shape[::-1])
        shape = N_rev if kz is None else (Wz,) + N_rev[1:]
        yg = torch.zeros(shape, dtype=ye.dtype, device=ye.device)
        for amulti in np.ndindex(*sp.nen_shape[::-1]):
            block = ye[(Ellipsis,) + tuple(amulti)]
            sl = []
            for g, win in enumerate(self._windows(amulti, kz)):
                if win is None:
                    block = torch.roll(block, amulti[g], dims=g)
                    sl.append(slice(None))
                else:
                    sl.append(win)
            yg[tuple(sl)] += block
        return yg

    # ------------------------------------------------------------- apply

    def matvec(self, x):
        sp = self.space
        flat_in = x.dim() == 1
        xv = x.reshape(sp.nnodes, sp.dof)
        y = self.matvec_unfixed(torch.where(self.fixed, torch.zeros_like(xv), xv))
        y = torch.where(self.fixed, self.mult[:, None] * xv, y)
        return y.reshape(-1) if flat_in else y

    def matvec_unfixed(self, xv):
        """The form's operator with no Dirichlet elimination, on
        (nnodes, dof) vectors — what lifts inhomogeneous boundary values
        into a right-hand side."""
        sp = self.space
        N = sp.node_shape
        ys = []
        for a in range(sp.dof):
            ya = None
            for b in range(sp.dof):
                cab = float(self.C[a, b])
                kab = float(self.Kmat[a, b])
                if cab == 0.0 and kab == 0.0:
                    continue
                xg = xv[:, b].reshape(tuple(N[::-1]))
                t = self._apply_field(xg, cab, kab)
                ya = t if ya is None else ya + t
            ys.append(ya if ya is not None else xv.new_zeros(sp.nnodes))
        return torch.stack(ys, dim=-1)  # (nnodes, dof)

    # forward sum factorization: contract each local axis with its
    # per-element 1-D table → values/derivatives at quad points.
    # Explicit einsums keep the layout (E_rev..., q_rev...) unambiguous.

    def _labels(self):
        dim = self.space.dim
        return "ZYX"[3 - dim:], "zyx"[3 - dim:], "wvu"[3 - dim:]

    def _contract(self, xe, tabs, transpose=False):
        """(E_rev..., a_rev...) closures -> (E_rev..., q_rev...) point
        values for per-axis tables ``tabs``; with ``transpose`` the
        reverse, point values back to closures."""
        dim = self.space.dim
        E_LBL, A_LBL, Q_LBL = self._labels()
        src_lbl, dst_lbl = (Q_LBL, A_LBL) if transpose else (A_LBL, Q_LBL)
        out = xe
        cur = list(src_lbl)
        for g in range(dim - 1, -1, -1):  # contract x first
            T = tabs[dim - 1 - g]  # (E_d, Q_d, p_d+1)
            lhs = f"{E_LBL[g]}{Q_LBL[g]}{A_LBL[g]}"
            src = E_LBL + "".join(cur)
            cur[g] = dst_lbl[g]
            dst = E_LBL + "".join(cur)
            out = torch.einsum(f"{lhs},{src}->{dst}", T, out)
        return out

    def _contract_T(self, z, tabs):
        """Transpose of :meth:`_contract`."""
        return self._contract(z, tabs, transpose=True)

    def _weights(self, zslice=None):
        """Separable quadrature weights on the (E_rev, q_rev) grid; with
        ``zslice=(z0, kz)`` the slowest axis is restricted."""
        dim = self.space.dim
        w = None
        for g in range(dim):
            wd = self.w1d[dim - 1 - g]  # (E_d, Q_d)
            if g == 0 and zslice is not None:
                wd = wd.narrow(0, zslice[0], zslice[1])
            shape = [1] * (2 * dim)
            shape[g] = wd.shape[0]
            shape[dim + g] = wd.shape[1]
            w_d = wd.reshape(shape)
            w = w_d if w is None else w * w_d
        return w

    def _field_tabs(self, zslice=None):
        """(name, tabs) list for value + per-axis gradients, with the
        slowest-axis tables restricted when windowed."""
        dim = self.space.dim

        def tabs_for(dd):
            out = []
            for d in range(dim):
                T = self.B1[d] if d == dd else self.B0[d]
                if d == dim - 1 and zslice is not None:
                    T = T.narrow(0, zslice[0], zslice[1])
                out.append(T)
            return out

        return [("val", tabs_for(None))] + [(f"g{dd}", tabs_for(dd)) for dd in range(dim)]

    def _accumulate_point(self, evals, c, kappa, w, zslice=None):
        """Pointwise coefficient application (identity or mapped)."""
        dim = self.space.dim
        acc = {}
        G, detJ = self._G, self._detJ
        if zslice is not None and G is not None:
            G = G.narrow(0, zslice[0], zslice[1])
            detJ = detJ.narrow(0, zslice[0], zslice[1])
        if G is None:
            if "val" in evals:
                acc["val"] = c * w * evals["val"]
            for dd in range(dim):
                acc[f"g{dd}"] = kappa * w * evals[f"g{dd}"]
        else:
            if "val" in evals:
                acc["val"] = c * w * detJ * evals["val"]
            for dd in range(dim):
                t = None
                for ee in range(dim):
                    term = G[..., dd, ee] * evals[f"g{ee}"]
                    t = term if t is None else t + term
                acc[f"g{dd}"] = kappa * w * t
        return acc

    def _apply_closures(self, xe, c, kappa, zslice=None):
        """Closures -> closures: evaluate at the quadrature points, apply
        the coefficients, and contract back."""
        fields = self._field_tabs(zslice)
        if c == 0.0:
            fields = fields[1:]
        evals = {name: self._contract(xe, tabs) for name, tabs in fields}
        acc = self._accumulate_point(evals, c, kappa, self._weights(zslice), zslice)
        ye = None
        for name, tabs in fields:
            term = self._contract_T(acc[name], tabs)
            ye = term if ye is None else ye + term
        return ye

    def _zwindows(self):
        """The windowed loop's ``(ci, z0, Wz)`` triples: chunk index,
        first node row and row count of each group of ``zchunk`` element
        slabs."""
        sp = self.space
        d = sp.dim - 1
        kz, s_z = self.zchunk, self.steps[d]
        Wz = s_z * (kz - 1) + 1 + sp.degrees[d]
        return [(ci, self.off0[d] + ci * kz * s_z, Wz)
                for ci in range(sp.elem_shape[d] // kz)]

    def _apply_field(self, xg, c, kappa):
        """Sum-factorized apply of one scalar field pair; returns flat
        (nnodes,).  With ``zchunk`` a loop over z-slab groups keeps the
        closure and quadrature-grid temporaries bounded — O(zchunk/E_z)
        of the unchunked footprint — at identical results (the overlap
        rows accumulate across iterations, in loop order)."""
        if self.zchunk is None:
            return self._scatter(self._apply_closures(self._gather(xg), c, kappa)).reshape(-1)
        kz = self.zchunk
        yg = torch.zeros_like(xg)
        for ci, z0, Wz in self._zwindows():
            xe = self._gather(xg.narrow(0, z0, Wz), kz)
            ye = self._apply_closures(xe, c, kappa, (ci * kz, kz))
            yg.narrow(0, z0, Wz).add_(self._scatter(ye, kz, Wz))
        return yg.reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)

    def load_vector(self, forcing):
        """Load vector ``b_a = ∫ f N_a`` by the same (windowed)
        sum-factorized contractions as the matvec.  ``forcing(x)`` takes
        physical points ``(..., dim)`` and returns ``(...)``.  Identity
        map, dof = 1.  Returns (nnodes, 1)."""
        sp = self.space
        if sp.geometry is not None or sp.dof != 1:
            raise ValueError("load_vector: identity map, dof=1 only")
        dim = sp.dim
        E = sp.elem_shape
        nq = [t.nqp for t in sp.tabs]
        pts = sp.tensor("tabs_point")  # (E_d, Q_d)

        def fvals(zslice=None):
            """(E_rev..., q_rev...) forcing values (slowest axis
            windowed)."""
            Ez = E[dim - 1] if zslice is None else zslice[1]
            shape = (Ez,) + tuple(E[:-1][::-1]) + tuple(nq[::-1])
            comps = []
            for d in range(dim):
                P = pts[d]
                if d == dim - 1 and zslice is not None:
                    P = P.narrow(0, zslice[0], zslice[1])
                g = dim - 1 - d
                sh = [1] * (2 * dim)
                sh[g] = P.shape[0]
                sh[dim + g] = P.shape[1]
                comps.append(torch.broadcast_to(P.reshape(sh), shape))
            return forcing(torch.stack(comps, dim=-1))

        if self.zchunk is None:
            tabs = self._field_tabs()[0][1]
            ye = self._contract_T(self._weights() * fvals(), tabs)
            return self._scatter(ye).reshape(sp.nnodes, 1)
        kz = self.zchunk
        yg = torch.zeros(tuple(sp.node_shape[::-1]), dtype=sp.dtype, device=sp.device)
        for ci, z0, Wz in self._zwindows():
            zsl = (ci * kz, kz)
            tabs = self._field_tabs(zsl)[0][1]
            ye = self._contract_T(self._weights(zsl) * fvals(zsl), tabs)
            yg.narrow(0, z0, Wz).add_(self._scatter(ye, kz, Wz))
        return yg.reshape(sp.nnodes, 1)

    def scalar_diagonal(self):
        """Diagonal for Jacobi: assembled-free, via per-axis table sums
        ``Σ_q w (c N_a² + κ Σ_d (∂N_a)²)``, separable per axis (exact for
        the identity map)."""
        sp = self.space
        dim = sp.dim

        # per axis, the placement of (element, a) onto its node as a
        # one-hot (N_d, nel_d·(p_d+1)) matrix: a dense product on the
        # space's device, in a fixed order
        place = []
        for d in range(dim):
            idx = np.asarray(sp.axis_node_index[d]).reshape(-1)
            P = np.zeros((sp.node_shape[d], idx.shape[0]))
            P[idx, np.arange(idx.shape[0])] = 1.0
            place.append(torch.as_tensor(P, dtype=sp.dtype, device=sp.device))

        def axis_diag(tabs):
            # (nnodes_d,) per axis: Σ_e Σ_q w N[a]² placed by a
            return [
                place[d] @ torch.einsum("eq,eqa->ea", self.w1d[d],
                                        tabs[d] * tabs[d]).reshape(-1)
                for d in range(dim)
            ]

        def outer(parts):
            g = None
            for gax in range(dim):
                d = dim - 1 - gax
                shape = [1] * dim
                shape[gax] = parts[d].shape[0]
                pd = parts[d].reshape(shape)
                g = pd if g is None else g * pd
            return g.reshape(-1)

        cols = []
        for a in range(sp.dof):
            caa = float(self.C[a, a])
            kaa = float(self.Kmat[a, a])
            total = torch.zeros(sp.nnodes, dtype=sp.dtype, device=sp.device)
            if caa != 0.0:
                total = total + caa * outer(axis_diag(self.B0))
            for dd in range(dim):
                tabs = [self.B1[d] if d == dd else self.B0[d] for d in range(dim)]
                total = total + kaa * outer(axis_diag(tabs))
            cols.append(total)
        out = torch.stack(cols, dim=-1)
        return torch.where(self.fixed, self.mult[:, None].expand_as(out), out)


class JacobianFreeOperator:
    """Exact Jacobian *action* J(U)·v by forward-mode AD of the batched
    residual — Newton–Krylov without ever materializing the stencil
    (JFNK): about two residual evaluations per product and O(vector)
    memory.

    Dirichlet semantics carry over exactly: fixed residual rows are
    ``u - v``, so their linearization is the identity row — the same
    elimination the assembled path applies."""

    def __init__(self, space, function, U, ctx=None, *, aux=None,
                 order=None, chunk=None, boundary=None):
        self.space = space
        self.U = U.reshape(space.nnodes, space.dof)
        self._args = (function, ctx, aux, order, chunk, boundary)

    def matvec(self, v):
        from ..assembly.assemble import _assemble_residual

        function, ctx, aux, order, chunk, boundary = self._args
        Jv = _assemble_residual(self.space, function, self.U, ctx, aux, order, chunk,
                                boundary, tangent=v)
        return Jv.reshape(-1) if v.dim() == 1 else Jv

    def __matmul__(self, v):
        return self.matvec(v)
