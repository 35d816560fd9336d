"""Field-split preconditioning (port of :mod:`petiga_tpu.solve.fieldsplit`):
the analog of the reference's per-field decomposition for PCFIELDSPLIT
(DMCreateFieldDecomposition_IGA, petigadm.c:294-383, which hands PETSc
one index set per dof field).

The decomposition is a slice of the stencil storage: the ``(f, g)``
block of a dof > 1 :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix`
(``data`` of shape ``(nnodes, K, dof, dof)``, rows on axis 2 and columns
on axis 3, as in the reference) is itself a stencil operator on the same
node grid, ``data[:, :, rows][..., cols]``.

Two combinators, as PETSc's ``-pc_fieldsplit_type``:

  * additive (block Jacobi over fields): ``M⁻¹ r = diag(M_0⁻¹, …) r``;
  * multiplicative (block Gauss–Seidel over fields): fields in order,
    each residual updated with the off-diagonal blocks of the fields
    already solved.

``inner`` maps each diagonal sub-operator to its approximate inverse
(any of the preconditioner factories: Jacobi, BBB, multigrid, …).  The
multiplicative sweep's coupling products run on the stencil kernel
(``fast_operator()``); the reference applies them by its slot loop.
:func:`fieldsplit_local_preconditioner` is the distributed variant for
:class:`~petiga_tpu_torch.parallel.dist.DistSpace`'s solvers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..sparse.stencil import StencilMatrix
from .krylov import jacobi_preconditioner

__all__ = ["field_split", "fieldsplit_preconditioner", "fieldsplit_local_preconditioner"]


class _RectBlock:
    """Rectangular (rows × cols) field-coupling block on the same stencil:
    ``matvec`` maps (nnodes, ncols) -> (nnodes, nrows) through the square
    stencil operator of size ``max(nrows, ncols)``, zero-padded, on the
    kernel (its planes are packed once, here)."""

    def __init__(self, A: StencilMatrix, rows, cols):
        self.nrows, self.ncols = len(rows), len(cols)
        m = max(self.nrows, self.ncols)
        data = A.data.new_zeros(A.data.shape[:2] + (m, m))
        data[:, :, :self.nrows, :self.ncols] = A.data[:, :, list(rows)][..., list(cols)]
        self._op = StencilMatrix(dataclasses.replace(A.stencil, dof=m), data).fast_operator()

    def matvec(self, x):
        xv = x.reshape(-1, self.ncols)
        xv = torch.nn.functional.pad(xv, (0, self._op.dof - self.ncols))
        return self._op.matvec(xv)[:, :self.nrows]


def _sub_operator(A: StencilMatrix, rows: Sequence[int], cols: Sequence[int]):
    """The (rows × cols) field block as a stencil operator."""
    if len(rows) != len(cols):
        return _RectBlock(A, rows, cols)
    st = dataclasses.replace(A.stencil, dof=len(rows))
    return StencilMatrix(st, A.data[:, :, list(rows)][..., list(cols)].contiguous())


def field_split(A: StencilMatrix, groups: Optional[Sequence] = None):
    """The diagonal field(-group) sub-operators of a dof > 1 operator.

    ``groups``: index tuples partitioning ``range(dof)``; default one
    group per scalar field (the reference's default splitting,
    petigadm.c:327-344).  Returns a list of StencilMatrix."""
    if groups is None:
        groups = [(f,) for f in range(A.stencil.dof)]
    return [_sub_operator(A, g, g) for g in groups]


def fieldsplit_preconditioner(
    A: StencilMatrix,
    groups: Optional[Sequence] = None,
    inner: Optional[Callable] = None,
    kind: str = "additive",
):
    """Field-split preconditioner ``M(r)`` for a dof > 1 stencil operator.

    Args:
      groups: partition of ``range(dof)`` into field groups (default
        single fields).
      inner: factory ``sub_A -> M_sub`` (default Jacobi).
      kind: ``"additive"`` (block Jacobi over fields) or
        ``"multiplicative"`` (block Gauss–Seidel, with the off-diagonal
        blocks)."""
    dof = A.stencil.dof
    if kind not in ("additive", "multiplicative"):
        raise ValueError("kind must be 'additive' or 'multiplicative'")
    groups = [tuple(g) for g in ([(f,) for f in range(dof)] if groups is None else groups)]
    inner = jacobi_preconditioner if inner is None else inner
    Ms = [inner(_sub_operator(A, g, g)) for g in groups]
    off = {}
    if kind == "multiplicative":  # the coupling blocks, on the kernel
        off = {(i, j): _sub_operator(A, gi, gj)
               for i, gi in enumerate(groups) for j, gj in enumerate(groups) if j < i}
        off = {k: b if isinstance(b, _RectBlock) else b.fast_operator() for k, b in off.items()}

    def M(r):
        rv = r.reshape(-1, dof)
        z = torch.zeros_like(rv)
        for i, (g, Mg) in enumerate(zip(groups, Ms)):
            ri = rv[:, list(g)]
            for j, gj in enumerate(groups[:i]):  # none when additive
                if (i, j) in off:
                    ri = ri - off[(i, j)].matvec(z[:, list(gj)]).reshape(ri.shape)
            z[:, list(g)] = Mg(ri).reshape(rv.shape[0], len(g))
        return z.reshape(r.shape)

    return M


def fieldsplit_local_preconditioner(
    groups: Optional[Sequence] = None,
    kind: str = "additive",
    inner: str = "jacobi",
    inner_iters: int = 5,
):
    """Field-split preconditioning under domain decomposition — the
    parallel ``-pc_type fieldsplit`` role (petigadm.c:294-383).

    Returns a ``pc`` callable for ``DistSpace.cg/bicgstab/gmres``'s
    ``pc=`` argument.  Field(-group) sub-blocks are slices of the rank's
    stencil block; the halo-exchange ``matvec_local`` is dof-agnostic,
    so each sub-block keeps full distributed semantics.

    ``inner``: "jacobi" (stationary — safe inside CG) or "cg" (a fixed
    ``inner_iters``-step Jacobi-PCG sub-solve per application; the PC
    then varies between outer iterations, so pair it with
    ``DistSpace.gmres``).  ``kind`` as in
    :func:`fieldsplit_preconditioner`."""
    if inner not in ("jacobi", "cg"):
        raise ValueError("inner must be 'jacobi' or 'cg'")
    if kind not in ("additive", "multiplicative"):
        raise ValueError("kind must be 'additive' or 'multiplicative'")

    def pc(ds, data_loc):
        dof = ds.space.dof
        gs = [(f,) for f in range(dof)] if groups is None else [tuple(g) for g in groups]

        def sub(gi, gj):
            return data_loc[..., list(gi), :][..., list(gj)]

        def make_inner(dsub):
            dinv = ds._jacobi_inv(dsub)
            if inner == "jacobi":
                return lambda r: r * dinv

            def Msub(r):
                planes = ds.local_planes(dsub)
                x = torch.zeros_like(r)
                z = r * dinv
                p_ = z
                rz = ds._dot(r, z)
                rr = r
                for _ in range(inner_iters):
                    Ap = ds.matvec_local(dsub, p_, DT_loc=planes)
                    pAp = ds._dot(p_, Ap)
                    alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
                    x = x + alpha * p_
                    rr = rr - alpha * Ap
                    z = rr * dinv
                    rznew = ds._dot(rr, z)
                    beta = torch.where(rz > 0, rznew / torch.where(rz == 0, 1.0, rz), 0.0)
                    p_ = z + beta * p_
                    rz = rznew
                return x

            return Msub

        inners = [make_inner(sub(g, g)) for g in gs]

        def M(r):
            z = torch.zeros_like(r)
            for i, (g, Mg) in enumerate(zip(gs, inners)):
                ri = r[..., list(g)]
                if kind == "multiplicative":
                    for gj in gs[:i]:
                        ri = ri - ds.matvec_local(sub(g, gj), z[..., list(gj)])
                z[..., list(g)] = Mg(ri)
            return z

        return M

    return pc
