"""Collocation assembly (port of :mod:`petiga_tpu.assembly.collocation`):
PetIGA's collocation method (``-iga_collocation``), one equation per
control point, enforced at its Greville abscissa.

Forms receive a :class:`~petiga_tpu_torch.assembly.point.Point` at the
collocation abscissa and return one block equation:

  system(pt, ctx) -> (K, F) with K reshapeable to (dof, nen*dof), F (dof,)
  function(pt, Ue, ctx) -> R (dof,)

A Dirichlet value condition replaces a boundary row by the interpolation
equation ``Σ_a N_a u_a = v`` (systems) or ``u - v`` (residuals, whose
Jacobian row is the identity row).

Deliberate difference from the reference: the reference tabulates every
point at once; the port walks the points in chunks of ``chunk`` ids
(default :data:`_CHUNK`), so a 128³ space (2.2 M points, order-2 tables)
fits on the card.  Each point's row is written once (its slots are
distinct), so the chunking changes no value.  The result is a node-major
:class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix` whose
``fast_operator()`` runs the full-storage stencil kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..sparse.stencil import StencilMatrix
from .assemble import _chunks, _points_of, _vmap, stencil_of
from .tabulation import tabulate_elements

__all__ = ["assemble_collocation", "assemble_collocation_function",
           "assemble_collocation_jacobian"]

# Collocation points per chunk: order-2 tables of a 3-D p=2 point are 27·13
# values, so a chunk is about 0.2 GB in f64 with the form's temporaries.
_CHUNK = 1 << 16


def _colloc_slots(space) -> torch.Tensor:
    """(npts, nen) stencil slot of each (point, closure entry), built on
    the host once per space and cached on its device."""
    cache = space._tensor_cache
    if "colloc_slots" in cache:
        return cache["colloc_slots"]
    sp = space
    if not sp.collocation:
        raise ValueError("space was not built with collocation=True")
    npts = sp.nel  # one point per control point
    emulti = np.unravel_index(np.arange(npts), sp.elem_shape, order="F")
    grids = np.meshgrid(*[np.arange(n) for n in sp.nen_shape], indexing="ij")
    locs = [g.ravel(order="F") for g in grids]
    slot = np.zeros((npts, sp.nen), dtype=np.int64)
    stride = 1
    for d in range(sp.dim):
        off = sp.tabs[d].offset[emulti[d]]
        o = off[:, None] + locs[d][None, :] - emulti[d][:, None]
        if sp.axes[d].periodic:
            N = sp.node_shape[d]
            o = np.mod(o + N // 2, N) - N // 2
        if o.min() < -sp.degrees[d] or o.max() > sp.degrees[d]:
            raise ValueError("collocation stencil exceeds bandwidth")
        slot += (o + sp.degrees[d]) * stride
        stride *= 2 * sp.degrees[d] + 1
    cache["colloc_slots"] = torch.as_tensor(slot, device=sp.device)
    return cache["colloc_slots"]


def _point_chunks(space, chunk):
    """(ids, Point of the chunk's collocation points (leading axis B),
    fixed mask (B, dof), fixed values (B, dof), closure map (B, nen))."""
    mask, vals = space.tensor("dirichlet")
    for ids in _chunks(space, _CHUNK if chunk is None else chunk):
        yield ids, mask[ids], vals[ids], space.device_emap(ids)


def _points(space, ids, order):
    pb = tabulate_elements(space, ids, order=order)
    return tree_map(lambda a: None if a is None else a[:, 0], _points_of(pb))


def _scatter_rows(space, data, ids, blocks):
    """Write the (B, nen, dof, dof) row blocks of points ``ids`` into the
    flat (nnodes·K, dof, dof) slot data (distinct slots: plain stores)."""
    st = stencil_of(space)
    rows = ids[:, None] * st.K + _colloc_slots(space)[ids]
    data[rows.reshape(-1)] = blocks.reshape(-1, space.dof, space.dof)


def assemble_collocation(space, system: Callable, ctx=None, *, order=None,
                         chunk: Optional[int] = None):
    """Assemble ``(A, b)`` by collocation (IGAComputeSystem, collocation
    path): ``A`` a :class:`StencilMatrix`, ``b`` (nnodes, dof)."""
    sp = space
    st = stencil_of(sp)
    dof, nen, dt = sp.dof, sp.nen, sp.dtype
    data = torch.zeros((st.nnodes * st.K, dof, dof), dtype=dt, device=sp.device)
    b = torch.zeros((st.nnodes, dof), dtype=dt, device=sp.device)
    eye = torch.eye(dof, dtype=dt, device=sp.device)
    for ids, m, v, _ in _point_chunks(sp, chunk):
        pts = _points(sp, ids, order)
        K, F = _vmap(lambda p: system(p, ctx), pts)
        B = ids.shape[0]
        K = K.reshape(B, dof, nen * dof).to(dt)
        F = F.reshape(B, dof).to(dt)
        # Dirichlet rows -> the interpolation equation
        interp = torch.einsum("pa,cd->pcad", pts.shape0, eye).reshape(B, dof, nen * dof)
        mf = m[:, :, None].to(dt)
        K = K * (1 - mf) + interp * mf
        b[ids] = torch.where(m, v, F)
        _scatter_rows(sp, data, ids, K.reshape(B, dof, nen, dof).transpose(1, 2))
    return StencilMatrix(st, data.reshape(st.nnodes, st.K, dof, dof)), b


def assemble_collocation_function(space, function: Callable, U, ctx=None, *,
                                  order=None, chunk: Optional[int] = None):
    """Collocation residual: ``R[i]`` is ``function`` at point ``i``, with
    fixed rows ``u - v``.  Returns (nnodes, dof)."""
    sp = space
    dof, dt = sp.dof, sp.dtype
    U = U.reshape(sp.nnodes, dof)
    mask, vals = sp.tensor("dirichlet")
    Uf = torch.where(mask, vals, U)
    R = torch.empty((sp.nnodes, dof), dtype=dt, device=sp.device)
    for ids, m, v, emap in _point_chunks(sp, chunk):
        pts = _points(sp, ids, order)
        r = _vmap(lambda p, ue: function(p, ue, ctx).reshape(dof), pts, Uf[emap]).to(dt)
        R[ids] = torch.where(m, U[ids] - v, r)
    return R


def assemble_collocation_jacobian(space, function: Callable, U, ctx=None, *,
                                  order=None, chunk: Optional[int] = None):
    """Collocation Jacobian by forward AD (``torch.func.jacfwd`` under
    ``vmap``) of the pointwise residual; fixed rows are the identity row,
    consistent with ``R = u - v``.  Returns a :class:`StencilMatrix`."""
    sp = space
    st = stencil_of(sp)
    dof, nen, dt = sp.dof, sp.nen, sp.dtype
    U = U.reshape(sp.nnodes, dof)
    mask, vals = sp.tensor("dirichlet")
    Uf = torch.where(mask, vals, U)
    eye = torch.eye(dof, dtype=dt, device=sp.device)
    data = torch.zeros((st.nnodes * st.K, dof, dof), dtype=dt, device=sp.device)

    def res(ue_flat, p):
        return function(p, ue_flat.reshape(nen, dof), ctx).reshape(dof)

    for ids, m, _, emap in _point_chunks(sp, chunk):
        pts = _points(sp, ids, order)
        B = ids.shape[0]
        J = _vmap(torch.func.jacfwd(res), Uf[emap].reshape(B, nen * dof), pts)
        J = J.reshape(B, dof, nen, dof).to(dt)
        # fixed rows: d(u - v)/dU, the point's own coefficient only
        own = (emap == ids[:, None]).to(dt)
        ident = torch.einsum("pa,cd->pcad", own, eye)
        mf = m[:, :, None, None].to(dt)
        J = J * (1 - mf) + ident * mf
        _scatter_rows(sp, data, ids, J.transpose(1, 2))
    return StencilMatrix(st, data.reshape(st.nnodes, st.K, dof, dof))
