"""Carry the reference's state into the port.

The system has no weights: its state is the discretization, the assembled
operator and the vectors.  These helpers take the JAX package's arrays as
numpy (``np.asarray`` of a ``PallasStencilOperator.DT`` or a
``StencilMatrix.data``) and its objects duck-typed (any object with the
reference's fields), and return the port's counterpart.  This module is
the only one that knows both layouts, and it imports nothing of the
reference.  ``device=None`` is the CUDA device everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.axis import Axis
from .core.quadrature import Rule
from .core.space import BoundaryCondition, Space
from .sparse.spmv import StencilOperator
from .sparse.stencil import Stencil, StencilMatrix, SymmetricStencilMatrix

__all__ = [
    "as_stencil",
    "space_from_reference",
    "stencil_matrix_from_reference",
    "operator_from_jax_planes",
    "operator_from_stencil_data",
    "random_stencil_data",
    "state_from_reference",
    "planes_from_reference",
    "prolongations_from_reference",
]


def as_stencil(stencil) -> Stencil:
    """The port's :class:`Stencil` for any object with the reference's
    stencil fields."""
    return Stencil(
        node_shape=tuple(int(n) for n in stencil.node_shape),
        widths=tuple(int(p) for p in stencil.widths),
        periodic=tuple(bool(b) for b in stencil.periodic),
        dof=int(stencil.dof),
    )


def _torch(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))


def space_from_reference(space, dtype=torch.float64, device=None) -> Space:
    """The port's :class:`Space` for a reference ``Space``: same knot
    vectors and quadrature rules (so the host tables are bit-identical),
    with its geometry, rational weights, properties, boundary values,
    loads and forms, and fix table carried across from its host
    fields."""
    axes = [Axis(p=int(ax.p), U=np.array(ax.U, dtype=np.float64),
                 periodic=bool(ax.periodic)) for ax in space.axes]
    rules = [Rule(kind=str(r.kind), points=np.array(r.points, dtype=np.float64),
                  weights=np.array(r.weights, dtype=np.float64)) for r in space.rules]
    sp = Space(axes, dof=int(space.dof), rule=rules, basis_type=space.basis_type,
               collocation=bool(space.collocation), order=int(space.order), nsd=int(space.nsd), dtype=dtype, device=device)
    if space.geometry is not None:
        sp.init_geometry(np.array(space.geometry), None if space.rational is None
                         else np.array(space.rational))
    elif space.rational is not None:  # weights on the identity map
        sp.rational = np.array(space.rational, dtype=np.float64).reshape(sp.nnodes)
    if space.property is not None:
        sp.set_property(np.array(space.property))
    if space.fix_table is not None:
        sp.set_fix_table(np.array(space.fix_table))
    sp.bc = [[BoundaryCondition(list(f.value), list(f.load)) for f in faces]
             for faces in space.bc]
    sp.bc_visit = [[bool(v) for v in faces] for faces in space.bc_visit]
    return sp


def stencil_matrix_from_reference(A, dtype=None, device=None):
    """The port's :class:`StencilMatrix` (or
    :class:`SymmetricStencilMatrix`, for data with the ``Ku`` upper slots
    only) for any object with the reference's ``stencil`` and node-major
    ``data`` fields."""
    st = as_stencil(A.stencil)
    data = _torch(A.data, dtype, device)
    if data.shape[1] == st.K:
        return StencilMatrix(st, data)
    if data.shape[1] == (st.K + 1) // 2:
        return SymmetricStencilMatrix(st, data)
    raise ValueError(f"data has {data.shape[1]} slots for a stencil of K={st.K}")


def operator_from_jax_planes(stencil, DT: np.ndarray, align=None, symmetric=False,
                             device=None, dtype=None) -> StencilOperator:
    """From the reference's ``(P, M, 128)`` kernel planes laid out on its
    extended grid (periodic halo plus the high-side ``align`` pads): drop
    the flat tail and the alignment volume, keep the periodic halos."""
    st = as_stencil(stencil)
    al = tuple(align) if align is not None else (0,) * st.dim
    ref_ext = [
        N + 2 * p + a if per else N + a
        for N, p, per, a in zip(st.node_shape, st.widths, st.periodic, al)
    ]
    P = DT.shape[0]
    grid = DT.reshape(P, -1)[:, :int(np.prod(ref_ext))].reshape(
        (P,) + tuple(ref_ext[::-1])
    )
    keep = tuple(
        slice(0, N + 2 * p if per else N)
        for N, p, per in zip(st.node_shape[::-1], st.widths[::-1], st.periodic[::-1])
    )
    planes = _torch(grid[(slice(None),) + keep].reshape(P, -1), dtype, device)
    if symmetric:
        return StencilOperator.from_planes_symmetric(st, planes)
    return StencilOperator.from_planes(st, planes)


def operator_from_stencil_data(stencil, data: np.ndarray, symmetric=False,
                               device=None, dtype=None) -> StencilOperator:
    """From node-major ``(nnodes, K, dof, dof)`` slot data (the reference
    ``StencilMatrix.data``), or ``(nnodes, Ku, dof, dof)`` upper-slot data
    (``SymmetricStencilMatrix.data``) with ``symmetric``."""
    cls = SymmetricStencilMatrix if symmetric else StencilMatrix
    return cls(as_stencil(stencil), _torch(data, dtype, device)).fast_operator()


def random_stencil_data(stencil, seed, symmetric=False) -> np.ndarray:
    """Seeded node-major ``(nnodes, K, dof, dof)`` slot data, standard
    normal where the slot's column lies on the grid and zero where an open
    axis clips it (the reference's ``Stencil.column_index`` semantics);
    the ``Ku`` upper slots only with ``symmetric``.  Usable as
    ``StencilMatrix.data`` on the reference's side and by
    :func:`operator_from_stencil_data` on the port's."""
    st = as_stencil(stencil)
    multi = np.unravel_index(np.arange(st.nnodes), st.node_shape, order="F")
    offs = st.slot_offsets()[st.diag_slot if symmetric else 0:]
    valid = np.ones((st.nnodes, len(offs)), bool)
    for d in range(st.dim):
        if not st.periodic[d]:
            j = multi[d][:, None] + offs[None, :, d]
            valid &= (j >= 0) & (j < st.node_shape[d])
    data = np.random.default_rng(seed).normal(size=valid.shape + (st.dof, st.dof))
    return data * valid[..., None, None]


def state_from_reference(state, dtype=torch.float64, device=None):
    """One state of the reference in the port's types: an array (a node
    vector ``(nnodes, dof)`` or ``(nnodes,)``) becomes a tensor of
    ``dtype`` on ``device``, a 0-d array a Python float; a dict (an
    ``aux`` dict of node vectors, a model's ``ctx``) is converted entry by
    entry, a tuple or list (a stepper's ``(U, V)`` or ``(U, V, A)``)
    item by item into a tuple; Python numbers and None pass through."""
    if isinstance(state, dict):
        return {k: state_from_reference(v, dtype, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_from_reference(v, dtype, device) for v in state)
    if state is None or isinstance(state, (int, float)):
        return state
    a = np.array(state)
    return float(a) if a.ndim == 0 else _torch(a, dtype, device)


def planes_from_reference(op, device=None, dtype=None) -> StencilOperator:
    """The port's :class:`StencilOperator` holding the planes of a
    reference operator: a ``PallasStencilOperator`` (its ``DT`` and
    ``align``, periodic halos kept) or a node-major ``StencilMatrix`` /
    ``SymmetricStencilMatrix`` (its ``data``)."""
    if hasattr(op, "DT"):
        return operator_from_jax_planes(op.stencil, np.asarray(op.DT), align=op.align,
                                        symmetric=op.kind == "sym", device=device,
                                        dtype=dtype)
    st = as_stencil(op.stencil)
    data = np.asarray(op.data)
    return operator_from_stencil_data(st, data, symmetric=data.shape[1] != st.K,
                                      device=device, dtype=dtype)


def prolongations_from_reference(hier, dtype=torch.float64, device=None) -> list:
    """The per-level, per-axis prolongation matrices of a reference
    ``MGHierarchy`` (``hier.prolongs[lvl][d]``, (N_fine_d, N_coarse_d)) as
    tensors, in the port's ``MGHierarchy.prolongs`` layout."""
    return [[_torch(P, dtype, device) for P in level] for level in hier.prolongs]
