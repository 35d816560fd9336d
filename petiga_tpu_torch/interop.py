"""Carry the reference's assembled state into the port.

The system has no weights: its state is the assembled operator and the
vectors.  These helpers take the JAX package's arrays as numpy (``np.asarray``
of a ``PallasStencilOperator.DT`` or a ``StencilMatrix.data``) and return a
port :class:`~petiga_tpu_torch.sparse.spmv.StencilOperator` computing the
same product.  Spaces need no conversion: build a port ``Space`` from the
same ``Axis`` arguments; its host tables are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse.spmv import StencilOperator
from .sparse.stencil import Stencil

__all__ = [
    "as_stencil",
    "operator_from_jax_planes",
    "operator_from_stencil_data",
    "random_stencil_data",
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
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def operator_from_jax_planes(stencil, DT: np.ndarray, align=None, symmetric=False,
                             device="cpu", dtype=None) -> StencilOperator:
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
                               device="cpu", dtype=None) -> StencilOperator:
    """From node-major ``(nnodes, K, dof, dof)`` slot data (the reference
    ``StencilMatrix.data``), or ``(nnodes, Ku, dof, dof)`` upper-slot data
    (``SymmetricStencilMatrix.data``) with ``symmetric``."""
    st = as_stencil(stencil)
    data = _torch(data, dtype, device)
    op = StencilOperator(st, dtype=data.dtype, device=device,
                         kind="sym" if symmetric else "full")
    grid = data.reshape(tuple(st.node_shape[::-1]) + (op.nplanes,))
    op._set_planes(op.pack_planes(grid))
    return op


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
