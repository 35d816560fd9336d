"""Stencil geometry and the slot-loop stencil matvec.

Port of :mod:`petiga_tpu.sparse.stencil` (``Stencil`` and
``stencil_apply``).  On a tensor-product IGA patch row (control point)
``i`` couples to columns ``j`` with per-axis offset ``|j_d - i_d| <= p_d``:
``K = prod(2 p_d + 1)`` slots per row.  Operator data is a dense slot
array ``data[nnodes, K, dof, dof]``; :func:`stencil_apply` applies it as
K shifted multiply-adds over the halo-padded node grid.  It is the
port's own reference matvec: the kernels in :mod:`.spmv` are held
against it.

Grid layout convention: node grids are stored with axes *reversed*
(``(N_{d-1}, ..., N_0, dof)``) so that C-order flattening reproduces the
axis-0-fastest flat node index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Stencil", "stencil_apply"]


@dataclasses.dataclass(frozen=True)
class Stencil:
    """Static stencil geometry for a space: slot tables and paddings."""

    node_shape: tuple  # (N_0, ..., N_{dim-1})
    widths: tuple  # per-axis half-width (= degree p_d)
    periodic: tuple  # per-axis periodic flags
    dof: int

    @property
    def dim(self) -> int:
        return len(self.node_shape)

    @property
    def K(self) -> int:
        K = 1
        for p in self.widths:
            K *= 2 * p + 1
        return K

    @property
    def nnodes(self) -> int:
        n = 1
        for N in self.node_shape:
            n *= N
        return n

    @property
    def diag_slot(self) -> int:
        s, stride = 0, 1
        for p in self.widths:
            s += p * stride
            stride *= 2 * p + 1
        return s

    def slot_offsets(self) -> np.ndarray:
        """(K, dim) per-slot per-axis offsets in [-p_d, p_d], slot index
        axis-0 fastest."""
        offs = np.stack(
            np.meshgrid(
                *[np.arange(-p, p + 1) for p in self.widths], indexing="ij"
            ),
            axis=-1,
        )
        return offs.reshape(-1, self.dim, order="F")


def halo_pad(xg: torch.Tensor, widths, periodic) -> torch.Tensor:
    """Pad a reversed-axis node grid ``(N_rev..., dof)`` by ``p_d`` on
    both sides of every axis: wrapped copies on periodic axes, zeros on
    open ones."""
    dim = len(widths)
    for g in range(dim):
        d = dim - 1 - g
        p = widths[d]
        if p == 0:
            continue
        n = xg.shape[g]
        if periodic[d]:
            lo = xg.narrow(g, n - p, p)
            hi = xg.narrow(g, 0, p)
        else:
            shape = list(xg.shape)
            shape[g] = p
            lo = hi = xg.new_zeros(shape)
        xg = torch.cat([lo, xg, hi], dim=g)
    return xg


def stencil_apply(data_grid, x_padded, widths, slot_offsets):
    """Core stencil SpMV: K shifted multiply-adds.

    Args:
      data_grid: (N_{d-1},...,N_0, K, dof, dof) — slot data on the
        (reversed-axis) node grid.
      x_padded: (N_{d-1}+2p_{d-1}, ..., N_0+2p_0, dof) — halo-padded input
        (see :func:`halo_pad`).
      widths: per-spatial-axis half widths (p_0..p_{d-1}).
      slot_offsets: (K, dim) array of per-slot offsets.

    Returns y on the unpadded grid, shape (N_rev..., dof).
    """
    dim = len(widths)
    N_rev = data_grid.shape[:dim]
    K = data_grid.shape[dim]
    y = None
    for sidx in range(K):
        slices = []
        for g in range(dim):
            d = dim - 1 - g
            o = int(slot_offsets[sidx, d])
            p = widths[d]
            slices.append(slice(p + o, p + o + N_rev[g]))
        xs = x_padded[tuple(slices)]
        term = torch.einsum("...ab,...b->...a", data_grid[..., sidx, :, :], xs)
        y = term if y is None else y + term
    return y
