"""Stencil geometry and the slot-loop stencil matvec.

Port of :mod:`petiga_tpu.sparse.stencil`.  On a tensor-product IGA patch
row (control point) ``i`` couples to columns ``j`` with per-axis offset
``|j_d - i_d| <= p_d``: ``K = prod(2 p_d + 1)`` slots per row.  Operator
data is a dense slot array ``data[nnodes, K, dof, dof]``
(:class:`StencilMatrix`, node-major; :class:`SymmetricStencilMatrix`
keeps the upper slots only); :func:`stencil_apply` applies it as K
shifted multiply-adds over the halo-padded node grid.  It is the port's
own reference matvec: the kernels in :mod:`.spmv` are held against it,
and ``fast_operator()`` re-packs either matrix for them.

Grid layout convention: node grids are stored with axes *reversed*
(``(N_{d-1}, ..., N_0, dof)``) so that C-order flattening reproduces the
axis-0-fastest flat node index.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..utils import profiling

__all__ = ["Stencil", "StencilMatrix", "SymmetricStencilMatrix", "stencil_apply"]


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

    def slot_table(self, nen_shape: Sequence[int]) -> np.ndarray:
        """(nen, nen) table: slot index for the column offset b - a of two
        local basis indices (independent of the element — the stencil is
        translation invariant)."""
        grids = np.meshgrid(*[np.arange(n) for n in nen_shape], indexing="ij")
        locs = [g.ravel(order="F") for g in grids]  # axis-0-fastest local ids
        nen = locs[0].shape[0]
        slot = np.zeros((nen, nen), dtype=np.int64)
        stride = 1
        for d in range(self.dim):
            off = locs[d][None, :] - locs[d][:, None] + self.widths[d]
            slot += off * stride
            stride *= 2 * self.widths[d] + 1
        return slot.astype(np.int32)

    def column_index(self) -> np.ndarray:
        """(nnodes, K) flat column index per (row, slot); out-of-range
        slots (clipped at open boundaries) point at the row itself — they
        only ever hold zero data.  Used for CSR/COO export."""
        N = self.node_shape
        multi = np.unravel_index(np.arange(self.nnodes), N, order="F")
        offs = self.slot_offsets()  # (K, dim)
        cols = np.zeros((self.nnodes, offs.shape[0]), dtype=np.int64)
        valid = np.ones((self.nnodes, offs.shape[0]), dtype=bool)
        stride = 1
        for d in range(self.dim):
            j = multi[d][:, None] + offs[None, :, d]
            if self.periodic[d]:
                j = np.mod(j, N[d])
            else:
                valid &= (j >= 0) & (j < N[d])
                j = np.clip(j, 0, N[d] - 1)
            cols += j * stride
            stride *= N[d]
        rows = np.arange(self.nnodes)[:, None]
        return np.where(valid, cols, rows)


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


def _slot_window(st: Stencil, sidx: int) -> tuple:
    """Slices of the halo-padded reversed-axis grid that slot ``sidx``
    reads: ``x_padded[window][n] = x[n + off(sidx)]``."""
    offs = st.slot_offsets()
    dim = st.dim
    return tuple(
        slice(st.widths[dim - 1 - g] + int(offs[sidx, dim - 1 - g]),
              st.widths[dim - 1 - g] + int(offs[sidx, dim - 1 - g])
              + st.node_shape[dim - 1 - g])
        for g in range(dim)
    )


def _shifted_blocks(st: Stencil, src: torch.Tensor, snew: int) -> torch.Tensor:
    """``out[j] = src[j + off(snew)]`` on the reversed-axis node grid:
    rolled on periodic axes, zero-filled at open boundaries."""
    offs = st.slot_offsets()
    dim = st.dim
    for g in range(dim):
        d = dim - 1 - g
        o = int(offs[snew, d])
        if o == 0:
            continue
        if st.periodic[d]:
            src = torch.roll(src, -o, dims=g)
            continue
        N = st.node_shape[d]
        out = torch.zeros_like(src)
        if o > 0:
            out.narrow(g, 0, N - o).copy_(src.narrow(g, o, N - o))
        else:
            out.narrow(g, -o, N + o).copy_(src.narrow(g, 0, N + o))
        src = out
    return src


class StencilMatrix:
    """A block operator in stencil storage.

    ``data``: (nnodes, K, dof, dof) tensor.  Row/column block index =
    flat node index; ``y[i] = sum_s data[i, s] @ x[i + off(s)]``.
    """

    def __init__(self, stencil: Stencil, data: torch.Tensor):
        self.stencil = stencil
        self.data = data

    @staticmethod
    def zeros(stencil: Stencil, dtype=torch.float32, device=None) -> "StencilMatrix":
        """An all-zero operator on ``device`` (None: the CUDA device)."""
        s = stencil
        return StencilMatrix(
            s, torch.zeros((s.nnodes, s.K, s.dof, s.dof), dtype=dtype,
                           device=resolve_device(device)))

    # ---------------------------------------------------------------- apply

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with x, y of shape (nnodes, dof) (or (nnodes*dof,)):
        the slot loop :func:`stencil_apply`."""
        profiling.count("MatMult", profiling.spmv_flops(self.stencil))
        s = self.stencil
        flat_in = x.dim() == 1
        xg = x.reshape(tuple(s.node_shape[::-1]) + (s.dof,))
        xp = halo_pad(xg, s.widths, s.periodic)
        dg = self.data.reshape(tuple(s.node_shape[::-1]) + (s.K, s.dof, s.dof))
        y = stencil_apply(dg, xp, s.widths, s.slot_offsets()).reshape(s.nnodes, s.dof)
        return y.reshape(-1) if flat_in else y

    def __matmul__(self, x):
        return self.matvec(x)

    def fast_operator(self):
        """This operator re-packed into slot-major planes for the stencil
        SpMV kernel (:class:`~petiga_tpu_torch.sparse.spmv.StencilOperator`,
        full storage) on the device of ``data``.  The result exposes the
        same ``matvec`` / ``diagonal`` surface, so it drops into the
        Krylov solvers and preconditioners unchanged."""
        from .spmv import StencilOperator

        return StencilOperator.from_matrix(self, keep_source=False)

    # ------------------------------------------------------------ structure

    def diagonal(self) -> torch.Tensor:
        """Block diagonal (nnodes, dof, dof)."""
        return self.data[:, self.stencil.diag_slot, :, :]

    def scalar_diagonal(self) -> torch.Tensor:
        """Point diagonal (nnodes, dof)."""
        return torch.diagonal(self.diagonal(), dim1=-2, dim2=-1)

    def transpose(self) -> "StencilMatrix":
        """A^T in the same storage: ``AT[j, s] = A[j + off(s), rev(s)]^T``
        with rev(s) = K-1-s (the slot enumeration is symmetric).  Pure
        shifted slices/rolls on the node grid."""
        s = self.stencil
        dim, dof, K = s.dim, s.dof, s.K
        dg = self.data.reshape(tuple(s.node_shape[::-1]) + (K, dof, dof))
        planes = [
            _shifted_blocks(s, dg[..., K - 1 - snew, :, :].transpose(-1, -2), snew)
            for snew in range(K)
        ]
        data = torch.stack(planes, dim=dim)  # (N_rev..., K, dof, dof)
        return StencilMatrix(s, data.reshape(s.nnodes, K, dof, dof))

    # -------------------------------------------------------------- exports

    def to_dense(self) -> np.ndarray:
        """(nnodes*dof, nnodes*dof) dense numpy export (tests only)."""
        s = self.stencil
        cols = s.column_index()
        n, dof = s.nnodes, s.dof
        A = np.zeros((n, dof, n, dof))
        data = self.data.detach().cpu().numpy()
        rows = np.arange(n)
        for k in range(s.K):
            np.add.at(A, (rows, slice(None), cols[:, k]), data[:, k])
        return A.reshape(n * dof, n * dof)

    def to_coo(self):
        """(rows, cols, blocks) in block COO (duplicate-free only where
        slots are valid; padded slots carry zero blocks on the diagonal
        column)."""
        s = self.stencil
        cols = s.column_index()
        rows = np.repeat(np.arange(s.nnodes), s.K)
        blocks = self.data.detach().cpu().numpy().reshape(-1, s.dof, s.dof)
        return rows, cols.ravel(), blocks

    def to_csr(self):
        """Scalar CSR export: (indptr, indices, data) for the
        (nnodes*dof)-square scalar matrix (numpy, host-side)."""
        s = self.stencil
        rows, cols, blocks = self.to_coo()
        dof = s.dof
        # expand blocks to scalar triplets
        ri = (rows[:, None, None] * dof + np.arange(dof)[None, :, None]
              + np.zeros((1, 1, dof), np.int64)).ravel()
        ci = (cols[:, None, None] * dof + np.arange(dof)[None, None, :]
              + np.zeros((1, dof, 1), np.int64)).ravel()
        vi = blocks.reshape(len(rows), dof, dof).ravel()
        n = s.nnodes * dof
        order = np.lexsort((ci, ri))
        ri, ci, vi = ri[order], ci[order], vi[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, ri + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, ci, vi


class SymmetricStencilMatrix:
    """Symmetric-storage stencil operator — the SBAIJ analog: only the
    ``Ku = (K+1)//2`` upper slots (diagonal slot onward; the slot
    enumeration is antisymmetric, ``off(K-1-s) = -off(s)``) are stored,
    halving operator memory for SPD systems.

    ``matvec`` applies each stored slot twice: the direct term
    ``y[i] += D_s[i] x[i+off]`` and the mirrored term
    ``y[i+off] += D_s[i]^T x[i]`` — still shift-structured slice work (no
    gathers).  ``to_full()`` reconstructs full storage.
    """

    def __init__(self, stencil: Stencil, data: torch.Tensor):
        self.stencil = stencil
        self.data = data  # (nnodes, Ku, dof, dof), slots diag..K-1

    @property
    def Ku(self) -> int:
        return (self.stencil.K + 1) // 2

    @classmethod
    def from_full(cls, A: StencilMatrix) -> "SymmetricStencilMatrix":
        """Crop a (symmetric) full-storage operator to its upper slots.
        The caller asserts symmetry (Galerkin forms with symmetric
        element matrices, e.g. after the symmetric Dirichlet
        elimination)."""
        s = A.stencil
        return cls(s, A.data[:, s.diag_slot:, :, :])

    def to_full(self) -> StencilMatrix:
        """Reconstruct full storage: lower slot s < diag is
        ``A[i, s] = A[i + off(s), K-1-s]^T`` (zero-filled at open
        boundaries, wrapped for periodic axes)."""
        s = self.stencil
        dim, dof, K = s.dim, s.dof, s.K
        dg = self.data.reshape(tuple(s.node_shape[::-1]) + (self.Ku, dof, dof))
        planes = [
            _shifted_blocks(
                s, dg[..., (K - 1 - snew) - s.diag_slot, :, :].transpose(-1, -2), snew)
            for snew in range(s.diag_slot)
        ]
        lower = torch.stack(planes, dim=dim)
        data = torch.cat(
            [lower.reshape(s.nnodes, s.diag_slot, dof, dof), self.data], dim=1
        )
        return StencilMatrix(s, data)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        profiling.count("MatMult", profiling.spmv_flops(self.stencil))
        s = self.stencil
        dim, dof = s.dim, s.dof
        N_rev = tuple(s.node_shape[::-1])
        flat_in = x.dim() == 1
        xg = x.reshape(N_rev + (dof,))
        xp = halo_pad(xg, s.widths, s.periodic)
        dg = self.data.reshape(N_rev + (self.Ku, dof, dof))

        y = None
        # direct terms: stored slots diag..K-1
        for ku in range(self.Ku):
            xs = xp[_slot_window(s, s.diag_slot + ku)]
            term = torch.einsum("...ab,...b->...a", dg[..., ku, :, :], xs)
            y = term if y is None else y + term
        # mirrored terms: y[i+off] += D^T[i] x[i] for strictly-upper
        # slots — t[i] = D[i]^T x[i] on the grid, placed shifted by +off
        # into a padded frame (the scatter-free transpose of the slice
        # read; in-place slice adds, sequential and deterministic)
        tg = torch.zeros(
            tuple(n + 2 * s.widths[dim - 1 - g] for g, n in enumerate(N_rev)) + (dof,),
            dtype=x.dtype, device=x.device,
        )
        for ku in range(1, self.Ku):
            t = torch.einsum("...ab,...a->...b", dg[..., ku, :, :], xg)
            tg[_slot_window(s, s.diag_slot + ku)] += t
        # fold the padded frame back (wrap for periodic, drop for open)
        for g in range(dim):
            d = dim - 1 - g
            p = s.widths[d]
            if p == 0:
                continue
            n = tg.shape[g]
            core = tg.narrow(g, p, n - 2 * p)
            if s.periodic[d]:
                core = core.clone()
                L = core.shape[g]
                core.narrow(g, L - p, p).add_(tg.narrow(g, 0, p))
                core.narrow(g, 0, p).add_(tg.narrow(g, n - p, p))
            tg = core
        y = (y + tg).reshape(s.nnodes, dof)
        return y.reshape(-1) if flat_in else y

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.data[:, 0, :, :]

    def scalar_diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.data[:, 0], dim1=-2, dim2=-1)

    def fast_operator(self):
        """The kernel operator for the symmetric storage.

        Open axes (any dof): the symmetric kernel streams only the stored
        upper planes (:class:`~petiga_tpu_torch.sparse.spmv.StencilOperator`
        of kind ``"sym"``).  Periodic axes expand to full storage
        first."""
        from .spmv import StencilOperator

        if any(self.stencil.periodic):
            return self.to_full().fast_operator()
        return StencilOperator.from_symmetric(self, keep_source=False)
