"""Distributed assembly and solve over ``torch.distributed`` ranks (port
of :mod:`petiga_tpu.parallel.dist`) — the counterpart of the reference's
MPI layer (``petigapart.c`` process grids, ``petigagrid.c`` ghost
scatters, ``petigavec.c`` g2l/l2g exchanges, PETSc's MatAssembly stash).

Design: SPMD, one process (rank) per block of the process grid.  The
node grid is block-partitioned over a dim-D grid of ranks chosen by the
surface-minimizing factorization (:func:`.partition.factor_grid`); each
rank owns its local block as ordinary tensors on its device, and the
reference's ``shard_map`` collectives become messages:

  * forward halo (the g2l ghost gather, ``lax.ppermute``): each rank
    fills a p-wide shell of its block from its neighbours' edge slabs
    (zeros at open ends, wrap pairs on periodic axes) by point-to-point
    ``batch_isend_irecv``, axis by axis so that corners propagate;
  * reverse halo (the l2g ADD): ghost-shell contributions written during
    element assembly are sent back and added into their owners;
  * reductions (dots, norms, functionals, ``lax.psum``) are
    ``all_reduce``.

A periodic axis with one block wraps onto itself by local copies; with
two blocks both neighbours are one rank, and the two messages carry
distinct tags.  The process group is the caller's (``group=None`` is the
default group; no group at all means one rank, pgrid ``(1, …, 1)``).
Halo staging is explicit and printed (:attr:`DistSpace.halo_staging`):
NCCL and CPU tensors send their slabs as they are (``"device"``); gloo
does not take device pointers in send/recv (on the card it aborts with
``writev … Bad address``), so on CUDA tensors gloo's slabs go through
pinned host buffers (``"host"``).  All compute stays on the device.

Element ownership: an element belongs to the rank owning its first
closure node (unwrapped basis index), so each rank writes at most a
p-wide ghost shell.  Padding: each axis is padded to ``L_d · m_d``
nodes; padded rows carry zero data and decouple.  Periodic axes require
``m_d | N_d``.

Layouts (what a rank holds): operator blocks ``(L_rev…, K, dof, dof)``,
vectors ``(L_rev…, dof)`` — together the ranks hold exactly the blocks of
the reference's padded global arrays.  :meth:`DistSpace.pad_grid` cuts a
rank's block out of a flat ``(nnodes, c)`` vector; :meth:`crop_flat`
gathers the blocks back into the flat vector on every rank.

The per-rank matvec is the stencil SpMV kernel
(:func:`~petiga_tpu_torch.sparse.spmv.stencil_spmv_full`) on the rank's
halo-extended block (``StencilOperator(ext_pads=((p, p), …))``); the
overlapped variant's frame correction runs the same kernel on each onion
slab.  Krylov and Newton loops run on the host (as the port's serial
solvers do) with all-reduced dots, so every rank takes the same branch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..assembly import fastpath
from ..assembly.assemble import (
    _element_residual,
    _face_elements,
    _faces_to_visit,
    _fix_arrays,
    _make_element_KF,
    _scan_points,
    _vmap,
    boundary_flux_vector,
    stencil_of,
)
from ..assembly.tabulation import tabulate_elements
from ..solve import krylov
from ..sparse.spmv import StencilOperator
from ..sparse.stencil import Stencil
from ..utils.profiling import Spans
from .launch import rank_device
from .partition import factor_grid

__all__ = ["DistSpace", "DistThetaStepper", "DistAlphaStepper", "Spans"]


class LocalPlanes(NamedTuple):
    """A rank's operator block packed once per solve for the kernel:
    the kernel operator and planes of the halo-extended block, per onion
    slab of the overlapped matvec ``(out slices, halo-window slices, slab
    operator, slab planes)`` (None when a block is too thin to split),
    and the block's (row, column) field counts — a rectangular field
    block (a field split's coupling) is zero-padded to a square one."""

    op: StencilOperator
    DT: torch.Tensor
    frames: Optional[list]
    fields: tuple


class _Pending(NamedTuple):
    works: list
    from_left: Optional[torch.Tensor]
    from_right: Optional[torch.Tensor]
    keep: tuple


class DistSpace:
    """A Space partitioned over the ranks of a process group.

    ``pgrid`` defaults to :func:`factor_grid` of the group size over the
    node grid; its product must equal the group size.  ``device=None``
    is ``cuda:{rank % device_count}`` and raises without CUDA;
    ``space`` must live on the same device.  ``group=None`` is the
    default process group, or a single rank when none is initialized.
    """

    def __init__(self, space, pgrid=None, *, device=None, group=None):
        self.space = space
        dim = space.dim
        if group is None and tdist.is_available() and tdist.is_initialized():
            group = tdist.group.WORLD
        self.group = group
        self.world = 1 if group is None else tdist.get_world_size(group)
        self.rank = 0 if group is None else tdist.get_rank(group)
        self.device = torch.empty(0, device=rank_device(device)).device
        if torch.empty(0, device=space.device).device != self.device:
            raise ValueError(
                f"space lives on {space.device}, this rank's device is {self.device}: "
                "build the space on the rank's device"
            )
        if pgrid is None:
            pgrid = factor_grid(self.world, space.node_shape)
        self.pgrid = tuple(int(m) for m in pgrid)
        if len(self.pgrid) != dim or int(np.prod(self.pgrid)) != self.world:
            raise ValueError(f"pgrid {self.pgrid} does not cover {self.world} ranks in {dim}-D")
        rem = self.rank
        coords = []
        for m in self.pgrid:  # flat rank order: spatial axis 0 fastest
            coords.append(rem % m)
            rem //= m
        self.coords = tuple(coords)
        self._mesh_index = self.coords[::-1]  # index into (m_rev..., ...) tables

        N = space.node_shape
        self.L = tuple(math.ceil(N[d] / self.pgrid[d]) for d in range(dim))
        for d in range(dim):
            if space.periodic[d] and N[d] % self.pgrid[d] != 0:
                raise ValueError(
                    f"periodic axis {d}: block count {self.pgrid[d]} must "
                    f"divide node count {N[d]}"
                )
        self.Np = tuple(self.L[d] * self.pgrid[d] for d in range(dim))
        self.widths = space.degrees
        self.st = stencil_of(space)
        self.Lext = tuple(self.L[d] + 2 * self.widths[d] for d in range(dim))

        backend = None if group is None else tdist.get_backend(group)
        self.backend = backend
        self.halo_staging = (
            "host" if backend == "gloo" and self.device.type == "cuda" else "device"
        )
        self._pinned: dict = {}
        self._side = None  # CUDA stream of the overlapped interior kernel
        self._frame_ops: dict = {}
        self.spans: Optional[Spans] = None
        self._partition_elements()

    # ----------------------------------------------------------- host setup

    def _partition_elements(self):
        """Assign each element to the rank owning its first closure
        node; build per-rank padded element-id arrays (mesh layout
        ``(m_rev..., emax)``, as the reference's)."""
        sp = self.space
        dim = sp.dim
        emulti = np.unravel_index(np.arange(sp.nel), sp.elem_shape, order="F")
        owner = []
        for d in range(dim):
            off = sp.tabs[d].offset[emulti[d]]  # unwrapped first basis index
            owner.append(np.clip(off // self.L[d], 0, self.pgrid[d] - 1))
        dev_flat = np.zeros(sp.nel, dtype=np.int64)
        for d in range(dim - 1, -1, -1):
            dev_flat = dev_flat * self.pgrid[d] + owner[d]
        ndev = int(np.prod(self.pgrid))
        lists = [np.where(dev_flat == r)[0] for r in range(ndev)]
        emax = max(len(lst) for lst in lists)
        ids = np.zeros((ndev, emax), dtype=np.int32)
        valid = np.zeros((ndev, emax), dtype=bool)
        for r, lst in enumerate(lists):
            ids[r, : len(lst)] = lst
            valid[r, : len(lst)] = True
        mesh_shape = tuple(self.pgrid[::-1])
        self.elem_ids = ids.reshape(mesh_shape + (emax,))
        self.elem_valid = valid.reshape(mesh_shape + (emax,))
        self.emax = emax
        self._face_cache = {}

    def _element_owner_flat(self, eids):
        """Flat rank index owning each element id (owner of the first
        closure node, as in :meth:`_partition_elements`)."""
        sp = self.space
        dim = sp.dim
        emulti = np.unravel_index(eids, sp.elem_shape, order="F")
        dev_flat = np.zeros(len(eids), dtype=np.int64)
        for d in range(dim - 1, -1, -1):
            off = sp.tabs[d].offset[emulti[d]]
            owner = np.clip(off // self.L[d], 0, self.pgrid[d] - 1)
            dev_flat = dev_flat * self.pgrid[d] + owner
        return dev_flat

    def _partition_face_elements(self, d, s):
        """Per-rank padded (ids, valid) mesh-layout arrays for the
        elements adjacent to face (d, s); ranks away from the face own
        none (all-invalid rows).  Cached per face."""
        key = (d, s)
        if key in self._face_cache:
            return self._face_cache[key]
        sp = self.space
        fids = _face_elements(sp, d, s)
        dev_flat = self._element_owner_flat(fids)
        ndev = int(np.prod(self.pgrid))
        lists = [fids[dev_flat == r] for r in range(ndev)]
        fmax = max(1, max(len(lst) for lst in lists))
        ids = np.zeros((ndev, fmax), dtype=np.int32)
        valid = np.zeros((ndev, fmax), dtype=bool)
        for r, lst in enumerate(lists):
            ids[r, : len(lst)] = lst
            valid[r, : len(lst)] = True
        mesh_shape = tuple(self.pgrid[::-1])
        out = (ids.reshape(mesh_shape + (fmax,)), valid.reshape(mesh_shape + (fmax,)))
        self._face_cache[key] = out
        return out

    def _face_args(self, boundary):
        """This rank's ``[(face, ids, valid), ...]`` for the visited faces
        (empty without a boundary form)."""
        if boundary is None:
            return []
        out = []
        for d, s in _faces_to_visit(self.space):
            ids, valid = self._partition_face_elements(d, s)
            out.append(((d, s), ids[self._mesh_index], valid[self._mesh_index]))
        return out

    def _box_setup(self):
        """Per-rank element sub-box tables for the shift fastpath
        (unit-step regular spaces): owned elements per axis form the
        contiguous range [e0_d, e0_d + cnt_d); returns mesh-layout
        (e0, cnt) arrays, the max box ``ebox`` and the first offsets.
        Cached."""
        if hasattr(self, "_box_cache"):
            return self._box_cache
        sp = self.space
        dim = sp.dim
        off0 = [int(sp.tabs[d].offset[0]) for d in range(dim)]
        e0s, cnts, ebox = [], [], []
        for d in range(dim):
            m, Ld = self.pgrid[d], self.L[d]
            nel_d = sp.elem_shape[d]
            lo = np.clip(np.arange(m) * Ld - off0[d], 0, nel_d)
            hi = np.clip((np.arange(m) + 1) * Ld - off0[d], 0, nel_d)
            hi[-1] = nel_d  # the last rank also owns the overhang
            e0s.append(lo)
            cnts.append(hi - lo)
            ebox.append(max(1, int(np.max(hi - lo))))
        ndev = int(np.prod(self.pgrid))
        e0_arr = np.zeros((ndev, dim), np.int32)
        cnt_arr = np.zeros((ndev, dim), np.int32)
        for r in range(ndev):
            rem = r
            coords = []
            for d in range(dim):
                coords.append(rem % self.pgrid[d])
                rem //= self.pgrid[d]
            for d in range(dim):
                e0_arr[r, d] = e0s[d][coords[d]]
                cnt_arr[r, d] = cnts[d][coords[d]]
        mesh_shape = tuple(self.pgrid[::-1])
        self._box_cache = (
            e0_arr.reshape(mesh_shape + (dim,)),
            cnt_arr.reshape(mesh_shape + (dim,)),
            tuple(ebox),
            tuple(off0),
        )
        return self._box_cache

    # ---------------------------------------------------- conversion helpers

    def block_slices(self, rank: Optional[int] = None) -> tuple:
        """Slices of a rank's block (default: this one) into the padded
        grid ``(Np_rev..., c)``."""
        coords = self.coords if rank is None else self._coords_of(rank)
        dim = self.space.dim
        return tuple(
            slice(coords[d] * self.L[d], (coords[d] + 1) * self.L[d])
            for d in range(dim)
        )[::-1]

    def _coords_of(self, rank):
        coords = []
        for m in self.pgrid:
            coords.append(rank % m)
            rank //= m
        return tuple(coords)

    def _rank_of(self, coords) -> int:
        r = 0
        for d in range(len(coords) - 1, -1, -1):
            r = r * self.pgrid[d] + coords[d]
        return r

    def pad_grid(self, v) -> torch.Tensor:
        """Flat ``(nnodes, c)`` vector (the same on every rank) -> this
        rank's block ``(L_rev..., c)`` of the padded grid, on the rank's
        device."""
        sp = self.space
        N = sp.node_shape
        v = torch.as_tensor(v, device=self.device)
        c = v.shape[-1] if v.dim() == 2 else 1
        g = v.reshape(tuple(N[::-1]) + (c,))
        real = tuple(slice(s.start, min(s.stop, n))
                     for s, n in zip(self.block_slices(), N[::-1]))
        out = g.new_zeros(tuple(self.L[::-1]) + (c,))
        out[tuple(slice(0, max(0, r.stop - r.start)) for r in real)] = g[real]
        return out

    def _local(self, U) -> torch.Tensor:
        """A vector argument as this rank's block: flat ``(nnodes, c)``
        is cut with :meth:`pad_grid`, a block passes through."""
        U = torch.as_tensor(U, device=self.device)
        if U.dim() == 2 and U.shape[0] == self.space.nnodes:
            return self.pad_grid(U)
        return U.reshape(tuple(self.L[::-1]) + (U.shape[-1],))

    def gather_grid(self, g_loc: torch.Tensor) -> torch.Tensor:
        """Every rank's block -> the padded global grid
        ``(Np_rev..., c...)`` on every rank (an all-gather)."""
        g_loc = g_loc.reshape(tuple(self.L[::-1]) + tuple(g_loc.shape[self.space.dim:]))
        if self.world == 1:
            return g_loc
        trail = tuple(g_loc.shape[self.space.dim:])
        src = g_loc.contiguous()
        if self.halo_staging == "host":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        tdist.all_gather(parts, src, group=self.group)
        out = src.new_empty(tuple(self.Np[::-1]) + trail)
        for r, part in enumerate(parts):
            out[self.block_slices(r)] = part
        return out.to(self.device)

    def crop_flat(self, g_loc: torch.Tensor) -> torch.Tensor:
        """This rank's block -> the flat ``(nnodes, c)`` vector, gathered
        on every rank (the reference's global array is readable
        everywhere)."""
        sp = self.space
        N = sp.node_shape
        g = self.gather_grid(g_loc)
        sl = tuple(slice(0, N[d]) for d in range(sp.dim))[::-1]
        return g[sl].reshape(sp.nnodes, g.shape[-1])

    # ------------------------------------------------------- halo primitives

    def _span(self, name):
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans(name, self.device)

    def _neighbor(self, d, step) -> Optional[int]:
        """Rank of the block ``step`` along axis d (wrapping on periodic
        axes), None past an open end — the reference's ``_perm`` pairs
        as a neighbour table."""
        c = list(self.coords)
        c[d] += step
        if not 0 <= c[d] < self.pgrid[d]:
            if not self.space.periodic[d]:
                return None
            c[d] %= self.pgrid[d]
        return self._rank_of(c)

    def _peer(self, r):
        if self.group is None or self.group is tdist.group.WORLD:
            return r
        return tdist.get_global_rank(self.group, r)

    def _buffer(self, key, like):
        """A cached pinned host buffer shaped like ``like``."""
        k = key + (tuple(like.shape), like.dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _exchange_start(self, g, d, lo, hi) -> _Pending:
        """Post one axis's exchange: ``hi`` to the right neighbour, ``lo``
        to the left; receive the left neighbour's hi and the right
        neighbour's lo.  Tags: 2g (rightward) and 2g + 1 (leftward)."""
        left, right = self._neighbor(d, -1), self._neighbor(d, +1)
        if left == self.rank and right == self.rank:  # one periodic block: self-wrap
            return _Pending([], hi, lo, ())
        host = self.halo_staging == "host"
        ops, keep = [], []
        recv_l = recv_r = None

        def out(t, key):
            t = t.contiguous()
            if host:
                buf = self._buffer(("send", g, key), t)
                buf.copy_(t)
                t = buf
            keep.append(t)
            return t

        def inbox(t, key):
            return self._buffer(("recv", g, key), t) if host else torch.empty_like(t)

        if right is not None:
            ops.append(tdist.P2POp(tdist.isend, out(hi, 0), self._peer(right), self.group,
                                   2 * g))
        if left is not None:
            ops.append(tdist.P2POp(tdist.isend, out(lo, 1), self._peer(left), self.group,
                                   2 * g + 1))
        if left is not None:
            recv_l = inbox(hi, 0)
            ops.append(tdist.P2POp(tdist.irecv, recv_l, self._peer(left), self.group, 2 * g))
        if right is not None:
            recv_r = inbox(lo, 1)
            ops.append(tdist.P2POp(tdist.irecv, recv_r, self._peer(right), self.group,
                                   2 * g + 1))
        works = tdist.batch_isend_irecv(ops) if ops else []
        return _Pending(works, recv_l, recv_r, tuple(keep))

    def _exchange_wait(self, pend: _Pending):
        """Complete a posted exchange: ``(from_left, from_right)`` on the
        device, None past an open end.  Staged receives are copied up
        before their pinned buffers can be reused."""
        for w in pend.works:
            w.wait()
        if self.halo_staging != "host" or not pend.works:
            return pend.from_left, pend.from_right
        return tuple(None if t is None else t.to(self.device)
                     for t in (pend.from_left, pend.from_right))

    def _gather(self, x_loc, launch=None):
        """Forward halo of a block ``(L_rev..., c)`` -> ``(L_rev + 2p..., c)``;
        ``launch()`` runs right after the first exchange is posted (the
        overlapped matvec's interior kernel)."""
        dim = self.space.dim
        p = self.widths
        out = x_loc
        for g in range(dim):
            d = dim - 1 - g
            pd = p[d]
            if pd == 0:
                continue
            n = out.shape[g]
            with self._span("halo"):
                pend = self._exchange_start(g, d, out.narrow(g, 0, pd), out.narrow(g, n - pd, pd))
            if launch is not None:
                launch()
                launch = None
            with self._span("halo"):
                fl, fr = self._exchange_wait(pend)
            shape = list(out.shape)
            shape[g] = pd
            fl = out.new_zeros(shape) if fl is None else fl  # open end
            fr = out.new_zeros(shape) if fr is None else fr
            out = torch.cat([fl, out, fr], dim=g)
        if launch is not None:
            launch()
        return out

    def halo_gather(self, x_loc: torch.Tensor) -> torch.Tensor:
        """Forward halo: local block ``(L_rev..., c)`` -> extended
        ``(L_rev + 2p..., c)`` with the neighbours' shells (the g2l ghost
        gather, petigavec.c:147-211)."""
        return self._gather(x_loc)

    def halo_fold(self, ext: torch.Tensor) -> torch.Tensor:
        """Reverse halo: extended ``(L_rev + 2p..., c)`` -> ``(L_rev...,
        c)`` with the ghost shells added into their owners (the l2g ADD /
        MatAssembly stash, petigavec.c:213-254), axis by axis so corner
        contributions propagate."""
        dim = self.space.dim
        p = self.widths
        out = ext
        for g in range(dim):
            d = dim - 1 - g
            pd = p[d]
            if pd == 0:
                continue
            n = out.shape[g]
            core = out.narrow(g, pd, n - 2 * pd).clone()
            with self._span("halo"):
                fl, fr = self._exchange_wait(self._exchange_start(
                    g, d, out.narrow(g, 0, pd), out.narrow(g, n - pd, pd)))
            Lg = core.shape[g]
            if fl is not None:  # my left neighbour's high ghost: my low rows
                core.narrow(g, 0, pd).add_(fl)
            if fr is not None:
                core.narrow(g, Lg - pd, pd).add_(fr)
            out = core
        return out

    # -------------------------------------------------------------- assembly

    def _ids(self, ids, valid):
        return (torch.as_tensor(np.asarray(ids, np.int64), device=self.device),
                torch.as_tensor(np.asarray(valid), device=self.device))

    def _local_rows(self, ids, valid=None) -> torch.Tensor:
        """Extended-block row per (element, closure entry), ``(B, nen)``
        int64 on the device; rows of invalid (padding) elements are 0
        (their data is zero)."""
        sp = self.space
        dim = sp.dim
        L, p, Lext = self.L, self.widths, self.Lext
        eshape = sp.elem_shape
        locs = sp._local_index
        rem = np.asarray(ids, np.int64)
        rows = np.zeros((rem.shape[0], sp.nen), np.int64)
        stride = 1
        for d in range(dim):
            e_d = rem % eshape[d]
            rem = rem // eshape[d]
            idx = sp.tabs[d].offset[e_d][:, None] + locs[d][None, :]
            idx = idx - self.coords[d] * L[d] + p[d]
            rows += idx * stride
            stride *= Lext[d]
        if valid is not None:
            rows = np.where(np.asarray(valid)[:, None], rows, 0)
        return torch.as_tensor(rows, device=self.device)

    def _scatter_KF(self, data_ext, b_ext, ids, valid, face, form, element_KF):
        """Element (K, F) of one batch, masked by ``valid``, added into
        the extended buffers."""
        K = self.st.K
        dof = self.space.dof
        ids_t, valid_t = self._ids(ids, valid)
        Ke, Fe, _ = element_KF(ids_t, face, form)
        vm = valid_t.to(Ke.dtype)
        Ke = Ke * vm[:, None, None, None, None]
        Fe = Fe * vm[:, None, None]
        rows = self._local_rows(ids, valid)
        slot = self._slot_table()
        sidx = rows[:, :, None] * K + slot[None, :, :]
        data_ext.index_add_(0, sidx.reshape(-1), Ke.reshape(-1, dof, dof))
        b_ext.index_add_(0, rows.reshape(-1), Fe.reshape(-1, dof))

    def _slot_table(self) -> torch.Tensor:
        return torch.as_tensor(self.st.slot_table(self.space.nen_shape), dtype=torch.int64,
                               device=self.device)

    def _box_interior(self, system, element_KF):
        """Shift fastpath per rank: the owned elements form a regular
        sub-box, so accumulation is (nen)² static slice adds into a box
        grid placed at the rank's origin, tabulated in z-slab chunks."""
        sp = self.space
        dim, dof = sp.dim, sp.dof
        K = self.st.K
        e0_a, cnt_a, ebox, off0 = self._box_setup()
        e0 = e0_a[self._mesh_index]
        cnt = cnt_a[self._mesh_index]
        eshape = sp.elem_shape
        Bslab = int(np.prod(ebox[:-1])) if dim > 1 else 1
        kz = max(1, min(ebox[-1], 65536 // max(Bslab, 1)))
        Gm = Gv = None
        for z0 in range(0, ebox[-1], kz):
            zext = min(kz, ebox[-1] - z0)
            Bc = Bslab * zext
            cshape = tuple(ebox[:-1]) + (zext,)
            jm = np.unravel_index(np.arange(Bc), cshape, order="F")
            ids = np.zeros(Bc, np.int64)
            valid = np.ones(Bc, bool)
            stride = 1
            for d in range(dim):
                jd = jm[d] + (z0 if d == dim - 1 else 0)
                valid &= jd < cnt[d]
                ids += np.clip(e0[d] + jd, 0, eshape[d] - 1) * stride
                stride *= eshape[d]
            ids_t, valid_t = self._ids(ids, valid)
            Ke, Fe, _ = element_KF(ids_t, None, system)
            vm = valid_t.to(Ke.dtype)
            Ke = Ke * vm[:, None, None, None, None]
            Fe = Fe * vm[:, None, None]
            Gm, Gv = fastpath.accumulate_box(sp, ebox, Ke, Fe, z0, Gm, Gv)
        Lext_rev = tuple(self.Lext[::-1])
        data_ext = torch.zeros(Lext_rev + (K, dof, dof), dtype=sp.dtype, device=self.device)
        b_ext = torch.zeros(Lext_rev + (dof,), dtype=sp.dtype, device=self.device)
        sl = []
        for g in range(dim):
            d = dim - 1 - g
            n = Gv.shape[g]
            o = off0[d] + int(e0[d]) - self.coords[d] * self.L[d] + self.widths[d]
            o = min(max(o, 0), Lext_rev[g] - n)  # dynamic_update_slice's clamp
            sl.append(slice(o, o + n))
        sl = tuple(sl)
        data_ext[sl] = Gm
        b_ext[sl] = Gv
        return data_ext.reshape(-1, dof, dof), b_ext.reshape(-1, dof)

    def assemble_system(self, system, ctx=None, *, order=None, apply_fix=True,
                        boundary=None):
        """Distributed IGAComputeSystem: this rank's element batches,
        local scatter into its extended block, reverse-halo fold.
        ``boundary(pt, ctx) -> (K, F)`` is evaluated on the visited
        faces' elements this rank owns (petigaelem.c:427-447).

        Returns this rank's ``(A_data (L_rev..., K, dof, dof), b (L_rev...,
        dof))``."""
        sp = self.space
        dof = sp.dof
        K = self.st.K
        Lext_rev = tuple(self.Lext[::-1])
        next_ext = int(np.prod(self.Lext))
        element_KF = _make_element_KF(sp, ctx, order, apply_fix)
        if fastpath.is_unit_step(sp):
            data_ext, b_ext = self._box_interior(system, element_KF)
        else:
            data_ext = torch.zeros((next_ext * K, dof, dof), dtype=sp.dtype, device=self.device)
            b_ext = torch.zeros((next_ext, dof), dtype=sp.dtype, device=self.device)
            self._scatter_KF(data_ext, b_ext, self.elem_ids[self._mesh_index],
                             self.elem_valid[self._mesh_index], None, system, element_KF)
        for face, ids, valid in self._face_args(boundary):
            self._scatter_KF(data_ext, b_ext, ids, valid, face, boundary, element_KF)
        data = self.halo_fold(data_ext.reshape(Lext_rev + (K * dof * dof,)))
        b = self.halo_fold(b_ext.reshape(Lext_rev + (dof,)))
        flux = boundary_flux_vector(sp)
        if flux is not None:
            mask, _ = sp.tensor("dirichlet")
            b = b + self.pad_grid(torch.where(mask, torch.zeros_like(flux), flux))
        return data.reshape(tuple(self.L[::-1]) + (K, dof, dof)), b

    # ----------------------------------------------- residual / Jacobian

    def _batch(self, ids, valid, face, form, ctx, order, Uext, aux_ext, directions=1):
        """One element batch: ``(res, Ue, rows)`` with ``res(Ue (B, nen,
        dof)) -> (B, nen·dof)`` the element residual with fix-value
        semantics, evaluated under ``directions`` tangents and masked by
        ``valid``; boundary forms (``face``) only add to free rows."""
        sp = self.space
        ids_t, valid_t = self._ids(ids, valid)
        pb = tabulate_elements(sp, ids_t, order=order, face=face)
        m, v = _fix_arrays(sp, sp.device_emap(ids_t))
        rows = self._local_rows(ids, valid)
        Ue = Uext[rows]
        aux_e = None if aux_ext is None else {k: a[rows] for k, a in aux_ext.items()}
        vm = valid_t.to(sp.dtype)[:, None]

        def res(ue):
            uorig = v if face is not None else ue.reshape(m.shape)
            Re = _element_residual(sp, form, ctx, pb, ue, m, v, uorig, aux_e, directions)
            if face is not None:
                Re = Re * (1.0 - m)
            return Re * vm

        return res, Ue, rows

    def _batches(self, function, boundary):
        """This rank's volume batch and its face batches: ``[(ids, valid,
        face, form), ...]``."""
        out = [(self.elem_ids[self._mesh_index], self.elem_valid[self._mesh_index], None,
                function)]
        out += [(ids, valid, face, boundary) for face, ids, valid in self._face_args(boundary)]
        return out

    def _extended(self, U_loc, aux_locs):
        dof = self.space.dof
        Uext = self.halo_gather(U_loc).reshape(-1, dof)
        aux_ext = None
        if aux_locs:
            aux_ext = {}
            for k, a in aux_locs.items():
                ext = self.halo_gather(a)
                aux_ext[k] = ext.reshape(-1, ext.shape[-1])
        return Uext, aux_ext

    def _residual(self, function, U_loc, ctx, order, aux_locs, boundary):
        """This rank's folded residual block (no flux term)."""
        sp = self.space
        dof = sp.dof
        Uext, aux_ext = self._extended(U_loc, aux_locs)
        b_ext = torch.zeros((int(np.prod(self.Lext)), dof), dtype=sp.dtype, device=self.device)
        for ids, valid, face, form in self._batches(function, boundary):
            res, Ue, rows = self._batch(ids, valid, face, form, ctx, order, Uext, aux_ext)
            b_ext.index_add_(0, rows.reshape(-1), res(Ue).reshape(-1, dof))
        return self.halo_fold(b_ext.reshape(tuple(self.Lext[::-1]) + (dof,)))

    def _jacobian(self, function, U_loc, ctx, order, aux_locs, boundary):
        """This rank's folded AD Jacobian block (one ``jvp`` per local
        unknown, batched by ``vmap``)."""
        sp = self.space
        dof, nen = sp.dof, sp.nen
        K = self.st.K
        n = nen * dof
        Uext, aux_ext = self._extended(U_loc, aux_locs)
        data_ext = torch.zeros((int(np.prod(self.Lext)) * K, dof, dof), dtype=sp.dtype,
                               device=self.device)
        slot = self._slot_table()
        basis = torch.eye(n, dtype=sp.dtype, device=self.device).reshape(n, 1, nen, dof)
        for ids, valid, face, form in self._batches(function, boundary):
            res, Ue, rows = self._batch(ids, valid, face, form, ctx, order, Uext, aux_ext,
                                        directions=n)
            B = Ue.shape[0]

            def column(t):
                return torch.func.jvp(res, (Ue,), (t.expand(B, nen, dof),))[1]

            Je = torch.func.vmap(column)(basis).permute(1, 2, 0)  # (B, row, col)
            Je = Je.reshape(B, nen, dof, nen, dof).permute(0, 1, 3, 2, 4)
            sidx = rows[:, :, None] * K + slot[None, :, :]
            data_ext.index_add_(0, sidx.reshape(-1), Je.reshape(-1, dof, dof))
        data = self.halo_fold(data_ext.reshape(tuple(self.Lext[::-1]) + (K * dof * dof,)))
        return data.reshape(tuple(self.L[::-1]) + (K, dof, dof))

    def _aux_locs(self, aux):
        return None if aux is None else {k: self._local(v) for k, v in aux.items()}

    def assemble_function(self, function, U, ctx=None, *, aux=None, order=None,
                          boundary=None):
        """Distributed IGAComputeFunction: halo-gather U, element
        residuals with fix-value semantics, reverse-halo fold; nodal
        fluxes are subtracted on free rows.  ``U`` and ``aux`` values are
        flat ``(nnodes, c)`` vectors or this rank's blocks; returns this
        rank's block ``(L_rev..., dof)``."""
        sp = self.space
        F = self._residual(function, self._local(U), ctx, order, self._aux_locs(aux), boundary)
        flux = boundary_flux_vector(sp)
        if flux is not None:
            mask, _ = sp.tensor("dirichlet")
            F = F - self.pad_grid(torch.where(mask, torch.zeros_like(flux), flux))
        return F

    def assemble_jacobian(self, function, U, ctx=None, *, aux=None, order=None,
                          boundary=None):
        """Distributed IGAComputeJacobian by forward AD of the element
        residual; this rank's block in :meth:`assemble_system`'s
        layout."""
        return self._jacobian(function, self._local(U), ctx, order, self._aux_locs(aux),
                              boundary)

    def newton(self, function, U0, ctx=None, *, rtol=1e-8, maxit=20, linear_rtol=1e-8,
               order=None, aux=None, boundary=None, linear_solver="cg", pc="jacobi"):
        """Distributed Newton–Krylov (SNES over the ranks,
        petigasnes.c:23-139): residual, AD Jacobian and the halo-exchange
        Krylov solve per iteration, on the host loop; stops when
        ``‖F‖² <= max(rtol² ‖F₀‖², 1e-60)`` or after ``maxit``.

        ``U0``: flat ``(nnodes, dof)`` or this rank's block; ``aux``: dict
        of flat state vectors (the form is then ``function(pt, Xe, aux_e,
        ctx)``).  Returns the flat solution (on every rank) and
        ``{"iters", "fnorm"}``."""
        U = self._local(U0)
        aux_locs = self._aux_locs(aux)
        solve = {"cg": self.cg, "bicgstab": self.bicgstab, "gmres": self.gmres}[linear_solver]
        F = self._residual(function, U, ctx, order, aux_locs, boundary)
        tol2 = max(rtol * rtol * self._dot(F, F).item(), 1e-60)
        k = 0
        while self._dot(F, F).item() > tol2 and k < maxit:
            data = self._jacobian(function, U, ctx, order, aux_locs, boundary)
            dx, _, _ = solve(data, F, rtol=linear_rtol, pc=pc)
            U = U - dx
            F = self._residual(function, U, ctx, order, aux_locs, boundary)
            k += 1
        return self.crop_flat(U), {"iters": k, "fnorm": math.sqrt(self._dot(F, F).item())}

    # ---------------------------------------------------------- collocation

    def _partition_points(self):
        """Per-rank padded point-id arrays in mesh layout ``(m_rev...,
        nloc)``: collocation rows are the nodes themselves, so the point
        partition is the node-box partition (petiga.c:1211-1274).  Local
        enumeration is box-grid order (reversed C-order)."""
        sp = self.space
        dim = sp.dim
        N = sp.node_shape
        nloc = int(np.prod(self.L))
        lgrids = np.meshgrid(*[np.arange(n) for n in self.L[::-1]], indexing="ij")
        mesh_shape = tuple(self.pgrid[::-1])
        ndev = int(np.prod(self.pgrid))
        ids = np.zeros((ndev,) + tuple(self.L[::-1]), np.int64)
        valid = np.zeros((ndev,) + tuple(self.L[::-1]), bool)
        for k, coords in enumerate(np.ndindex(*mesh_shape)):
            flat = np.zeros(tuple(self.L[::-1]), np.int64)
            ok = np.ones(tuple(self.L[::-1]), bool)
            stride = 1
            for d in range(dim):
                g = dim - 1 - d
                j = coords[g] * self.L[d] + lgrids[g]
                ok &= j < N[d]
                flat += np.minimum(j, N[d] - 1) * stride
                stride *= N[d]
            ids[k] = flat
            valid[k] = ok
        return ids.reshape(mesh_shape + (nloc,)), valid.reshape(mesh_shape + (nloc,))

    def assemble_collocation(self, system, ctx=None, *, order=None):
        """Distributed collocation assembly (petiga.c:1211-1274): each
        rank evaluates the collocation equations of the points it owns.
        Rows are point-local, so no reverse halo is needed.  Returns this
        rank's ``(A_data, F)`` blocks for the nonsymmetric solvers."""
        from ..assembly.collocation import _colloc_slots, _points

        sp = self.space
        if not sp.collocation:
            raise ValueError("space was not built with collocation=True")
        K = self.st.K
        dof, nen, dt = sp.dof, sp.nen, sp.dtype
        ids_a, valid_a = self._partition_points()
        ids, valid = self._ids(ids_a[self._mesh_index], valid_a[self._mesh_index])
        nloc = ids.shape[0]
        Lrev = tuple(self.L[::-1])
        pts = _points(sp, ids, order)
        Kp, Fp = _vmap(lambda p_: system(p_, ctx), pts)
        Kp = Kp.reshape(nloc, dof, nen * dof).to(dt)
        Fp = Fp.reshape(nloc, dof).to(dt)
        mask, vals = sp.tensor("dirichlet")
        m = mask[ids].to(dt)
        v = vals[ids]
        eye = torch.eye(dof, dtype=dt, device=self.device)
        interp = torch.einsum("pa,cd->pcad", pts.shape0, eye).reshape(nloc, dof, nen * dof)
        Kp = Kp * (1 - m[:, :, None]) + interp * m[:, :, None]
        Fp = torch.where(m > 0, v, Fp)
        vm = valid.to(dt)
        Kp = Kp * vm[:, None, None]
        Fp = Fp * vm[:, None]
        slots = _colloc_slots(sp)[ids]
        Kb = Kp.reshape(nloc, dof, nen, dof).transpose(1, 2)
        data = torch.zeros((nloc * K, dof, dof), dtype=dt, device=self.device)
        rows = torch.arange(nloc, device=self.device)[:, None] * K + slots
        data.index_add_(0, rows.reshape(-1), Kb.reshape(-1, dof, dof))
        return data.reshape(Lrev + (K, dof, dof)), Fp.reshape(Lrev + (dof,))

    def solve_collocation(self, system, ctx=None, *, rtol=1e-8, order=None, maxiter=10000,
                          solver="gmres", pc="jacobi", **kw):
        """Distributed collocation assembly + nonsymmetric Krylov solve;
        returns the flat solution and ``{"iters", "residual"}``."""
        data, F = self.assemble_collocation(system, ctx, order=order)
        solve = {"bicgstab": self.bicgstab, "gmres": self.gmres}[solver]
        x, k, res = solve(data, F, rtol=rtol, maxiter=maxiter, pc=pc, **kw)
        return self.crop_flat(x), {"iters": int(k), "residual": float(res)}

    # ------------------------------------------------------------------ spmv

    def _frame_operator(self, shape, dof) -> StencilOperator:
        """The kernel operator of a block of ``shape`` (spatial order)
        with ``dof`` fields, framed by a p-wide halo on every side — an
        open local stencil whose every slot is a constant flat shift of
        the extended index (the halo rows of its planes are zero).
        Cached."""
        key = (tuple(shape), dof)
        op = self._frame_ops.get(key)
        if op is None:
            st = Stencil(node_shape=tuple(shape), widths=self.widths,
                         periodic=(False,) * self.space.dim, dof=dof)
            op = self._frame_ops[key] = StencilOperator(
                st, dtype=self.space.dtype, device=self.device,
                ext_pads=tuple((p, p) for p in self.widths))
        return op

    def _onion(self, Lrev):
        """The overlapped matvec's frame: per (axis, side) the output
        rows and the halo window they read, onion-decomposed so every
        boundary row is corrected exactly once (None when a block is
        thinner than 2p on some split axis)."""
        dim = self.space.dim
        p = self.widths
        for g in range(dim):
            if p[dim - 1 - g] > 0 and Lrev[g] < 2 * p[dim - 1 - g]:
                return None
        out = []
        for g in range(dim):
            pd = p[dim - 1 - g]
            if pd == 0:
                continue
            for side in (0, 1):
                out_sl, h_sl = [], []
                for g2 in range(dim):
                    p2 = p[dim - 1 - g2]
                    L2 = Lrev[g2]
                    if g2 < g:
                        out_sl.append(slice(p2, L2 - p2))
                        h_sl.append(slice(p2, L2 + p2))
                    elif g2 == g:
                        if side == 0:
                            out_sl.append(slice(0, pd))
                            h_sl.append(slice(0, 3 * pd))
                        else:
                            out_sl.append(slice(L2 - pd, L2))
                            h_sl.append(slice(L2 - pd, L2 + 2 * pd))
                    else:
                        out_sl.append(slice(0, L2))
                        h_sl.append(slice(0, L2 + 2 * p2))
                out.append((tuple(out_sl), tuple(h_sl)))
        return out

    def local_planes(self, data_loc) -> LocalPlanes:
        """Pack a local operator block ``(L_rev..., K, a, b)`` into the
        kernel's planes — once per solve (the reference's
        ``local_pallas_planes``): the halo-extended block, and every onion
        slab of the overlapped matvec."""
        K = self.st.K
        Lrev = tuple(self.L[::-1])
        a, b = data_loc.shape[-2:]
        n = max(a, b)
        data_loc = data_loc.reshape(Lrev + (K, a, b))
        if a != b:
            data_loc = torch.nn.functional.pad(data_loc, [0, n - b, 0, n - a])
        data_loc = data_loc.reshape(Lrev + (K * n * n,))
        op = self._frame_operator(self.L, n)
        onion = self._onion(Lrev)
        frames = None
        if onion is not None:
            frames = []
            for out_sl, h_sl in onion:
                slab = data_loc[out_sl]
                sop = self._frame_operator(tuple(slab.shape[:-1])[::-1], n)
                frames.append((out_sl, h_sl, sop, sop.pack_planes(slab.contiguous())))
        return LocalPlanes(op, op.pack_planes(data_loc), frames, (a, b))

    def _apply_ext(self, op, DT, x_ext):
        """Kernel apply on an extended block -> the block's rows
        ``(rows_rev..., dof)``."""
        with self._span("kernel"):
            yb = op._kernel(DT, op.pack_ext(x_ext))
        return op.unpack_vec(yb).reshape(tuple(op.st.node_shape[::-1]) + (op.dof,))

    def _halo_shell(self, x_loc, launch=None):
        """Extended block holding ONLY the received halo shells (interior
        zeroed) — the exchange-dependent part of the vector."""
        dim = self.space.dim
        p = self.widths
        ext = self._gather(x_loc, launch)
        interior = tuple(
            slice(p[dim - 1 - g], p[dim - 1 - g] + x_loc.shape[g]) for g in range(dim)
        )
        ext[interior] = 0
        return ext

    def matvec_local(self, data_loc, x_loc, overlap=True, DT_loc=None):
        """Local SpMV with forward halo: ``data_loc (L_rev..., K, dof,
        dof)``, ``x_loc (L_rev..., dof)`` -> this rank's rows of ``A x``.

        ``DT_loc`` (from :meth:`local_planes`) holds the packed planes;
        without it they are packed here.  With ``overlap`` the first
        halo exchange is posted, the interior kernel (zero-padded local x,
        no exchange dependence) launches — on a side stream on the card —
        and the exchanges complete before the O(surface·p) frame
        correction, itself the kernel on each onion slab of the halo
        shell.  Blocks thinner than 2p on a split axis use the plain
        exchange-then-compute path."""
        dim = self.space.dim
        planes = self.local_planes(data_loc) if DT_loc is None else DT_loc
        rows, cols = planes.fields
        x_loc = x_loc.reshape(tuple(self.L[::-1]) + (cols,))
        if rows != cols:  # a zero-padded square block
            n = max(rows, cols)
            xs = torch.nn.functional.pad(x_loc, [0, n - cols])
            return self.matvec_local(None, xs, overlap, planes._replace(fields=(n, n)))[..., :rows]
        if not overlap or planes.frames is None:
            return self._apply_ext(planes.op, planes.DT, self.halo_gather(x_loc))
        p = self.widths
        pad = []
        for g in range(dim - 1, -1, -1):  # torch pads the last grid axis first
            pad += [p[dim - 1 - g]] * 2
        xp0 = torch.nn.functional.pad(x_loc, [0, 0] + pad)
        box = {}
        side = None
        if self.device.type == "cuda":
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            side = self._side
            side.wait_stream(torch.cuda.current_stream(self.device))

        def interior():
            if side is None:
                box["y"] = self._apply_ext(planes.op, planes.DT, xp0)
                return
            with torch.cuda.stream(side):
                box["y"] = self._apply_ext(planes.op, planes.DT, xp0)

        h = self._halo_shell(x_loc, launch=interior)
        y = box["y"]
        if side is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(side)
            y.record_stream(main)
            xp0.record_stream(side)
        for out_sl, h_sl, op, DT in planes.frames:
            y[out_sl] += self._apply_ext(op, DT, h[h_sl])
        return y

    # ------------------------------------------------------------------ krylov

    def _dot(self, a, c) -> torch.Tensor:
        """Global dot product (all-reduced) as a 0-d tensor."""
        v = torch.dot(a.reshape(-1), c.reshape(-1)).reshape(1)
        if self.world > 1:
            with self._span("allreduce"):
                tdist.all_reduce(v, group=self.group)
        return v[0]

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce sum of a tensor (the reference's ``psum``)."""
        if self.world > 1:
            t = t.contiguous()
            with self._span("allreduce"):
                tdist.all_reduce(t, group=self.group)
        return t

    def _jacobi_inv(self, data_loc):
        dvals = torch.diagonal(data_loc[..., self.st.diag_slot, :, :], dim1=-2, dim2=-1)
        return torch.where(dvals != 0, 1.0 / torch.where(dvals == 0, torch.ones_like(dvals),
                                                         dvals), torch.ones_like(dvals))

    def _pc_local(self, data_loc, pc):
        """Per-rank preconditioner ``Mv(r)``: None/"none" (identity),
        "jacobi" (point diagonal — PCJACOBI; padded rows' zero diagonals
        map to 1), "pbjacobi" (dof×dof diagonal blocks; singular blocks
        fall back to their scalar-Jacobi inverse), or a callable ``(ds,
        data_loc) -> Mv`` (e.g. :func:`~petiga_tpu_torch.solve.schwarz.
        schwarz_local_preconditioner`)."""
        if callable(pc):
            return pc(self, data_loc)
        if pc in (None, False, "none"):
            return lambda r: r
        if pc in (True, "jacobi"):
            dinv = self._jacobi_inv(data_loc)
            return lambda r: r * dinv
        if pc == "pbjacobi":
            D = data_loc[..., self.st.diag_slot, :, :]
            dof = self.space.dof
            eye = torch.eye(dof, dtype=D.dtype, device=D.device)
            det = torch.linalg.det(D)
            dmax = D.abs().amax(dim=(-2, -1))
            bad = det.abs() <= 1e-12 * torch.clamp(dmax, min=1.0) ** dof
            Dinv = torch.linalg.inv(torch.where(bad[..., None, None], eye, D))
            diag = torch.diagonal(D, dim1=-2, dim2=-1)
            sinv = torch.where(diag != 0, 1.0 / torch.where(diag == 0, torch.ones_like(diag),
                                                            diag), torch.ones_like(diag))
            Dinv = torch.where(bad[..., None, None], sinv[..., :, None] * eye, Dinv)
            return lambda r: torch.einsum("...ab,...b->...a", Dinv, r)
        raise ValueError(f"unknown preconditioner {pc!r}")

    def _krylov(self, solver, data, b, pc, **kw):
        sp = self.space
        dof = sp.dof
        Lrev = tuple(self.L[::-1])
        data = data.reshape(Lrev + (self.st.K, dof, dof))
        b = b.reshape(Lrev + (dof,))
        Mv = self._pc_local(data, pc)
        planes = self.local_planes(data)  # once per solve
        res = solver(lambda v: self.matvec_local(data, v, DT_loc=planes), b, M=Mv,
                     dot=self._dot, **kw)
        return res.x, res.iters, res.residual

    def cg(self, data, b, *, rtol=1e-8, atol=0.0, maxiter=10000, jacobi=True, pc=None):
        """Distributed preconditioned CG (:func:`~petiga_tpu_torch.solve.
        krylov.cg` on the halo-exchange matvec with all-reduced dots).
        Returns this rank's ``x`` block, the iterations and the residual
        norm.  ``pc`` overrides ``jacobi`` (see :meth:`_pc_local`)."""
        pc = ("jacobi" if jacobi else "none") if pc is None else pc
        return self._krylov(krylov.cg, data, b, pc, rtol=rtol, atol=atol, maxiter=maxiter)

    def bicgstab(self, data, b, *, rtol=1e-8, atol=0.0, maxiter=10000, jacobi=True, pc=None):
        """Distributed preconditioned BiCGStab; the layout contract of
        :meth:`cg`."""
        pc = ("jacobi" if jacobi else "none") if pc is None else pc
        return self._krylov(krylov.bicgstab, data, b, pc, rtol=rtol, atol=atol,
                            maxiter=maxiter)

    def gmres(self, data, b, *, rtol=1e-8, atol=0.0, restart=30, maxiter=200, pc="jacobi"):
        """Distributed restarted GMRES(m) with left preconditioning; the
        Hessenberg least squares is solved on every rank's host from the
        same all-reduced dots.  ``maxiter`` counts inner iterations (the
        reported count is ``cycles·restart``)."""
        return self._krylov(krylov.gmres, data, b, pc, rtol=rtol, atol=atol, restart=restart,
                            maxiter=maxiter)

    # ------------------------------------------------------------ functionals

    def compute_scalar(self, functional, U=None, ctx=None, *, order=None):
        """Distributed IGAComputeScalar (petigacomp.c:35-90): this rank's
        quadrature sums, all-reduced (the MPI_Allreduce at
        petigacomp.c:84).  Returns the ``(nsc,)`` result on every
        rank."""
        sp = self.space
        ids, valid = self._ids(self.elem_ids[self._mesh_index], self.elem_valid[self._mesh_index])
        pb = tabulate_elements(sp, ids, order=order)
        Ue = None
        if U is not None:
            rows = self._local_rows(self.elem_ids[self._mesh_index],
                                    self.elem_valid[self._mesh_index])
            Ue = self.halo_gather(self._local(U)).reshape(-1, sp.dof)[rows]
        vm = valid.to(sp.dtype)

        def one(pt, ue):
            return torch.atleast_1d(functional(pt, ue, ctx))

        def body(acc, pt, w):
            s = _vmap(one, pt, Ue)
            part = torch.sum((w * vm)[:, None] * s, dim=0)
            return part if acc is None else acc + part

        return self._psum(_scan_points(pb, body, None))

    def compute_error_norm(self, U, exact, k: int = 0, ctx=None, *, order=None):
        """Distributed IGAComputeErrorNorm (petigacomp.c:102-186): L2
        (k=0) or H^k-seminorm of ``u - u_exact``, all-reduced."""
        if not 0 <= k <= 4:
            raise ValueError("k must be in 0..4")
        field = ("value", "grad", "hess", "der3", "der4")[k]

        def err2(pt, Ue, _):
            e = getattr(pt, field)(Ue) - exact(pt.x)
            return torch.sum(e * e)

        val = self.compute_scalar(err2, U, ctx, order=max(k, 1) if order is None else order)
        return torch.sqrt(val[0])

    # ------------------------------------------------------------ high level

    def solve_system(self, system, ctx=None, *, rtol=1e-8, order=None, maxiter=10000,
                     boundary=None, solver="cg", pc=None):
        """Assemble + Krylov solve in one call; returns the flat
        ``(nnodes, dof)`` solution (gathered on every rank) and
        ``{"iters", "residual"}``."""
        data, b = self.assemble_system(system, ctx, order=order, boundary=boundary)
        solve = {"cg": self.cg, "bicgstab": self.bicgstab, "gmres": self.gmres}[solver]
        kw = {} if pc is None else {"pc": pc}
        x, k, res = solve(data, b, rtol=rtol, maxiter=maxiter, **kw)
        return self.crop_flat(x), {"iters": int(k), "residual": float(res)}


class DistThetaStepper:
    """Distributed θ-method (TSTHETA under domain decomposition): the
    stage residual of :class:`~petiga_tpu_torch.solve.ts.ThetaStepper`
    driven by :meth:`DistSpace.newton` (IGAComputeIFunction's MPI loop,
    petigats.c:23-90)."""

    def __init__(self, ds: DistSpace, ifunction: Callable, theta=0.5, ctx=None,
                 newton_kw=None):
        self.ds, self.ifn, self.theta = ds, ifunction, theta
        self.ctx = ctx
        self.newton_kw = newton_kw or {}

    def step(self, U, t, dt):
        ds, th, ifn = self.ds, self.theta, self.ifn

        def form(pt, Xe, aux_e, c):
            U0e = aux_e["U0"]
            Ue = U0e + th * (Xe - U0e)
            Ve = (Xe - U0e) / dt
            return ifn(pt, th / dt, Ve, t + th * dt, Ue, c)

        sp = ds.space
        U = torch.as_tensor(U, device=ds.device).reshape(sp.nnodes, sp.dof)
        return ds.newton(form, U, self.ctx, aux={"U0": U}, **self.newton_kw)


class DistAlphaStepper:
    """Distributed generalized-α for first-order systems (TSALPHA over
    the ranks): the stage algebra of :class:`~petiga_tpu_torch.solve.ts.
    AlphaStepper`; the Newton solve, halo exchanges and reductions run
    distributed."""

    def __init__(self, ds: DistSpace, ifunction: Callable, rho_inf=0.5, ctx=None,
                 newton_kw=None):
        self.ds, self.ifn = ds, ifunction
        r = rho_inf
        self.am = 0.5 * (3 - r) / (1 + r)
        self.af = 1.0 / (1 + r)
        self.g = 0.5 + self.am - self.af
        self.ctx = ctx
        self.newton_kw = newton_kw or {}

    def step(self, U, V, t, dt):
        ds, ifn = self.ds, self.ifn
        am, af, g = self.am, self.af, self.g

        def form(pt, Xe, aux_e, c):
            U0e, V0e = aux_e["U0"], aux_e["V0"]
            V1e = (Xe - U0e) / (g * dt) + (1 - 1 / g) * V0e
            Uaf = U0e + af * (Xe - U0e)
            Vam = V0e + am * (V1e - V0e)
            shift = am * af / (g * dt)
            return ifn(pt, shift, Vam, t + af * dt, Uaf, c)

        sp = ds.space
        U = torch.as_tensor(U, device=ds.device).reshape(sp.nnodes, sp.dof)
        V = torch.as_tensor(V, device=ds.device).reshape(sp.nnodes, sp.dof)
        U1, info = ds.newton(form, U, self.ctx, aux={"U0": U, "V0": V}, **self.newton_kw)
        V1 = (U1 - U) / (g * dt) + (1 - 1 / g) * V
        return U1, V1, info
