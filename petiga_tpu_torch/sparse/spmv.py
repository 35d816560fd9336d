"""Stencil SpMV on flat slot-major planes, through hand-written CUDA kernels.

Port of :mod:`petiga_tpu.sparse.pallas_spmv`.  The operator is stored as

  DT  (P, next)  slot-major planes, plane index ``(s·dof + a)·dof + b``,
                 one column per node of the *extended* grid ``Ne`` — the
                 node grid plus a halo of ``p_d`` on both sides of every
                 periodic axis (``Ne = N`` for open axes), ``next =
                 prod(Ne)``, or plus explicit ``ext_pads`` (the halo frame
                 of a distributed rank's block).  Halo columns hold zero
                 planes.
  xb  (dof, G + next + G)  a packed vector: one row per field, ``G =
                 max|c_s|`` guard entries on each side (zero), periodic
                 halos holding wrapped copies.

Every stencil slot ``s`` is a constant flat shift ``c_s`` of the extended
node index, because out-of-range slots store zero blocks (the
reference's ``Stencil.column_index`` semantics), so

    y[a][n] = Σ_s Σ_b DT[(s·dof + a)·dof + b][n] · x_b[n + c_s].

Symmetric storage keeps only the ``Ku = (K+1)/2`` upper slots (diagonal
first, ``c >= 0``) and applies each stored plane twice: directly at
``+c`` and transposed at ``-c``.

Krylov solves iterate on packed vectors (``pack_vec`` once, ``matvec_xb``
per iteration, ``unpack_vec`` once): dots and axpys on packed vectors are
exact for open axes because guards stay zero.

Kernels: :func:`stencil_spmv_full` and :func:`stencil_spmv_sym` launch
the CUDA kernels of ``csrc/stencil_spmv.cu`` (any dof: templated kernels
for dof 1–3, a runtime-dof kernel above) for CUDA tensors and run
their plain PyTorch versions (``_spmv_full_plain``, ``_spmv_sym_plain``)
for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import resolve_device
from .stencil import Stencil

__all__ = [
    "LAUNCHES",
    "StencilOperator",
    "stencil_matvec",
    "stencil_spmv_full",
    "stencil_spmv_sym",
]

# kernel launches by kind; a plain-version (CPU) apply does not count
LAUNCHES = {"full": 0, "sym": 0}


# ------------------------------------------------------------------ layout


def default_pads(stencil: Stencil) -> tuple:
    """Per-axis (lo, hi) grid pads: a halo of p on both sides of every
    periodic axis, none on open axes."""
    return tuple((p, p) if per else (0, 0)
                 for p, per in zip(stencil.widths, stencil.periodic))


def ext_shape(stencil: Stencil, pads=None) -> tuple:
    """Extended node shape: every axis grows by its (lo, hi) pads
    (:func:`default_pads` when None)."""
    pads = default_pads(stencil) if pads is None else pads
    return tuple(N + lo + hi for N, (lo, hi) in zip(stencil.node_shape, pads))


def flat_shifts(stencil: Stencil, pads=None) -> np.ndarray:
    """(K,) constant flat-index shift per slot in the extended index
    space (axis-0 fastest)."""
    offs = stencil.slot_offsets()
    c = np.zeros(offs.shape[0], dtype=np.int64)
    stride = 1
    for d, Ne in enumerate(ext_shape(stencil, pads)):
        c += offs[:, d] * stride
        stride *= Ne
    return c


# ----------------------------------------------------------------- kernels


def _alloc_packed(xb: torch.Tensor, G: int, next_: int) -> torch.Tensor:
    """Packed output vector with zero guards (the kernel writes the
    interior)."""
    out = torch.empty(xb.shape[0], next_ + 2 * G, dtype=xb.dtype, device=xb.device)
    out[:, :G].zero_()
    out[:, G + next_:].zero_()
    return out


def _check(kind, DT, xb, shifts, G, out):
    dof = xb.shape[0] if xb.dim() == 2 else 0
    if DT.dim() != 2 or xb.dim() != 2 or dof < 1:
        raise ValueError(
            f"{kind}: want DT (P, next) and xb (dof, G+next+G), got "
            f"{tuple(DT.shape)} and {tuple(xb.shape)}"
        )
    next_ = DT.shape[1]
    if DT.shape[0] != shifts.numel() * dof * dof:
        raise ValueError(
            f"{kind}: {DT.shape[0]} planes for {shifts.numel()} slots and dof {dof}"
        )
    if xb.shape[1] != next_ + 2 * G:
        raise ValueError(f"{kind}: xb length {xb.shape[1]} != {next_} + 2·{G}")
    if DT.dtype not in (torch.float32, torch.float64) or xb.dtype != DT.dtype:
        raise TypeError(f"{kind}: dtypes {DT.dtype}, {xb.dtype}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise TypeError(f"{kind}: shifts must be a 1-D int32 tensor")
    tensors = [DT, xb, shifts] + ([out] if out is not None else [])
    if any(t.device != xb.device for t in tensors):
        raise ValueError(f"{kind}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kind}: tensors must be contiguous")
    if out is not None and (out.shape != xb.shape or out.dtype != xb.dtype):
        raise ValueError(f"{kind}: out must match xb")
    return dof, next_


def _launch(kind, DT, xb, out, shifts, dof, next_, G):
    from . import _build

    lib = _build.load()
    fn = getattr(lib, f"ptt_spmv_{kind}_{'f32' if DT.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        rc = fn(
            ctypes.c_void_p(DT.data_ptr()), ctypes.c_void_p(xb.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(shifts.data_ptr()),
            shifts.numel(), dof, next_, G, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"stencil_spmv_{kind} launch failed: {lib.ptt_error_string(rc).decode()}"
        )
    LAUNCHES[kind] += 1


def _apply(kind, plain, DT, xb, shifts, G, out):
    dof, next_ = _check(kind, DT, xb, shifts, G, out)
    if out is None:
        out = _alloc_packed(xb, G, next_)
    if xb.is_cuda:
        _launch(kind, DT, xb, out, shifts, dof, next_, G)
    elif xb.device.type == "cpu":
        plain(DT, xb, shifts.tolist(), G, out)
    else:
        raise ValueError(f"stencil_spmv_{kind}: unsupported device {xb.device}")
    return out


def stencil_spmv_full(DT, xb, shifts, G, out=None):
    """Full-storage stencil SpMV on packed vectors: writes
    ``y[a][n] = Σ_s Σ_b DT[(s·dof+a)·dof+b][n] · x_b[n + c_s]`` into the
    interior of ``out`` (allocated with zero guards when None).

    ``shifts``: (K,) int32 tensor on the device of ``xb``.  CUDA tensors
    launch the ``stencil_spmv_full`` kernel; CPU tensors run
    :func:`_spmv_full_plain`."""
    return _apply("full", _spmv_full_plain, DT, xb, shifts, G, out)


def stencil_spmv_sym(DTu, xb, shifts_u, G, out=None):
    """Symmetric stencil SpMV from the ``Ku`` upper planes (``shifts_u``
    non-negative, diagonal first): direct term at ``+c``, transposed
    mirror term at ``-c``.  CUDA tensors launch the ``stencil_spmv_sym``
    kernel; CPU tensors run :func:`_spmv_sym_plain`."""
    return _apply("sym", _spmv_sym_plain, DTu, xb, shifts_u, G, out)


def _spmv_full_plain(DT, xb, shifts, G, out):
    """Plain PyTorch version of the full kernel: K shifted slices of the
    packed x, multiply-added per plane."""
    dof = xb.shape[0]
    next_ = DT.shape[1]
    y = out[:, G:G + next_]
    y.zero_()
    for s, c in enumerate(shifts):
        for b in range(dof):
            xs = xb[b, G + c:G + c + next_]
            for a in range(dof):
                y[a].addcmul_(DT[(s * dof + a) * dof + b], xs)


def _spmv_sym_plain(DTu, xb, shifts_u, G, out):
    """Plain PyTorch version of the symmetric kernel: direct terms as in
    the full product, mirror terms ``y_b[n] += D[(ku,a,b)][n-c]·x_a[n-c]``
    as slices shifted the other way."""
    dof = xb.shape[0]
    next_ = DTu.shape[1]
    y = out[:, G:G + next_]
    y.zero_()
    for ku, c in enumerate(shifts_u):
        for b in range(dof):
            xs = xb[b, G + c:G + c + next_]
            for a in range(dof):
                y[a].addcmul_(DTu[(ku * dof + a) * dof + b], xs)
        if ku == 0 or c >= next_:
            continue
        for a in range(dof):
            xm = xb[a, G:G + next_ - c]
            for b in range(dof):
                y[b, c:].addcmul_(DTu[(ku * dof + a) * dof + b, :next_ - c], xm)


# ---------------------------------------------------------------- operator


class StencilOperator:
    """A stencil operator held as slot-major planes on ``device`` (the
    port of ``PallasStencilOperator``; ``device=None`` is the CUDA
    device).

    Build with :meth:`from_matrix` / :meth:`from_symmetric` (pack a
    :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix` or
    :class:`~petiga_tpu_torch.sparse.stencil.SymmetricStencilMatrix` on the
    device of its data), :meth:`from_planes` / :meth:`from_planes_symmetric`
    (the zero-copy path of plane assembly), or pack node-grid data with
    :meth:`pack_planes`.  ``kind`` is ``"full"`` or ``"sym"``.

    ``ext_pads=((lo, hi), ...)`` per spatial axis replaces the derived
    periodic halos with an explicit frame, as ``PallasStencilOperator(
    ext_pads=)`` does for the distributed layer: a rank's block of an
    open local stencil, framed by the p-wide halo its neighbours send.
    The frame's plane columns are zero; :meth:`pack_ext` packs an
    already-extended vector, :meth:`packed_mask` marks the owned
    entries."""

    def __init__(self, stencil: Stencil, *, dtype=torch.float32, device=None,
                 kind: str = "full", ext_pads=None):
        if kind not in ("full", "sym"):
            raise ValueError(f"kind must be 'full' or 'sym', got {kind!r}")
        if kind == "sym" and any(stencil.periodic):
            raise ValueError("sym kernel requires open axes")
        st = self.st = stencil
        self.kind = kind
        self.dtype = dtype
        self.device = resolve_device(device)
        self.dof = st.dof
        self.pads = default_pads(st) if ext_pads is None else tuple(
            (int(lo), int(hi)) for lo, hi in ext_pads)
        if len(self.pads) != st.dim:
            raise ValueError(f"ext_pads: want {st.dim} (lo, hi) pairs, got {self.pads}")
        self.Ne = ext_shape(st, self.pads)
        self.next = int(np.prod(self.Ne))
        shifts = flat_shifts(st, self.pads)
        self.G = int(np.max(np.abs(shifts)))
        self.shifts = tuple(int(c) for c in shifts)
        if kind == "sym":
            self.shifts_u = self.shifts[st.diag_slot:]
            if self.shifts_u[0] != 0 or min(self.shifts_u) < 0:
                raise ValueError("upper-slot shifts must be non-negative")
        used = self.shifts_u if kind == "sym" else self.shifts
        self.nplanes = len(used) * self.dof * self.dof
        self._shift_t = torch.tensor(used, dtype=torch.int32, device=self.device)
        self._any_per = any(st.periodic)
        self._framed = any(pad != (0, 0) for pad in self.pads)
        self.DT = None
        self.A = None  # the source matrix of from_matrix / from_symmetric

    @classmethod
    def from_matrix(cls, A, keep_source: bool = True) -> "StencilOperator":
        """Pack a full-storage ``StencilMatrix`` into slot-major planes
        (kind ``"full"``) on the device of ``A.data`` — the port of
        ``PallasStencilOperator(A)``.  ``keep_source=False`` leaves ``A``
        out of the operator (``data`` is then None), so that dropping
        ``A`` frees its slot data."""
        return cls._from_slot_data(A, "full", keep_source)

    @classmethod
    def from_symmetric(cls, S, keep_source: bool = True) -> "StencilOperator":
        """Pack a ``SymmetricStencilMatrix`` for the symmetric kernel
        (kind ``"sym"``): only its ``Ku = (K+1)/2`` upper planes are stored
        and streamed.  Open axes only (raises on a periodic one), any
        dof.  ``keep_source`` as in :meth:`from_matrix`."""
        return cls._from_slot_data(S, "sym", keep_source)

    @classmethod
    def _from_slot_data(cls, M, kind, keep_source):
        s = M.stencil
        op = cls(s, dtype=M.data.dtype, device=M.data.device, kind=kind)
        op._set_planes(op.pack_planes(M.data.reshape(tuple(s.node_shape[::-1]) + (op.nplanes,))))
        if keep_source:
            op.A = M
        return op

    @classmethod
    def from_planes(cls, stencil: Stencil, DT: torch.Tensor) -> "StencilOperator":
        """Zero-copy construction from (K·dof², next) planes."""
        op = cls(stencil, dtype=DT.dtype, device=DT.device)
        op._set_planes(DT)
        return op

    @classmethod
    def from_planes_symmetric(cls, stencil: Stencil, DTu: torch.Tensor) -> "StencilOperator":
        """Zero-copy construction from (Ku·dof², next) upper-slot planes
        (kind ``"sym"``)."""
        op = cls(stencil, dtype=DTu.dtype, device=DTu.device, kind="sym")
        op._set_planes(DTu)
        return op

    def _set_planes(self, DT):
        want = (self.nplanes, self.next)
        if tuple(DT.shape) != want:
            raise ValueError(f"plane shape {tuple(DT.shape)} != {want}")
        self.DT = DT

    # ------------------------------------------------------------- packing

    def _to_ext(self, xg: torch.Tensor, wrap: bool) -> torch.Tensor:
        """(N_rev..., C) node grid -> (Ne_rev..., C) extended grid:
        periodic halos hold wrapped copies (``wrap``), every other pad
        zeros."""
        st = self.st
        dim = st.dim
        for g in range(dim):
            d = dim - 1 - g
            lo, hi = self.pads[d]
            if lo == hi == 0:
                continue
            n = xg.shape[g]
            if wrap and st.periodic[d]:
                lo_t, hi_t = xg.narrow(g, n - lo, lo), xg.narrow(g, 0, hi)
            else:
                shape = list(xg.shape)
                shape[g] = lo
                lo_t = xg.new_zeros(shape)
                shape[g] = hi
                hi_t = xg.new_zeros(shape)
            xg = torch.cat([lo_t, xg, hi_t], dim=g)
        return xg

    def _from_ext(self, y: torch.Tensor) -> torch.Tensor:
        """(next, C...) on the extended grid -> (nnodes, C...): crop the
        pads."""
        st = self.st
        if not self._framed:
            return y
        dim = st.dim
        trail = tuple(y.shape[1:])
        yg = y.reshape(tuple(self.Ne[::-1]) + trail)
        sl = tuple(
            slice(self.pads[dim - 1 - g][0],
                  self.pads[dim - 1 - g][0] + st.node_shape[dim - 1 - g])
            for g in range(dim)
        )
        return yg[sl].reshape((st.nnodes,) + trail)

    def pack_planes(self, data_grid: torch.Tensor, planes=None) -> torch.Tensor:
        """(N_rev..., P) grid-layout slot data -> (P, next) planes (halo
        columns zero)."""
        if planes is None:
            planes = self.nplanes
        ext = self._to_ext(data_grid, wrap=False)
        return ext.reshape(self.next, planes).T.contiguous()

    def pack_vec(self, x: torch.Tensor) -> torch.Tensor:
        """Flat (nnodes·dof,) or (nnodes, dof) -> packed (dof, G+next+G):
        zero guards, wrapped periodic halos."""
        st = self.st
        xg = x.reshape(tuple(st.node_shape[::-1]) + (self.dof,))
        xe = self._to_ext(xg, wrap=True).reshape(self.next, self.dof)
        return self.embed(xe.T)

    def unpack_vec(self, xb: torch.Tensor, flat: bool = False) -> torch.Tensor:
        """Packed -> (nnodes, dof) (or flat (nnodes·dof,)): the pads
        cropped."""
        y = self._from_ext(xb[:, self.G:self.G + self.next].T)
        return y.reshape(-1) if flat else y.contiguous()

    def embed(self, y: torch.Tensor) -> torch.Tensor:
        """(dof, next) on the extended grid -> packed layout with zero
        guards."""
        out = torch.zeros(self.dof, self.next + 2 * self.G, dtype=y.dtype, device=y.device)
        out[:, self.G:self.G + self.next] = y
        return out

    def pack_ext(self, x_ext: torch.Tensor) -> torch.Tensor:
        """Pack an ALREADY-extended grid ``(Ne_rev..., dof)`` — a rank's
        halo-exchanged block — into the packed layout (zero guards)."""
        return self.embed(x_ext.reshape(self.next, self.dof).T)

    def packed_mask(self) -> torch.Tensor:
        """(dof, G+next+G) 1/0 mask of the owned entries (zero on guards
        and pads), for exact dots on packed vectors whose halos hold
        copies."""
        ones = torch.ones(self.st.nnodes, self.dof, dtype=self.dtype, device=self.device)
        xg = ones.reshape(tuple(self.st.node_shape[::-1]) + (self.dof,))
        return self.pack_ext(self._to_ext(xg, wrap=False))

    # --------------------------------------------------------------- apply

    def _kernel(self, DT, xb):
        if self.kind == "sym":
            return stencil_spmv_sym(DT, xb, self._shift_t, self.G)
        return stencil_spmv_full(DT, xb, self._shift_t, self.G)

    def matvec(self, x):
        return self.matvec_packed(self.DT, x)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def stencil(self) -> Stencil:
        return self.st

    @property
    def data(self):
        """The source matrix's slot data, or None for an operator built
        from planes or packed with ``keep_source=False``."""
        return None if self.A is None else self.A.data

    def matvec_packed(self, DT, x):
        """matvec on node-ordered vectors with the planes passed
        explicitly."""
        flat_in = x.dim() == 1
        y = self.unpack_vec(self._kernel(DT, self.pack_vec(x)))
        return y.reshape(-1) if flat_in else y

    def matvec_xb(self, DT, xb):
        """Packed-in, packed-out matvec — the solver-loop path.  Periodic
        halos are re-wrapped after the apply (the kernel leaves them
        zero: halo rows of the planes are zero)."""
        yb = self._kernel(DT, xb)
        if self._any_per:
            return self.pack_vec(self.unpack_vec(yb))
        return yb

    # ------------------------------------------------------------ diagonal

    @property
    def _dslot(self) -> int:
        return 0 if self.kind == "sym" else self.st.diag_slot

    def diag_from_planes(self, DT=None) -> torch.Tensor:
        """Scalar diagonal (nnodes, dof) read from the planes."""
        if DT is None:
            DT = self.DT
        dof, s = self.dof, self._dslot
        cols = [DT[(s * dof + a) * dof + a] for a in range(dof)]
        return self._from_ext(torch.stack(cols, dim=-1))

    def packed_diag_inv_of(self, DT) -> torch.Tensor:
        """Jacobi inverse diagonal in packed layout from explicit planes
        (zero on guards and where the diagonal is zero)."""
        d = self.diag_from_planes(DT)
        inv = torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                          torch.zeros_like(d))
        return self.pack_vec(inv)

    def packed_diag_inv(self) -> torch.Tensor:
        return self.packed_diag_inv_of(self.DT)

    def scalar_diagonal(self) -> torch.Tensor:
        return self.diag_from_planes()

    def diagonal(self) -> torch.Tensor:
        """Block diagonal (nnodes, dof, dof)."""
        dof, s = self.dof, self._dslot
        blocks = torch.stack(
            [
                torch.stack([self.DT[(s * dof + a) * dof + b] for b in range(dof)], dim=-1)
                for a in range(dof)
            ],
            dim=-2,
        )  # (next, dof, dof)
        return self._from_ext(blocks)

    @property
    def plane_bytes(self) -> int:
        """Bytes of planes one apply streams."""
        return self.nplanes * self.next * self.DT.element_size()

    def __repr__(self) -> str:
        return (
            f"StencilOperator(kind={self.kind}, planes={self.nplanes}, "
            f"next={self.next}, G={self.G}, dof={self.dof}, "
            f"dtype={self.dtype}, device={self.device})"
        )


def stencil_matvec(A, x):
    """One product ``A @ x`` through the stencil kernel, packing ``A`` on
    every call (the port of ``pallas_matvec``): prefer a
    :class:`StencilOperator` kept across a solve."""
    return A.fast_operator().matvec(x)
