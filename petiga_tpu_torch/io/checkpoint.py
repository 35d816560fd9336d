"""Checkpoint I/O in PetIGA's binary format (port of
:mod:`petiga_tpu.io.checkpoint`; PetIGA's petigaio.c).

Files are **PetIGA/PETSc-binary compatible** (big-endian, classid
headers) and written in *natural ordering* — the axis-0-fastest
lexicographic node order that is this framework's native layout — so
checkpoints are independent of the device layout and interoperate with
PetIGA itself, igakit and the JAX package: for the same space and vector
the files are byte-identical.  Host numpy; vectors come back as tensors on
the space's device in its dtype.

Format (IGASave/IGALoad, petigaio.c:29-138):
  int32  IGA_FILE_CLASSID = 1211299
  int32  info   (bit 0: geometry present, bit 1: property present)
  int32  dim
  per axis: int32 p, int32 m+1, float64 U[m+1]
  if geometry: int32 nsd, Vec of (nsd+1)-homogeneous coords [x*w, w]
  if property: int32 npd, Vec of properties
Vec format: int32 VEC_FILE_CLASSID = 1211214, int32 n, float64 data[n].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space

__all__ = [
    "write_space",
    "read_space",
    "write_vec",
    "read_vec",
    "IGA_FILE_CLASSID",
    "VEC_FILE_CLASSID",
]

IGA_FILE_CLASSID = 1211299
VEC_FILE_CLASSID = 1211214


def _wi(f, *vals):
    np.asarray(vals, dtype=">i4").tofile(f)


def _wr(f, arr):
    np.asarray(arr, dtype=">f8").tofile(f)


def _ri(f, n=1):
    v = np.fromfile(f, dtype=">i4", count=n)
    if len(v) != n:
        raise IOError("unexpected end of file")
    return v.astype(np.int64)


def _rr(f, n):
    v = np.fromfile(f, dtype=">f8", count=n)
    if len(v) != n:
        raise IOError("unexpected end of file")
    return v


def _write_petsc_vec(f, data):
    data = np.asarray(data, dtype=np.float64).ravel()
    _wi(f, VEC_FILE_CLASSID, len(data))
    _wr(f, data)


def _read_petsc_vec(f):
    classid, n = _ri(f, 2)
    if classid != VEC_FILE_CLASSID:
        raise IOError(f"not a Vec in file (classid {classid})")
    return _rr(f, int(n))


def write_space(space: Space, path: str) -> None:
    """IGAWrite analog (petigaio.c:535-598)."""
    with open(path, "wb") as f:
        _wi(f, IGA_FILE_CLASSID)
        info = (1 if space.has_geometry else 0) | (
            2 if space.property is not None else 0
        )
        _wi(f, info)
        _wi(f, space.dim)
        for ax in space.axes:
            _wi(f, ax.p, ax.m + 1)
            _wr(f, ax.U)
        if space.has_geometry:
            nsd = space.nsd
            _wi(f, nsd)
            W = (
                space.rational
                if space.rational is not None
                else np.ones(space.nnodes)
            )
            Xw = np.concatenate(
                [space.geometry * W[:, None], W[:, None]], axis=1
            )
            _write_petsc_vec(f, Xw)
        if space.property is not None:
            _wi(f, space.property.shape[1])
            _write_petsc_vec(f, space.property)


def read_space(path: str, *, dof: int = 1, periodic=None, dtype=None, device=None,
               **space_kw) -> Space:
    """IGARead analog (petigaio.c:11-75).  ``periodic`` (per-axis flags)
    is not stored in the file — as in PetIGA, where it comes from the
    options database.  ``device=None`` is the CUDA device."""
    dtype = torch.float32 if dtype is None else dtype
    with open(path, "rb") as f:
        (classid,) = _ri(f)
        if classid != IGA_FILE_CLASSID:
            raise IOError(f"not an IGA in file (classid {classid})")
        (info,) = _ri(f)
        has_geom = bool(info & 0x1)
        has_prop = bool(info & 0x2)
        (dim,) = _ri(f)
        axes = []
        for d in range(int(dim)):
            p, m1 = _ri(f, 2)
            U = _rr(f, int(m1))
            per = bool(periodic[d]) if periodic is not None else False
            axes.append(Axis.from_knots(int(p), U, periodic=per))
        sp = Space(axes, dof=dof, dtype=dtype, device=device, **space_kw)
        if has_geom:
            (nsd,) = _ri(f)
            Xw = _read_petsc_vec(f).reshape(sp.nnodes, int(nsd) + 1)
            W = Xw[:, -1]
            X = np.where(
                np.abs(W)[:, None] > 0, Xw[:, :-1] / np.where(W == 0, 1, W)[:, None],
                Xw[:, :-1],
            )
            rational = None if np.allclose(W, 1.0) else W
            sp.nsd = int(nsd)  # dim != nsd manifolds round-trip
            sp.init_geometry(X, rational)
        if has_prop:
            (npd,) = _ri(f)
            A = _read_petsc_vec(f).reshape(sp.nnodes, int(npd))
            sp.set_property(A)
    return sp


def write_vec(space: Space, U, path: str) -> None:
    """IGAWriteVec analog: solution vector in natural ordering
    (petigaio.c:644-736; natural order == our native flat order)."""
    if torch.is_tensor(U):
        U = U.detach().cpu().numpy()
    U = np.asarray(U).reshape(space.nnodes * space.dof)
    with open(path, "wb") as f:
        _write_petsc_vec(f, U)


def read_vec(space: Space, path: str):
    """IGAReadVec analog: (nnodes, dof) on the space's device."""
    with open(path, "rb") as f:
        data = _read_petsc_vec(f)
    if len(data) != space.nnodes * space.dof:
        raise IOError(
            f"vector length {len(data)} does not match space "
            f"({space.nnodes} nodes x {space.dof} dof)"
        )
    return torch.as_tensor(data.astype(np.float64).reshape(space.nnodes, space.dof),
                           dtype=space.dtype,
                           device=space.device)
