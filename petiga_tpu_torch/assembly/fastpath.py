"""Shift-structured assembly accumulation (port of
:mod:`petiga_tpu.assembly.fastpath`) — the replacement for scatter-add
matrix assembly.

A space is *regular* when its per-axis element offsets are in arithmetic
progression ``offset[e] = s_d * e`` (uniform multiplicity, open or
periodic), and *unit-step* when that step is 1 on every axis (maximal
continuity).  On regular spaces the map from element blocks to stencil
slots is translation-invariant in the element index too:

    A[node i, slot(b-a)] += Ke[e, a, b]   with   i_d = s_d e_d + a_d,

so accumulation is a strided-slice add of the element-grid-shaped array
``Ke[:, a, b]`` into the node grid — no scatter, no gather, ``nen``
shifted adds per chunk.  They run IN PLACE on the preallocated
accumulator, one after the other: sequential and deterministic.

Element chunks must be whole slabs of the slowest axis (see
:func:`slab_chunk`) so each chunk occupies a contiguous node range.  The
``*_dyn`` variants are the reference's traced-start forms (open slow
axis); here the start is a Python int either way and they share the body
of the static ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "is_regular",
    "is_unit_step",
    "slab_chunk",
    "accumulate_matrix",
    "accumulate_vector",
    "accumulate_matrix_dyn",
    "accumulate_vector_dyn",
    "accumulate_matrix_dyn_planes",
    "accumulate_box",
]


def is_unit_step(space) -> bool:
    """Regular AND unit element step on every axis."""
    return is_regular(space) and all(s == 1 for s in _steps(space))


def is_regular(space) -> bool:
    """Offsets in arithmetic progression on every axis (and not
    collocation)."""
    if space.collocation:
        return False
    for d, t in enumerate(space.tabs):
        off = t.offset
        if len(off) > 1:
            dd = np.diff(off)
            if not np.all(dd == dd[0]):
                return False
            if space.periodic[d] and dd[0] != 1:
                return False
    return True


def _steps(space):
    return tuple(
        int(t.offset[1] - t.offset[0]) if t.nel > 1 else 1 for t in space.tabs
    )


def slab_chunk(space, target: int) -> int:
    """Round a target chunk size to whole slabs of the slowest axis."""
    eshape = space.elem_shape
    if space.dim == 1:
        return min(target, eshape[0])
    slab = int(np.prod(eshape[:-1]))
    k = min(max(1, target // slab), eshape[-1])
    return k * slab


def _chunk_rev(space, B):
    """Reversed-axis element-grid shape of a chunk of ``B`` elements
    (whole slabs of the slowest axis)."""
    eshape = space.elem_shape
    if space.dim == 1:
        return (B,)
    return (B // int(np.prod(eshape[:-1])),) + tuple(eshape[:-1][::-1])


def _slot_box(space, a_multi):
    """For a fixed row-local index ``a`` the whole column box ``b`` lands
    in ONE contiguous sub-box of the (reversed) slot box, slot = b - a + p
    per axis: its slices."""
    dim = space.dim
    p, nshape = space.degrees, space.nen_shape
    return tuple(
        slice(p[dim - 1 - g] - a_multi[dim - 1 - g],
              p[dim - 1 - g] - a_multi[dim - 1 - g] + nshape[dim - 1 - g])
        for g in range(dim)
    )


def _place(space, target, g, a_multi, z0, lead=0):
    """``target[node window of local index a] += g`` in place.

    ``target`` carries the reversed node axes at dims ``lead..lead+dim``;
    ``g`` is element-grid shaped there (the slowest axis holding the
    chunk's ``kz`` slabs from slab ``z0``) and equal to ``target``
    elsewhere.  Node index along axis d is ``s_d e_d + a_d``: a strided
    window on open axes, a rotation on periodic ones (step 1, one element
    per node; the slow axis wraps as a two-segment split)."""
    dim = space.dim
    steps = _steps(space)
    N = space.node_shape
    idx = [slice(None)] * target.dim()
    for gax in range(1, dim):
        d = dim - 1 - gax
        a_d, n_el = int(a_multi[d]), g.shape[lead + gax]
        if space.periodic[d]:
            if steps[d] != 1 or n_el != N[d]:
                raise AssertionError("periodic axis must be unit-step (is_regular guards this)")
            g = torch.roll(g, a_d, dims=lead + gax)
        else:
            idx[lead + gax] = slice(a_d, a_d + steps[d] * (n_el - 1) + 1, steps[d])
    d = dim - 1
    s, kz = steps[d], g.shape[lead]
    start = int(z0) * s + int(a_multi[d])
    if space.periodic[d]:
        Nz = target.shape[lead]
        start %= Nz
        k = min(kz, Nz - start)  # rows before the wrap
        idx[lead] = slice(start, start + k)
        target[tuple(idx)] += g.narrow(lead, 0, k)
        if k < kz:
            idx[lead] = slice(0, kz - k)
            target[tuple(idx)] += g.narrow(lead, k, kz - k)
    else:
        idx[lead] = slice(start, start + s * (kz - 1) + 1, s)
        target[tuple(idx)] += g


def accumulate_matrix(space, A_grid, Ke, z0):
    """Add one chunk of element blocks into the stencil node grid, in
    place.

    Args:
      A_grid: (N_rev..., K, dof, dof) accumulator.
      Ke: (B, nen, nen, dof, dof) element blocks, B = whole slabs of the
        slowest axis starting at slab index z0.
      z0: starting slab index along the slowest axis.

    Returns ``A_grid``.
    """
    dim, dof, nen = space.dim, space.dof, space.nen
    locs = space._local_index
    bbox_rev = tuple(space.nen_shape[::-1])
    KeG = Ke.reshape(_chunk_rev(space, Ke.shape[0]) + (nen,) + bbox_rev + (dof, dof))
    # view the accumulator with the slot axis unflattened (reversed box)
    sbox_rev = tuple(2 * p + 1 for p in space.degrees)[::-1]
    Agv = A_grid.view(A_grid.shape[:dim] + sbox_rev + (dof, dof))
    for a in range(nen):
        a_multi = [int(locs[d][a]) for d in range(dim)]
        g = KeG[(Ellipsis, a) + (slice(None),) * (dim + 2)]
        sub = Agv[(slice(None),) * dim + _slot_box(space, a_multi)]
        _place(space, sub, g, a_multi, z0)
    return A_grid


def accumulate_matrix_dyn(space, A_grid, Ke, z0):
    """:func:`accumulate_matrix` on an open (non-wrapping) slow axis."""
    if space.periodic[-1]:
        raise ValueError("dynamic accumulation requires an open slow axis")
    return accumulate_matrix(space, A_grid, Ke, z0)


def accumulate_matrix_dyn_planes(space, P, Ke, z0):
    """Slot-major shift accumulation: the plane-direct counterpart of
    :func:`accumulate_matrix_dyn`, writing in place straight into the
    kernel's flat layout, so large operators are never stored node-major
    at all.

    Args:
      P: (K·dof², nnodes) accumulator — the planes of a
        :class:`~petiga_tpu_torch.sparse.spmv.StencilOperator` on open
        axes (plane index ``(s·dof + a)·dof + b``).
      Ke: (B, nen, nen, dof, dof) element blocks — whole slabs of the
        slowest axis starting at slab index ``z0``.

    Open, unit-step axes only (enforced by the caller).  Returns ``P``.
    """
    dim, dof, nen = space.dim, space.dof, space.nen
    locs = space._local_index
    sbox_rev = tuple(2 * p + 1 for p in space.degrees)[::-1]
    bbox_rev = tuple(space.nen_shape[::-1])
    chunk_rev = _chunk_rev(space, Ke.shape[0])
    nsp = len(chunk_rev)
    Pv = P.view(sbox_rev + (dof, dof) + tuple(space.node_shape[::-1]))
    KeG = Ke.reshape(chunk_rev + (nen,) + bbox_rev + (dof, dof))
    # -> (nen_a, bbox_rev..., dof, dof, chunk_rev...)
    KeG = KeG.permute(tuple(range(nsp, nsp + 1 + dim + 2)) + tuple(range(nsp)))
    for a in range(nen):
        a_multi = [int(locs[d][a]) for d in range(dim)]
        _place(space, Pv[_slot_box(space, a_multi)], KeG[a], a_multi, z0, lead=dim + 2)
    return P


def accumulate_vector(space, b_grid, Fe, z0):
    """Same shift placement for element load vectors, in place.

    b_grid: (N_rev..., dof); Fe: (B, nen, dof).  Returns ``b_grid``."""
    dim, nen = space.dim, space.nen
    locs = space._local_index
    FeG = Fe.reshape(_chunk_rev(space, Fe.shape[0]) + (nen, space.dof))
    for a in range(nen):
        a_multi = [int(locs[d][a]) for d in range(dim)]
        _place(space, b_grid, FeG[..., a, :], a_multi, z0)
    return b_grid


def accumulate_vector_dyn(space, b_grid, Fe, z0):
    """:func:`accumulate_vector` on an open (non-wrapping) slow axis."""
    if space.periodic[-1]:
        raise ValueError("dynamic accumulation requires an open slow axis")
    return accumulate_vector(space, b_grid, Fe, z0)


def accumulate_box(space, ebox, Ke=None, Fe=None, z0: int = 0, Gm=None, Gv=None):
    """Shift-accumulate the element blocks of a regular element SUB-BOX
    into box-local grids (the conv engine's generic boxes and a
    distributed rank's owned elements): ``nen`` static slice adds per
    chunk, like the whole-grid path.

    Args:
      ebox: full box extents (e_0..e_{dim-1}).
      Ke: (B, nen, nen, dof, dof) or None; Fe: (B, nen, dof) or None,
        with B = kz·prod(ebox[:-1]) covering slabs [z0, z0+kz) of the
        box's slowest axis, axis-0 fastest.
      Gm/Gv: accumulators on the box-extended node grid from an earlier
        chunk, added to in place; allocated when None.

    Returns ``(Gm, Gv)``: ``((ebox_d - 1 + nen_d)_rev..., K, dof, dof)``
    and ``(..., dof)`` on the box-extended node grid (None for an absent
    input).  Unit element step only; the caller places the result.
    """
    dim, dof, nen = space.dim, space.dof, space.nen
    nshape = space.nen_shape
    locs = space._local_index
    E = Ke if Ke is not None else Fe
    next_rev = tuple(ebox[d] - 1 + nshape[d] for d in range(dim))[::-1]
    sbox_rev = tuple(2 * p + 1 for p in space.degrees)[::-1]
    kz = E.shape[0] // int(np.prod(ebox[:-1])) if dim > 1 else E.shape[0]
    chunk_rev = (kz,) + tuple(ebox[:-1][::-1])
    opts = dict(dtype=E.dtype, device=E.device)
    if Ke is not None:
        KeG = Ke.reshape(chunk_rev + (nen,) + tuple(nshape[::-1]) + (dof, dof))
        shape = next_rev + sbox_rev + (dof, dof)
        Gm = torch.zeros(shape, **opts) if Gm is None else Gm.view(shape)
    if Fe is not None:
        FeG = Fe.reshape(chunk_rev + (nen, dof))
        if Gv is None:
            Gv = torch.zeros(next_rev + (dof,), **opts)
    for a in range(nen):
        am = [int(locs[d][a]) for d in range(dim)]
        gsl = tuple(
            slice(am[dim - 1 - g] + (z0 if g == 0 else 0),
                  am[dim - 1 - g] + (z0 if g == 0 else 0) + chunk_rev[g])
            for g in range(dim)
        )
        if Ke is not None:
            Gm[gsl + _slot_box(space, am)] += KeG[(Ellipsis, a) + (slice(None),) * (dim + 2)]
        if Fe is not None:
            Gv[gsl] += FeG[..., a, :]
    if Gm is not None:
        Gm = Gm.reshape(next_rev + (int(np.prod(sbox_rev)), dof, dof))
    return Gm, Gv
