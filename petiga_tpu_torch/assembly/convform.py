"""Coefficient-form plane assembly, constant-coefficient route (port of
:mod:`petiga_tpu.assembly.convform`).

A second-order bilinear form ``K_ab = Σ_q w_q Σ_ij C_ij D_i N_a D_j N_b``
with spatially constant channels ``C_ij`` on the identity map factorizes
EXACTLY over the axes: the dim-D stencil planes are sums of per-axis
outer products of assembled 1-D stencil matrices,

    planes[s] = Σ_ch C_ch · Π_d A_d^{(o_i, o_j)}[n_d, s_d],

so the matrix is written at store speed, straight into the kernel's
slot-major layout (:class:`~petiga_tpu_torch.sparse.spmv.StencilOperator`),
in chunks of the slowest axis — never a second copy of the planes.  The
load vector ``b_a = ∫ f N_a`` is sum-factorized on the fine quadrature
grid, ``b = Bᵀ(w·f)`` with the per-axis basis matrices ``B_d``, in
chunks of the slowest axis.

The variable-coefficient convolution, state ``fields``, periodic axes,
second-derivative channels and dof > 1 are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import fastpath
from .assemble import dirichlet_post_fix, stencil_of
from ..sparse.spmv import StencilOperator

__all__ = [
    "poisson_coefficients",
    "assemble_coefficient_planes",
    "assemble_load_vector",
]

# Byte budgets of one slowest-axis chunk: the per-channel plane temporaries
# of the outer-product write, and the fine-quadrature-grid temporaries of
# the load vector and the error functional.  The chunk counts follow from
# the sizes, so the full 256³ system is never held twice.
_CHUNK_BYTES = 2**26
_FINE_CHUNK_BYTES = 2**28


def poisson_coefficients(x, ctx):
    """Reaction–diffusion channels ``c u v + k grad(u).grad(v)``."""
    ctx = ctx or {}
    c = ctx.get("c", 0.0)
    k = ctx.get("k", 1.0)
    dim = x.shape[-1]
    ch = {(i + 1, i + 1): k for i in range(dim)}
    if not isinstance(c, (int, float)) or c != 0.0:
        ch[(0, 0)] = c
    return ch


def _chan_orders(idx, dim):
    """Per-axis derivative orders of a channel index: ``0`` = value,
    ``i`` = d/dx_{i-1}."""
    return tuple(int(idx == d + 1) for d in range(dim))


# -------------------------------------------------------- per-axis tables


def _axis_factor_mats(space, dtype):
    """Per-axis assembled 1-D stencil factor matrices ``A[d][da][db]`` of
    shape (N_d, 2p_d+1): the exact 1-D Galerkin integrals
    ``∫ D^{da} N_r D^{db} N_{r+s-p}`` accumulated over elements (periodic
    rows wrap)."""
    out = []
    for d in range(space.dim):
        t = space.tabs[d]
        N = space.node_shape[d]
        p = t.p
        sK = 2 * p + 1
        w = np.asarray(t.weight * t.detJac[:, None])  # (nel, q)
        V = np.asarray(t.value[:, :, :3, :])  # (nel, q, 3, p+1)
        off = np.asarray(t.offset)
        rows = off[:, None] + np.arange(p + 1)[None, :]  # (nel, p+1)
        if space.periodic[d]:
            rows = rows % N
        slot = (np.arange(p + 1)[None, :] - np.arange(p + 1)[:, None]
                + p)  # (a, b) -> b - a + p
        ridx = np.broadcast_to(rows[:, :, None], (t.nel, p + 1, p + 1))
        sidx = np.broadcast_to(slot[None], (t.nel, p + 1, p + 1))
        mats = [[None] * 3 for _ in range(3)]
        for da in (0, 1, 2):
            for db in (0, 1, 2):
                M = np.einsum(
                    "eq,eqa,eqb->eab", w, V[:, :, da, :], V[:, :, db, :]
                )
                A = np.zeros((N, sK))
                np.add.at(A, (ridx, sidx), M)
                mats[da][db] = torch.as_tensor(A, dtype=dtype, device=space.device)
        out.append(mats)
    return out


def _fine_basis_mats(space, dtype):
    """Per-axis dense (F_d, N_d) basis value/derivative matrices on the
    fine quadrature grid (F_d = nel_d·nq_d rows, p+1 nonzeros per row)."""
    mats = []
    for d in range(space.dim):
        t = space.tabs[d]
        N = space.node_shape[d]
        Bs = [np.zeros((t.nel * t.nqp, N)) for _ in range(3)]
        for e in range(t.nel):
            o = int(t.offset[e])
            cols = np.arange(o, o + t.p + 1)
            if space.periodic[d]:
                cols = cols % N
            for k in range(3):
                Bs[k][e * t.nqp:(e + 1) * t.nqp, cols] = t.value[e, :, k, :]
        mats.append(
            tuple(torch.as_tensor(B, dtype=dtype, device=space.device) for B in Bs)
        )
    return mats


def _fine_points(space, z0, z1):
    """(z1-z0, F_{dim-2}, ..., F_0, dim) physical points of fine rows
    [z0, z1) of the slowest axis (identity map)."""
    dim = space.dim
    xs = [
        torch.as_tensor(space.tabs[d].point.reshape(-1), dtype=space.dtype,
                        device=space.device)
        for d in range(dim)
    ]
    xs[dim - 1] = xs[dim - 1][z0:z1]
    grids = torch.meshgrid(*xs[::-1], indexing="ij")  # reversed-axis grid
    return torch.stack(grids[::-1], dim=-1)


def _fine_weights(space, z0, z1):
    """Quadrature weights × det-Jacobians on fine rows [z0, z1) of the
    slowest axis, reversed-axis grid."""
    dim = space.dim
    w = None
    for g in range(dim):
        t = space.tabs[dim - 1 - g]
        wd = torch.as_tensor((t.weight * t.detJac[:, None]).reshape(-1),
                             dtype=space.dtype, device=space.device)
        if g == 0:
            wd = wd[z0:z1]
        w = wd if w is None else w[..., None] * wd
    return w


# ----------------------------------------------------------- entry points


def _check_space(space, symmetric):
    if not fastpath.is_unit_step(space):
        raise ValueError("conv assembly requires a regular unit-step space")
    if symmetric and any(space.periodic):
        raise ValueError("symmetric conv assembly requires open axes")
    if any(space.periodic):
        raise NotImplementedError("periodic conv assembly (ROADMAP Queue 1 item 8.3)")
    if space.dof != 1:
        raise NotImplementedError("conv assembly for dof > 1 (ROADMAP Queue 1 item 8)")


def assemble_load_vector(space, forcing: Callable, ctx=None):
    """Load vector ``b_a = ∫ f N_a`` (no Dirichlet elimination) on the
    identity map, dof = 1: ``b = Bᵀ(w·f)`` on the fine quadrature grid,
    sum-factorized one axis at a time, in chunks of the slowest axis.
    ``forcing(x, ctx)`` takes points ``(..., dim)``.  Returns (nnodes, 1)."""
    _check_space(space, False)
    dim = space.dim
    B = [m[0] for m in _fine_basis_mats(space, space.dtype)]  # (F_d, N_d)
    F_rev = [B[dim - 1 - g].shape[0] for g in range(dim)]
    per_row = math.prod(F_rev[1:]) * (dim + 3)
    itemsize = torch.empty((), dtype=space.dtype).element_size()
    cz = max(1, min(F_rev[0], _FINE_CHUNK_BYTES // (per_row * itemsize)))
    bg = torch.zeros(tuple(space.node_shape[::-1]), dtype=space.dtype,
                     device=space.device)
    for z0 in range(0, F_rev[0], cz):
        z1 = min(z0 + cz, F_rev[0])
        X = _fine_points(space, z0, z1)
        f = torch.broadcast_to(
            torch.as_tensor(forcing(X, ctx), dtype=space.dtype, device=space.device),
            X.shape[:-1],
        )
        g_ = f * _fine_weights(space, z0, z1)
        for g in range(dim - 1, -1, -1):  # fast axes first: fine -> nodes
            Bd = B[dim - 1 - g]
            if g == 0:
                Bd = Bd[z0:z1]
            g_ = torch.movedim(torch.tensordot(Bd, g_, dims=([0], [g])), 0, g)
        bg += g_
    return bg.reshape(space.nnodes, 1)


def _outer_planes(space, chlist, chv, slots):
    """(len(slots), next) planes: the channel-weighted outer products of
    the per-axis factor rows, written in chunks of the slowest axis
    straight into one preallocated tensor.

    The arithmetic follows the reference operation for operation
    (``((f_z·f_y)·f_x)`` per channel, times the channel value, channels
    summed in ``chlist`` order, all in ``space.dtype``), so f32 planes are
    rounded exactly as the reference rounds them.  That matters: interior
    rows share one stencil, so its rounding acts as one systematic
    perturbation of every row."""
    dim = space.dim
    dt = space.dtype
    p = space.degrees
    N_rev = tuple(space.node_shape[::-1])
    Keff = len(slots)
    facs = _axis_factor_mats(space, dt)
    # per-axis slot components of the selected slots (axis-0 fastest)
    scomp = []
    rem = np.asarray(slots)
    for d in range(dim):
        sKd = 2 * p[d] + 1
        scomp.append(torch.as_tensor(rem % sKd, device=space.device))
        rem = rem // sKd
    chans = []
    for (i, j) in chlist:
        oi, oj = _chan_orders(i, dim), _chan_orders(j, dim)
        # per grid axis g (spatial axis dim-1-g): (Keff, N_rev[g]) rows
        rows = [
            facs[d][oi[d]][oj[d]][:, scomp[d]].T
            for d in (dim - 1 - g for g in range(dim))
        ]
        val = torch.as_tensor(chv[(i, j)], dtype=dt, device=space.device)
        chans.append((val, rows))

    P = torch.empty((Keff, math.prod(N_rev)), dtype=dt, device=space.device)
    Pg = P.view((Keff,) + N_rev)
    layer = Keff * math.prod(N_rev[1:]) * P.element_size()
    zc = max(1, min(N_rev[0], _CHUNK_BYTES // layer))
    term = None
    for z0 in range(0, N_rev[0], zc):
        z1 = min(z0 + zc, N_rev[0])
        blk = Pg[:, z0:z1]
        for ci, (val, rows) in enumerate(chans):
            out = blk if ci == 0 else term
            if out is None or out.shape != blk.shape:
                out = term = torch.empty(blk.shape, dtype=dt, device=space.device)
            t0 = rows[0][:, z0:z1]
            for g in range(1, dim):
                shape = (Keff,) + (1,) * g + (N_rev[g],)
                if g < dim - 1:
                    t0 = t0[..., None] * rows[g].reshape(shape)
                else:
                    torch.mul(t0[..., None], rows[g].reshape(shape), out=out)
            if dim == 1:
                out.copy_(t0)
            out.mul_(val)
            if ci > 0:
                blk.add_(out)
    return P


def assemble_coefficient_planes(
    space,
    coef: Callable,
    ctx=None,
    *,
    forcing: Optional[Callable] = None,
    symmetric: bool = False,
    apply_fix: bool = True,
    fields: Optional[dict] = None,
):
    """Assemble the system of a constant-coefficient bilinear form
    straight into kernel planes; returns ``(op, b)`` with ``op`` a
    :class:`StencilOperator` (kind ``"sym"`` when ``symmetric``: only the
    ``Ku = (K+1)/2`` upper slots are built and stored) and ``b`` the
    (nnodes, 1) load vector, Dirichlet-fixed when ``apply_fix``.

    ``coef(x, ctx) -> {(i, j): value}`` with ``i, j in 0..dim`` (0 =
    value channel, ``i`` = d/dx_{i-1}); every value must be a scalar."""
    if fields is not None:
        raise NotImplementedError("field coefficients (ROADMAP Queue 1 item 8.4)")
    _check_space(space, symmetric)
    st = stencil_of(space)
    dim = space.dim
    probe = coef(torch.zeros((1, dim), dtype=space.dtype, device=space.device), ctx)
    for (i, j), v in probe.items():
        if isinstance(i, tuple) or isinstance(j, tuple):
            raise NotImplementedError(
                "second-derivative channels (ROADMAP Queue 1 item 8.3)"
            )
        if np.ndim(v) != 0:
            raise NotImplementedError(
                "variable-coefficient conv assembly (ROADMAP Queue 1 item 8.2)"
            )
    chlist = sorted(probe)  # the reference's channel order: value first
    slots = tuple(range(st.diag_slot, st.K)) if symmetric else tuple(range(st.K))
    P = _outer_planes(space, chlist, probe, slots)
    if symmetric:
        op = StencilOperator.from_planes_symmetric(st, P)
    else:
        op = StencilOperator.from_planes(st, P)
    if forcing is not None:
        b = assemble_load_vector(space, forcing, ctx)
    else:
        b = torch.zeros((st.nnodes, 1), dtype=space.dtype, device=space.device)
    if apply_fix:
        op, b = dirichlet_post_fix(space, op, b)
    return op, b
