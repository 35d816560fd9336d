"""Coefficient-form assembly: the generic assembly engine as
convolutions (port of :mod:`petiga_tpu.assembly.convform`).

A second-order bilinear form ``K_ab = Σ_q w_q Σ_ij C_ij(x_q) D_i N_a D_j
N_b`` (channels ``(i, j)``: 0 = value, ``i`` = d/dx_{i-1}, or a tuple
``(d1, d2)`` for the second derivative ∂²/∂x_{d1}∂x_{d2}) is assembled
straight into the kernel's slot-major planes
(:class:`~petiga_tpu_torch.sparse.spmv.StencilOperator`) by one of two
routes:

* spatially constant channels factorize EXACTLY over the axes: the
  planes are sums of per-axis outer products of assembled 1-D stencil
  matrices, ``planes[s] = Σ_ch C_ch · Π_d A_d^{(o_i, o_j)}[n_d, s_d]``,
  written at store speed in chunks of the slowest axis;
* variable channels — functions of the point, or of state ``fields``
  evaluated sum-factorized on the fine quadrature grid — become one
  convolution over the element grid per box of elements that share one
  basis-table type: ``planes[n, s] = Σ_a Σ_k W[n - a, k] Kc[k, a, s]``
  with ``W[e, (q, ch)] = C_ch(x_{e,q})`` and ``Kc`` a static
  ``(p+1)^dim``-tap kernel built from the 1-D tables, computed as one
  GEMM per tap (cuBLAS on the card, TF32 off; see :func:`_conv`).  Open knot vectors give at most ``3^dim`` such boxes
  (the interior block, faces, edges, corners); boxes under ``conv_min``
  elements take the generic quadrature path with box-local shift
  accumulation.  Periodic unit-step axes have one box, and its node
  window's overhang folds back circularly into the interior of the
  extended plane layout (whose periodic halo columns stay zero).

:func:`assemble_residual_conv` is the same machinery for nonlinear
residuals with derivative TEST channels, ``R_a = Σ_α ∫ D^α N_a f_α``.
The load vector ``b_a = ∫ f N_a`` is sum-factorized on the fine
quadrature grid, ``b = Bᵀ(w·f)``, open or periodic.

The port caches only static tables per space (conv kernels, fine basis
matrices, geometry grids, box lists), never anything that depends on
``ctx`` or on the field values.  dof > 1 operators take ``(dof, dof)``
channel blocks: each block entry ``(r, c)`` is its own set of planes,
written or convolved from the channels whose block reaches it.

Mapped geometry and rational (NURBS) weights (``nsd == dim``, order-1
channels) keep the conv kernels parametric: the geometry and the weight
field are evaluated sum-factorized on the fine grid, and the spatial
channels are pulled back per point, ``C̃_kl = detX Σ_ij S_ik C_ij S_jl``,
with ``S`` the structurally sparse map from the plain basis' parametric
derivatives to the stored basis' spatial ones (inverse-map pullback and
rationalization, :func:`_S_components`).  The conv result of the plain
basis is conjugated by the node weights (``A = D_w Ã D_w``); the generic
boxes tabulate the mapped rational basis directly.  Under a map the load
vector of :func:`assemble_coefficient_planes` carries ``detX / W`` and
the node weights the same way (:func:`_load_vector`); the standalone
:func:`assemble_load_vector` and :func:`assemble_residual_conv` stay on
the identity map, as the reference's do.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import fastpath
from .assemble import _add_flux, _make_element_KF, dirichlet_post_fix, stencil_of
from .tabulation import det_small, inv_small, tabulate_elements
from ..sparse.spmv import StencilOperator, ext_shape
from ..utils import profiling

__all__ = [
    "coefficient_pointwise_form",
    "poisson_coefficients",
    "assemble_coefficient_planes",
    "assemble_load_vector",
    "assemble_residual_conv",
]

# Byte budgets of one slowest-axis chunk: the per-channel plane temporaries
# of the outer-product write, the fine-quadrature-grid temporaries of the
# load vector and the error functional, and the conv input (point
# coordinates, field values, coefficient channels and their conv layout).
# The chunk counts follow from the sizes, so the full 256³ system is never
# held twice.
_CHUNK_BYTES = 2**26
_FINE_CHUNK_BYTES = 2**28
_CONV_CHUNK_BYTES = 2**31
# Elements per generic (edge/corner) box.
_SHELL_CHUNK = 32768


# ------------------------------------------------------------ coefficient API


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
    ``i`` = d/dx_{i-1}, a tuple of axis ids = the mixed derivative over
    those axes."""
    o = [0] * dim
    if isinstance(idx, tuple):
        for d in idx:
            o[d] += 1
    elif idx > 0:
        o[idx - 1] = 1
    return tuple(o)


def _chan_total(idx):
    return len(idx) if isinstance(idx, tuple) else (0 if idx == 0 else 1)


def _one_key(i):
    return (_chan_total(i), i if isinstance(i, tuple) else (i,))


def _chan_key(ij):
    """Deterministic sort key over mixed int/tuple channel indices."""
    return (_one_key(ij[0]), _one_key(ij[1]))


def _check_idx(idx, dim):
    if isinstance(idx, tuple):
        return len(idx) <= 2 and all(0 <= d < dim for d in idx)
    return 0 <= idx <= dim


def _chan_D(shape, idx):
    """Basis factor of a channel index from the tabulated shape leaves
    ``shape = (N, dN, d²N, ...)`` (leading axes (…, Q, nen))."""
    if isinstance(idx, tuple):
        d1, d2 = idx
        return shape[2][..., d1, d2]
    if idx == 0:
        return shape[0]
    return shape[1][..., idx - 1]


def _value_shape(v):
    return tuple(v.shape) if torch.is_tensor(v) else np.shape(v)


def _as(v, dtype, device):
    if torch.is_tensor(v):
        return v.to(dtype)
    return torch.tensor(v, dtype=dtype, device=device)


def coefficient_pointwise_form(coef: Callable, forcing: Optional[Callable] = None):
    """The pointwise q-batched form equivalent to a coefficient spec:
    ``K_ab = Σ_q w_q Σ_ij C_ij D_i N_a D_j N_b`` (and the load ``F_a =
    Σ_q w_q f N_a`` with ``forcing(x, ctx) -> f``), for
    :func:`~petiga_tpu_torch.assembly.assemble.assemble_system` and
    friends.  A channel value with two or more axes is a ``(dof, dof)``
    block (trailing axes), and the form is then the dof > 1 block form
    ``K[(a,r),(b,c)] = Σ_q w_q Σ_ij C_ij[r,c] D_i N_a D_j N_b`` with a
    ``(…, dof)`` forcing."""

    def form(pt, w, ctx):
        X = pt.x  # (Q, nsd)
        dt = pt.shape0.dtype
        nen = pt.shape0.shape[-1]
        shapes = (pt.shape0, pt.shape1, pt.shape2)
        ch = coef(X, ctx)
        dof = next((int(_value_shape(c)[-1]) for c in ch.values()
                    if len(_value_shape(c)) >= 2), 1)
        K = None
        for (i, j), c in ch.items():
            Di, Dj = _chan_D(shapes, i), _chan_D(shapes, j)
            if dof == 1:
                wc = w * torch.broadcast_to(_as(c, dt, w.device), w.shape)
                term = torch.einsum("q,qa,qb->ab", wc, Di, Dj)
            else:
                C = torch.broadcast_to(_as(c, dt, w.device), w.shape + (dof, dof))
                term = torch.einsum("q,qrc,qa,qb->arbc", w, C, Di, Dj)
            K = term if K is None else K + term
        if dof > 1:
            K = K.reshape(nen * dof, nen * dof)
        if forcing is None:
            Fv = torch.zeros(nen * dof, dtype=dt, device=w.device)
        elif dof == 1:
            f = torch.broadcast_to(_as(forcing(X, ctx), dt, w.device), w.shape)
            Fv = torch.einsum("q,qa->a", w * f, pt.shape0)
        else:
            f = torch.broadcast_to(_as(forcing(X, ctx), dt, w.device), w.shape + (dof,))
            Fv = torch.einsum("q,qr,qa->ar", w, f, pt.shape0).reshape(nen * dof)
        return K, Fv

    form.qbatched = True
    return form


# ------------------------------------------------------------- static tables


def _cached(space, key, build):
    """Static per-space table under ``key`` in the space's tensor cache
    (cleared with it when the space's boundary data change)."""
    cache = space._tensor_cache
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _axis_interior_run(t):
    """Longest contiguous run of elements sharing the modal (interior)
    1-D basis table on one axis -> (lo, hi).  Boundary-layer elements of
    an open knot vector have modified basis values and fall outside;
    interior rows differ only by evaluation jitter (~1e-15 relative)."""
    nel = t.nel
    rows = np.concatenate(
        [t.value[:, :, :2, :].reshape(nel, -1), t.weight, t.detJac[:, None]], axis=1
    )
    scale = np.max(np.abs(rows)) or 1.0
    mid = rows[nel // 2]  # middle element: interior whenever one exists
    close = np.all(np.abs(rows - mid) <= 1e-8 * scale, axis=1)
    best = (0, 0)
    i = 0
    while i < nel:
        if close[i]:
            j = i
            while j < nel and close[j]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        else:
            i += 1
    return best


def _axis_options(space):
    """Per-axis block options: the interior run plus one single-element
    layer per boundary element, as (start, stop, representative)."""
    opts = []
    for t in space.tabs:
        lo, hi = _axis_interior_run(t)
        o = [(lo, hi, lo)] if hi > lo else []
        o += [(l, l + 1, l) for l in range(0, lo)]
        o += [(l, l + 1, l) for l in range(hi, t.nel)]
        opts.append(o)
    return opts


def _combo_boxes(space):
    """All type-combo boxes (blo, bext, reps) covering the element grid
    disjointly: each box shares one basis-table type per axis."""
    out = []
    for sel in itertools.product(*_axis_options(space)):
        bext = tuple(s[1] - s[0] for s in sel)
        if all(e > 0 for e in bext):
            out.append((tuple(s[0] for s in sel), bext, tuple(s[2] for s in sel)))
    return out


def _split_box(lo, ext, max_elems):
    """Split a box along its largest axis until each part has at most
    ``max_elems`` elements."""
    vol = int(np.prod(ext))
    if vol <= max_elems:
        return [(tuple(lo), tuple(ext))]
    d = int(np.argmax(ext))
    nparts = min(-(-vol // max_elems), ext[d])
    step = -(-ext[d] // nparts)
    out = []
    s = 0
    while s < ext[d]:
        e = min(step, ext[d] - s)
        nlo, nex = list(lo), list(ext)
        nlo[d] += s
        nex[d] = e
        out.extend(_split_box(nlo, nex, max_elems))
        s += e
    return out


def _box_ids(space, lo, ext):
    """Flat element ids (axis-0 fastest) of a box, in box-grid order, on
    the space's device."""
    eshape = space.elem_shape
    dim = len(eshape)
    idx = np.meshgrid(*[np.arange(lo[d], lo[d] + ext[d]) for d in range(dim)][::-1],
                      indexing="ij")[::-1]
    flat = np.zeros(tuple(np.array(ext)[::-1]), dtype=np.int64)
    stride = 1
    for d in range(dim):
        flat = flat + idx[d] * stride
        stride *= eshape[d]
    return torch.as_tensor(flat.reshape(-1), device=space.device)


def _boxes(space, conv_min):
    """(conv boxes, generic boxes): combo boxes of at least ``conv_min``
    elements convolve; the rest are split into generic boxes."""
    def build():
        conv, gen = [], []
        for blo, bext, reps in _combo_boxes(space):
            if int(np.prod(bext)) >= conv_min:
                conv.append((blo, bext, reps))
            else:
                gen.extend(_split_box(blo, bext, _SHELL_CHUNK))
        return conv, gen

    return _cached(space, ("conv_boxes", conv_min), build)


def _box_node_slices(space, lo, ext):
    """Node region [lo, lo + ext + p) per axis, grid (reversed) order."""
    dim = space.dim
    nshape = space.nen_shape
    return tuple(
        slice(lo[dim - 1 - g], lo[dim - 1 - g] + ext[dim - 1 - g] + nshape[dim - 1 - g] - 1)
        for g in range(dim)
    )


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
    fine quadrature grid (F_d = nel_d·nq_d rows, p+1 nonzeros per row;
    periodic columns wrap)."""
    def build():
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
            mats.append(tuple(torch.as_tensor(B, dtype=dtype, device=space.device)
                              for B in Bs))
        return mats

    return _cached(space, ("fine_basis_mats", dtype), build)


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


def _kernel_factors(space, reps):
    """Per axis (nq_d, NDER, nen_d) tables ``w·detJac·D^k N`` of the
    representative elements ``reps[d]`` (the per-axis quadrature weights
    ride in the kernel, so W carries only the pointwise coefficients)."""
    out = []
    for d in range(space.dim):
        t = space.tabs[d]
        lo = reps[d]
        wd = t.weight[lo] * t.detJac[lo]  # (nq,)
        out.append((t.value[lo, :, :3, :], wd))
    return out


def _conv_kernel(space, chlist, dtype, reps, slots):
    """Static conv weight ``(Keff, Q·nch, taps_rev...)`` from the 1-D
    tables of the representative elements ``reps[d]``: input channel
    ``q·nch + ch`` (q-major, matching :func:`_space_to_depth`), output
    channel = slot, taps pre-flipped because :func:`_conv` correlates
    (the reference's layout for ``lax.conv_general_dilated``)."""
    def build():
        dim = space.dim
        p = space.degrees
        nq = [space.tabs[d].nqp for d in range(dim)]
        nen_d = [p[d] + 1 for d in range(dim)]
        sK = [2 * p[d] + 1 for d in range(dim)]
        G = []
        for d, (V, wd) in enumerate(_kernel_factors(space, reps)):
            g = np.zeros((3, 3, nq[d], nen_d[d], sK[d]))
            for a in range(nen_d[d]):
                for s in range(sK[d]):
                    b = a + s - p[d]
                    if 0 <= b <= p[d]:
                        for da in range(3):
                            for db in range(3):
                                g[da, db, :, a, s] = V[:, da, a] * V[:, db, b] * wd
            G.append(g)
        kers = []
        for (i, j) in chlist:
            oi, oj = _chan_orders(i, dim), _chan_orders(j, dim)
            k = np.ones(tuple(nq[::-1]) + tuple(nen_d[::-1]) + tuple(sK[::-1]))
            for d in range(dim):
                sh = [1] * (3 * dim)
                gi = dim - 1 - d
                sh[gi], sh[dim + gi], sh[2 * dim + gi] = nq[d], nen_d[d], sK[d]
                k = k * G[d][oi[d], oj[d]].reshape(sh)
            kers.append(k)
        ker = np.stack(kers)  # (nch, q_rev..., a_rev..., s_rev...)
        Q, K = int(np.prod(nq)), int(np.prod(sK))
        ker = np.moveaxis(ker, 0, dim).reshape((Q * len(chlist),) + tuple(nen_d[::-1]) + (K,))
        ker = np.flip(ker, axis=tuple(range(1, 1 + dim)))  # correlation -> convolution
        ker = np.moveaxis(ker[..., list(slots)], -1, 0)  # (Keff, Q·nch, taps_rev...)
        return torch.as_tensor(np.ascontiguousarray(ker), dtype=dtype, device=space.device)

    return _cached(space, ("conv_kernel", tuple(chlist), dtype, reps, tuple(slots)), build)


def _test_kernel(space, dtype, reps, chans):
    """Stacked residual (test-side) weight ``(1, Q·nch, taps_rev...)``:
    per channel α the per-axis product of ``w·detJac·D^{α_d}N`` tables of
    the representative elements ``reps``; q-major, channel-minor."""
    def build():
        dim = space.dim
        p = space.degrees
        nq = [space.tabs[d].nqp for d in range(dim)]
        nen_d = [p[d] + 1 for d in range(dim)]
        Q = int(np.prod(nq))
        fac = _kernel_factors(space, reps)
        ks = []
        for idx in chans:
            ders = _chan_orders(idx, dim)
            k = np.ones(tuple(nq[::-1]) + tuple(nen_d[::-1]))
            for d, (V, wd) in enumerate(fac):
                sh = [1] * (2 * dim)
                gi = dim - 1 - d
                sh[gi], sh[dim + gi] = nq[d], nen_d[d]
                k = k * (V[:, ders[d], :] * wd[:, None]).reshape(sh)
            ks.append(k.reshape((Q, 1) + tuple(nen_d[::-1])))
        k = np.concatenate(ks, axis=1).reshape((1, Q * len(chans)) + tuple(nen_d[::-1]))
        k = np.flip(k, axis=tuple(range(2, 2 + dim)))
        return torch.as_tensor(np.ascontiguousarray(k), dtype=dtype, device=space.device)

    return _cached(space, ("test_kernel", tuple(chans), dtype, reps), build)


# ------------------------------------------------------ fine-grid evaluation


def _fine_X(space, blo, bext):
    """Quadrature-point coordinates of an element box on the fine tensor
    grid (per-axis flat index ``e·nq + q``): shape (f_rev..., dim)."""
    dim = space.dim
    xs = []
    for d in range(dim):
        t = space.tabs[d]
        a = torch.as_tensor(t.point.reshape(-1), dtype=space.dtype, device=space.device)
        xs.append(a[blo[d] * t.nqp:(blo[d] + bext[d]) * t.nqp])
    grids = torch.meshgrid(*xs[::-1], indexing="ij")
    return torch.stack(grids[::-1], dim=-1)


def _fine_field(space, mats, ders, G, blo, bext):
    """A node-grid field ``G (N_rev...)`` on a box's fine grid with
    per-axis derivative orders ``ders``: (f_rev...), sum-factorized one
    axis at a time, the slowest first."""
    dim = space.dim
    out = G
    for d in range(dim - 1, -1, -1):
        nq = space.tabs[d].nqp
        Bd = mats[d][ders[d]][blo[d] * nq:(blo[d] + bext[d]) * nq]
        g = dim - 1 - d
        out = torch.movedim(torch.tensordot(Bd, out, dims=([1], [g])), 0, g)
    return out


def _geometry_grids(space):
    """``(Gg, wg)``: the control points on the node grid ``(N_rev..., nsd)``
    — projective (times the weights) on rational spaces — or None on the
    identity map, and the weights ``(N_rev...)`` or None."""
    def build():
        N_rev = tuple(space.node_shape[::-1])
        W = space.rational
        Gg = wg = None
        if W is not None:
            wg = torch.as_tensor(W.reshape(N_rev), dtype=space.dtype, device=space.device)
        if space.has_geometry:
            X = space.geometry if W is None else space.geometry * W[:, None]
            Gg = torch.as_tensor(X.reshape(N_rev + (space.nsd,)), dtype=space.dtype,
                                 device=space.device)
        return Gg, wg

    return _cached(space, "geometry_grids", build)


def _unit(dim, *axes):
    """Per-axis derivative orders of the derivative along ``axes``."""
    return tuple(sum(1 for a in axes if a == d) for d in range(dim))


def _fine_geometry(space, blo, bext):
    """Geometry of a box on its fine grid: ``(X, J, W0, dW)`` with the
    physical points ``X (f_rev..., dim)``, the Jacobian ``J[..., i, d] =
    dx_i/du_d`` (None on the identity map) and, on rational spaces, the
    weight field ``W0 (f_rev...)`` and its parametric gradient ``dW
    (f_rev..., dim)`` (else None).  A mapped rational map is the quotient
    ``A/W`` of the projective map ``A``: ``dX = (dA·W - A·dW)/W²``."""
    dim = space.dim
    mats = _fine_basis_mats(space, space.dtype)
    Gg, wg = _geometry_grids(space)

    def field(G, *axes):
        return _fine_field(space, mats, _unit(dim, *axes), G, blo, bext)

    W0 = dW = None
    if wg is not None:
        W0 = field(wg)
        dW = torch.stack([field(wg, d) for d in range(dim)], dim=-1)
    if Gg is None:
        return _fine_X(space, blo, bext), None, W0, dW
    A0 = field(Gg)
    Ad = [field(Gg, d) for d in range(dim)]
    if wg is None:
        return A0, torch.stack(Ad, dim=-1), None, None
    X = A0 / W0[..., None]
    J = torch.stack([(Ad[d] * W0[..., None] - A0 * dW[..., d, None]) / (W0**2)[..., None]
                     for d in range(dim)], dim=-1)
    return X, J, W0, dW


def _S_components(space, E1, W0, dW):
    """Structurally sparse ``S[i][k]``: spatial derivative ``D_i`` of the
    stored basis from the parametric derivative ``D̂_k`` of the plain
    B-splines (index 0 = value; None = zero), per point.  The inverse-map
    pullback ``E1[..., k, i] = du_k/dx_i`` (None on the identity map) and
    the rationalization ``N/W`` composed."""
    dim = space.dim
    S = [[None] * (dim + 1) for _ in range(dim + 1)]
    if W0 is None:
        S[0][0] = 1.0
        for i in range(1, dim + 1):
            if E1 is None:
                S[i][i] = 1.0
            else:
                for k in range(1, dim + 1):
                    S[i][k] = E1[..., k - 1, i - 1]
        return S
    S[0][0] = 1.0 / W0
    for i in range(1, dim + 1):
        if E1 is None:
            S[i][0] = -dW[..., i - 1] / W0**2
            S[i][i] = 1.0 / W0
        else:
            S[i][0] = -torch.einsum("...d,...d->...", E1[..., i - 1], dW) / W0**2
            for k in range(1, dim + 1):
                S[i][k] = E1[..., k - 1, i - 1] / W0
    return S


def _fine_pullback(space, blo, bext):
    """``(X, detX, S)`` of a box's fine grid: physical points, the map's
    determinant (None on the identity map) and :func:`_S_components`."""
    X, J, W0, dW = _fine_geometry(space, blo, bext)
    detX = E1 = None
    if J is not None:
        detX = det_small(J)
        E1 = inv_small(J, detX)
    return X, detX, _S_components(space, E1, W0, dW)


def _param_pairs(space, users):
    """The parametric channel pairs ``(k, l)`` that the user channels
    ``users`` reach through ``S`` (rows ``k`` of ``S`` that can be nonzero
    for the user's spatial index)."""
    dim = space.dim

    def rows(k):
        if k == 0:
            return set(range(dim + 1)) if space.is_rational else {0}
        return set(range(1, dim + 1))

    ui = {i for i, _ in users}
    uj = {j for _, j in users}
    return tuple((k, l) for k in range(dim + 1) for l in range(dim + 1)
                 if rows(k) & ui and rows(l) & uj)


def _pulled_channel(space, S, detX, users, vals, k, l, rc, f_rev):
    """Parametric channel ``C̃_kl = detX Σ_ij S_ik C_ij S_jl`` of plane
    entry ``rc`` on a fine grid ``f_rev``; ``vals`` are the user channel
    values at the grid's physical points."""
    dt, dev = space.dtype, space.device
    acc = None
    for (i, j) in users:
        if S[i][k] is None or S[j][l] is None:
            continue
        term = S[i][k] * _as(_block_entry(space, vals[(i, j)], rc), dt, dev) * S[j][l]
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros(f_rev, dtype=dt, device=dev)
    if detX is not None:
        acc = detX * acc
    return torch.broadcast_to(_as(acc, dt, dev), f_rev)


def _weight_window(space, wg, node_sl, off_rev):
    """``w[n + off]`` for the nodes ``n`` of a window (grid order): zero
    outside an open axis, wrapped on a periodic one."""
    dim = space.dim
    idx, keep = [], None
    for g, s in enumerate(node_sl):
        N = space.node_shape[dim - 1 - g]
        i = torch.arange(s.start, s.stop, device=wg.device) + off_rev[g]
        shape = [1] * dim
        shape[g] = -1
        if space.periodic[dim - 1 - g]:
            i = i % N
        else:
            ok = ((i >= 0) & (i < N)).view(shape)
            keep = ok if keep is None else keep & ok
            i = i.clamp(0, N - 1)
        idx.append(i.view(shape))
    w = wg[tuple(idx)]
    return w if keep is None else w * keep


def _conjugate_weights(space, out, slots, node_sl):
    """Rational conv result: ``out[s][n] *= w[n]·w[n + off(s)]`` for the
    stored slots ``slots`` over the window ``node_sl``, in place (the
    plain-basis operator conjugated by the node weights)."""
    dim = space.dim
    wg = _geometry_grids(space)[1]
    offs = stencil_of(space).slot_offsets()
    wn = _weight_window(space, wg, node_sl, (0,) * dim)
    for si, s in enumerate(slots):
        off_rev = tuple(int(offs[s, dim - 1 - g]) for g in range(dim))
        out[si] *= wn * _weight_window(space, wg, node_sl, off_rev)
    return out


def _field_specs(fields):
    """``fields`` -> sorted ((name, vector, order), ...), or None for no
    fields; a bare vector means order 0."""
    if fields is None:
        return None
    out = []
    for k in sorted(fields):
        v = fields[k]
        vec, o = (v[0], int(v[1])) if isinstance(v, tuple) else (v, 0)
        out.append((k, vec, o))
    return tuple(out)


def _field_count(specs, dim):
    """Fine-grid field arrays the specs evaluate (values, gradients,
    Hessians)."""
    return sum(1 + dim * (o >= 1) + dim * dim * (o >= 2) for *_, o in specs or ())


def _tab_order(max_order, specs):
    return max((max_order,) + tuple(o for *_, o in specs or ()))


def _field_probe(specs, dim, dtype, device):
    fp = {}
    for k, _, o in specs:
        fp[k] = torch.zeros((1,), dtype=dtype, device=device)
        if o >= 1:
            fp[k + "_grad"] = torch.zeros((1, dim), dtype=dtype, device=device)
        if o >= 2:
            fp[k + "_hess"] = torch.zeros((1, dim, dim), dtype=dtype, device=device)
    return fp


def _fine_fields(space, specs, blo, bext):
    """Point values of the state fields on a box's fine grid: ``name``,
    ``name_grad`` (…, dim) and ``name_hess`` (…, dim, dim) up to each
    field's order."""
    dim = space.dim
    mats = _fine_basis_mats(space, space.dtype)
    N_rev = tuple(space.node_shape[::-1])
    fe = {}
    for k, vec, o in specs:
        G = vec.reshape(N_rev).to(space.dtype)
        memo = {}

        def der(ders):
            if ders not in memo:
                memo[ders] = _fine_field(space, mats, ders, G, blo, bext)
            return memo[ders]

        fe[k] = der(_unit(dim))
        if o >= 1:
            fe[k + "_grad"] = torch.stack([der(_unit(dim, d)) for d in range(dim)], dim=-1)
        if o >= 2:
            fe[k + "_hess"] = torch.stack(
                [torch.stack([der(_unit(dim, d1, d2)) for d2 in range(dim)], dim=-1)
                 for d1 in range(dim)], dim=-2)
    return fe


def _element_fields(space, specs, pb, emap):
    """Point values of the state fields on tabulated elements (the
    generic boxes): (B, Q), (B, Q, dim), (B, Q, dim, dim)."""
    fe = {}
    for k, vec, o in specs:
        Ue = vec.reshape(-1)[emap].to(space.dtype)  # (B, nen)
        fe[k] = torch.einsum("bqn,bn->bq", pb.shape[0], Ue)
        if o >= 1:
            fe[k + "_grad"] = torch.einsum("bqnd,bn->bqd", pb.shape[1], Ue)
        if o >= 2:
            fe[k + "_hess"] = torch.einsum("bqnde,bn->bqde", pb.shape[2], Ue)
    return fe


def _space_to_depth(space, Fc, bext):
    """(C, f_rev...) fine-grid channels -> (Q·C, E_rev...) conv input,
    q-major and C-minor (matching :func:`_conv_kernel`)."""
    dim = space.dim
    shape = [Fc.shape[0]]
    for g in range(dim):
        shape += [bext[dim - 1 - g], space.tabs[dim - 1 - g].nqp]
    perm = [2 + 2 * g for g in range(dim)] + [0] + [1 + 2 * g for g in range(dim)]
    return Fc.reshape(shape).permute(perm).reshape((-1,) + tuple(bext[::-1]))


def _conv(W, ker, p):
    """One element-tap correlation of the conv input ``W (C_in, E_rev...)``
    with ``ker (C_out, C_in, taps_rev...)`` padded by ``p``: ``(C_out,
    (E + p)_rev...)``, the node window of the box.

    Written as one GEMM per tap, ``(C_out × C_in) @ (C_in × E)``, added
    into the tap's shifted output window (``W[e]`` lands at ``e + p -
    t``), in a fixed order: deterministic, and rounded like a direct sum.
    cuDNN's convolution of the same product (``conv3d``, deterministic or
    not) rounds the f32 Cahn–Hilliard Jacobian an order of magnitude worse
    on an H100 (``tests/test_torch_conv_rounding.py``, card only)."""
    E = W.shape[1:]
    pr = tuple(p[::-1])
    out = torch.zeros((ker.shape[0],) + tuple(e + q for e, q in zip(E, pr)),
                      dtype=W.dtype, device=W.device)
    Wm = W.reshape(W.shape[0], -1)
    for t in itertools.product(*[range(k) for k in ker.shape[2:]]):
        Y = ker[(slice(None), slice(None)) + t] @ Wm
        sl = tuple(slice(q - tt, q - tt + e) for q, tt, e in zip(pr, t, E))
        out[(slice(None),) + sl] += Y.view((ker.shape[0],) + tuple(E))
    return out


def _fold_pieces(space, node_sl, lo_off):
    """Split a node window into (dest, src) slice pieces: dest in the
    target's coordinates (node + ``lo_off`` per grid axis), the overhang
    on a periodic axis wrapped to the axis start (window length ≤ N + p
    < 2N: at most one split per axis)."""
    dim = space.dim
    pieces = [((), ())]
    for g, s in enumerate(node_sl):
        N = space.node_shape[dim - 1 - g]
        L, lo = s.stop - s.start, lo_off[g]
        new = []
        for dest, src in pieces:
            if space.periodic[dim - 1 - g] and s.stop > N:
                core = N - s.start
                new.append((dest + (slice(lo + s.start, lo + N),), src + (slice(0, core),)))
                new.append((dest + (slice(lo, lo + L - core),), src + (slice(core, L),)))
            else:
                new.append((dest + (slice(lo + s.start, lo + s.stop),), src + (slice(0, L),)))
        pieces = new
    return pieces


def _add_folded(space, target, contrib, node_sl, lo_off, lead=1):
    """``target[window] += contrib`` in place, wrap-folded on periodic
    axes; the first ``lead`` axes of both are not spatial."""
    head = (slice(None),) * lead
    for dest, src in _fold_pieces(space, node_sl, lo_off):
        target[head + dest] += contrib[head + src]


def _zsplits(space, bext, per_point_bytes):
    """Slowest-axis chunks (z0, ez) of a box so that one chunk's conv
    input stays within ``_CONV_CHUNK_BYTES``."""
    dim = space.dim
    ez = bext[dim - 1]
    if dim > 1:
        layer = per_point_bytes * math.prod(
            bext[d] * space.tabs[d].nqp for d in range(dim - 1)) * space.tabs[dim - 1].nqp
        ez_c = max(1, min(ez, _CONV_CHUNK_BYTES // max(layer, 1)))
    else:
        ez_c = ez
    return [(s, min(ez_c, ez - s)) for s in range(0, ez, ez_c)]


def _conv_tasks(space, boxes, per_point_bytes):
    """(blo, bext, reps) of every slowest-axis chunk of the conv boxes."""
    dim = space.dim
    out = []
    for blo0, bext0, reps in boxes:
        for zs, ez in _zsplits(space, bext0, per_point_bytes):
            blo, bext = list(blo0), list(bext0)
            blo[dim - 1] += zs
            bext[dim - 1] = ez
            out.append((tuple(blo), tuple(bext), reps))
    return out


def _window(space, blo, bext):
    """Node window [blo, blo + bext + p) of a conv chunk, grid order."""
    dim, p = space.dim, space.degrees
    return tuple(slice(blo[dim - 1 - g], blo[dim - 1 - g] + bext[dim - 1 - g] + p[dim - 1 - g])
                 for g in range(dim))


# ----------------------------------------------------------- entry points


def _geometry_values(dim):
    """Fine-grid values per point that the pullback holds beside the
    channels: the geometry fields, J, its inverse and the S components."""
    return 4 * (dim + 1) ** 2


def _check_space(space, symmetric):
    if not fastpath.is_unit_step(space):
        raise ValueError("conv assembly requires a regular unit-step space")
    if symmetric and any(space.periodic):
        raise ValueError("symmetric conv assembly requires open axes")
    if (space.has_geometry or space.is_rational) and space.nsd != space.dim:
        raise ValueError("conv assembly requires dim == nsd geometry (manifolds take "
                         "the pointwise path)")


def assemble_load_vector(space, forcing: Callable, ctx=None):
    """Load vector ``b_a = ∫ f N_a`` (no Dirichlet elimination) on the
    identity map, open or periodic axes: ``b = Bᵀ(w·f)`` on the fine
    quadrature grid, sum-factorized one axis at a time, in chunks of the
    slowest axis.  ``forcing(x, ctx)`` takes points ``(..., dim)`` and
    returns ``(...)`` (dof = 1) or ``(..., dof)``, one load per field.
    Returns (nnodes, dof)."""
    _check_space(space, False)
    if space.has_geometry or space.is_rational:
        raise ValueError("conv load assembly: identity map")
    return _load_vector(space, forcing, ctx)


def _load_vector(space, forcing, ctx):
    """:func:`assemble_load_vector`, on mapped and rational spaces too:
    there the fine grid's points are the mapped ones, the weights carry
    ``detX / W`` and the result the node weights (``N_a = w_a B_a / W``);
    the chunks are then whole elements of the slowest axis."""
    dim, dof = space.dim, space.dof
    geom = space.has_geometry or space.is_rational
    B = [m[0] for m in _fine_basis_mats(space, space.dtype)]  # (F_d, N_d)
    F_rev = [B[dim - 1 - g].shape[0] for g in range(dim)]
    per_row = math.prod(F_rev[1:]) * (dim + 2 + dof + (_geometry_values(dim) if geom else 0))
    itemsize = torch.empty((), dtype=space.dtype).element_size()
    cz = max(1, min(F_rev[0], _FINE_CHUNK_BYTES // (per_row * itemsize)))
    nqz = space.tabs[dim - 1].nqp
    if geom:
        cz = max(nqz, cz // nqz * nqz)
    bg = torch.zeros(tuple(space.node_shape[::-1]) + (dof,), dtype=space.dtype,
                     device=space.device)
    for z0 in range(0, F_rev[0], cz):
        z1 = min(z0 + cz, F_rev[0])
        w = _fine_weights(space, z0, z1)
        if geom:
            blo = (0,) * (dim - 1) + (z0 // nqz,)
            bext = tuple(space.elem_shape[:-1]) + ((z1 - z0) // nqz,)
            X, J, W0, _ = _fine_geometry(space, blo, bext)
            if J is not None:
                w = w * det_small(J)
            if W0 is not None:
                w = w / W0
        else:
            X = _fine_points(space, z0, z1)
        f = torch.as_tensor(forcing(X, ctx), dtype=space.dtype, device=space.device)
        f = torch.broadcast_to(f[..., None] if dof == 1 else f, X.shape[:-1] + (dof,))
        for r in range(dof):
            g_ = f[..., r] * w
            for g in range(dim - 1, -1, -1):  # fast axes first: fine -> nodes
                Bd = B[dim - 1 - g]
                if g == 0:
                    Bd = Bd[z0:z1]
                g_ = torch.movedim(torch.tensordot(Bd, g_, dims=([0], [g])), 0, g)
            bg[..., r] += g_
    if space.is_rational:
        bg *= _geometry_grids(space)[1][..., None]
    return bg.reshape(space.nnodes, dof)


def _block_entry(space, v, rc):
    """Entry ``rc = r·dof + c`` of a channel value: the value itself for
    dof = 1, else entry (r, c) of its ``(…, dof, dof)`` block."""
    if space.dof == 1:
        return v
    v = v if torch.is_tensor(v) else np.asarray(v)
    return v[..., rc // space.dof, rc % space.dof]


def _channels_rc(space, chlist, probe, is_const):
    """Per plane entry ``rc`` the channels that reach it: for dof > 1 a
    constant block whose probed ``(r, c)`` entry is exactly zero is left
    out of that entry (elasticity's blocks are mostly zeros); the
    reference prunes the same way."""
    out = []
    for rc in range(space.dof ** 2):
        out.append(tuple(
            ch for ch in chlist
            if space.dof == 1 or not is_const[ch]
            or float(_block_entry(space, probe[ch], rc)) != 0.0))
    return out


def _outer_planes(space, chlist, chv, slots):
    """(len(slots)·dof², next) planes: the channel-weighted outer products
    of the per-axis factor rows, written in chunks of the slowest axis
    straight into one preallocated tensor (its interior columns; the
    periodic halo columns stay zero).  For dof > 1 every block entry
    ``(r, c)`` is written on its own from the channels whose constant
    block is nonzero there (adding an exact zero would change nothing);
    an entry no channel reaches stays zero.

    The arithmetic follows the reference operation for operation
    (``((f_z·f_y)·f_x)`` per channel, times the channel value, channels
    summed in ``chlist`` order, all in ``space.dtype``), so f32 planes are
    rounded exactly as the reference rounds them.  That matters: interior
    rows share one stencil, so its rounding acts as one systematic
    perturbation of every row."""
    st = stencil_of(space)
    dim, dd = space.dim, space.dof ** 2
    dt = space.dtype
    p = space.degrees
    N_rev = tuple(space.node_shape[::-1])
    Ne_rev = tuple(ext_shape(st)[::-1])
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
        chans.append(((i, j), val, rows))
    is_const = {ch: True for ch in chlist}
    per_rc = [set(c) for c in _channels_rc(space, chlist, chv, is_const)]

    alloc = torch.zeros if any(space.periodic) or dd > 1 else torch.empty
    P = alloc((Keff * dd, math.prod(Ne_rev)), dtype=dt, device=space.device)
    interior = tuple(slice((ne - n) // 2, (ne - n) // 2 + n) for n, ne in zip(N_rev, Ne_rev))
    Pg = P.view((Keff, dd) + Ne_rev)[(slice(None), slice(None)) + interior]
    layer = Keff * math.prod(N_rev[1:]) * P.element_size()
    zc = max(1, min(N_rev[0], _CHUNK_BYTES // layer))
    term = None
    for z0 in range(0, N_rev[0], zc):
        z1 = min(z0 + zc, N_rev[0])
        for rc in range(dd):
            blk = Pg[:, rc, z0:z1]
            live = [(_block_entry(space, val, rc), rows)
                    for ch, val, rows in chans if ch in per_rc[rc]]
            for ci, (val, rows) in enumerate(live):
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


def _gen_box_matrix(space, coef, ctx, specs, max_order, ids):
    """Element matrices (B, nen, nen, 1, 1) of a generic box: the
    synthesized pointwise form, or — with state fields — the coefficient
    channels at tabulated points with the fields gathered per element."""
    if specs is None:
        element_KF = _make_element_KF(space, ctx, max_order, False)
        return element_KF(ids, None, coefficient_pointwise_form(coef))[0]
    dt = space.dtype
    pb = tabulate_elements(space, ids, order=_tab_order(max_order, specs))
    ch = coef(pb.x, ctx, _element_fields(space, specs, pb, space.device_emap(ids)))
    Ke = None
    for (i, j), v in ch.items():
        wc = pb.weight * torch.broadcast_to(_as(v, dt, pb.weight.device), pb.weight.shape)
        term = torch.einsum("bq,bqa,bqc->bac", wc, _chan_D(pb.shape, i), _chan_D(pb.shape, j))
        Ke = term if Ke is None else Ke + term
    return Ke[:, :, :, None, None]


def _conv_planes(space, coef, ctx, specs, chlist, chv, is_const, max_order, slots,
                 conv_min):
    """(len(slots)·dof², next) planes of a variable-coefficient spec, or
    of any spec on a mapped or rational space: one convolution per
    conv-box chunk and block entry ``(r, c)`` (over the channels that
    reach it: the user's, or under a map the parametric pairs that they
    reach), generic boxes by shift accumulation, both folded into the
    interior of the extended layout."""
    st = stencil_of(space)
    dim, dt, dev, dd = space.dim, space.dtype, space.device, space.dof ** 2
    geom = space.has_geometry or space.is_rational
    Ne = ext_shape(st)
    Ne_rev = tuple(Ne[::-1])
    los = tuple((ne - n) // 2 for n, ne in zip(space.node_shape, Ne))[::-1]
    Keff = len(slots)
    P = torch.zeros((Keff * dd, math.prod(Ne)), dtype=dt, device=dev)
    Pg = P.view((Keff, dd) + Ne_rev)
    users = _channels_rc(space, chlist, chv, is_const)
    chmap = [_param_pairs(space, u) for u in users] if geom else users
    conv_boxes, gen_boxes = _boxes(space, conv_min)
    nch = max(len(c) for c in chmap)
    per_point = ((1 + dd) * nch + _field_count(specs, dim) + dim
                 + (_geometry_values(dim) if geom else 0)) * P.element_size()
    for blo, bext, reps in _conv_tasks(space, conv_boxes, per_point):
        if geom:
            X, detX, S = _fine_pullback(space, blo, bext)
        else:
            X = _fine_X(space, blo, bext)
        ch = (coef(X, ctx, _fine_fields(space, specs, blo, bext)) if specs is not None
              else coef(X, ctx))
        f_rev = X.shape[:-1]
        for rc, chl in enumerate(chmap):
            if not chl:
                continue
            if geom:
                Fc = torch.stack([_pulled_channel(space, S, detX, users[rc], ch, k, l, rc,
                                                  f_rev) for k, l in chl])
            else:
                Fc = torch.stack([
                    torch.broadcast_to(
                        _as(_block_entry(space, chv[c] if is_const[c] else ch[c], rc), dt,
                            dev), f_rev)
                    for c in chl])
            out = _conv(_space_to_depth(space, Fc, bext),
                        _conv_kernel(space, chl, dt, reps, slots), space.degrees)
            del Fc
            if space.is_rational:
                _conjugate_weights(space, out, slots, _window(space, blo, bext))
            _add_folded(space, Pg[:, rc], out, _window(space, blo, bext), los)
        del ch, X
        if geom:
            del detX, S
    # plane k·dof² + rc of the stored slots, out of the box's K·dof² planes
    sel = [s * dd + rc for s in slots for rc in range(dd)]
    for blo, bext in gen_boxes:
        Ke = _gen_box_matrix(space, coef, ctx, specs, max_order, _box_ids(space, blo, bext))
        Gm, _ = fastpath.accumulate_box(space, bext, Ke=Ke)
        contrib = torch.movedim(Gm.reshape(Gm.shape[:dim] + (st.K * dd,)), dim, 0)
        _add_folded(space, P.view((Keff * dd,) + Ne_rev), contrib[sel],
                    _box_node_slices(space, blo, bext), los)
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
    const_outer: bool = True,
    conv_min: int = 2048,
):
    """Assemble the system of a coefficient-form bilinear operator
    straight into kernel planes; returns ``(op, b)`` with ``op`` a
    :class:`StencilOperator` (kind ``"sym"`` when ``symmetric``: only the
    ``Ku = (K+1)/2`` upper slots are built and stored; open axes only)
    and ``b`` the (nnodes, dof) load vector, Dirichlet-fixed when
    ``apply_fix``, plus the nodal fluxes.

    ``coef(x, ctx) -> {(i, j): value}`` with ``i, j`` channel indices
    (0 = value, ``i`` = d/dx_{i-1}, ``(d1, d2)`` = ∂²/∂x_{d1}∂x_{d2});
    values are scalars or tensors broadcastable against ``x[..., 0]``,
    and for dof > 1 ``(dof, dof)`` blocks or ``(…, dof, dof)`` tensors
    (entry ``(r, c)`` couples field ``r`` of the test function to field
    ``c`` of the trial function: plane ``(s·dof + r)·dof + c``), with a
    ``(…, dof)`` forcing.  ``fields`` need dof = 1 (ValueError).
    With ``fields`` — names mapped to node vectors ``(nnodes,)`` or to
    ``(vector, order)`` — the signature is ``coef(x, ctx, fe)`` with
    ``fe[name]``, ``fe[name + "_grad"]`` and ``fe[name + "_hess"]`` the
    fields' point values up to their order; re-assembling with new field
    values rebuilds no static table.

    Spatially constant specs without fields take the exact outer-product
    write unless ``const_outer`` is False; everything else convolves over
    the type-combo boxes of at least ``conv_min`` elements and assembles
    the rest generically.

    Mapped and rational spaces (``nsd == dim``; order-1 channels) always
    convolve, with the channels pulled back per point (module docstring);
    their load vector carries the map's measure and the weights."""
    _check_space(space, symmetric)
    geom = space.has_geometry or space.is_rational
    if fields is not None and (space.dof != 1 or geom):
        raise ValueError("field coefficients: dof=1 identity map only")
    profiling.count("IGA_FormSystem", profiling.system_flops(space))
    st = stencil_of(space)
    dim, dt, dof = space.dim, space.dtype, space.dof
    specs = _field_specs(fields)
    x0 = torch.zeros((1, dim), dtype=dt, device=space.device)
    probe = (coef(x0, ctx, _field_probe(specs, dim, dt, space.device)) if specs is not None
             else coef(x0, ctx))
    chlist = sorted(probe, key=_chan_key)
    for i, j in chlist:
        if not (_check_idx(i, dim) and _check_idx(j, dim)):
            raise ValueError(f"channel {(i, j)} out of range")
    max_order = max([1] + [max(_chan_total(i), _chan_total(j)) for i, j in chlist])
    if max_order > 1 and geom:
        raise ValueError("second-derivative channels require the identity map "
                         "(no second-order pullback in the conv engine)")
    if dof > 1 and any(_value_shape(probe[c])[-2:] != (dof, dof) for c in chlist):
        raise ValueError(f"channel values of a dof={dof} space are ({dof}, {dof}) blocks")
    const_shapes = ((), (dof, dof)) if dof > 1 else ((),)
    is_const = {c: _value_shape(probe[c]) in const_shapes for c in chlist}
    slots = tuple(range(st.diag_slot, st.K)) if symmetric else tuple(range(st.K))
    if const_outer and specs is None and all(is_const.values()) and not geom:
        P = _outer_planes(space, chlist, probe, slots)
    else:
        P = _conv_planes(space, coef, ctx, specs, chlist, probe, is_const, max_order, slots,
                         conv_min)
    if symmetric:
        op = StencilOperator.from_planes_symmetric(st, P)
    else:
        op = StencilOperator.from_planes(st, P)
    if forcing is not None:
        b = _load_vector(space, forcing, ctx)
    else:
        b = torch.zeros((st.nnodes, dof), dtype=dt, device=space.device)
    if apply_fix:
        op, b = dirichlet_post_fix(space, op, b)
    return op, _add_flux(space, b)


def assemble_residual_conv(space, res_coef, ctx=None, *, fields=None, conv_min=2048):
    """Residual / weighted-load assembly with derivative TEST channels
    and state-field coefficients, one convolution per type-combo box:

        R_a = Σ_α ∫ D^α N_a · f_α(x, state)

    ``res_coef(x, ctx, fe) -> {α: value}`` with α a test-channel index
    (``0`` value, ``1..dim`` first derivatives, ``(d1, d2)`` second
    derivatives) and ``fe`` the state fields' point values as in
    :func:`assemble_coefficient_planes`; without ``fields`` the signature
    is ``res_coef(x, ctx)``.  Identity map, dof = 1, unit-step open or
    periodic axes.  Returns a flat ``(nnodes, 1)`` vector with no
    Dirichlet elimination."""
    if not fastpath.is_unit_step(space):
        raise ValueError("conv residual assembly requires unit-step axes")
    if space.has_geometry or space.is_rational or space.dof != 1:
        raise ValueError("conv residual assembly: identity map, dof=1")
    dim, dt, dev = space.dim, space.dtype, space.device
    specs = _field_specs(fields) if fields else None
    x0 = torch.zeros((1, dim), dtype=dt, device=dev)
    probe = (res_coef(x0, ctx, _field_probe(specs, dim, dt, dev)) if specs is not None
             else res_coef(x0, ctx))
    chans = sorted(probe, key=_one_key)
    for idx in chans:
        if not _check_idx(idx, dim):
            raise ValueError(f"residual channel {idx} out of range")
    max_order = max([1] + [_chan_total(i) for i in chans])
    bg = torch.zeros(tuple(space.node_shape[::-1]), dtype=dt, device=dev)
    zero = (0,) * dim
    conv_boxes, gen_boxes = _boxes(space, conv_min)
    per_point = (2 * max(len(chans), 2) + _field_count(specs, dim) + dim) * bg.element_size()
    for blo, bext, reps in _conv_tasks(space, conv_boxes, per_point):
        X = _fine_X(space, blo, bext)
        ch = (res_coef(X, ctx, _fine_fields(space, specs, blo, bext)) if specs is not None
              else res_coef(X, ctx))
        Fc = torch.stack([torch.broadcast_to(_as(ch[idx], dt, dev), X.shape[:-1])
                          for idx in chans])
        del ch, X
        out = _conv(_space_to_depth(space, Fc, bext),
                    _test_kernel(space, dt, reps, tuple(chans)), space.degrees)
        _add_folded(space, bg, out[0], _window(space, blo, bext), zero, lead=0)
    for blo, bext in gen_boxes:
        ids = _box_ids(space, blo, bext)
        pb = tabulate_elements(space, ids, order=_tab_order(max_order, specs))
        ch = (res_coef(pb.x, ctx, _element_fields(space, specs, pb, space.device_emap(ids)))
              if specs is not None else res_coef(pb.x, ctx))
        Fe = None
        for idx in chans:
            wc = pb.weight * torch.broadcast_to(_as(ch[idx], dt, dev), pb.weight.shape)
            term = torch.einsum("bq,bqa->ba", wc, _chan_D(pb.shape, idx))
            Fe = term if Fe is None else Fe + term
        _, Gv = fastpath.accumulate_box(space, bext, Fe=Fe[..., None])
        _add_folded(space, bg, Gv[..., 0], _box_node_slices(space, blo, bext), zero, lead=0)
    return bg.reshape(space.nnodes, 1)
