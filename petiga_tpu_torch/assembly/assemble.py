"""Batched assembly routines (port of :mod:`petiga_tpu.assembly.assemble`):
the replacement of PetIGA's element loops (IGAComputeSystem/
Vector/Matrix, IGAComputeScalar/ErrorNorm) and of its per-element
Dirichlet machinery (FixSystem).

User forms are *pure functions of one quadrature point*.  A residual
form (``assemble_function``, ``assemble_jacobian``'s AD, the
matrix-free products) is evaluated at every point of an element batch
in one call, a ``torch.func.vmap`` over the points inside one over the
elements, then weighted and summed over the points in their natural
order; each such call is one ``IGA_ElementBatch`` log event.  System,
vector and scalar forms are lifted over the elements with one ``vmap``
per point, summed by a Python loop in the same order (or contracted by
the form itself when it is ``qbatched``).  Element contributions go into
the stencil operator by shifted in-place slice adds on regular spaces
(:mod:`.fastpath`) or by ``index_add_`` otherwise.  The element loop
runs over chunks of whole element ids so memory stays bounded: a
residual's or Jacobian's default chunk holds as many elements as keep
its largest intermediate within ``_BATCH_BYTES``, and where one slab of
elements over all points would pass that, the points are taken in
consecutive groups.  The last chunk is simply shorter (no padded ids,
no validity masks).

The Dirichlet post-fix is the reference's global elimination on an
assembled operator: every fixed row and column zeroed, the diagonal set
to the node's element multiplicity (each element's FixSystem adds 1), the
right-hand side lifted by the unfixed operator (``b -= A (m∘v)``, one
matvec) and fixed rows set to ``mult · v``.

Nonlinear residuals (``assemble_function``) keep the reference's
fix-value semantics; their Jacobians (``assemble_jacobian``) are
forward-mode AD of the element residual (``torch.func.jvp``, batched over
the element's local unknowns with ``torch.func.vmap``), or a hand-written
``jacobian=`` form.  :func:`assemble_separable_planes` is the
sum-factorized assembly of the separable reaction–diffusion system.

The routines register PetIGA's log events (``IGA_FormSystem``,
``IGA_FormVector``, ``IGA_FormFunction``, ``IGA_FormJacobian``,
``IGA_FormScalar``) with :mod:`petiga_tpu_torch.utils.profiling` where the
reference's do, and ``IGA_ElementBatch`` per batched evaluation of a
residual form (host-side counts: it never waits for the card).
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..sparse.spmv import StencilOperator
from ..sparse.stencil import Stencil, StencilMatrix, _slot_window, halo_pad
from ..utils import profiling
from . import fastpath
from .point import Point
from .tabulation import PointBlock, tabulate_elements

__all__ = [
    "stencil_of",
    "assemble_system",
    "assemble_system_planes",
    "assemble_separable_planes",
    "assemble_matrix",
    "assemble_vector",
    "assemble_function",
    "assemble_jacobian",
    "compute_scalar",
    "compute_error_norm",
    "boundary_flux_vector",
    "dirichlet_post_fix",
    "dirichlet_post_fix_homogeneous",
]

# The bytes of a residual batch's largest intermediate, directions ×
# elements × quadrature points × nen·dof × itemsize, that a default chunk
# and a group of quadrature points keep within (the pointwise counterpart
# of the conv engine's ``convform._FINE_CHUNK_BYTES``).  Directions are
# nen·dof for an AD Jacobian and 1 for a residual or a matrix-free product.
_BATCH_BYTES = 2**29


# ----------------------------------------------------------------- utilities


def stencil_of(space) -> Stencil:
    return Stencil(
        node_shape=space.node_shape,
        widths=space.degrees,
        periodic=space.periodic,
        dof=space.dof,
    )


def _points_of(pb: PointBlock) -> Point:
    """A PointBlock's leaves as a Point whose leaves are stacked over
    (B, Q)."""
    order = len(pb.shape) - 1
    return Point(
        u=pb.u,
        x=pb.x,
        shape0=pb.shape[0],
        shape1=pb.shape[1] if order >= 1 else None,
        shape2=pb.shape[2] if order >= 2 else None,
        shape3=pb.shape[3] if order >= 3 else None,
        shape4=pb.shape[4] if order >= 4 else None,
        normal=pb.normal,
        gmap1=pb.gmap1,
        gmap2=pb.gmap2,
    )


def _leaf_dims(tree):
    """``vmap`` in_dims of a pytree: 0 for its tensor leaves, None for
    ``None`` leaves (absent Point fields, a missing ``Ue``)."""
    return tree_map(lambda a: None if a is None else 0, tree)


def _vmap(fn, *args):
    """``torch.func.vmap`` of ``fn`` over the leading axis of every
    tensor leaf of ``args``; ``None`` leaves pass through."""
    return torch.func.vmap(fn, in_dims=tuple(_leaf_dims(a) for a in args))(*args)


def _scan_points(pb: PointBlock, body: Callable, init):
    """Fold ``body(acc, pt_batch, w_batch)`` over the quadrature axis
    (axis 1) of a PointBlock, in order; pt leaves have shape (B, ...)."""
    pts = _points_of(pb)
    acc = init
    for q in range(pb.weight.shape[1]):
        pt = tree_map(lambda a: None if a is None else a[:, q], pts)
        acc = body(acc, pt, pb.weight[:, q])
    return acc


def _batch_elements(space, directions: int) -> int:
    """Elements in a default residual or Jacobian chunk: as many as keep
    ``directions × elements × Q × nen·dof × itemsize`` within
    ``_BATCH_BYTES`` (at least one)."""
    Q = math.prod(t.value.shape[1] for t in space.tabs)
    per_element = directions * Q * space.nen * space.dof * space.dtype.itemsize
    return max(1, _BATCH_BYTES // per_element)


def _point_groups(Q: int, per_point: int) -> list:
    """Consecutive ranges of the Q quadrature points, as few as keep
    ``per_point`` bytes a point within ``_BATCH_BYTES``."""
    g = max(1, min(Q, _BATCH_BYTES // max(per_point, 1)))
    return [(q0, min(q0 + g, Q)) for q0 in range(0, Q, g)]


def _chunks(space, chunk: Optional[int]) -> list:
    """Element ids in chunks of ``chunk`` (all elements when None): a
    list of (B,) int64 tensors on ``space.device``, the last one
    shorter."""
    nel = space.nel
    if chunk is None or chunk >= nel:
        chunk = nel
    return [
        torch.arange(start, min(start + chunk, nel), device=space.device)
        for start in range(0, nel, chunk)
    ]


def _fix_arrays(space, emap):
    """Per-element Dirichlet mask/values (float mask) flattened to
    (B, nen*dof)."""
    mask, vals = space.tensor("dirichlet")
    B = emap.shape[0]
    m = mask[emap].reshape(B, -1)
    v = vals[emap].reshape(B, -1)
    return m.to(vals.dtype), v


def _fix_system(Ke, Fe, m, v):
    """Symmetric Dirichlet elimination with RHS lift, batched (PetIGA's
    FixSystem): zero row+col k, unit diagonal, F -= K[:,k] v, F[k] = v."""
    lift = m * v
    Fe = Fe - torch.einsum("bij,bj->bi", Ke, lift)
    keep = 1.0 - m
    Ke = Ke * keep[:, :, None] * keep[:, None, :]
    Ke = Ke + torch.diag_embed(m)
    Fe = Fe * keep + lift
    return Ke, Fe


def _scatter_matrix(space, A_data, Ke, emap):
    """Scatter element blocks (B, nen, nen, dof, dof) into flat stencil
    data (nnodes·K, dof, dof), in place.  ``index_add_`` on a CUDA tensor
    adds atomically: the sum's order, hence its last bits, may change
    from run to run (the shift method does not have this)."""
    st = stencil_of(space)
    slot = torch.as_tensor(st.slot_table(space.nen_shape), dtype=torch.int64,
                           device=emap.device)  # (nen, nen)
    rows = emap[:, :, None] * st.K + slot[None, :, :]  # (B, nen, nen)
    return A_data.index_add_(0, rows.reshape(-1), Ke.reshape(-1, space.dof, space.dof))


def _scatter_vector(space, b, Fe, emap):
    return b.index_add_(0, emap.reshape(-1), Fe.reshape(-1, space.dof))


def _faces_to_visit(space):
    return [(d, s) for d in range(space.dim) for s in range(2) if space.bc_visit[d][s]]


def _face_elements(space, d, s) -> np.ndarray:
    """Flat ids of elements adjacent to face (d, s) — host-side."""
    eshape = space.elem_shape
    multi = np.unravel_index(np.arange(space.nel), eshape, order="F")
    tgt = 0 if s == 0 else eshape[d] - 1
    return np.where(multi[d] == tgt)[0]


def _normalize_K(K, nen, dof, dtype):
    return K.to(dtype).reshape(nen * dof, nen * dof)


def _normalize_F(F, nen, dof, dtype):
    return F.to(dtype).reshape(nen * dof)


def _node_multiplicity(space) -> torch.Tensor:
    """(nnodes,) element multiplicity of every node on ``space.device`` —
    the Dirichlet diagonal value of the per-element fix summed over
    elements.  Separable: per-axis closure counts, outer-multiplied."""
    dim = space.dim
    g = torch.ones((), dtype=space.dtype, device=space.device)
    for gax in range(dim):
        d = dim - 1 - gax
        m = np.bincount(space.axis_node_index[d].ravel(), minlength=space.node_shape[d])
        g = g[..., None] * torch.as_tensor(m, dtype=space.dtype, device=space.device)
    return g.reshape(-1)


# ------------------------------------------------------------ Dirichlet fix


def _planes_fixed(A: StencilOperator, mask) -> bool:
    """Whether ``A``'s planes already carry the fix of ``mask``: the
    fix's plane rewrite recorded it (:func:`_postfix_planes`) and neither
    the planes nor the mask was written in place since, by their version
    counters."""
    seen = getattr(A, "_dirichlet_fixed", None)
    if seen is None:
        return False
    dt_ref, dt_version, mask_ref, mask_version = seen
    return (dt_ref() is A.DT and A.DT._version == dt_version
            and mask_ref() is mask and mask._version == mask_version)


def _postfix_planes(A: StencilOperator, b, mask, vals, mult):
    """The post-fix on slot-major planes (full or symmetric storage),
    IN PLACE, so a multi-GB operator is never held twice.  Symmetric
    storage masks only the stored slots (row OR column fixed zeroes the
    entry — the same keep_a·keep_b product) and lifts through the
    symmetric kernel.  The plane rewrite depends on the mask alone and
    is idempotent, so it is skipped where :func:`_planes_fixed` says the
    planes carry it already: a load case on a fixed operator lifts and
    fixes its right-hand side only (at 96³ dof 3 the rewrite is 2,250
    launches over 4.24 GB of planes)."""
    st, dof = A.st, A.dof
    dt = A.DT.dtype
    maskf = mask.to(dt)
    vals = vals.to(dt)
    keep = 1.0 - maskf
    lift = maskf * vals

    # b2 = b - A_unfixed @ lift, through the kernel
    Alift = A.matvec(lift)
    b2 = b - Alift.reshape(b.shape)
    b2 = torch.where(mask, mult[:, None] * vals, b2 * keep)
    if _planes_fixed(A, mask):
        return A, b2

    # zero fixed rows and columns: plane (s, a, c) at row n holds
    # A[n, n + c_s]; scale by keep_a[n] · keep_c[n + c_s]
    keep_b = A.pack_vec(keep)
    G, nx = A.G, A.next
    DT = A.DT
    shifts = A.shifts_u if A.kind == "sym" else A.shifts
    for si, c in enumerate(shifts):
        for a in range(dof):
            ka = keep_b[a, G:G + nx]
            for bb in range(dof):
                kb = keep_b[bb, G + c:G + c + nx]
                DT[(si * dof + a) * dof + bb].mul_(ka).mul_(kb)
    # diagonal of fixed rows = element multiplicity
    dadd = A.pack_planes(
        (mult[:, None] * maskf).reshape(tuple(st.node_shape[::-1]) + (dof,)), planes=dof
    )
    s = 0 if A.kind == "sym" else st.diag_slot
    for a in range(dof):
        DT[(s * dof + a) * dof + a].add_(dadd[a])
    A._dirichlet_fixed = (weakref.ref(DT), DT._version, weakref.ref(mask), mask._version)
    return A, b2


def _postfix_node(A: StencilMatrix, b, mask, vals, mult):
    """The post-fix on node-major stencil storage (open or periodic
    axes), IN PLACE on ``A.data``."""
    st = A.stencil
    dof, K = st.dof, st.K
    N_rev = tuple(st.node_shape[::-1])
    data = A.data
    dt = data.dtype
    maskf = mask.to(dt)
    vals = vals.to(dt)
    keep = 1.0 - maskf
    lift = maskf * vals
    b2 = b - A.matvec(lift).reshape(b.shape)
    b2 = torch.where(mask, mult[:, None] * vals, b2 * keep)
    keep_g = keep.reshape(N_rev + (dof,))
    kp = halo_pad(keep_g, st.widths, st.periodic)
    dg = data.view(N_rev + (K, dof, dof))
    for s in range(K):
        win = kp[_slot_window(st, s)]  # (N_rev..., dof)
        dg[..., s, :, :] *= keep_g[..., :, None] * win[..., None, :]
    dadd = (mult[:, None] * maskf).reshape(N_rev + (dof,))
    dg[..., st.diag_slot, :, :] += torch.diag_embed(dadd)
    return A, b2


def _post_fix(space, A, b, vals):
    if isinstance(A, StencilOperator):
        fn = _postfix_planes
    elif isinstance(A, StencilMatrix):
        fn = _postfix_node
    else:
        raise TypeError(f"dirichlet_post_fix: unsupported operator {type(A).__name__}")
    return fn(A, b, space.tensor("dirichlet")[0], vals, _node_multiplicity(space))


def dirichlet_post_fix(space, A, b: torch.Tensor):
    """Global Dirichlet elimination on the *assembled* system —
    algebraically the per-element FixSystem summed over elements.  Used
    by the Galerkin *system* assemblers only.

    ``A``: a :class:`StencilMatrix` or a plane-direct
    :class:`StencilOperator` (full or symmetric storage).  The operator
    is fixed IN PLACE; returns ``(A, b_fixed)``."""
    if not space.has_dirichlet():
        return A, b
    return _post_fix(space, A, b, space.tensor("dirichlet")[1])


def dirichlet_post_fix_homogeneous(space, A, b: torch.Tensor):
    """Newton-system Dirichlet fix (FixJacobian semantics): rows/cols of
    fixed dofs zeroed, diagonal = multiplicity, and the rhs (``-R``)
    zeroed on fixed rows — the update δ is zero there.
    :func:`dirichlet_post_fix` with a zero lift."""
    if not space.has_dirichlet():
        return A, b
    return _post_fix(space, A, b, torch.zeros_like(space.tensor("dirichlet")[1]))


# --------------------------------------------------------------- assembly


def _make_element_KF(space, ctx, order, apply_fix):
    """Per-chunk element (K, F) evaluator shared by the node-major and
    the slot-major (plane-direct) system assemblers.

    Returns ``element_KF(ids, face, form) -> (Ke, Fe, emap)`` with Ke
    (B, nen, nen, dof, dof) — row/col local indices unflattened from the
    (nen·dof) element matrix — and Fe (B, nen, dof)."""
    dt = space.dtype
    nen, dof = space.nen, space.dof

    def element_KF(ids, face, form):
        pb = tabulate_elements(space, ids, order=order, face=face)
        emap = space.device_emap(ids)
        B = ids.shape[0]

        if getattr(form, "qbatched", False):
            def one(pt, w):
                K, F = form(pt, w, ctx)
                return _normalize_K(K, nen, dof, dt), _normalize_F(F, nen, dof, dt)

            Ke, Fe = _vmap(one, _points_of(pb), pb.weight)
        else:
            def one(pt):
                K, F = form(pt, ctx)
                return _normalize_K(K, nen, dof, dt), _normalize_F(F, nen, dof, dt)

            def body(acc, pt, w):
                K, F = _vmap(one, pt)
                acc[0].addcmul_(w[:, None, None], K)
                acc[1].addcmul_(w[:, None], F)
                return acc

            Ke = torch.zeros((B, nen * dof, nen * dof), dtype=dt, device=space.device)
            Fe = torch.zeros((B, nen * dof), dtype=dt, device=space.device)
            Ke, Fe = _scan_points(pb, body, (Ke, Fe))
        if apply_fix:
            m, v = _fix_arrays(space, emap)
            Ke, Fe = _fix_system(Ke, Fe, m, v)
        Ke = Ke.reshape(B, nen, dof, nen, dof).permute(0, 1, 3, 2, 4)
        return Ke, Fe.reshape(B, nen, dof), emap

    return element_KF


def _add_flux(space, b):
    """Nodal fluxes are added before the Dirichlet overwrite; fixed dofs
    keep their boundary value."""
    flux = boundary_flux_vector(space)
    if flux is None:
        return b
    mask, _ = space.tensor("dirichlet")
    return b + torch.where(mask, torch.zeros_like(flux), flux)


def assemble_system_planes(
    space,
    system: Callable,
    ctx=None,
    *,
    order: Optional[int] = None,
    chunk: Optional[int] = None,
    apply_fix: bool = True,
):
    """Slot-major (plane-direct) system assembly: element blocks
    accumulate straight into the kernel's flat slot-major plane layout,
    so the operator is never stored twice (node-major A + packed planes).

    Same semantics as :func:`assemble_system` (IGAComputeSystem, with the
    Dirichlet elimination applied post-assembly) restricted to open,
    regular, unit-step spaces (maximal continuity).  Returns ``(op, b)``
    with ``op`` a :class:`StencilOperator` built zero-copy from the
    planes and ``b`` the (nnodes, dof) load vector.
    """
    st = stencil_of(space)
    if any(space.periodic):
        raise ValueError("plane-direct assembly requires open axes")
    if not fastpath.is_unit_step(space):
        raise ValueError("plane-direct assembly requires a regular unit-step space")
    profiling.count("IGA_FormSystem", profiling.system_flops(space))
    dt, dof = space.dtype, space.dof
    if chunk is None:
        chunk = min(space.nel, 8192)
    chunk_sz = fastpath.slab_chunk(space, chunk)
    kz = chunk_sz // (space.nel // space.elem_shape[-1])
    element_KF = _make_element_KF(space, ctx, order, False)

    P = torch.zeros((st.K * dof * dof, st.nnodes), dtype=dt, device=space.device)
    b_grid = torch.zeros(tuple(space.node_shape[::-1]) + (dof,), dtype=dt,
                         device=space.device)
    for c, ids in enumerate(_chunks(space, chunk_sz)):
        Ke, Fe, _ = element_KF(ids, None, system)
        fastpath.accumulate_matrix_dyn_planes(space, P, Ke, c * kz)
        fastpath.accumulate_vector_dyn(space, b_grid, Fe, c * kz)
    op = StencilOperator.from_planes(st, P)
    b = b_grid.reshape(st.nnodes, dof)
    if apply_fix:
        op, b = dirichlet_post_fix(space, op, b)
    return op, _add_flux(space, b)


def assemble_separable_planes(
    space,
    *,
    c: float = 0.0,
    kappa: float = 1.0,
    forcing: Optional[Callable] = None,
    chunk: Optional[int] = None,
    apply_fix: bool = True,
):
    """Sum-factorized assembly of the separable reaction–diffusion system
    ``a(u,v) = ∫ c u v + κ ∇u·∇v`` (identity map, constant coefficients):
    the element matrix is the Kronecker combination

        Ke = c M_z⊗M_y⊗M_x + κ (S_z⊗M_y⊗M_x + M_z⊗S_y⊗M_x + M_z⊗M_y⊗S_x)

    of per-axis 1-D element mass and stiffness matrices ((p+1)² each,
    computed once per axis), accumulated by shifted slice adds straight
    into the kernel's slot-major planes.  The same operator as
    :func:`assemble_system_planes` with the generic Poisson form.

    ``forcing(x) -> scalar`` at one point builds the load vector through
    the order-0 tabulation; Dirichlet elimination is the post-assembly
    fix.  Open regular unit-step spaces, dof = 1.  Returns ``(op, b)``
    with ``op`` a full-storage :class:`StencilOperator`."""
    st = stencil_of(space)
    if any(space.periodic):
        raise ValueError("separable assembly requires open axes")
    if not fastpath.is_unit_step(space) or space.dof != 1:
        raise ValueError("separable assembly requires a regular unit-step dof=1 space")
    if space.has_geometry:
        raise ValueError("separable assembly requires the identity map")
    profiling.count("IGA_FormSystem", profiling.system_flops(space))
    dt, dim, dev = space.dtype, space.dim, space.device
    eshape = space.elem_shape
    if chunk is None:
        chunk = min(space.nel, 8192)
    chunk_sz = fastpath.slab_chunk(space, chunk)
    kz = chunk_sz // (space.nel // eshape[-1])

    # per-axis 1-D element matrices (nel_d, p_d+1, p_d+1)
    Ms, Ss = [], []
    for t in space.tabs:
        w = torch.as_tensor(t.weight * t.detJac[:, None], dtype=dt, device=dev)
        B0 = torch.as_tensor(t.value[:, :, 0, :], dtype=dt, device=dev)
        B1 = torch.as_tensor(t.value[:, :, 1, :], dtype=dt, device=dev)
        Ms.append(torch.einsum("eq,eqa,eqb->eab", w, B0, B0))
        Ss.append(torch.einsum("eq,eqa,eqb->eab", w, B1, B1))

    def kron(parts):
        # slowest axis major, so the flat local index is axis-0 fastest
        out = parts[dim - 1]
        for d in range(dim - 2, -1, -1):
            t = parts[d]
            B, na, nb = out.shape
            out = (out[:, :, None, :, None] * t[:, None, :, None, :]).reshape(
                B, na * t.shape[1], nb * t.shape[2])
        return out

    def chunk_Ke(ids):
        rem, fac = ids, []
        for d in range(dim):
            ed = rem % eshape[d]
            rem = rem // eshape[d]
            fac.append((Ms[d][ed], Ss[d][ed]))
        Ke = c * kron([f[0] for f in fac]) if c != 0.0 else None
        for dd in range(dim):
            term = kappa * kron([fac[d][1] if d == dd else fac[d][0] for d in range(dim)])
            Ke = term if Ke is None else Ke + term
        return Ke

    P = torch.zeros((st.K, st.nnodes), dtype=dt, device=dev)
    b_grid = torch.zeros(tuple(space.node_shape[::-1]) + (1,), dtype=dt, device=dev)
    for ci, ids in enumerate(_chunks(space, chunk_sz)):
        fastpath.accumulate_matrix_dyn_planes(space, P, chunk_Ke(ids)[..., None, None],
                                              ci * kz)
        if forcing is not None:
            pb = tabulate_elements(space, ids, order=0)
            f = torch.func.vmap(torch.func.vmap(forcing))(pb.x)
            Fe = torch.einsum("bq,bqa->ba", pb.weight * f, pb.shape[0])[..., None]
            fastpath.accumulate_vector_dyn(space, b_grid, Fe, ci * kz)
    op = StencilOperator.from_planes(st, P)
    b = b_grid.reshape(st.nnodes, 1)
    if apply_fix:
        op, b = dirichlet_post_fix(space, op, b)
    return op, _add_flux(space, b)


def assemble_system(
    space,
    system: Callable,
    ctx=None,
    *,
    boundary: Optional[Callable] = None,
    order: Optional[int] = None,
    chunk: Optional[int] = None,
    apply_fix: bool = True,
    method: str = "auto",
    fix: str = "element",
):
    """Assemble (A, b) from a Galerkin system form (IGAComputeSystem).

    ``fix="post"`` applies the Dirichlet elimination globally after
    assembly (:func:`dirichlet_post_fix` — algebraically identical to
    the per-element masks of ``fix="element"``).

    ``system(pt, ctx) -> (K, F)`` at one quadrature point, with
    K reshapeable to (nen*dof, nen*dof) and F to (nen*dof).
    ``boundary(pt, ctx) -> (K, F)`` is evaluated on faces flagged with
    ``space.set_boundary_form``.

    ``method``: "shift" uses the scatter-free shifted-slice accumulation
    (regular knot vectors), "scatter" the index-based scatter-add,
    "auto" picks shift when available.

    ``qbatched`` forms: if ``system`` has an attribute ``qbatched=True``
    it is called as ``system(pt, w, ctx)`` with Point leaves carrying a
    leading quadrature axis (Q, ...) and weights w (Q,), and must return
    the quadrature-summed (K, F) — the form contracts over q with one
    matmul instead of looped outer products.

    Returns a :class:`StencilMatrix` (node-major) and ``b`` (nnodes, dof).
    """
    st = stencil_of(space)
    dt, dof = space.dtype, space.dof
    fast = method != "scatter" and fastpath.is_regular(space)
    if method == "shift" and not fast:
        raise ValueError("shift method requires a regular space")
    if fix not in ("element", "post"):
        raise ValueError(f"unknown fix mode {fix!r}")
    post_fix = apply_fix and fix == "post"
    profiling.count("IGA_FormSystem", profiling.system_flops(space))
    element_KF = _make_element_KF(space, ctx, order, apply_fix and not post_fix)

    if fast:
        if chunk is None:
            chunk = min(space.nel, 8192)
        chunk_sz = fastpath.slab_chunk(space, chunk)
        kz = chunk_sz // (space.nel // space.elem_shape[-1])
        N_rev = tuple(space.node_shape[::-1])
        A_grid = torch.zeros(N_rev + (st.K, dof, dof), dtype=dt, device=space.device)
        b_grid = torch.zeros(N_rev + (dof,), dtype=dt, device=space.device)
        for c, ids in enumerate(_chunks(space, chunk_sz)):
            Ke, Fe, _ = element_KF(ids, None, system)
            fastpath.accumulate_matrix(space, A_grid, Ke, c * kz)
            fastpath.accumulate_vector(space, b_grid, Fe, c * kz)
        A_data = A_grid.reshape(st.nnodes * st.K, dof, dof)
        b = b_grid.reshape(st.nnodes, dof)
    else:
        A_data = torch.zeros((st.nnodes * st.K, dof, dof), dtype=dt, device=space.device)
        b = torch.zeros((st.nnodes, dof), dtype=dt, device=space.device)
        for ids in _chunks(space, chunk):
            Ke, Fe, emap = element_KF(ids, None, system)
            _scatter_matrix(space, A_data, Ke, emap)
            _scatter_vector(space, b, Fe, emap)

    if boundary is not None:
        for d, s in _faces_to_visit(space):
            fids = torch.as_tensor(_face_elements(space, d, s), device=space.device)
            Ke, Fe, emap = element_KF(fids, (d, s), boundary)
            _scatter_matrix(space, A_data, Ke, emap)
            _scatter_vector(space, b, Fe, emap)

    A = StencilMatrix(st, A_data.reshape(st.nnodes, st.K, dof, dof))
    if post_fix:
        A, b = dirichlet_post_fix(space, A, b)
    return A, _add_flux(space, b)


def assemble_vector(space, vecform, ctx=None, *, order=None, chunk=None):
    """Assemble a load vector from F-only form (IGAComputeVector)."""
    profiling.count("IGA_FormVector", profiling.residual_flops(space))
    dt = space.dtype
    nen, dof = space.nen, space.dof
    b = torch.zeros((space.nnodes, dof), dtype=dt, device=space.device)

    def one(pt):
        return _normalize_F(vecform(pt, ctx), nen, dof, dt)

    def body(Fa, pt, w):
        return Fa.addcmul_(w[:, None], _vmap(one, pt))

    for ids in _chunks(space, chunk):
        pb = tabulate_elements(space, ids, order=order)
        emap = space.device_emap(ids)
        B = ids.shape[0]
        Fe = _scan_points(pb, body, torch.zeros((B, nen * dof), dtype=dt,
                                                device=space.device))
        _scatter_vector(space, b, Fe.reshape(B, nen, dof), emap)
    return b


def assemble_matrix(space, matform, ctx=None, *, order=None, chunk=None,
                    apply_fix: bool = True):
    """Assemble A from a K-only form (IGAComputeMatrix)."""
    def system(pt, c):
        return matform(pt, c), pt.shape0.new_zeros(space.nen * space.dof)

    A, _ = assemble_system(space, system, ctx, order=order, chunk=chunk,
                           apply_fix=apply_fix)
    return A


def _call_function(function, pt, ue, aux_e, ctx):
    """Call a residual form, passing per-element auxiliary closures (time
    integrator states U0/V0/..., each (nen, c)) when present."""
    if aux_e is None:
        return function(pt, ue, ctx)
    return function(pt, ue, aux_e, ctx)


def _element_residual(space, function, ctx, pb, Ue, m, v, uorig, aux_e=None,
                      directions=1):
    """Residual (B, nen·dof) of one element batch with Dirichlet
    semantics (FixValues + FixFunction): fixed coefficients are
    overwritten with their boundary values before evaluation; fixed
    residual rows become ``uorig - v``.  Written without in-place
    updates, so it runs under ``torch.func`` transforms.

    The form is evaluated at all of the batch's quadrature points in one
    call (a ``vmap`` over the points inside one over the elements), then
    weighted and summed over the points in order, q = 0 … Q−1: the sum
    of one ``vmap`` per point, bit for bit.  ``directions`` (the tangents
    an enclosing ``vmap`` of ``jvp`` carries) sizes the groups of points
    taken in one call within ``_BATCH_BYTES``."""
    dt = space.dtype
    nen, dof = space.nen, space.dof
    n = nen * dof
    B, Q = pb.weight.shape
    Uf = torch.where(m.reshape(B, nen, dof) > 0, v.reshape(B, nen, dof), Ue)

    def one(pt, ue, ax):
        return _normalize_F(_call_function(function, pt, ue, ax, ctx), nen, dof, dt)

    def element(pt, ue, ax):  # one element at its (group of) points
        return torch.func.vmap(one, in_dims=(_leaf_dims(pt), None, None))(pt, ue, ax)

    pts = _points_of(pb)
    Re = torch.zeros((B, n), dtype=dt, device=Ue.device)
    for q0, q1 in _point_groups(Q, directions * B * n * dt.itemsize):
        profiling.count("IGA_ElementBatch")
        pt = tree_map(lambda a: None if a is None else a[:, q0:q1], pts)
        wR = pb.weight[:, q0:q1, None] * _vmap(element, pt, Uf, aux_e)
        for q in range(q1 - q0):
            Re = Re + wR[:, q]
    return Re * (1.0 - m) + m * (uorig - v)


def _gather_aux(space, aux, emap):
    if aux is None:
        return None
    return {k: v.reshape(space.nnodes, -1)[emap] for k, v in aux.items()}


def _scatter_blocks(space, chunk, blocks, out, directions=1):
    """Accumulate per-chunk element data into ``out``, in place.

    ``blocks(ids) -> (E, emap)`` gives element vectors ``(B, nen, dof)``
    (``out`` (nnodes, dof)) or element matrices ``(B, nen, nen, dof,
    dof)`` (``out`` (nnodes·K, dof, dof)).  ``chunk=None`` sizes the
    chunks by bytes (:func:`_batch_elements`, ``directions`` tangents a
    batch).  Regular spaces take the shifted slice adds of
    :mod:`.fastpath` over whole slabs, in a fixed order (deterministic on
    the card); others ``index_add_``."""
    matrix = out.dim() == 3
    if chunk is None:
        chunk = min(space.nel, _batch_elements(space, directions))
    if fastpath.is_regular(space):
        chunk_sz = fastpath.slab_chunk(space, chunk)
        kz = chunk_sz // (space.nel // space.elem_shape[-1])
        N_rev = tuple(space.node_shape[::-1])
        grid = out.view(N_rev + ((stencil_of(space).K,) if matrix else ()) + out.shape[1:])
        acc = fastpath.accumulate_matrix if matrix else fastpath.accumulate_vector
        for c, ids in enumerate(_chunks(space, chunk_sz)):
            acc(space, grid, blocks(ids)[0], c * kz)
    else:
        scatter = _scatter_matrix if matrix else _scatter_vector
        for ids in _chunks(space, chunk):
            E, emap = blocks(ids)
            scatter(space, out, E, emap)
    return out


def _element_batch(space, function, ctx, ids, order, face, aux, directions=1):
    """An element batch's tables and its residual as a function of the
    element coefficients: ``(res, emap, (pb, m, v, aux_e))`` with
    ``res(Ue (B, nen, dof)) -> (B, nen·dof)``, evaluated under
    ``directions`` tangents.  Boundary forms (``face``) only add to free
    rows, so their fixed rows are zero."""
    pb = tabulate_elements(space, ids, order=order, face=face)
    emap = space.device_emap(ids)
    m, v = _fix_arrays(space, emap)
    aux_e = _gather_aux(space, aux, emap)

    def res(ue):
        uorig = v if face is not None else ue.reshape(m.shape)
        Re = _element_residual(space, function, ctx, pb, ue, m, v, uorig, aux_e,
                               directions)
        return Re * (1.0 - m) if face is not None else Re

    return res, emap, (pb, m, v, aux_e)


def _residual_blocks(space, function, U, ctx, aux, order, face=None, tangent=None):
    """``blocks(ids)`` for :func:`_scatter_blocks`: element residuals of
    ``U`` — or, with ``tangent``, their directional derivatives along
    ``tangent`` (``torch.func.jvp``; the global scatter is linear, so
    this is the derivative of the assembled residual)."""
    def blocks(ids):
        res, emap, _ = _element_batch(space, function, ctx, ids, order, face, aux)
        if tangent is None:
            Re = res(U[emap])
        else:
            _, Re = torch.func.jvp(res, (U[emap],), (tangent[emap],))
        return Re.reshape(emap.shape[0], space.nen, space.dof), emap

    return blocks


def _assemble_residual(space, function, U, ctx, aux, order, chunk, boundary, tangent=None):
    U = U.reshape(space.nnodes, space.dof)
    if tangent is not None:
        tangent = tangent.reshape(U.shape)
    F = torch.zeros((space.nnodes, space.dof), dtype=space.dtype, device=space.device)
    _scatter_blocks(space, chunk, _residual_blocks(space, function, U, ctx, aux, order,
                                                   tangent=tangent), F)
    if boundary is not None:
        for d, s in _faces_to_visit(space):
            fids = torch.as_tensor(_face_elements(space, d, s), device=space.device)
            E, emap = _residual_blocks(space, boundary, U, ctx, aux, order, face=(d, s),
                                       tangent=tangent)(fids)
            _scatter_vector(space, F, E, emap)
    return F


def assemble_function(space, function, U, ctx=None, *, aux=None, order=None,
                      chunk=None, boundary=None):
    """Assemble the residual F(U) (IGAComputeFunction).

    ``function(pt, Ue, ctx) -> R`` reshapeable to (nen*dof) with Ue the
    element coefficients (nen, dof).  With ``aux`` (dict of global
    (nnodes, c) vectors) the signature is ``function(pt, Ue, aux_e, ctx)``
    with aux_e holding (nen, c) element closures — the mechanism behind
    the reference's IFunction/I2Function/IEFunction multi-state forms.
    Dirichlet rows hold ``u - v``; nodal fluxes are subtracted on free
    rows.  Returns (nnodes, dof)."""
    profiling.count("IGA_FormFunction", profiling.residual_flops(space))
    F = _assemble_residual(space, function, U, ctx, aux, order, chunk, boundary)
    flux = boundary_flux_vector(space)
    if flux is not None:
        mask, _ = space.tensor("dirichlet")
        F = F - torch.where(mask, torch.zeros_like(flux), flux)
    return F


def _jacobian_blocks(space, function, U, ctx, jacobian, aux, order, face=None):
    """``blocks(ids)`` for :func:`_scatter_blocks`: element Jacobians
    (B, nen, nen, dof, dof) — forward-mode AD of the element residual
    (one ``jvp`` per local unknown, batched by ``vmap``), or the
    hand-written ``jacobian`` form with FixJacobian's rows and columns."""
    nen, dof, dt = space.nen, space.dof, space.dtype
    n = nen * dof

    def blocks(ids):
        res, emap, (pb, m, v, aux_e) = _element_batch(space, function, ctx, ids, order, face,
                                                      aux, directions=n)
        B = ids.shape[0]
        Ue = U[emap]
        if jacobian is not None:
            Uf = torch.where(m.reshape(B, nen, dof) > 0, v.reshape(B, nen, dof), Ue)

            def one(pt, ue, ax):
                return _normalize_K(_call_function(jacobian, pt, ue, ax, ctx), nen, dof, dt)

            def body(Ka, pt, w):
                return Ka + w[:, None, None] * _vmap(one, pt, Uf, aux_e)

            Je = _scan_points(pb, body, torch.zeros((B, n, n), dtype=dt, device=Ue.device))
            keep = 1.0 - m
            Je = Je * keep[:, :, None] * keep[:, None, :]
            if face is None:
                Je = Je + torch.diag_embed(m)
        else:
            basis = torch.eye(n, dtype=dt, device=Ue.device).reshape(n, 1, nen, dof)

            def column(t):
                return torch.func.jvp(res, (Ue,), (t.expand(B, nen, dof),))[1]

            Je = torch.func.vmap(column)(basis).permute(1, 2, 0)  # (B, row, col)
        Je = Je.reshape(B, nen, dof, nen, dof).permute(0, 1, 3, 2, 4)
        return Je, emap

    return blocks


def assemble_jacobian(space, function, U, ctx=None, *, jacobian=None, aux=None,
                      order=None, chunk=None, boundary=None):
    """Assemble J = dF/dU (IGAComputeJacobian) by forward-mode AD of the
    element residual; ``jacobian(pt, Ue, ctx) -> K`` replaces the AD when
    given.  Returns a node-major :class:`StencilMatrix`, whose
    ``fast_operator()`` is the CUDA kernel operator."""
    profiling.count("IGA_FormJacobian", profiling.jacobian_flops(space))
    st = stencil_of(space)
    dof = space.dof
    U = U.reshape(space.nnodes, dof)
    A_data = torch.zeros((st.nnodes * st.K, dof, dof), dtype=space.dtype, device=space.device)
    _scatter_blocks(space, chunk, _jacobian_blocks(space, function, U, ctx, jacobian, aux, order),
                    A_data, directions=space.nen * dof)
    if boundary is not None:
        for d, s in _faces_to_visit(space):
            fids = torch.as_tensor(_face_elements(space, d, s), device=space.device)
            Je, emap = _jacobian_blocks(space, boundary, U, ctx, None, aux, order,
                                        face=(d, s))(fids)
            _scatter_matrix(space, A_data, Je, emap)
    return StencilMatrix(st, A_data.reshape(st.nnodes, st.K, dof, dof))


# ----------------------------------------------------------- functionals


def compute_scalar(space, functional, U=None, ctx=None, *, order=None, chunk=None):
    """Quadrature sum of a scalar functional (IGAComputeScalar).
    ``functional(pt, Ue, ctx) -> (nsc,)``; returns (nsc,)."""
    profiling.count("IGA_FormScalar", profiling.residual_flops(space))
    Uv = None if U is None else U.reshape(space.nnodes, space.dof)

    def one(pt, ue):
        return torch.atleast_1d(functional(pt, ue, ctx))

    def body(acc, pt, w):
        s = _vmap(one, pt, Ue)
        part = torch.sum(w[:, None] * s, dim=0)
        return part if acc is None else acc + part

    acc = None
    for ids in _chunks(space, chunk):
        pb = tabulate_elements(space, ids, order=order)
        Ue = None if Uv is None else Uv[space.device_emap(ids)]
        acc = _scan_points(pb, body, acc)
    return acc


def _error_norm_l2_factorized(space, U, exact):
    """L2 norm of ``u_h - exact`` on the identity map, sum-factorized:
    u_h is evaluated on the fine quadrature grid (every element's Gauss
    points, per axis) by one banded contraction per axis with the
    ``_fine_basis_mats`` value matrices, in chunks of the slowest axis.
    The same integral as the tabulated :func:`compute_scalar` route."""
    from .convform import _FINE_CHUNK_BYTES, _fine_basis_mats, _fine_points, _fine_weights

    dim, dof = space.dim, space.dof
    dt = space.dtype
    B = [m[0] for m in _fine_basis_mats(space, dt)]  # (F_d, N_d)
    Ug = U.reshape(tuple(space.node_shape[::-1]) + (dof,)).to(dt)
    F_rev = [B[dim - 1 - g].shape[0] for g in range(dim)]
    per_row = math.prod(F_rev[1:]) * (dim + dof + 2)
    cz = max(1, min(F_rev[0], _FINE_CHUNK_BYTES // (per_row * Ug.element_size())))
    total = torch.zeros((), dtype=dt, device=space.device)
    for z0 in range(0, F_rev[0], cz):
        z1 = min(z0 + cz, F_rev[0])
        uh = Ug
        for g in range(dim):  # the chunked slowest axis first
            Bd = B[dim - 1 - g]
            if g == 0:
                Bd = Bd[z0:z1]
            uh = torch.movedim(torch.tensordot(Bd, uh, dims=([1], [g])), 0, g)
        X = _fine_points(space, z0, z1)
        e = uh - exact(X)
        w = _fine_weights(space, z0, z1)
        total = total + torch.sum(w * torch.sum(e * e, dim=-1))
    return torch.sqrt(total)


def _error_norm_pointwise(space, U, exact, k, ctx, order, chunk):
    """The general tabulated route of :func:`compute_error_norm`."""
    if not 0 <= k <= 4:
        raise ValueError("k must be in 0..4")
    field = ("value", "grad", "hess", "der3", "der4")[k]

    def err2(pt, Ue, _):
        e = getattr(pt, field)(Ue) - exact(pt.x)
        return torch.sum(e * e)

    val = compute_scalar(space, err2, U, ctx,
                         order=max(k, 1) if order is None else order, chunk=chunk)
    return torch.sqrt(val[0])


def compute_error_norm(space, U, exact, k: int = 0, ctx=None, *, order=None,
                       chunk=None):
    """L2 (k=0) or H^k-seminorm (k=1..4) of u - u_exact
    (IGAComputeErrorNorm).

    ``exact(x) -> (..., dof) + (nsd,)*k`` — value / gradient / Hessian
    / ... for points ``x`` of shape ``(..., nsd)`` (leading axes
    batched).  k = 0 on the identity map takes the sum-factorized route
    (no per-element tabulation, memory bounded by its own chunks); every
    other case the tabulated pointwise one."""
    if k == 0 and not (space.has_geometry or space.is_rational):
        return _error_norm_l2_factorized(space, U, exact)
    return _error_norm_pointwise(space, U, exact, k, ctx, order, chunk)


# -------------------------------------------------------- boundary fluxes


def boundary_flux_vector(space):
    """Global nodal flux vector from the per-face load tables (PetIGA's
    BuildFix/AddFlux): every element adjacent to a loaded face adds
    ``value * elementFaceArea`` to each face-local basis function of its
    closure.  Returns (nnodes, dof) on ``space.device`` or None."""
    if not any(space.bc[d][s].load for d in range(space.dim) for s in range(2)):
        return None
    flux = np.zeros((space.nnodes, space.dof))
    nen_shape = space.nen_shape
    locs = space._local_index
    for d in range(space.dim):
        for s in range(2):
            loads = space.bc[d][s].load
            if not loads:
                continue
            fids = _face_elements(space, d, s)
            areas = _element_face_areas(space, d, s, fids)
            # face-local slab of the closure
            slab = np.where(locs[d] == (nen_shape[d] - 1 if s else 0))[0]
            nodes = space.element_nodes(fids)[:, slab]  # (nface, nslab)
            for field, value in loads:
                np.add.at(flux[:, field], nodes.ravel(),
                          np.repeat(value * areas, len(slab)))
    return torch.as_tensor(flux, dtype=space.dtype, device=space.device)


def _element_face_areas(space, d, s, fids) -> np.ndarray:
    """Area of each face element's boundary face (PetIGA's
    BoundaryArea)."""
    if not space.has_geometry:
        area = np.ones(len(fids))
        emulti = np.unravel_index(fids, space.elem_shape, order="F")
        for dd in range(space.dim):
            if dd != d:
                area *= 2.0 * space.tabs[dd].detJac[emulti[dd]]
        return area
    # mapped geometry: integrate dS over the face tabulation
    pb = tabulate_elements(space, torch.as_tensor(fids, device=space.device),
                           order=1, face=(d, s))
    return pb.weight.sum(dim=1).cpu().numpy()
