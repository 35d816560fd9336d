"""Batched dim-D tabulation: tensor product, NURBS rationalization,
geometry map, inverse map, pushforward (port of
:mod:`petiga_tpu.assembly.tabulation`; the analog of PetIGA's per-element
Fortran kernel chain ``petiga{1,2,3}d.F90``, ``petigarat``,
``petigamapgeo/inv/shf``).

Everything here operates on a *batch* of elements at once, on
``space.device`` in ``space.dtype``: the per-element/per-point loops of
PetIGA become batched einsums.

Index conventions (axis 0 fastest everywhere, matching
:mod:`petiga_tpu_torch.core.space`):

  * ``N[k]``: parametric partials, shape ``(B, Q, nen, dim^k)`` expressed
    as ``(B, Q, nen) + (dim,)*k``; ``N[1][..., a] = dN/du_a``.
  * ``X1[..., i, a] = dx_i/du_a`` (nsd × dim);
    ``X2[..., i, a, b] = d2x_i/du_a du_b``.
  * ``E1[..., a, i] = du_a/dx_i`` (dim × nsd); ``E2[..., a, i, j]``,
    ``E3[..., a, i, j, k]`` are higher inverse-map partials.
  * ``shape[k]``: spatial partials ``(B, Q, nen) + (nsd,)*k``.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "PointBlock",
    "tensor_basis",
    "rationalize",
    "geometry_map",
    "inverse_map",
    "push_forward",
    "tabulate_elements",
    "validate_geometry",
    "det_small",
    "inv_small",
    "get_normal",
]


class PointBlock(NamedTuple):
    """Quadrature-point data for a batch of elements (the batched analog
    of ``IGAPoint``).

    ``shape[k]`` has shape ``(B, Q, nen) + (nsd,)*k``.  ``weight`` is the
    full measure ``w_q * detJac_parametric * det(X1)`` (or ``* dS`` on
    boundary faces) — the factor ``IGAPointAddMat`` scales by.
    """

    u: torch.Tensor  # (B, Q, dim) parametric coords
    x: torch.Tensor  # (B, Q, nsd) physical coords
    weight: torch.Tensor  # (B, Q)
    shape: tuple  # shape[0..order]
    detX: Optional[torch.Tensor]  # (B, Q) geometry det, None if identity map
    normal: Optional[torch.Tensor]  # (B, Q, nsd) outward normal on faces
    gmap1: Optional[torch.Tensor] = None  # (B, Q, nsd, dim) dx_i/du_a —
    # surface tangents for dim != nsd manifolds (shell models compute
    # their metric from this, like the reference's mapX[1] access)
    gmap2: Optional[torch.Tensor] = None  # (B, Q, nsd, dim, dim) curvature

    @property
    def nen(self) -> int:
        return self.shape[0].shape[-1]

    @property
    def dim(self) -> int:
        return self.u.shape[-1]

    @property
    def nsd(self) -> int:
        return self.x.shape[-1]


# --------------------------------------------------------------- small linalg


def det_small(A):
    """Determinant of (..., d, d), d in {1,2,3}, explicit cofactors."""
    d = A.shape[-1]
    if d == 1:
        return A[..., 0, 0]
    if d == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if d == 3:
        return (
            A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
        )
    raise ValueError(f"det_small supports d<=3, got {d}")


def inv_small(A, detA=None):
    """Inverse of (..., d, d), d in {1,2,3}, explicit cofactors."""
    d = A.shape[-1]
    if detA is None:
        detA = det_small(A)
    r = 1.0 / detA
    if d == 1:
        return r[..., None, None]
    if d == 2:
        row0 = torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1)
        row1 = torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1)
        return torch.stack([row0, row1], dim=-2) * r[..., None, None]
    if d == 3:
        c = torch.stack(
            [
                torch.stack(
                    [
                        A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1],
                        A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2],
                        A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1],
                    ],
                    dim=-1,
                ),
                torch.stack(
                    [
                        A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2],
                        A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0],
                        A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2],
                    ],
                    dim=-1,
                ),
                torch.stack(
                    [
                        A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0],
                        A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1],
                        A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0],
                    ],
                    dim=-1,
                ),
            ],
            dim=-2,
        )
        return c * r[..., None, None]
    raise ValueError(f"inv_small supports d<=3, got {d}")


# ----------------------------------------------------------- tensor product


def tensor_basis(axis_tables, order: int):
    """Tensor-product basis partials from per-axis tables.

    Args:
      axis_tables: list over axes of arrays ``(B, nqp_d, 5, p_d+1)`` —
        gathered 1-D tables for the element batch.
      order: highest derivative order to form (0..4).

    Returns:
      list ``N[0..order]``; ``N[k]`` has shape ``(B, Q, nen) + (dim,)*k``
      with Q and nen flattened axis-0 fastest.

    The loops of PetIGA's ``TensorBasisFuns`` over elements and points
    are one batched outer product per distinct per-axis derivative-degree
    tuple (symmetric repeats come from a cache).
    """
    dim = len(axis_tables)
    B = axis_tables[0].shape[0]
    nqs = [t.shape[1] for t in axis_tables]
    nens = [t.shape[3] for t in axis_tables]
    Q = 1
    for n in nqs:
        Q *= n
    nen = 1
    for n in nens:
        nen *= n

    # per-axis per-degree factors: F[d][k] = (B, nqp_d, nen_d)
    factors = [[t[:, :, k, :] for k in range(5)] for t in axis_tables]

    cache: dict = {}

    def product(degs):
        degs = tuple(degs)
        if degs in cache:
            return cache[degs]
        # einsum 'bqa,brb,bsc->bsrqcba' style: output q axes reversed
        # (axis dim-1 ... axis 0) then nen axes reversed, so the final
        # reshape flattens with axis 0 fastest.
        in_subs = []
        qs = "qrs"[:dim]
        as_ = "abc"[:dim]
        for d in range(dim):
            in_subs.append(f"B{qs[d]}{as_[d]}")
        out_sub = "B" + qs[::-1] + as_[::-1]
        eq = ",".join(in_subs) + "->" + out_sub
        args = [factors[d][degs[d]] for d in range(dim)]
        res = torch.einsum(eq, *args).reshape(B, Q, nen)
        cache[degs] = res
        return res

    N = [product((0,) * dim)]
    for k in range(1, order + 1):
        # partial index tuples (i1..ik), each in range(dim)
        parts = []
        for idx in itertools.product(range(dim), repeat=k):
            degs = [0] * dim
            for i in idx:
                degs[i] += 1
            parts.append(product(degs))
        Nk = torch.stack(parts, dim=-1).reshape((B, Q, nen) + (dim,) * k)
        N.append(Nk)
    return N


# ------------------------------------------------------------- rationalize


def rationalize(N, W):
    """NURBS rationalization by the quotient rule through 3rd derivatives
    (PetIGA's ``petigarat``).

    Args:
      N: list of parametric partials ``(B, Q, nen) + (dim,)*k``.
      W: rational weights of the element closure, ``(B, nen)``.

    Returns:
      list R of the same shapes.
    """
    order = len(N) - 1
    Wb = W[:, None, :]  # (B, 1, nen)
    R0 = Wb * N[0]
    W0 = torch.sum(R0, dim=-1, keepdim=True)  # (B, Q, 1)
    R0 = R0 / W0
    R = [R0]
    if order < 1:
        return R
    WN1 = Wb[..., None] * N[1]  # (B,Q,nen,dim)
    W1 = torch.sum(WN1, dim=2)  # (B,Q,dim)
    R1 = (WN1 - R0[..., None] * W1[:, :, None, :]) / W0[..., None]
    R.append(R1)
    if order < 2:
        return R
    WN2 = Wb[..., None, None] * N[2]
    W2 = torch.sum(WN2, dim=2)  # (B,Q,dim,dim)
    R2 = (
        WN2
        - R0[..., None, None] * W2[:, :, None, :, :]
        - R1[..., :, None] * W1[:, :, None, None, :]
        - R1[..., None, :] * W1[:, :, None, :, None]
    ) / W0[..., None, None]
    R.append(R2)
    if order < 3:
        return R
    WN3 = Wb[..., None, None, None] * N[3]
    W3 = torch.sum(WN3, dim=2)  # (B,Q,dim,dim,dim)
    # R3(i,j,k) = [W*N3 - R0*W3 - R1(i)W2(jk) - R1(j)W2(ik) - R1(k)W2(ij)
    #              - R2(jk)W1(i) - R2(ik)W1(j) - R2(ij)W1(k)] / W0
    def ex(x, *axes):
        # expand W-moments over the nen axis
        return x[:, :, None, ...]

    R3 = (
        WN3
        - R0[..., None, None, None] * ex(W3)
        - R1[..., :, None, None] * ex(W2)[..., None, :, :]
        - R1[..., None, :, None] * ex(W2)[..., :, None, :]
        - R1[..., None, None, :] * ex(W2)[..., :, :, None]
        - R2[..., None, :, :] * ex(W1)[..., :, None, None]
        - R2[..., :, None, :] * ex(W1)[..., None, :, None]
        - R2[..., :, :, None] * ex(W1)[..., None, None, :]
    ) / W0[..., None, None, None]
    R.append(R3)
    if order >= 4:
        R.append(torch.zeros_like(N[4]))  # 4th-order rationalization:
        # not implemented in PetIGA or the JAX package either
    return R


# ------------------------------------------------------------ geometry map


def geometry_map(N, Xe):
    """Map derivatives X_k = sum_a N_k[a] * X[a].

    Args:
      N: list of (rationalized) partials.
      Xe: element geometry closure ``(B, nen, nsd)``.

    Returns:
      list ``X[0..order]``: ``X[k]`` shaped ``(B, Q, nsd) + (dim,)*k``.
    """
    out = []
    for k, Nk in enumerate(N):
        # (B,Q,nen,d^k) x (B,nen,nsd) -> (B,Q,nsd,d^k)
        if k == 0:
            Xk = torch.einsum("bqn,bni->bqi", Nk, Xe)
        else:
            Xk = torch.einsum("bq...n,bni->bqi...", torch.movedim(Nk, 2, -1), Xe)
        out.append(Xk)
    return out


def inverse_map(X):
    """Inverse-map partials E1..E3 and det(X1).

    Only valid for dim == nsd.  Returns (detX, [None, E1, E2, E3, ...]).
    """
    order = len(X) - 1
    X1 = X[1]  # (B,Q,nsd,dim)
    detX = det_small(X1)
    E1 = inv_small(X1, detX)  # (B,Q,dim,nsd): E1[a,i] = du_a/dx_i
    E = [None, E1]
    if order >= 2:
        X2 = X[2]  # (B,Q,nsd,dim,dim) : X2[k,a,b]
        # E2[c,i,j] = - X2[k,a,b] E1[a,i] E1[b,j] E1[c,k]
        E2 = -torch.einsum("ZQkab,ZQai,ZQbj,ZQck->ZQcij", X2, E1, E1, E1)
        E.append(E2)
    if order >= 3:
        X2, X3 = X[2], X[3]
        # E3[d,i,j,k] = -[ X3[l,a,b,c] E1[a,i]E1[b,j]E1[c,k]
        #   + X2[l,a,b]( E1[a,i]E2[b,j,k] + E1[b,j]E2[a,i,k] + E1[b,k]E2[a,i,j] )
        #  ] E1[d,l]
        E2 = E[2]
        t1 = torch.einsum("ZQlabc,ZQai,ZQbj,ZQck->ZQlijk", X3, E1, E1, E1)
        t2 = torch.einsum("ZQlab,ZQai,ZQbjk->ZQlijk", X2, E1, E2)
        t3 = torch.einsum("ZQlab,ZQbj,ZQaik->ZQlijk", X2, E1, E2)
        t4 = torch.einsum("ZQlab,ZQbk,ZQaij->ZQlijk", X2, E1, E2)
        E3 = -torch.einsum("ZQlijk,ZQdl->ZQdijk", t1 + t2 + t3 + t4, E1)
        E.append(E3)
    return detX, E


def push_forward(N, E):
    """Spatial partials from parametric partials + inverse map.

    shape1[n,i] = N1[n,a] E1[a,i]
    shape2[n,i,j] = N2[n,a,b] E1[a,i] E1[b,j] + N1[n,a] E2[a,i,j]
    shape3[n,i,j,k] = N3 E1 E1 E1
        + N2[n,a,b](E1[a,i]E2[b,j,k] + E1[b,j]E2[a,i,k] + E1[b,k]E2[a,i,j])
        + N1[n,a] E3[a,i,j,k]
    """
    order = len(N) - 1
    S = [N[0]]
    if order >= 1:
        E1 = E[1]
        S.append(torch.einsum("ZQna,ZQai->ZQni", N[1], E1))
    if order >= 2:
        E1, E2 = E[1], E[2]
        S2 = torch.einsum("ZQnab,ZQai,ZQbj->ZQnij", N[2], E1, E1)
        S2 = S2 + torch.einsum("ZQna,ZQaij->ZQnij", N[1], E2)
        S.append(S2)
    if order >= 3:
        E1, E2, E3 = E[1], E[2], E[3]
        S3 = torch.einsum("ZQnabc,ZQai,ZQbj,ZQck->ZQnijk", N[3], E1, E1, E1)
        S3 = S3 + torch.einsum("ZQnab,ZQai,ZQbjk->ZQnijk", N[2], E1, E2)
        S3 = S3 + torch.einsum("ZQnab,ZQbj,ZQaik->ZQnijk", N[2], E1, E2)
        S3 = S3 + torch.einsum("ZQnab,ZQbk,ZQaij->ZQnijk", N[2], E1, E2)
        S3 = S3 + torch.einsum("ZQna,ZQaijk->ZQnijk", N[1], E3)
        S.append(S3)
    if order >= 4:
        S.append(torch.zeros_like(N[4]))  # matches the JAX package (unimplemented)
    return S


def get_normal(axis: int, side: int, X1):
    """Boundary normal and surface element from the geometry Jacobian.  X1: (B, Q, dim, dim) with X1[i,a]=dx_i/du_a.
    Returns (dS, n) with n unit outward normal, shapes (B,Q) and (B,Q,dim).
    """
    dim = X1.shape[-1]
    if dim == 1:
        dS = torch.ones(X1.shape[:2], dtype=X1.dtype, device=X1.device)
        n = torch.ones(X1.shape[:2] + (1,), dtype=X1.dtype, device=X1.device)
    elif dim == 2:
        # tangent along the in-face parametric direction, with sign so the
        # 90°-rotation below points outward
        t = X1[..., :, 1] if axis == 0 else -X1[..., :, 0]
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
        dS = torch.sqrt(torch.sum(n * n, dim=-1))
        n = n / dS[..., None]
    elif dim == 3:
        # s, t = tangents along the other two axes, cyclic
        o1, o2 = [(1, 2), (2, 0), (0, 1)][axis]
        s = X1[..., :, o1]
        t = X1[..., :, o2]
        n = torch.linalg.cross(s, t, dim=-1)
        dS = torch.sqrt(torch.sum(n * n, dim=-1))
        n = n / dS[..., None]
    else:
        raise ValueError("dim must be 1..3")
    if side == 0:
        n = -n
    return dS, n


# ------------------------------------------------------------ full pipeline


def tabulate_elements(
    space,
    elem_ids,
    order: Optional[int] = None,
    face: Optional[tuple] = None,
):
    """Full tabulation for a batch of elements.

    Args:
      space: a :class:`petiga_tpu_torch.core.space.Space`.
      elem_ids: (B,) int64 flat element indices on ``space.device``.
      order: max derivative order (default space.order).
      face: optional (axis, side) — tabulate on that boundary face of the
        given elements instead of the interior (PetIGA's "atboundary"
        path).

    Returns:
      a :class:`PointBlock`.
    """
    dim = space.dim
    order = space.order if order is None else order
    dt = space.dtype

    vals = space.tensor("tabs_value")
    wts = space.tensor("tabs_weight")
    dJs = space.tensor("tabs_detJac")
    pts = space.tensor("tabs_point")
    bvals = space.tensor("tabs_bnd_value")
    bpts = space.tensor("tabs_bnd_point")

    # decompose flat element ids (axis 0 fastest)
    eshape = space.elem_shape
    rem = elem_ids
    emulti = []
    for d in range(dim):
        emulti.append(rem % eshape[d])
        rem = rem // eshape[d]

    B = elem_ids.shape[0]

    axis_tables = []
    axis_w = []
    axis_u = []
    for d in range(dim):
        if face is not None and face[0] == d:
            side = face[1]
            tabd = torch.broadcast_to(
                bvals[d][side][None, None, :, :],
                (B, 1) + bvals[d][side].shape,
            )
            wd = torch.ones((B, 1), dtype=dt, device=space.device)  # bnd_weight=1, bnd_detJac=1
            ud = torch.broadcast_to(bpts[d][side][None, None], (B, 1))
        else:
            tabd = vals[d][emulti[d]]  # (B, nqp_d, 5, p_d+1)
            wd = wts[d][emulti[d]] * dJs[d][emulti[d]][:, None]
            ud = pts[d][emulti[d]]  # (B, nqp_d)
        axis_tables.append(tabd)
        axis_w.append(wd)
        axis_u.append(ud)

    # combined weights and parametric points, axis-0-fastest flattening
    Q = 1
    for t in axis_tables:
        Q *= t.shape[1]

    def outer_all(parts):
        # parts[d]: (B, nq_d) -> (B, Q) flattened axis-0 fastest
        acc = parts[0]
        for d in range(1, dim):
            acc = (parts[d][:, :, None] * acc[:, None, :]).reshape(B, -1)
        return acc

    weight = outer_all(axis_w)

    us = []
    for d in range(dim):
        shape = [1] * dim
        shape[d] = axis_u[d].shape[1]
        ud = axis_u[d].reshape((B,) + tuple(shape[::-1]))
        ud = torch.broadcast_to(
            ud, (B,) + tuple(t.shape[1] for t in axis_tables[::-1])
        ).reshape(B, Q)
        us.append(ud)
    u = torch.stack(us, dim=-1)  # (B, Q, dim)

    N = tensor_basis(axis_tables, order)

    emap = space.device_emap(elem_ids)  # (B, nen)

    if space.is_rational:
        W = space.tensor("rational")[emap]  # (B, nen)
        N = rationalize(N, W)

    detX = None
    normal = None
    gmap1 = None
    gmap2 = None
    x = u
    S = N
    if space.has_geometry:
        Xe = space.tensor("geometry")[emap]  # (B, nen, nsd)
        X = geometry_map(N, Xe)
        x = X[0]
        gmap1 = X[1]
        gmap2 = X[2] if len(X) > 2 else None
        if dim == space.nsd:
            detX, E = inverse_map(X)
            S = push_forward(N, E)
            if face is None:
                if not space.collocation:
                    weight = weight * detX
            else:
                dS, normal = get_normal(face[0], face[1], X[1])
                if not space.collocation:
                    weight = weight * dS
        # dim != nsd (manifold): shapes stay parametric and the form
        # builds its metric from gmap1/gmap2
    elif face is not None:
        normal = torch.zeros((B, Q, space.nsd), dtype=dt, device=space.device)
        normal[..., face[0]] = 1.0 if face[1] else -1.0

    return PointBlock(u=u, x=x, weight=weight, shape=tuple(S), detX=detX,
                      normal=normal, gmap1=gmap1, gmap2=gmap2)


def validate_geometry(space, *, order: int = 1, chunk: int = 4096):
    """Positive-Jacobian sanity guard — PetIGA's debug assert "Negative
    determinant of Jacobian", here an explicit host-level check to run
    once after ``init_geometry`` (the hot paths stay assert-free).  Raises ``ValueError`` naming the offending elements when
    ``det(∂x/∂u) <= 0`` at any interior quadrature point.
    """
    if not space.has_geometry:
        return  # identity map: detJ ≡ 1
    if space.dim != space.nsd:
        raise ValueError(
            "validate_geometry requires dim == nsd (manifold metrics "
            "are form-defined)"
        )
    bad = []
    for start in range(0, space.nel, chunk):
        ids = torch.arange(start, min(start + chunk, space.nel), device=space.device)
        pb = tabulate_elements(space, ids, order=order)
        d = pb.detX.cpu().numpy()
        rows = np.where((d <= 0.0).any(axis=1))[0]
        bad.extend((start + rows).tolist())
    if bad:
        shown = ", ".join(map(str, bad[:20]))
        more = f" (+{len(bad) - 20} more)" if len(bad) > 20 else ""
        raise ValueError(
            f"non-positive geometry Jacobian determinant in elements "
            f"[{shown}]{more}"
        )
