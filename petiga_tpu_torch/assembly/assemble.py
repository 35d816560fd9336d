"""Dirichlet post-fix and the L2 error functional (port of the plane-layout
parts of :mod:`petiga_tpu.assembly.assemble`).

The post-fix is the reference's global Dirichlet elimination on an
assembled operator: every fixed row and column zeroed, the diagonal set
to the node's element multiplicity (each element's FixSystem adds 1), the
right-hand side lifted by the unfixed operator (``b -= A (m∘v)``, one
kernel matvec) and fixed rows set to ``mult · v``.
"""

from __future__ import annotations

import math

import torch

from ..sparse.spmv import StencilOperator
from ..sparse.stencil import Stencil

__all__ = ["stencil_of", "dirichlet_post_fix", "compute_error_norm"]


def stencil_of(space) -> Stencil:
    return Stencil(
        node_shape=space.node_shape,
        widths=space.degrees,
        periodic=space.periodic,
        dof=space.dof,
    )


def _node_multiplicity(space) -> torch.Tensor:
    """(nnodes,) element multiplicity of every node on ``space.device``:
    per-axis closure counts, outer-multiplied."""
    dim = space.dim
    g = torch.ones((), dtype=space.dtype, device=space.device)
    for gax in range(dim):
        d = dim - 1 - gax
        N = space.node_shape[d]
        idx = space.axis_node_index[d].ravel()
        m = torch.zeros(N, dtype=torch.float64)
        m.index_add_(0, torch.as_tensor(idx), torch.ones(idx.size, dtype=torch.float64))
        g = g[..., None] * m.to(space.dtype).to(space.device)
    return g.reshape(-1)


def dirichlet_post_fix(space, A: StencilOperator, b: torch.Tensor):
    """Global Dirichlet elimination on a plane operator (full or
    symmetric storage) — algebraically the reference's per-element
    FixSystem summed over elements.

    The planes of ``A`` are fixed IN PLACE, so a multi-GB operator is
    never held twice; returns ``(A, b_fixed)``."""
    if not any(space.bc[d][s] for d in range(space.dim) for s in range(2)):
        return A, b
    st, dof = A.st, A.dof
    dt = A.DT.dtype
    mask, vals = space.tensor("dirichlet")
    mult = _node_multiplicity(space)
    maskf = mask.to(dt)
    keep = 1.0 - maskf
    lift = maskf * vals

    # b2 = b - A_unfixed @ lift, through the kernel
    Alift = A.matvec(lift)
    b2 = b - Alift.reshape(b.shape)
    b2 = torch.where(mask, mult[:, None] * vals, b2 * keep)

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
    return A, b2


def compute_error_norm(space, U, exact, k: int = 0):
    """L2 norm of ``u_h - exact`` (IGAComputeErrorNorm, k = 0) on the
    identity map, sum-factorized: u_h is evaluated on the fine quadrature
    grid (every element's Gauss points, per axis) by one banded
    contraction per axis with the ``_fine_basis_mats`` value matrices,
    in chunks of the slowest axis.  The same integral as the reference's
    tabulated ``compute_scalar`` route.

    ``exact(x) -> (..., dof)`` for points ``x`` of shape ``(..., dim)``."""
    from .convform import _FINE_CHUNK_BYTES, _fine_basis_mats, _fine_points, _fine_weights

    if k != 0:
        raise NotImplementedError("H^k error norms (ROADMAP Queue 1 item 6)")
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
