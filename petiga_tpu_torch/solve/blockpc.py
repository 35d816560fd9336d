"""Element- and block-structured preconditioners (port of
:mod:`petiga_tpu.solve.blockpc`): the analogs of the reference's
PCIGAEBE (petigapce.c: block diagonal of inverted element matrices) and
PCIGABBB (petigapcb.c: a dense-inverted overlapping neighbourhood block
per control point).

Both are batched dense inverses and gathers.  The inverses are library
calls (``torch.linalg.pinv`` / ``inv``, cuSOLVER on the card), as the
reference's are XLA calls; each application is a gather, one batched
matrix-vector product and, for EBE, an ``index_add_`` scatter.

The pseudo-inverse cut-off is the reference's, passed explicitly:
element stiffness matrices are singular (rigid-body and constant null
spaces), so the cut-off decides which singular values survive, and
``torch.linalg.pinv``'s default (``max(M, N)·eps``) is ten times smaller
than ``jnp.linalg.pinv``'s (``10·max(M, N)·eps``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ebe_preconditioner", "bbb_preconditioner"]


def _pinv_rtol(n: int, dtype) -> float:
    """The reference's relative pseudo-inverse cut-off for ``n × n``
    matrices: ``10·n·eps`` of ``dtype`` (``jnp.linalg.pinv``'s default)."""
    return 10.0 * n * torch.finfo(dtype).eps


def ebe_preconditioner(space, element_matrices, *, scaled: bool = True):
    """Element-by-element PC (PCIGAEBE, petigapce.c:18-259).

    ``element_matrices``: (nel, nen·dof, nen·dof) element blocks (as
    produced during assembly, after the Dirichlet fix).  Application:
    ``M⁻¹ r = Σ_e C_eᵀ (W Ke W)⁺ C_e r`` with ``W`` the inverse square
    roots of the node multiplicities (each dof counted once)."""
    dof, nen = space.dof, space.nen
    mapping = space.tensor("mapping")  # (nel, nen)
    mult = np.bincount(space.mapping.ravel(), minlength=space.nnodes).astype(np.float64)
    w = torch.as_tensor(1.0 / np.sqrt(mult), dtype=space.dtype, device=space.device)

    Ke = element_matrices.reshape(-1, nen * dof, nen * dof)
    if scaled:
        We = torch.repeat_interleave(w[mapping], dof, dim=1)  # (nel, nen·dof)
        Ke = Ke * We[:, :, None] * We[:, None, :]
    Kinv = torch.linalg.pinv(Ke, rtol=_pinv_rtol(nen * dof, Ke.dtype))
    rows = mapping.reshape(-1)

    def M(r):
        rv = r.reshape(space.nnodes, dof)
        re = rv[mapping].reshape(-1, nen * dof)  # gather the closures
        ze = torch.einsum("eij,ej->ei", Kinv, re)
        z = torch.zeros_like(rv).index_add_(0, rows, ze.reshape(-1, dof))
        return z.reshape(r.shape)

    return M


def bbb_preconditioner(A, *, overlap: int = 1):
    """Block-by-block PC (PCIGABBB, petigapcb.c): for every control
    point, dense-invert the ``(2·overlap + 1)^dim`` neighbourhood block of
    the assembled operator and apply its centre row.

    ``overlap`` defaults to 1 (3^dim neighbourhoods); the reference's C
    code defaults to the degree, stronger and far costlier.  ``A`` is a
    node-major :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix`."""
    st = A.stencil
    dim, dof = st.dim, st.dof
    N = st.node_shape
    m = 2 * overlap + 1
    nb = m ** dim
    dev = A.data.device

    # neighbourhood offsets (axis-0 fastest)
    offs = np.stack(np.meshgrid(*[np.arange(-overlap, overlap + 1)] * dim, indexing="ij"),
                    axis=-1).reshape(-1, dim, order="F")
    multi = np.unravel_index(np.arange(st.nnodes), N, order="F")
    nbr = np.zeros((st.nnodes, nb), np.int64)
    valid = np.ones((st.nnodes, nb), bool)
    stride = 1
    for d in range(dim):
        j = multi[d][:, None] + offs[None, :, d]
        if st.periodic[d]:
            j = np.mod(j, N[d])
        else:
            valid &= (j >= 0) & (j < N[d])
            j = np.clip(j, 0, N[d] - 1)
        nbr += j * stride
        stride *= N[d]

    # B[n, i, j] = A[nbr[n, i], nbr[n, j]] through the slot of the offset
    # between the two neighbours
    slot_of = {tuple(o): s for s, o in enumerate(st.slot_offsets())}
    pairs = np.zeros((nb, nb), np.int64)
    pair_ok = np.zeros((nb, nb), bool)
    for i in range(nb):
        for j in range(nb):
            o = tuple(offs[j] - offs[i])
            if all(abs(o[d]) <= st.widths[d] for d in range(dim)):
                pairs[i, j] = slot_of[o]
                pair_ok[i, j] = True
    nbr_t = torch.as_tensor(nbr, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    Bk = A.data[nbr_t[:, :, None], torch.as_tensor(pairs, device=dev)[None]]
    mask = valid_t[:, :, None] & valid_t[:, None, :] & torch.as_tensor(pair_ok, device=dev)[None]
    Bk = torch.where(mask[..., None, None], Bk, torch.zeros((), dtype=Bk.dtype, device=dev))
    B = Bk.permute(0, 1, 3, 2, 4).reshape(st.nnodes, nb * dof, nb * dof)
    # identity on the rows of neighbours off the grid, so the inverse exists
    fix = torch.repeat_interleave(~valid_t, dof, dim=1).to(B.dtype)
    B = B + torch.diag_embed(fix)
    center = nb // 2
    Crow = torch.linalg.inv(B)[:, center * dof:(center + 1) * dof, :].contiguous()

    def M(r):
        rv = r.reshape(st.nnodes, dof)
        rn = torch.where(valid_t[..., None], rv[nbr_t], torch.zeros((), dtype=rv.dtype,
                                                                      device=dev))
        return torch.einsum("nij,nj->ni", Crow, rn.reshape(st.nnodes, nb * dof)).reshape(r.shape)

    return M
