"""Two-level overlapping Schwarz preconditioner (port of
:mod:`petiga_tpu.solve.schwarz`): the analog of the reference's BDDC
preparation layer (petigapcbddc.c), which feeds PETSc's PCBDDC a
subdomain decomposition, primal vertices and "minimal" near-null-space
vectors (masked constants per subdomain).

The node grid is split into a dim-D grid of boxes (the balanced block
distribution of the device partitioner), each extended by ``overlap``
layers (default: the stencil width); every extended box takes its dense
local operator straight from the stencil slot storage, and all of them
are inverted in one batched ``torch.linalg.inv`` (cuSOLVER on the card,
a library call as the reference's XLA inverse is).  The coarse space is
the per-subdomain, per-field constants on the owned (non-overlapping)
boxes, or user modes such as the rigid-body modes of elasticity, with
``A0 = R0 A R0ᵀ`` formed by stencil products and dense-inverted.

Application is the symmetric balancing (hybrid) form:

    z1 = C r,   z2 = z1 + Σ_s R_sᵀ A_s⁻¹ R_s (r − A z1),
    M r = z2 + C (r − A z2),        C = R0ᵀ A0⁻¹ R0.

``restricted=True`` scatters only the owned boxes (RAS; nonsymmetric,
pair with BiCGStab/GMRES).  Every product with ``A`` (the coarse
operator's columns, the balancing residuals) runs on the stencil kernel
(``A.fast_operator()``).

:func:`schwarz_local_preconditioner` is the same two-level method under
domain decomposition, for the distributed solvers of
:class:`~petiga_tpu_torch.parallel.dist.DistSpace`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["schwarz_preconditioner", "schwarz_local_preconditioner", "subdomain_boxes"]


def subdomain_boxes(N, nsub):
    """Balanced 1-D block split per axis: ``N[d]`` nodes into ``nsub[d]``
    chunks (the IGA_Dist1D rule: N//s + (N%s > rank)).  Returns per-axis
    (starts, sizes) numpy arrays."""
    starts, sizes = [], []
    for n, s in zip(N, nsub):
        if not (1 <= s <= n):
            raise ValueError(f"cannot split {n} nodes into {s} subdomains")
        sz = np.full(s, n // s, np.int64)
        sz[: n % s] += 1
        starts.append(np.concatenate([[0], np.cumsum(sz)[:-1]]))
        sizes.append(sz)
    return starts, sizes


MAX_SUBDOMAIN_BLOCK = 4096  # dense-inverse guard: (nb·dof)² entries


def _check_block(N, subdomains, ov, dof, max_block):
    """Refuse memory-quadratic dense subdomain inverses (raise, never
    allocate)."""
    nb = 1
    for n, s in zip(N, subdomains):
        nb *= -(-n // s) + 2 * ov
    if nb * dof > max_block:
        raise ValueError(
            f"Schwarz subdomain block is {nb * dof} dofs "
            f"(> max_block={max_block}); its dense inverse would need "
            f"{(nb * dof) ** 2 * 8 / 2**30:.1f} GiB per box — use more "
            f"subdomains (smaller boxes) or raise max_block explicitly"
        )


def schwarz_preconditioner(
    A,
    *,
    subdomains=None,
    overlap=None,
    coarse: bool = True,
    restricted: bool = False,
    coarse_modes=None,
    max_block: int = MAX_SUBDOMAIN_BLOCK,
):
    """The two-level Schwarz PC for a node-major
    :class:`~petiga_tpu_torch.sparse.stencil.StencilMatrix` ``A``
    (Dirichlet rows already fixed).

    Args:
      subdomains: per-axis subdomain counts; default ``N_d // 8`` (at
        least 1).
      overlap: extension layers; default the largest stencil half-width.
      coarse: include the coarse correction.
      restricted: RAS scatter (owned boxes only; nonsymmetric).
      coarse_modes: optional (nmodes, nnodes, dof) near-null-space vectors
        in place of the per-field constants (for elasticity,
        ``models.elasticity.rigid_body_modes``).
      max_block: guard on the dense subdomain block size ``nb·dof``.

    Returns ``M(r) -> z``, closed over the factors on ``A``'s device."""
    st = A.stencil
    dim, dof, N = st.dim, st.dof, st.node_shape
    dev, dt = A.data.device, A.data.dtype
    if subdomains is None:
        subdomains = tuple(max(1, n // 8) for n in N)
    subdomains = tuple(int(s) for s in subdomains)
    if len(subdomains) != dim:
        raise ValueError("subdomains must give one count per axis")
    ov = int(max(st.widths) if overlap is None else overlap)
    for n, p in zip(N, st.widths):
        if n <= 2 * p:
            raise ValueError("grid too small for the stencil width")
    _check_block(N, subdomains, ov, dof, max_block)

    starts, sizes = subdomain_boxes(N, subdomains)
    nsub = int(np.prod(subdomains))
    ext = tuple(int(sizes[d].max()) + 2 * ov for d in range(dim))
    nb = int(np.prod(ext))
    # local multi-index grid of the extended box, axis-0 fastest
    grids = np.meshgrid(*[np.arange(e) for e in ext], indexing="ij")
    local = np.stack([g.ravel(order="F") for g in grids], axis=-1)  # (nb, dim)
    sub_multi = np.unravel_index(np.arange(nsub), subdomains, order="F")

    idx = np.zeros((nsub, nb), np.int64)
    valid = np.ones((nsub, nb), bool)
    owned = np.ones((nsub, nb), bool)
    stride = 1
    for d in range(dim):
        base = starts[d][sub_multi[d]] - ov
        sz = sizes[d][sub_multi[d]]
        j = base[:, None] + local[None, :, d]
        # entries past this subdomain's (possibly shorter) extended box
        valid &= local[None, :, d] < (sz[:, None] + 2 * ov)
        owned &= (local[None, :, d] >= ov) & (local[None, :, d] < sz[:, None] + ov)
        if st.periodic[d]:
            j = np.mod(j, N[d])
        else:
            valid &= (j >= 0) & (j < N[d])
            j = np.clip(j, 0, N[d] - 1)
        idx += j * stride
        stride *= N[d]
    owned &= valid

    # pair slot table of the local box (shared by all subdomains)
    slot_of = {tuple(o): s for s, o in enumerate(st.slot_offsets())}
    off = local[None, :, :] - local[:, None, :]
    pair_ok = np.all(np.abs(off) <= np.asarray(st.widths), axis=-1)
    pairs = np.zeros((nb, nb), np.int64)
    ii, jj = np.nonzero(pair_ok)
    pairs[ii, jj] = [slot_of[tuple(o)] for o in off[ii, jj]]

    idx_t = torch.as_tensor(idx, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    scatter_t = torch.as_tensor(owned if restricted else valid, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    # dense local operators: B[s, i, :, j, :] = data[idx[s, i], pairs[i, j]]
    Bk = A.data[idx_t[:, :, None], torch.as_tensor(pairs, device=dev)[None]]
    mask = valid_t[:, :, None] & valid_t[:, None, :] & torch.as_tensor(pair_ok, device=dev)[None]
    Bk = torch.where(mask[..., None, None], Bk, zero)
    B = Bk.permute(0, 1, 3, 2, 4).reshape(nsub, nb * dof, nb * dof)
    del Bk, mask
    # identity on masked-out entries so the batched inverse exists
    B = B + torch.diag_embed(torch.repeat_interleave(~valid_t, dof, dim=1).to(dt))
    Binv = torch.linalg.inv(B)
    del B
    Af = A.fast_operator()

    if coarse:
        if coarse_modes is None:
            modes = np.zeros((dof, st.nnodes, dof))
            for f in range(dof):
                modes[f, :, f] = 1.0
        else:
            modes = np.asarray(coarse_modes, np.float64)
            if modes.shape[1:] != (st.nnodes, dof):
                raise ValueError(f"coarse_modes must be (nmodes, {st.nnodes}, {dof})")
        nm = modes.shape[0]
        R0 = np.zeros((nsub * nm, st.nnodes, dof))
        for s in range(nsub):
            rows = idx[s][owned[s]]
            for k in range(nm):
                R0[s * nm + k, rows, :] = modes[k, rows, :]
        R0_t = torch.as_tensor(R0, dtype=dt, device=dev)
        # A0[c, c'] = R0_c · A R0_c', one kernel product per coarse vector
        AR = torch.stack([Af.matvec(R0_t[c]) for c in range(nsub * nm)])
        A0 = torch.einsum("cnd,knd->ck", R0_t, AR)
        del AR
        # Dirichlet-eliminated rows can zero a mode on a box entirely
        dead = (torch.diagonal(A0).abs() < 1e-30).to(dt)
        A0inv = torch.linalg.inv(A0 + torch.diag_embed(dead))

    nnodes = st.nnodes
    flat_idx = idx_t.reshape(-1)

    def local_solves(rv):
        re = torch.where(valid_t[..., None], rv[idx_t], zero).reshape(nsub, nb * dof)
        ze = torch.einsum("sij,sj->si", Binv, re).reshape(nsub, nb, dof)
        ze = torch.where(scatter_t[..., None], ze, zero)
        return torch.zeros_like(rv).index_add_(0, flat_idx, ze.reshape(-1, dof))

    def coarse_solve(rv):
        rc = torch.einsum("cnd,nd->c", R0_t, rv)
        return torch.einsum("cnd,c->nd", R0_t, A0inv @ rc)

    def M(r):
        rv = r.reshape(nnodes, dof)
        if not coarse:
            return local_solves(rv).reshape(r.shape)
        z1 = coarse_solve(rv)
        z2 = z1 + local_solves(rv - Af.matvec(z1))
        return (z2 + coarse_solve(rv - Af.matvec(z2))).reshape(r.shape)

    return M


def _coarse_ids(ds, L, nsub, starts):
    """Per local row its (rank, box) coarse id, and per (row, slot) the
    coarse id of the column's (rank, box), int64 (the reference builds
    int64 ids on the mode path, schwarz.py:568-569)."""
    sp = ds.space
    dim, K = sp.dim, ds.st.K
    m = ds.pgrid
    nloc = int(np.prod(L))
    nsub_loc = int(np.prod(nsub))
    boxtab = [np.searchsorted(starts[d], np.arange(L[d]), side="right") - 1 for d in range(dim)]
    lgrids = np.meshgrid(*[np.arange(n) for n in L], indexing="ij")
    lc = np.stack([g.ravel(order="F") for g in lgrids], axis=-1)
    row_box = np.zeros(nloc, np.int64)
    for d in range(dim - 1, -1, -1):
        row_box = row_box * nsub[d] + boxtab[d][lc[:, d]]
    soffs = ds.st.slot_offsets()
    dev_flat = ds.rank
    row_cid = dev_flat * nsub_loc + row_box
    cdev_flat = np.zeros((nloc, K), np.int64)
    cbox_flat = np.zeros((nloc, K), np.int64)
    for d in range(dim - 1, -1, -1):
        g = ds.coords[d] * L[d] + lc[:, d:d + 1] + soffs[None, :, d]
        if sp.periodic[d]:
            g = np.mod(g, sp.node_shape[d])
        else:
            g = np.clip(g, 0, L[d] * m[d] - 1)
        cdev = g // L[d]
        cdev_flat = cdev_flat * m[d] + cdev
        cbox_flat = cbox_flat * nsub[d] + boxtab[d][g - cdev * L[d]]
    col_cid = cdev_flat * nsub_loc + cbox_flat
    return lc, row_cid, col_cid


def schwarz_local_preconditioner(
    *,
    subdomains=None,
    overlap=None,
    coarse: bool = True,
    restricted: bool = False,
    coarse_modes=None,
    max_block: int = MAX_SUBDOMAIN_BLOCK,
):
    """Distributed two-level Schwarz — the serial PC above applied inside
    the ranks' Krylov loops (the role PCBDDC plays under MPI,
    petigapcbddc.c + petigaksp.c:260-384).

    Returns a ``pc`` callable for ``DistSpace.cg/bicgstab/gmres``'s
    ``pc=`` argument (``(ds, data_loc) -> Mv``).  Per rank, the owned
    block is split into subdomain boxes extended by ``overlap`` layers
    (capped at the stencil width, so every needed row is in the p-wide
    halo shell the layer already exchanges); the dense subdomain
    operators come from the halo-gathered stencil rows and are
    batch-inverted.  Overlaps that cross ranks go through the forward
    halo (residual gather) and the reverse halo fold (solution scatter).

    The coarse space is one constant per (rank, box, field) on the
    disjoint owned boxes — or, with ``coarse_modes`` (nmodes, nnodes,
    dof), each mode restricted to a (rank, box) — with ``A0 = R0 A R0ᵀ``
    assembled from the local stencil rows and all-reduced, so it is the
    same on every rank; application is the symmetric balancing form.
    """

    def pc(ds, data_loc):
        sp = ds.space
        st = ds.st
        dim, dof, K = st.dim, st.dof, st.K
        p = tuple(int(w) for w in st.widths)
        L = tuple(int(n) for n in ds.L)
        dev, dt = data_loc.device, data_loc.dtype
        ov = tuple(min(p[d], p[d] if overlap is None else int(overlap)) for d in range(dim))
        nsub = (tuple(max(1, L[d] // 8) for d in range(dim)) if subdomains is None
                else tuple(int(n) for n in subdomains))
        starts, sizes = subdomain_boxes(L, nsub)
        nsub_loc = int(np.prod(nsub))
        ext = tuple(int(sizes[d].max()) + 2 * ov[d] for d in range(dim))
        nb = int(np.prod(ext))
        if nb * dof > max_block:
            raise ValueError(
                f"Schwarz subdomain block is {nb * dof} dofs (> max_block={max_block}) — "
                "use more subdomains per rank or raise max_block explicitly"
            )
        Lext = ds.Lext
        next_ = int(np.prod(Lext))
        nloc = int(np.prod(L))

        # static tables (the same on every rank: equal padded blocks)
        grids = np.meshgrid(*[np.arange(e) for e in ext], indexing="ij")
        local = np.stack([g.ravel(order="F") for g in grids], axis=-1)
        sub_multi = np.unravel_index(np.arange(nsub_loc), nsub, order="F")
        idx = np.zeros((nsub_loc, nb), np.int64)
        valid = np.ones((nsub_loc, nb), bool)
        owned = np.ones((nsub_loc, nb), bool)
        stride = 1
        for d in range(dim):
            base = p[d] - ov[d] + starts[d][sub_multi[d]]  # extended-block coordinate
            sz = sizes[d][sub_multi[d]]
            valid &= local[None, :, d] < (sz[:, None] + 2 * ov[d])
            owned &= (local[None, :, d] >= ov[d]) & (local[None, :, d] < sz[:, None] + ov[d])
            idx += (base[:, None] + local[None, :, d]) * stride
            stride *= Lext[d]
        owned &= valid
        idx = np.where(valid, idx, 0)  # entries past a shorter box: masked, kept in range
        soffs = st.slot_offsets()
        slot_of = {tuple(soffs[s_]): s_ for s_ in range(K)}
        off = local[None, :, :] - local[:, None, :]
        pair_ok = np.all(np.abs(off) <= np.asarray(p), axis=-1)
        pairs = np.zeros((nb, nb), np.int64)
        ii, jj = np.nonzero(pair_ok)
        pairs[ii, jj] = [slot_of[tuple(o)] for o in off[ii, jj]]

        idx_t = torch.as_tensor(idx, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        scatter_t = torch.as_tensor(owned if restricted else valid, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)

        # dense subdomain operators from halo-gathered stencil rows
        dataK = data_loc.reshape(tuple(L[::-1]) + (K * dof * dof,))
        data_ext = ds.halo_gather(dataK).reshape(next_, K, dof, dof)
        Bk = data_ext[idx_t[:, :, None], torch.as_tensor(pairs, device=dev)[None]]
        mask = valid_t[:, :, None] & valid_t[:, None, :] & torch.as_tensor(pair_ok, device=dev)[None]
        Bk = torch.where(mask[..., None, None], Bk, zero)
        B = Bk.permute(0, 1, 3, 2, 4).reshape(nsub_loc, nb * dof, nb * dof)
        del Bk, mask, data_ext
        # identity on dead rows (mask, padding, open-boundary shell)
        dead = (B.abs().sum(dim=2) == 0).to(dt)
        Binv = torch.linalg.inv(B + torch.diag_embed(dead))
        del B
        flat_idx = idx_t.reshape(-1)
        Lrev = tuple(L[::-1])

        def Av(v):
            return ds.matvec_local(data_loc, v)

        def local_solves(r_loc):
            r_ext = ds.halo_gather(r_loc).reshape(next_, dof)
            re = torch.where(valid_t[..., None], r_ext[idx_t], zero).reshape(nsub_loc, nb * dof)
            ze = torch.einsum("sij,sj->si", Binv, re).reshape(nsub_loc, nb, dof)
            ze = torch.where(scatter_t[..., None], ze, zero)
            zext = torch.zeros((next_, dof), dtype=dt, device=dev).index_add_(
                0, flat_idx, ze.reshape(-1, dof))
            return ds.halo_fold(zext.reshape(tuple(Lext[::-1]) + (dof,)))

        if not coarse:
            return local_solves

        lc, row_cid, col_cid = _coarse_ids(ds, L, nsub, starts)
        row_cid_t = torch.as_tensor(row_cid, device=dev)
        col_cid_t = torch.as_tensor(col_cid, device=dev)
        vals = data_loc.reshape(nloc, K, dof, dof)
        ndev = ds.world
        if coarse_modes is None:
            # constants per (rank, box, field)
            nm = dof
            Wr = torch.eye(dof, dtype=dt, device=dev).expand(nloc, dof, dof)  # (i, m, a)
            We = Wr[:, None].expand(nloc, K, dof, dof)
        else:
            modes = np.asarray(coarse_modes, np.float64)
            nm = modes.shape[0]
            if modes.shape[1:] != (sp.nnodes, dof):
                raise ValueError(f"coarse_modes must be (nmodes, {sp.nnodes}, {dof})")
            Wfull = torch.as_tensor(np.moveaxis(modes, 0, 1).reshape(sp.nnodes, nm * dof),
                                    dtype=dt, device=dev)
            W_loc = ds.pad_grid(Wfull)
            W_ext = ds.halo_gather(W_loc).reshape(next_, nm, dof)
            Wr = W_loc.reshape(nloc, nm, dof)
            col_ext = np.zeros((nloc, K), np.int64)
            stride = 1
            for d in range(dim):
                col_ext += (p[d] + lc[:, d:d + 1] + soffs[None, :, d]) * stride
                stride *= Lext[d]
            We = W_ext[torch.as_tensor(col_ext, device=dev)]  # (nloc, K, nm, dof)
        nc = ndev * nsub_loc * nm
        contrib = torch.einsum("ikab,ima,iknb->ikmn", vals, Wr, We)
        ar = torch.arange(nm, device=dev)
        I2 = (row_cid_t[:, None, None, None] * nm + ar[None, None, :, None]).expand(contrib.shape)
        J2 = (col_cid_t[:, :, None, None] * nm + ar[None, None, None, :]).expand(contrib.shape)
        A0 = torch.zeros((nc, nc), dtype=dt, device=dev)
        A0.index_put_((I2.reshape(-1), J2.reshape(-1)), contrib.reshape(-1), accumulate=True)
        A0 = ds._psum(A0)
        if coarse_modes is None:
            dead0 = (torch.diagonal(A0) == 0.0).to(dt)
            A0 = A0 + torch.diag_embed(dead0 * dead0)
        else:
            A0 = A0 + torch.diag_embed((torch.diagonal(A0).abs() < 1e-30).to(dt))
        A0inv = torch.linalg.inv(A0)
        rows_nm = (row_cid_t[:, None] * nm + ar[None, :]).reshape(-1)

        def coarse_solve(r_loc):
            rv = r_loc.reshape(nloc, dof)
            rm = torch.einsum("ima,ia->im", Wr, rv)
            rc = torch.zeros((nc,), dtype=dt, device=dev).index_add_(0, rows_nm, rm.reshape(-1))
            z0 = A0inv @ ds._psum(rc)
            z = torch.einsum("ima,im->ia", Wr, z0[rows_nm].reshape(nloc, nm))
            return z.reshape(r_loc.shape)

        def M(r_loc):
            r_loc = r_loc.reshape(Lrev + (dof,))
            z1 = coarse_solve(r_loc)
            z2 = z1 + local_solves(r_loc - Av(z1))
            return z2 + coarse_solve(r_loc - Av(z2))

        return M

    return pc
