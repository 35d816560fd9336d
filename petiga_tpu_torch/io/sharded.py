"""Sharded (per-rank-block) checkpoint I/O (port of
:mod:`petiga_tpu.io.sharded`).

The reference scales its checkpoints past one process with the
natural-ordering scatter machinery (``IGA_Grid_NewScatterApp``,
petigagrid.c:469-576): every rank writes and reads its own block of the
natural-order vector.  Here every rank of a
:class:`~petiga_tpu_torch.parallel.dist.DistSpace` writes exactly its
own block as one ``.npy`` file, and rank 0 writes a small JSON manifest
holding the padded-grid geometry; on load each rank assembles its block
from only the source shards overlapping it.  Because each shard records
its slice into the *padded natural-order grid*, a checkpoint written
under one process grid loads under any other, or serially.

The on-disk format is the reference's, byte for byte, so a checkpoint
written by either package loads in the other.  Layout
(``<dir>/<name>.meta.json`` + ``<dir>/<name>.shard<k>.npy``)::

    meta.json: {format, node_shape, pgrid, L, dof, dtype,
                shards: [{file, start, shape}, ...]}   # grid layout

``start``/``shape`` index the padded grid (reversed spatial axes,
trailing dof axis); shard ``k`` is the block of flat rank ``k``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["save_sharded", "load_sharded", "sharded_to_petiga_binary"]

_FORMAT = "petiga_tpu-sharded-v1"


def _manifest_path(dirpath, name):
    return os.path.join(dirpath, f"{name}.meta.json")


def _np_dtype(dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def save_sharded(ds, U, dirpath: str, name: str = "U") -> None:
    """Write a distributed vector as per-rank shard files + manifest.

    ``U``: this rank's block ``(L_rev..., dof)`` as the distributed
    solvers return it, or the flat ``(nnodes, dof)`` vector (cut with
    ``ds.pad_grid``).  Every rank writes its own shard, rank 0 the
    manifest; the ranks meet at a barrier before returning, so a load
    that follows sees every file."""
    sp = ds.space
    dof = sp.dof
    blk = ds._local(U).detach().cpu().numpy()
    os.makedirs(dirpath, exist_ok=True)
    global_shape = tuple(ds.Np[::-1]) + (dof,)
    shards_meta = []
    for k in range(ds.world):
        sl = ds.block_slices(k)
        shards_meta.append(
            {"file": f"{name}.shard{k:05d}.npy",
             "start": [s.start for s in sl] + [0],
             "shape": [s.stop - s.start for s in sl] + [global_shape[-1]]}
        )
    np.save(os.path.join(dirpath, shards_meta[ds.rank]["file"]), blk)
    meta = {
        "format": _FORMAT,
        "node_shape": list(sp.node_shape),
        "pgrid": list(ds.pgrid),
        "L": list(ds.L),
        "dof": dof,
        "dtype": _np_dtype(sp.dtype).name,
        "shards": shards_meta,
    }
    if ds.rank == 0:
        with open(_manifest_path(dirpath, name), "w") as f:
            json.dump(meta, f, indent=1)
    if ds.world > 1:
        tdist.barrier(group=ds.group)


def _read_meta(dirpath, name):
    with open(_manifest_path(dirpath, name)) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise IOError(f"not a sharded checkpoint: {meta.get('format')}")
    return meta


def load_sharded(dirpath: str, name: str = "U", *, ds=None):
    """Load a sharded checkpoint.

    With ``ds``, returns this rank's block ``(L_rev..., dof)`` on the
    rank's device; the target process grid may differ from the one that
    wrote the checkpoint (a repartitioning restart).  Each block is
    assembled from only the source shards overlapping it.  Without
    ``ds``, the full flat natural-order ``(nnodes, dof)`` numpy array
    (the serial path)."""
    meta = _read_meta(dirpath, name)
    N = meta["node_shape"]
    L = meta["L"]
    pgrid = meta["pgrid"]
    dof = meta["dof"]
    dim = len(N)
    dtype = np.dtype(meta["dtype"])

    if ds is None:
        Np = [L[d] * pgrid[d] for d in range(dim)]
        g = np.zeros(tuple(Np[::-1]) + (dof,), dtype)
        for sh in meta["shards"]:
            sl = tuple(slice(s, s + n) for s, n in zip(sh["start"], sh["shape"]))
            g[sl] = np.load(os.path.join(dirpath, sh["file"]))
        crop = tuple(slice(0, N[d]) for d in range(dim))[::-1]
        return g[crop].reshape(-1, dof)

    sp = ds.space
    if list(sp.node_shape) != N or sp.dof != dof:
        raise ValueError(
            f"checkpoint grid {N}x{dof} does not match space {sp.node_shape}x{sp.dof}"
        )
    # both padded grids share the origin and crop to N
    real = [N[dim - 1 - g] for g in range(dim)]
    target = ds.block_slices()
    t_lo = [s.start for s in target]
    t_hi = [s.stop for s in target]
    out = np.zeros(tuple(ds.L[::-1]) + (dof,), _np_dtype(sp.dtype))
    for sh in meta["shards"]:
        lo = [max(t_lo[g], sh["start"][g]) for g in range(dim)]
        hi = [min(t_hi[g], sh["start"][g] + sh["shape"][g], real[g]) for g in range(dim)]
        if any(lo[g] >= hi[g] for g in range(dim)):
            continue
        src = tuple(slice(lo[g] - sh["start"][g], hi[g] - sh["start"][g])
                    for g in range(dim)) + (slice(None),)
        dst = tuple(slice(lo[g] - t_lo[g], hi[g] - t_lo[g]) for g in range(dim)) + (slice(None),)
        out[dst] = np.load(os.path.join(dirpath, sh["file"]))[src]
    return torch.as_tensor(out, device=ds.device)


def sharded_to_petiga_binary(dirpath: str, space, path: str, name: str = "U") -> None:
    """Convert a sharded checkpoint to the reference's single-file
    PetIGA/PETSc binary (petigaio.c:644-736) for interop with PetIGA and
    igakit."""
    from .checkpoint import write_vec

    write_vec(space, load_sharded(dirpath, name), path)
