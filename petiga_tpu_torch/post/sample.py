"""Solution resampling + VTK output (port of :mod:`petiga_tpu.post.sample`)
— the analog of ``IGADraw`` / ``IGADrawVec`` (petigadraw.c): resample
geometry and solution on a uniform per-element sample grid (default p
points per element, petigadraw.c:38-130) and write VTK structured-grid ``.vts`` files
(PetIGA's `.vts` path via PETSC_VIEWER_VTK, petiga.c:267-284).  For the
same inputs the files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import base64
import struct

import numpy as np
import torch

from .probe import Probe

__all__ = ["sample_grid", "write_vts"]


def sample_grid(space, U=None, resolution=None):
    """Sample the geometry (and optionally a solution vector) on a
    tensor grid of parametric points.

    Returns (coords, values, grid_shape): coords (npts, nsd) and values
    (npts, dof) or None, with points ordered axis-0 fastest.
    ``resolution``: samples per element per axis (default p).
    """
    dim = space.dim
    if resolution is None:
        resolution = [max(ax.p, 1) for ax in space.axes]
    elif np.isscalar(resolution):
        resolution = [int(resolution)] * dim
    axes_pts = []
    for d, ax in enumerate(space.axes):
        u0, u1 = ax.limits
        n = space.elem_shape[d] * resolution[d] + (0 if ax.periodic else 1)
        axes_pts.append(np.linspace(u0, u1, n, endpoint=ax.periodic is False))
    shape = tuple(len(a) for a in axes_pts)
    mesh = np.meshgrid(*axes_pts, indexing="ij")
    pts = np.stack([m.ravel(order="F") for m in mesh], axis=-1)
    probe = Probe(space, U)
    coords = probe.geometry(pts).cpu().numpy()
    vals = None if U is None else probe.value(pts).cpu().numpy()
    return coords, vals, shape


def write_vts(path, coords, grid_shape, point_data=None):
    """Minimal VTK XML StructuredGrid writer (appended-base64 format).

    coords: (npts, nsd<=3) numpy, axis-0-fastest ordering matching
    grid_shape (n0, n1, n2).
    point_data: dict name -> (npts,) or (npts, c) arrays.
    """
    n = list(grid_shape) + [1] * (3 - len(grid_shape))
    npts = int(np.prod(n))
    xyz = np.zeros((npts, 3), dtype=np.float32)
    xyz[:, : coords.shape[1]] = coords
    extent = f"0 {n[0]-1} 0 {n[1]-1} 0 {n[2]-1}"

    def b64(arr):
        raw = arr.astype(np.float32).tobytes()
        return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="StructuredGrid" version="0.1" byte_order="LittleEndian">',
        f'  <StructuredGrid WholeExtent="{extent}">',
        f'    <Piece Extent="{extent}">',
        "      <Points>",
        '        <DataArray type="Float32" NumberOfComponents="3" format="binary">',
        "          " + b64(xyz),
        "        </DataArray>",
        "      </Points>",
        "      <PointData>",
    ]
    for name, arr in (point_data or {}).items():
        arr = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        lines += [
            f'        <DataArray type="Float32" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="binary">',
            "          " + b64(arr),
            "        </DataArray>",
        ]
    lines += [
        "      </PointData>",
        "    </Piece>",
        "  </StructuredGrid>",
        "</VTKFile>",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
