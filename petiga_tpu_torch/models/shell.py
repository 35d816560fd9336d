"""Manifold (dim=2, nsd=3) models (port of :mod:`petiga_tpu.models.shell`),
PetIGA's demo/ClassicalShell.c: on manifolds the shape functions stay
parametric and forms build the surface metric from the geometry-map
tangents ``pt.gmap1`` (a_α = x,α) and curvatures ``pt.gmap2`` (x,αβ):

  * :func:`laplace_beltrami_system` — the surface scalar Laplacian (on a
    flat tilted plane it is exactly the 2-D Laplacian),
  * :func:`kl_shell_system` — linear Kirchhoff–Love bending; on a flat
    plate the classical Kirchhoff plate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.tabulation import det_small, inv_small
from ..core.axis import Axis
from ..core.space import Space

__all__ = [
    "surface_measure",
    "laplace_beltrami_system",
    "kl_shell_system",
    "make_plate_space",
    "clamp_plate",
]


def surface_measure(pt):
    """(sqrt(det g), g, g⁻¹, unit normal): the first fundamental form
    from the tangents a_α = ∂x/∂u_α."""
    A = pt.gmap1  # (3, 2): columns are tangents
    g = A.T @ A  # (2, 2) metric
    detg = det_small(g)
    ginv = inv_small(g, detg)
    n = torch.linalg.cross(A[:, 0], A[:, 1], dim=-1)
    return torch.sqrt(detg), g, ginv, n / torch.linalg.vector_norm(n)


def laplace_beltrami_system(pt, ctx):
    """Surface Laplacian: K_ab = √g (∇_s N_a · ∇_s N_b) with
    ∇_s N = g^{αβ} N,β a_α; forcing f(x) from ``ctx["forcing"]``."""
    jac, g, ginv, n = surface_measure(pt)
    N1 = pt.shape1  # parametric derivatives (nen, 2) on manifolds
    K = jac * torch.einsum("na,ab,mb->nm", N1, ginv, N1)
    f = ctx["forcing"](pt.x) if "forcing" in ctx else 0.0
    return K, jac * f * pt.shape0


def kl_shell_system(pt, ctx):
    """Linear Kirchhoff–Love shell (transverse displacement only, the
    flat-plate bending specialization of ClassicalShell.c): on a flat
    plate the biharmonic plate operator D ∫ w,αβ v,αβ with the isotropic
    plate constitutive tensor."""
    D = ctx["D"]  # bending stiffness E t^3 / 12(1-ν²)
    nu = ctx.get("nu", 0.3)
    jac, g, gi, n = surface_measure(pt)
    # curvature correction for curved shells (b_ab = x,αβ·n), switched
    # off as in the reference: zero on a flat plate
    corr = torch.einsum("iab,i->ab", pt.gmap2, n)
    kappa = pt.shape2 - 0.0 * corr  # linear bending strain per basis function

    tr = torch.einsum("ab,nab->n", gi, kappa)
    full = torch.einsum("nab,ac,bd,mcd->nm", kappa, gi, gi, kappa)
    K = D * jac * (nu * torch.outer(tr, tr) + (1 - nu) * full)
    return K, jac * ctx.get("load", 0.0) * pt.shape0


def make_plate_space(nel=16, p=2, dtype=torch.float64, tilt=None, device=None) -> Space:
    """Flat (optionally tilted by ``tilt`` radians about the x axis)
    unit square embedded in R³ as a dim=2/nsd=3 manifold, order-2
    tables."""
    sp = Space([Axis.uniform(p=p, nel=nel)] * 2, dof=1, nsd=3, dtype=dtype, order=2,
               device=device)
    X = np.zeros((sp.nnodes, 3))
    X[:, :2] = sp.greville_coordinates()
    if tilt is not None:
        c, s = np.cos(tilt), np.sin(tilt)
        X = X @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]]).T
    sp.init_geometry(X)
    return sp


def clamp_plate(sp):
    """Clamped BC for the Kirchhoff plate: w = 0 and zero normal
    derivative by fixing the two outer control-point rings (standard IGA
    practice).  Replaces the space's ``dirichlet_mask`` on the instance,
    as the reference does, and clears the tensor cache so the fix table
    is rebuilt from it."""
    mask = np.zeros((sp.nnodes, 1), bool)
    multi = sp.node_multi_index()
    for d in range(2):
        Nd = sp.node_shape[d]
        mask[(multi[d] <= 1) | (multi[d] >= Nd - 2), 0] = True
    sp.set_fix_table(np.zeros((sp.nnodes, 1)))
    sp.dirichlet_mask = lambda: (mask, np.zeros((sp.nnodes, 1)))
    sp._tensor_cache.clear()
    return sp
