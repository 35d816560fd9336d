"""Quadrature-point view handed to user forms — the analog of
``IGAPoint`` (port of :mod:`petiga_tpu.assembly.point`).

A :class:`Point` is a per-point slice of a
:class:`~petiga_tpu_torch.assembly.tabulation.PointBlock`: forms are
written for ONE point and lifted over elements with ``torch.func.vmap``
(the quadrature points are looped, or carried as a leading axis for
``qbatched`` forms).  Field-evaluation helpers contract the tabulated
shape functions with the element coefficient closure ``Ue`` of shape
``(nen, dof)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Point"]


class Point(NamedTuple):
    """One quadrature point of one element (unweighted view; the
    assembly applies ``weight`` when accumulating, matching
    ``IGAPointAddMat/Vec``)."""

    u: torch.Tensor  # (dim,) parametric coords
    x: torch.Tensor  # (nsd,) physical coords
    shape0: torch.Tensor  # (nen,)
    shape1: Optional[torch.Tensor] = None  # (nen, nsd)
    shape2: Optional[torch.Tensor] = None  # (nen, nsd, nsd)
    shape3: Optional[torch.Tensor] = None  # (nen, nsd, nsd, nsd)
    shape4: Optional[torch.Tensor] = None  # (nen, nsd, nsd, nsd, nsd)
    normal: Optional[torch.Tensor] = None  # (nsd,)
    gmap1: Optional[torch.Tensor] = None  # (nsd, dim) surface tangents
    gmap2: Optional[torch.Tensor] = None  # (nsd, dim, dim) curvatures

    @property
    def nen(self) -> int:
        return self.shape0.shape[0]

    @property
    def dim(self) -> int:
        return self.u.shape[0]

    @property
    def nsd(self) -> int:
        return self.x.shape[0]

    # --- field evaluation (IGA_GetValue/Grad/Hess/Del2/Der3)

    def value(self, Ue) -> torch.Tensor:
        """u(x): (dof,)"""
        return torch.einsum("n,nd->d", self.shape0, Ue)

    def grad(self, Ue) -> torch.Tensor:
        """∇u: (dof, nsd)"""
        return torch.einsum("ni,nd->di", self.shape1, Ue)

    def hess(self, Ue) -> torch.Tensor:
        """∇∇u: (dof, nsd, nsd)"""
        return torch.einsum("nij,nd->dij", self.shape2, Ue)

    def del2(self, Ue) -> torch.Tensor:
        """Δu: (dof,)"""
        return torch.einsum("nii,nd->d", self.shape2, Ue)

    def der3(self, Ue) -> torch.Tensor:
        """3rd derivatives: (dof, nsd, nsd, nsd)"""
        return torch.einsum("nijk,nd->dijk", self.shape3, Ue)

    def der4(self, Ue) -> torch.Tensor:
        """4th derivatives: (dof, nsd, nsd, nsd, nsd) (parametric-domain
        only, like the reference's unimplemented order-4 pushforward)."""
        return torch.einsum("nijkl,nd->dijkl", self.shape4, Ue)
