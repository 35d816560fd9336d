"""The tensor-product discretization object (analog of PetIGA's ``IGA``).

Port of :mod:`petiga_tpu.core.space`, for the identity map (no geometry,
no rational weights).  A :class:`Space` bundles ``dim`` axes (knot
vectors + tabulation tables), the number of dofs per control point and
the Dirichlet tables.  Everything is computed once on the host in float64
numpy; :meth:`Space.tensor` caches torch copies on ``space.device`` in
``space.dtype``.

Indexing convention throughout: axis 0 fastest ("natural ordering") —
``flat = i0 + N0*(i1 + N1*i2)``; node grids are stored with their axes
reversed, ``(N_{d-1}, ..., N_0)``, so that C-order flattening gives the
flat index.
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from .axis import Axis
from .basis import Tabulation, tabulate
from .quadrature import Rule

__all__ = ["Space"]


class Space:
    """An IGA function space on a tensor-product patch.

    ``device`` is where every tensor derived from the space lives;
    ``dtype`` is the working floating-point type of assembly and solve.
    ``bc[axis][side]`` lists the face's strong Dirichlet conditions as
    ``(field, value)`` pairs.
    """

    def __init__(
        self,
        axes: Sequence[Axis],
        dof: int = 1,
        *,
        rule: Optional[Sequence[Rule]] = None,
        quadrature: Optional[Sequence[int]] = None,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ):
        self.axes = tuple(axes)
        self.dim = len(self.axes)
        if not (1 <= self.dim <= 3):
            raise ValueError("dim must be 1, 2, or 3")
        self.dof = int(dof)
        self.dtype = dtype
        self.device = torch.device(device)

        # quadrature rules (default p+1 Gauss points per axis)
        if rule is None:
            sizes = quadrature or [ax.p + 1 for ax in self.axes]
            rule = [Rule.legendre(q) for q in sizes]
        self.rules = tuple(rule)
        self.tabs: tuple[Tabulation, ...] = tuple(
            tabulate(ax, r) for ax, r in zip(self.axes, self.rules)
        )
        self.bc = [[[] for _ in range(2)] for _ in range(self.dim)]
        self._tensor_cache: dict = {}

    # ------------------------------------------------------------------ sizes

    @cached_property
    def node_shape(self) -> tuple[int, ...]:
        """Unique control points per axis (nnp)."""
        return tuple(ax.nnp for ax in self.axes)

    @cached_property
    def elem_shape(self) -> tuple[int, ...]:
        return tuple(t.nel for t in self.tabs)

    @property
    def nnodes(self) -> int:
        return int(np.prod(self.node_shape))

    @property
    def nel(self) -> int:
        return int(np.prod(self.elem_shape))

    @property
    def degrees(self) -> tuple[int, ...]:
        return tuple(ax.p for ax in self.axes)

    @property
    def periodic(self) -> tuple[bool, ...]:
        return tuple(ax.periodic for ax in self.axes)

    # --------------------------------------------------------------- indexing

    @cached_property
    def axis_node_index(self) -> tuple[np.ndarray, ...]:
        """Per axis: table (nel_d, p_d+1) of control-point indices in the
        element closure (basis index modulo nnp for periodic axes)."""
        return tuple(
            np.mod(t.offset[:, None] + np.arange(ax.p + 1)[None, :], ax.nnp)
            for ax, t in zip(self.axes, self.tabs)
        )

    # ------------------------------------------------------ boundary handling

    def set_boundary_value(self, axis: int, side: int, field: int, value: float):
        """Strong Dirichlet BC on a face (IGASetBoundaryValue)."""
        if not (0 <= axis < self.dim):
            raise ValueError(f"axis must be in [0,{self.dim-1}], got {axis}")
        if side not in (0, 1):
            raise ValueError("side must be 0 or 1")
        if not (0 <= field < self.dof):
            raise ValueError(f"field must be in [0,{self.dof-1}], got {field}")
        if self.axes[axis].periodic:
            raise ValueError("cannot set boundary data on a periodic axis")
        self.bc[axis][side].append((int(field), float(value)))
        self._tensor_cache.clear()
        return self

    def dirichlet_mask(self) -> tuple[np.ndarray, np.ndarray]:
        """Global (nnodes, dof) fixed mask and values from the BC tables."""
        mask = np.zeros((self.nnodes, self.dof), dtype=bool)
        vals = np.zeros((self.nnodes, self.dof), dtype=np.float64)
        multi = np.unravel_index(np.arange(self.nnodes), self.node_shape, order="F")
        for d in range(self.dim):
            for side in range(2):
                nodes = np.where(multi[d] == (0 if side == 0 else self.node_shape[d] - 1))[0]
                for field, value in self.bc[d][side]:
                    mask[nodes, field] = True
                    vals[nodes, field] = value
        return mask, vals

    # ------------------------------------------------------------ device data

    def tensor(self, key: str):
        """Cached tensors on ``self.device`` derived from the host tables
        (the reference's ``Space.device(key)``; renamed because
        ``device`` is the torch device here).  ``"dirichlet"``: the
        (mask, values) pair of :meth:`dirichlet_mask`."""
        if key not in self._tensor_cache:
            if key != "dirichlet":
                raise KeyError(key)
            mask, vals = self.dirichlet_mask()
            self._tensor_cache[key] = (
                torch.as_tensor(mask, device=self.device),
                torch.as_tensor(vals, dtype=self.dtype, device=self.device),
            )
        return self._tensor_cache[key]

    def __repr__(self) -> str:
        return (
            f"Space(dim={self.dim}, dof={self.dof}, "
            f"degrees={self.degrees}, elements={self.elem_shape}, "
            f"nodes={self.node_shape}, periodic={self.periodic}, "
            f"device={self.device}, dtype={self.dtype})"
        )
