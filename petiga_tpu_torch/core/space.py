"""The tensor-product discretization object (analog of PetIGA's ``IGA``).

Port of :mod:`petiga_tpu.core.space`.  A :class:`Space` bundles ``dim`` axes (knot vectors +
tabulation tables), the number of dofs per control point, optional NURBS
weights / geometry control points / property fields, the boundary tables
and the element -> control-point closure map.  Everything is computed
once on the host in float64 numpy; :meth:`Space.tensor` caches torch
copies on ``space.device`` in ``space.dtype``.

Indexing convention throughout: axis 0 fastest ("natural ordering") —
``flat = i0 + N0*(i1 + N1*i2)``; node grids are stored with their axes
reversed, ``(N_{d-1}, ..., N_0)``, so that C-order flattening gives the
flat index.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .axis import Axis
from .basis import BasisType, Tabulation, tabulate, tabulate_collocation
from .quadrature import Rule

__all__ = ["Space", "BoundaryCondition"]


@dataclasses.dataclass
class BoundaryCondition:
    """Per-face boundary data (analog of IGAFormBC).

    ``value``: list of (field, value) strong Dirichlet conditions.
    ``load``: list of (field, value) nodal fluxes added to the RHS.
    """

    value: list
    load: list


class Space:
    """An IGA function space on a tensor-product patch.

    ``device`` is where every tensor derived from the space lives
    (``None``: the CUDA device, see
    :func:`petiga_tpu_torch.default_device`); ``dtype`` is the working
    floating-point type of assembly and solve.  ``bc[axis][side]`` is the
    face's :class:`BoundaryCondition`.
    """

    def __init__(
        self,
        axes: Sequence[Axis],
        dof: int = 1,
        *,
        rule: Optional[Sequence[Rule]] = None,
        quadrature: Optional[Sequence[int]] = None,
        basis_type: str = BasisType.BSPLINE,
        collocation: bool = False,
        order: Optional[int] = None,
        nsd: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.axes = tuple(axes)
        self.dim = len(self.axes)
        if not (1 <= self.dim <= 3):
            raise ValueError("dim must be 1, 2, or 3")
        self.dof = int(dof)
        self.nsd = self.dim if nsd is None else int(nsd)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.basis_type = basis_type
        self.collocation = bool(collocation)
        maxp = max(ax.p for ax in self.axes)
        self.order = min(maxp, 4) if order is None else int(order)

        # quadrature rules (default p+1 Gauss points per axis)
        if rule is None:
            sizes = quadrature or [ax.p + 1 for ax in self.axes]
            rule = [Rule.legendre(q) for q in sizes]
        self.rules = tuple(rule)
        # per-axis tabulation: quadrature points, or one collocation point
        # (Greville abscissa) per control point
        if collocation:
            self.tabs: tuple[Tabulation, ...] = tuple(
                tabulate_collocation(ax) for ax in self.axes)
        else:
            self.tabs = tuple(
                tabulate(ax, r, basis_type) for ax, r in zip(self.axes, self.rules))

        # geometry / rational weights / properties — set via init_geometry
        self.geometry: Optional[np.ndarray] = None  # (nnodes, nsd)
        self.rational: Optional[np.ndarray] = None  # (nnodes,)
        self.property: Optional[np.ndarray] = None  # (nnodes, npd)
        self.fix_table: Optional[np.ndarray] = None  # (nnodes, dof) values or None

        self.bc = [[BoundaryCondition([], []) for _ in range(2)] for _ in range(self.dim)]
        self.bc_visit = [[False, False] for _ in range(self.dim)]  # boundary-form flags
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

    @cached_property
    def nen_shape(self) -> tuple[int, ...]:
        return tuple(ax.p + 1 for ax in self.axes)

    @property
    def nen(self) -> int:
        return int(np.prod(self.nen_shape))

    @cached_property
    def nqp_shape(self) -> tuple[int, ...]:
        return tuple(t.nqp for t in self.tabs)

    @property
    def nqp(self) -> int:
        return int(np.prod(self.nqp_shape))

    @property
    def degrees(self) -> tuple[int, ...]:
        return tuple(ax.p for ax in self.axes)

    @property
    def periodic(self) -> tuple[bool, ...]:
        return tuple(ax.periodic for ax in self.axes)

    @property
    def ndofs(self) -> int:
        return self.nnodes * self.dof

    # --------------------------------------------------------------- indexing

    @cached_property
    def axis_node_index(self) -> tuple[np.ndarray, ...]:
        """Per axis: table (nel_d, p_d+1) of control-point indices in the
        element closure (basis index modulo nnp for periodic axes)."""
        return tuple(
            np.mod(t.offset[:, None] + np.arange(ax.p + 1)[None, :], ax.nnp)
            for ax, t in zip(self.axes, self.tabs)
        )

    @cached_property
    def _local_index(self) -> tuple[np.ndarray, ...]:
        """Per axis: (nen,) local basis index of every closure entry,
        axis-0 fastest (shared with the shift assembly)."""
        grids = np.meshgrid(*[np.arange(n) for n in self.nen_shape], indexing="ij")
        return tuple(g.ravel(order="F") for g in grids)

    def element_nodes(self, ids: np.ndarray) -> np.ndarray:
        """(B,) flat element ids -> (B, nen) flat closure node indices
        (host numpy; rows of :attr:`mapping`)."""
        locs = self._local_index
        rem = np.asarray(ids, dtype=np.int64)
        flat = np.zeros((rem.shape[0], self.nen), dtype=np.int64)
        stride = 1
        for d in range(self.dim):
            e_d = rem % self.elem_shape[d]
            rem = rem // self.elem_shape[d]
            flat += self.axis_node_index[d][e_d][:, locs[d]] * stride
            stride *= self.node_shape[d]
        return flat

    def device_emap(self, ids: torch.Tensor) -> torch.Tensor:
        """(B,) flat element ids -> (B, nen) flat closure node indices,
        computed on ``self.device`` from the per-axis closure tables (the
        full (nel, nen) table is 1.8 GB of int32 at 256³ p=2; the
        per-axis tables are O(nel_d · nen_d))."""
        per_axis = self.tensor("axis_node_index")
        locs = self.tensor("local_index")
        rem = ids
        flat = torch.zeros((ids.shape[0], self.nen), dtype=torch.int64, device=ids.device)
        stride = 1
        for d in range(self.dim):
            e_d = rem % self.elem_shape[d]
            rem = rem // self.elem_shape[d]
            flat = flat + per_axis[d][e_d][:, locs[d]] * stride
            stride *= self.node_shape[d]
        return flat

    @cached_property
    def mapping(self) -> np.ndarray:
        """Element closure map: (nel, nen) flat control-point indices,
        local basis ordering axis-0 fastest, matching the tensor-product
        tabulation.  Large meshes use the native C++ builder
        (:mod:`petiga_tpu_torch.native`), as the reference's do."""
        if self.nel >= 4096:
            from .. import native

            if native.available():
                return native.build_mapping(self.dim, self.elem_shape, self.nen_shape,
                                            self.node_shape, [t.offset for t in self.tabs])
        return self.element_nodes(np.arange(self.nel)).astype(np.int32)

    def node_multi_index(self) -> tuple[np.ndarray, ...]:
        """Multi-index arrays of all nodes (axis-0-fastest order)."""
        return np.unravel_index(np.arange(self.nnodes), self.node_shape, order="F")

    # ------------------------------------------------------ boundary handling

    def set_boundary_value(self, axis: int, side: int, field: int, value: float):
        """Strong Dirichlet BC on a face (IGASetBoundaryValue)."""
        self._check_face(axis, side, field)
        self.bc[axis][side].value.append((int(field), float(value)))
        self._tensor_cache.clear()
        return self

    def set_boundary_load(self, axis: int, side: int, field: int, value: float):
        """Nodal flux on a face (IGASetBoundaryLoad)."""
        self._check_face(axis, side, field)
        self.bc[axis][side].load.append((int(field), float(value)))
        self._tensor_cache.clear()
        return self

    def set_boundary_form(self, axis: int, side: int, flag: bool = True):
        """Request boundary-integral evaluation on a face
        (IGASetBoundaryForm)."""
        self._check_face(axis, side, 0)
        self.bc_visit[axis][side] = bool(flag)
        return self

    def set_fix_table(self, table: Optional[np.ndarray]):
        """Inhomogeneous Dirichlet values from a vector (IGASetFixTable):
        boundary dofs are constrained to the values in ``table`` (shape
        (nnodes, dof))."""
        if table is not None:
            table = np.asarray(table, dtype=np.float64).reshape(self.nnodes, self.dof)
        self.fix_table = table
        self._tensor_cache.clear()
        return self

    def _check_face(self, axis: int, side: int, field: int):
        if not (0 <= axis < self.dim):
            raise ValueError(f"axis must be in [0,{self.dim-1}], got {axis}")
        if side not in (0, 1):
            raise ValueError("side must be 0 or 1")
        if not (0 <= field < self.dof):
            raise ValueError(f"field must be in [0,{self.dof-1}], got {field}")
        if self.axes[axis].periodic:
            raise ValueError("cannot set boundary data on a periodic axis")

    @cached_property
    def boundary_nodes(self) -> list:
        """Per (axis, side): flat indices of nodes on that boundary face."""
        out = []
        multi = self.node_multi_index()
        for d in range(self.dim):
            faces = []
            for side in range(2):
                tgt = 0 if side == 0 else self.node_shape[d] - 1
                faces.append(np.where(multi[d] == tgt)[0])
            out.append(faces)
        return out

    def has_dirichlet(self) -> bool:
        return any(self.bc[d][s].value for d in range(self.dim) for s in range(2))

    def dirichlet_mask(self) -> tuple[np.ndarray, np.ndarray]:
        """Global (nnodes, dof) fixed mask and values from the BC tables.
        With a fix table set, fixed dofs take their values from it."""
        mask = np.zeros((self.nnodes, self.dof), dtype=bool)
        vals = np.zeros((self.nnodes, self.dof), dtype=np.float64)
        for d in range(self.dim):
            for side in range(2):
                for field, value in self.bc[d][side].value:
                    nodes = self.boundary_nodes[d][side]
                    mask[nodes, field] = True
                    if self.fix_table is not None:
                        vals[nodes, field] = self.fix_table[nodes, field]
                    else:
                        vals[nodes, field] = value
        return mask, vals

    def flux_vector(self) -> Optional[np.ndarray]:
        """Global (nnodes, dof) nodal flux vector from boundary loads, or
        None if no loads are set (unit value per loaded node; the
        assembled flux with element face areas is
        ``assemble.boundary_flux_vector``)."""
        if not any(self.bc[d][s].load for d in range(self.dim) for s in range(2)):
            return None
        flux = np.zeros((self.nnodes, self.dof), dtype=np.float64)
        for d in range(self.dim):
            for side in range(2):
                for field, value in self.bc[d][side].load:
                    flux[self.boundary_nodes[d][side], field] += value
        return flux

    # --------------------------------------------------------------- geometry

    def init_geometry(self, X: np.ndarray, W: Optional[np.ndarray] = None):
        """Attach geometry control points (nnodes..., nsd) and optional
        rational weights (NURBS)."""
        self.geometry = np.asarray(X, dtype=np.float64).reshape(self.nnodes, self.nsd)
        if W is not None:
            self.rational = np.asarray(W, dtype=np.float64).reshape(self.nnodes)
        self._tensor_cache.clear()
        return self

    def set_property(self, A: np.ndarray):
        self.property = np.asarray(A, dtype=np.float64).reshape(self.nnodes, -1)
        self._tensor_cache.clear()
        return self

    @property
    def has_geometry(self) -> bool:
        return self.geometry is not None

    @property
    def is_rational(self) -> bool:
        return self.rational is not None

    def greville_coordinates(self) -> np.ndarray:
        """Parametric coordinates of each node at Greville abscissae
        (IGACreateCoordinates): (nnodes, dim)."""
        gs = []
        for ax in self.axes:
            g = ax.greville()
            if ax.periodic:
                shift = (ax.nbasis - ax.nnp) // 2
                g = g[shift : shift + ax.nnp]
            gs.append(g)
        multi = self.node_multi_index()
        return np.stack([gs[d][multi[d]] for d in range(self.dim)], axis=-1)

    # ------------------------------------------------------------ device data

    def tensor(self, key: str):
        """Cached tensors on ``self.device`` derived from the host tables
        (the reference's ``Space.device(key)``; renamed because
        ``device`` is the torch device here)."""
        if key not in self._tensor_cache:
            self._tensor_cache[key] = self._build_tensor(key)
        return self._tensor_cache[key]

    def _build_tensor(self, key: str):
        def real(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)

        if key in ("tabs_value", "tabs_weight", "tabs_detJac", "tabs_point",
                   "tabs_bnd_value", "tabs_bnd_point"):
            return tuple(real(getattr(t, key[5:])) for t in self.tabs)
        if key == "mapping":
            return index(self.mapping)
        if key == "axis_node_index":
            return tuple(index(t) for t in self.axis_node_index)
        if key == "local_index":
            return tuple(index(t) for t in self._local_index)
        if key in ("geometry", "rational", "property"):
            a = getattr(self, key)
            return None if a is None else real(a)
        if key == "dirichlet":
            mask, vals = self.dirichlet_mask()
            return torch.as_tensor(mask, device=self.device), real(vals)
        raise KeyError(key)

    # ------------------------------------------------------------------ views

    def clone(self, dof: Optional[int] = None, **kw) -> "Space":
        """New space sharing the discretization with a different dof,
        ``dtype`` or ``nsd`` (IGAClone), on the same device."""
        return Space(
            self.axes,
            dof=self.dof if dof is None else dof,
            rule=self.rules,
            basis_type=self.basis_type,
            collocation=self.collocation,
            nsd=kw.get("nsd", self.nsd),
            dtype=kw.get("dtype", self.dtype),
            device=self.device,
        )

    def __repr__(self) -> str:
        return (
            f"Space(dim={self.dim}, dof={self.dof}, "
            f"degrees={self.degrees}, elements={self.elem_shape}, "
            f"nodes={self.node_shape}, periodic={self.periodic}, "
            f"collocation={self.collocation}, device={self.device}, dtype={self.dtype})"
        )
