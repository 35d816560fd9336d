"""Options / configuration layer (port of :mod:`petiga_tpu.config`) — the
analog of PetIGA's PETSc options database usage (``petigaopts.c`` typed
getters + aliases; ``petiga.c:712-897`` IGASetFromOptions with its
``-iga_*`` flag set and reject-after-setup staging; ``petiga.c:177-249``
IGAPrint).

A single dataclass holds every discretization option with the same
names/semantics as the reference flags; ``bind_cli`` maps command-line
arguments onto it (``--dim`` ↔ ``-iga_dim`` etc.); ``build_space``
constructs the Space (``device=None``: the CUDA device, as everywhere in
the port).  After construction the options object is frozen — PetIGA's
"reject after setup" discipline (petiga.c:557).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .core.axis import Axis
from .core.space import Space

__all__ = ["Options", "bind_cli", "print_info"]


def _per_axis(value, dim, cast):
    if value is None:
        return None
    if np.isscalar(value):
        return (cast(value),) * dim
    vals = tuple(cast(v) for v in value)
    if len(vals) == 1:
        return vals * dim
    if len(vals) != dim:
        raise ValueError(f"expected 1 or {dim} values, got {len(vals)}")
    return vals


@dataclasses.dataclass
class Options:
    """Discretization options (flag names follow PetIGA's ``-iga_*`` set,
    petiga.c:712-897)."""

    dim: int = 3
    dof: int = 1
    elements: Sequence[int] | int = 16  # -iga_elements
    degree: Sequence[int] | int = 2  # -iga_degree
    continuity: Optional[Sequence[int] | int] = None  # -iga_continuity
    periodic: Sequence[bool] | bool = False  # -iga_periodic
    limits: Sequence[float] = (0.0, 1.0)  # -iga_limits
    quadrature: Optional[Sequence[int] | int] = None  # -iga_quadrature
    rule_type: str = "legendre"  # -iga_rule_type
    basis_type: str = "bspline"  # -iga_basis_type
    collocation: bool = False  # -iga_collocation
    order: Optional[int] = None  # -iga_order
    dtype: str = "float32"
    load: Optional[str] = None  # -iga_load (geometry file)

    _frozen: bool = dataclasses.field(default=False, repr=False)

    def __setattr__(self, k, v):
        if getattr(self, "_frozen", False) and k != "_frozen":
            raise AttributeError(
                f"option {k!r} cannot be changed after setup "
                "(reject-after-setup, petiga.c:557)"
            )
        object.__setattr__(self, k, v)

    def build_space(self, device=None) -> Space:
        """Construct and freeze (IGASetUp staging) on ``device`` (None:
        the CUDA device)."""
        dtype = getattr(torch, self.dtype)
        if self.load is not None:
            from .io.checkpoint import read_space

            per = _per_axis(self.periodic, 99, bool)
            sp = read_space(
                self.load,
                dof=self.dof,
                periodic=None if per is None else per,
                dtype=dtype,
                device=device,
            )
            object.__setattr__(self, "_frozen", True)
            return sp
        dim = self.dim
        nel = _per_axis(self.elements, dim, int)
        deg = _per_axis(self.degree, dim, int)
        cont = _per_axis(self.continuity, dim, int)
        per = _per_axis(self.periodic, dim, bool)
        quad = _per_axis(self.quadrature, dim, int)
        lo, hi = self.limits
        axes = [
            Axis.uniform(
                p=deg[d],
                nel=nel[d],
                u0=lo,
                u1=hi,
                continuity=None if cont is None else cont[d],
                periodic=per[d],
            )
            for d in range(dim)
        ]
        sp = Space(
            axes,
            dof=self.dof,
            quadrature=quad,
            basis_type=self.basis_type,
            collocation=self.collocation,
            order=self.order,
            dtype=dtype,
            device=device,
        )
        if self.rule_type != "legendre":
            from .core.quadrature import Rule

            rules = [
                Rule.make(self.rule_type, (quad or [deg[d] + 1 for d in range(dim)])[d])
                for d in range(dim)
            ]
            sp = Space(
                axes, dof=self.dof, rule=rules, basis_type=self.basis_type,
                collocation=self.collocation, order=self.order,
                dtype=dtype, device=device,
            )
        object.__setattr__(self, "_frozen", True)
        return sp


def bind_cli(argv=None, defaults: Optional[Options] = None, extra=None) -> tuple:
    """Parse CLI flags onto an Options object (IGAOptionsAlias analog:
    short flags map onto the -iga_* set).  ``extra`` is a list of
    (name, type, default, help) app-specific options (IGAGetOpt*).

    Returns (options, namespace_with_extras).
    """
    d = defaults or Options()
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=d.dim)
    ap.add_argument("--dof", type=int, default=d.dof)
    ap.add_argument("--elements", "-N", type=int, nargs="+",
                    default=d.elements)
    ap.add_argument("--degree", "-p", type=int, nargs="+", default=d.degree)
    ap.add_argument("--continuity", "-k", type=int, nargs="+",
                    default=d.continuity)
    ap.add_argument("--periodic", type=int, nargs="+",
                    default=d.periodic)
    ap.add_argument("--quadrature", type=int, nargs="+", default=d.quadrature)
    ap.add_argument("--rule-type", default=d.rule_type)
    ap.add_argument("--basis-type", default=d.basis_type)
    ap.add_argument("--collocation", action="store_true",
                    default=d.collocation)
    ap.add_argument("--dtype", default=d.dtype)
    ap.add_argument("--load", default=d.load)
    for name, typ, default, hlp in extra or []:
        ap.add_argument(f"--{name}", type=typ, default=default, help=hlp)
    ns = ap.parse_args(argv)
    opts = Options(
        dim=ns.dim, dof=ns.dof, elements=ns.elements, degree=ns.degree,
        continuity=ns.continuity, periodic=ns.periodic,
        quadrature=ns.quadrature, rule_type=ns.rule_type,
        basis_type=ns.basis_type, collocation=ns.collocation,
        dtype=ns.dtype, load=ns.load,
    )
    return opts, ns


def print_info(space, file=None, pgrid=None):
    """Human-readable summary (IGAPrint, petiga.c:177-249): sizes,
    degrees, continuity, periodicity, and per-device balance when a
    partition is given.  ``file=None`` is ``sys.stdout`` at the call (the
    reference binds the stream of its import)."""
    w = (sys.stdout if file is None else file).write
    w(f"IGA: dim={space.dim}  dof={space.dof}  "
      f"order={space.order}  geometry={space.nsd if space.has_geometry else 0}  "
      f"rational={1 if space.is_rational else 0}\n")
    for d, ax in enumerate(space.axes):
        t = space.tabs[d]
        w(
            f"Axis {d}: basis={space.basis_type}[{ax.p},{ax.continuity}] "
            f"rule={space.rules[d].kind}[{t.nqp}] periodic={int(ax.periodic)} "
            f"nnp={ax.nnp} nel={ax.nel}\n"
        )
    w(f"Partition - nnp: {space.nnodes}  nel: {space.nel}\n")
    if pgrid is not None:
        from .parallel.partition import block_sizes

        sizes_n = [block_sizes(space.node_shape[d], pgrid[d]) for d in
                   range(space.dim)]
        sizes_e = [block_sizes(space.elem_shape[d], pgrid[d]) for d in
                   range(space.dim)]
        nmax = int(np.prod([s.max() for s in sizes_n]))
        nmin = int(np.prod([s.min() for s in sizes_n]))
        emax = int(np.prod([s.max() for s in sizes_e]))
        emin = int(np.prod([s.min() for s in sizes_e]))
        w(f"Partition - grid: {tuple(pgrid)}\n")
        w(f"Partition - nnp: sum={space.nnodes}  min={nmin}  max={nmax}  "
          f"max/min={nmax/max(nmin,1):.3f}\n")
        w(f"Partition - nel: sum={space.nel}  min={emin}  max={emax}  "
          f"max/min={emax/max(emin,1):.3f}\n")
