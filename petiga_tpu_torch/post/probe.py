"""Arbitrary-point solution evaluation (port of
:mod:`petiga_tpu.post.probe`) — the analog of PetIGA's ``IGAProbe``
(petigaprobe.c): FindSpan → closure gather → 1-D basis eval → tensor
product → rationalize → geometry/inverse map → value/grad/hess.

Points are parametric; evaluation reuses the batched tabulation pipeline
with each probe point treated as a one-point "element".  The span search
and 1-D basis evaluation run on the host; the contractions on the space's
device.  The reference's ``assemble._probe_functional`` is a shape probe
for ``jax.eval_shape`` of a traced functional; eager PyTorch needs no such
probe, so it has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.tabulation import (
    geometry_map,
    inverse_map,
    push_forward,
    rationalize,
    tensor_basis,
)
from ..core.bspline import MAX_DER, bspline_ders

__all__ = ["Probe", "FixedProbe"]

_CONTRACT = {0: "pqn,pnd->pd", 1: "pqni,pnd->pdi", 2: "pqnij,pnd->pdij",
             3: "pqnijk,pnd->pdijk", 4: "pqnijkl,pnd->pdijkl"}


def _as_field(space, U):
    U = torch.as_tensor(U, device=space.device)
    return U.reshape(space.nnodes, space.dof)


class Probe:
    """Evaluate fields of a space at arbitrary parametric points."""

    def __init__(self, space, U=None, order: int = 2):
        self.space = space
        self.order = min(order, space.order)
        self.U = None if U is None else _as_field(space, U)

    def set_vec(self, U):
        self.U = _as_field(self.space, U)
        return self

    # ------------------------------------------------------------- internals

    def _tabulate(self, u):
        """u: (npts, dim) parametric points -> (shape tables, emap, x)."""
        sp = self.space
        dim = sp.dim
        dev = sp.device
        u = np.atleast_2d(np.asarray(u, dtype=np.float64))
        npts = u.shape[0]

        axis_tables = []
        closures = []
        for ax_i in range(dim):
            ax = sp.axes[ax_i]
            ui = u[:, ax_i]
            if ax.periodic:
                u0, u1 = ax.limits
                ui = u0 + np.mod(ui - u0, u1 - u0)
            spans = ax.find_span(ui)
            ders = bspline_ders(ax.U, ax.p, spans, ui, min(ax.p, MAX_DER))
            tab = np.zeros((npts, 1, MAX_DER + 1, ax.p + 1))
            tab[:, 0, : ders.shape[1], :] = ders
            axis_tables.append(torch.as_tensor(tab, dtype=sp.dtype, device=dev))
            idx = spans[:, None] - ax.p + np.arange(ax.p + 1)[None, :]
            closures.append(np.mod(idx, ax.nnp))
        # flat closure node indices (axis-0 fastest local ordering)
        grids = np.meshgrid(*[np.arange(n) for n in sp.nen_shape], indexing="ij")
        locs = [g.ravel(order="F") for g in grids]
        emap = np.zeros((npts, sp.nen), dtype=np.int64)
        stride = 1
        for ax_i in range(dim):
            emap += closures[ax_i][:, locs[ax_i]] * stride
            stride *= sp.node_shape[ax_i]
        emap = torch.as_tensor(emap, device=dev)

        N = tensor_basis(axis_tables, self.order)
        if sp.is_rational:
            N = rationalize(N, sp.tensor("rational")[emap])
        x = torch.as_tensor(u, dtype=sp.dtype, device=dev)[:, None, :]
        S = N
        if sp.has_geometry:
            X = geometry_map(N, sp.tensor("geometry")[emap])
            x = X[0]
            if dim == sp.nsd and self.order >= 1:
                _, E = inverse_map(X)
                S = push_forward(N, E)
        return S, emap, x

    def _contract(self, Sk, emap, extra_axes):
        return torch.einsum(_CONTRACT[extra_axes], Sk, self.U.to(Sk.dtype)[emap])

    # ------------------------------------------------------------------ API

    def value(self, u):
        """(npts, dof) field values at parametric points u (npts, dim)."""
        S, emap, _ = self._tabulate(u)
        return self._contract(S[0], emap, 0)

    def grad(self, u):
        S, emap, _ = self._tabulate(u)
        return self._contract(S[1], emap, 1)

    def hess(self, u):
        S, emap, _ = self._tabulate(u)
        return self._contract(S[2], emap, 2)

    def der3(self, u):
        """(npts, dof, nsd, nsd, nsd) third derivatives (needs order>=3)."""
        S, emap, _ = self._tabulate(u)
        return self._contract(S[3], emap, 3)

    def der4(self, u):
        """(npts, dof, nsd⁴) fourth derivatives (needs order=4)."""
        S, emap, _ = self._tabulate(u)
        return self._contract(S[4], emap, 4)

    def geometry(self, u):
        """(npts, nsd) mapped physical coordinates."""
        _, _, x = self._tabulate(u)
        return x[:, 0, :]

    def evaluate(self, u):
        """(value, grad) in one pass."""
        S, emap, _ = self._tabulate(u)
        return self._contract(S[0], emap, 0), self._contract(S[1], emap, 1)


class FixedProbe:
    """Probe at a FIXED set of parametric points, tabulated once.

    The host-side span search and 1-D basis evaluation of :class:`Probe`
    run once, at construction; every evaluator afterwards is a gather and
    an einsum on the card on the coefficient vector it is given, so a time
    stepper's monitor can probe each step without a host round trip.

    Example (sampling a point each time step)::

        probe = FixedProbe(space, [[0.5, 0.5]])
        def monitor(U):
            return probe.value(U)[0, 0]
    """

    def __init__(self, space, u, order: int = 2):
        self.space = space
        S, emap, x = Probe(space, None, order)._tabulate(u)
        self.S = S
        self.emap = emap
        self.x = x[:, 0, :]
        self.order = min(order, space.order)

    def _contract(self, Sk, U, extra_axes):
        Ue = _as_field(self.space, U).to(Sk.dtype)[self.emap]
        return torch.einsum(_CONTRACT[extra_axes], Sk, Ue)

    def value(self, U):
        """(npts, dof) values of U at the fixed points."""
        return self._contract(self.S[0], U, 0)

    def grad(self, U):
        return self._contract(self.S[1], U, 1)

    def hess(self, U):
        return self._contract(self.S[2], U, 2)

    def der3(self, U):
        return self._contract(self.S[3], U, 3)

    def der4(self, U):
        return self._contract(self.S[4], U, 4)

    def geometry(self):
        """(npts, nsd) mapped physical coordinates of the fixed points."""
        return self.x

    def evaluate(self, U):
        """(value, grad) in one pass."""
        return self.value(U), self.grad(U)
