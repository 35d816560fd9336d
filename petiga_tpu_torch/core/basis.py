"""Per-axis basis tabulation tables.

Analog of ``IGABasis`` (PetIGA's ``src/petigabasis.c``): for every
element of a 1-D axis and every quadrature point, the values and
derivatives 0..4 of the ``p+1`` nonzero basis functions, plus the element
offsets (first global basis index), parametric det-Jacobians, and the
boundary-point tables used for surface integrals.  Tables are dense
float64 numpy arrays of static shape — exactly what batched TPU kernels
want to consume (converted to the compute dtype once, at setup).

Collocation tabulation (``IGABasisInitCollocation``, petigabasis.c:226-299)
evaluates at Greville abscissae instead: one "quadrature point" per
unique control point.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .axis import Axis
from .bspline import MAX_DER, bspline_ders, lagrange_ders, newton_cotes_points
from .quadrature import Rule, gauss_lobatto

__all__ = ["Tabulation", "tabulate", "tabulate_collocation", "BasisType"]


class BasisType:
    BSPLINE = "bspline"
    BERNSTEIN = "bernstein"
    LAGRANGE = "lagrange"
    SPECTRAL = "spectral"


def _eval_basis(axis: Axis, basis_type: str, spans, u, nder: int) -> np.ndarray:
    """Dispatch like petigabasis.c:175-186: Bernstein shares the B-spline
    path (valid because non-B-spline types require C^0 multiplicity)."""
    if basis_type in (BasisType.BSPLINE, BasisType.BERNSTEIN):
        return bspline_ders(axis.U, axis.p, spans, u, nder)
    p, U = axis.p, axis.U
    spans = np.atleast_1d(np.asarray(spans))
    u = np.atleast_1d(np.asarray(u))
    out = np.zeros((len(u), nder + 1, p + 1))
    for k in np.unique(spans):
        sel = spans == k
        u0, u1 = U[k], U[k + 1]
        if basis_type == BasisType.LAGRANGE:
            nodes = newton_cotes_points(p + 1, u0, u1)
        elif basis_type == BasisType.SPECTRAL:
            x, _ = gauss_lobatto(p + 1)
            nodes = (x + 1.0) * (u1 - u0) / 2.0 + u0
        else:
            raise ValueError(f"unknown basis type {basis_type!r}")
        out[sel] = lagrange_ders(nodes, u[sel], nder)
    return out


def _check_c0(axis: Axis, basis_type: str) -> None:
    if basis_type in (BasisType.BSPLINE,):
        return
    # non-B-spline basis types require C^0 continuity (petigabasis.c:109-121)
    U, p, m = axis.U, axis.p, axis.m
    k = 1
    while k < m:
        j = k + 1
        while j < m and U[j] == U[k]:
            j += 1
        if U[j] > U[k]:
            pass
        mult = j - k
        if mult < p and U[k] != U[0] and U[k] != U[m]:
            raise ValueError(
                f"basis type {basis_type!r} requires C^0 continuity "
                f"(knot {U[k]} has multiplicity {mult} < degree {p})"
            )
        k = j


@dataclasses.dataclass(frozen=True)
class Tabulation:
    """Per-axis, per-element, per-quadrature-point basis tables.

    Shapes: ``value (nel, nqp, 5, p+1)``, ``point/weight (nel, nqp)``,
    ``detJac (nel,)``, ``offset (nel,)``, ``bnd_value (2, 5, p+1)``,
    ``bnd_point (2,)``.
    """

    p: int
    nel: int
    nqp: int
    offset: np.ndarray
    detJac: np.ndarray
    weight: np.ndarray
    point: np.ndarray
    value: np.ndarray
    bnd_value: np.ndarray
    bnd_point: np.ndarray
    collocation: bool = False

    @property
    def nen(self) -> int:
        return self.p + 1


def tabulate(axis: Axis, rule: Rule, basis_type: str = BasisType.BSPLINE) -> Tabulation:
    """Quadrature tabulation of one axis (petigabasis.c:83-219)."""
    _check_c0(axis, basis_type)
    p, U = axis.p, axis.U
    spans = axis.spans
    nel = len(spans)
    nqp = rule.nqp
    d = min(p, MAX_DER)

    u0 = U[spans]
    u1 = U[spans + 1]
    detJac = (u1 - u0) / 2.0  # parametric half-width
    # points/weights per element; "reduced" uses one fewer point on
    # interior elements, zero-padded (petigabasis.c:144-172)
    point = np.empty((nel, nqp))
    weight = np.zeros((nel, nqp))
    point[:] = (rule.points[None, :] + 1.0) * detJac[:, None] + u0[:, None]
    weight[:] = rule.weights[None, :]
    if rule.kind == "reduced" and nel > 2 and nqp > 1:
        xr, wr = np.polynomial.legendre.leggauss(nqp - 1)
        interior = slice(1, nel - 1)
        point[interior, : nqp - 1] = (xr[None, :] + 1.0) * detJac[
            interior, None
        ] + u0[interior, None]
        # pad with the element midpoint (weight 0 ⇒ no contribution, but
        # keeps downstream geometry maps finite)
        point[interior, nqp - 1] = (u0[interior] + u1[interior]) / 2.0
        weight[interior, : nqp - 1] = wr[None, :]
        weight[interior, nqp - 1] = 0.0

    span_rep = np.repeat(spans, nqp)
    ders = _eval_basis(axis, basis_type, span_rep, point.ravel(), d)
    value = np.zeros((nel, nqp, MAX_DER + 1, p + 1))
    value[:, :, : d + 1, :] = ders.reshape(nel, nqp, d + 1, p + 1)

    offset = spans - p

    # boundary tables at the two parametric ends (petigabasis.c:205-216)
    n = axis.n
    k0, k1 = p, n
    ub0, ub1 = U[k0], U[k1 + 1]
    bnd = _eval_basis(axis, basis_type, np.array([k0, k1]), np.array([ub0, ub1]), d)
    bnd_value = np.zeros((2, MAX_DER + 1, p + 1))
    bnd_value[:, : d + 1, :] = bnd

    return Tabulation(
        p=p,
        nel=nel,
        nqp=nqp,
        offset=offset.astype(np.int64),
        detJac=detJac,
        weight=weight,
        point=point,
        value=value,
        bnd_value=bnd_value,
        bnd_point=np.array([ub0, ub1]),
        collocation=False,
    )


def tabulate_collocation(axis: Axis) -> Tabulation:
    """Collocation tabulation at Greville points (petigabasis.c:226-299).

    One evaluation point per unique control point; ``offset`` carries the
    periodic shift ``(n+1-nnp)/2`` so closures index the same ghosted
    layout as the Galerkin path.
    """
    p, U, n = axis.p, axis.U, axis.n
    nnp = axis.nnp
    shift = (n + 1 - nnp) // 2
    d = min(p, MAX_DER)

    g = np.array([np.mean(U[i + shift + 1 : i + shift + p + 1]) for i in range(nnp)])
    spans = axis.find_span(g)
    ders = _eval_basis(axis, BasisType.BSPLINE, spans, g, d)
    value = np.zeros((nnp, 1, MAX_DER + 1, p + 1))
    value[:, 0, : d + 1, :] = ders

    k0, k1 = p, n
    ub0, ub1 = U[k0], U[k1 + 1]
    bnd = _eval_basis(axis, BasisType.BSPLINE, np.array([k0, k1]), np.array([ub0, ub1]), d)
    bnd_value = np.zeros((2, MAX_DER + 1, p + 1))
    bnd_value[:, : d + 1, :] = bnd

    return Tabulation(
        p=p,
        nel=nnp,
        nqp=1,
        offset=(spans - p - shift).astype(np.int64),
        detJac=np.ones(nnp),
        weight=np.ones((nnp, 1)),
        point=g.reshape(nnp, 1),
        value=value,
        bnd_value=bnd_value,
        bnd_point=np.array([ub0, ub1]),
        collocation=True,
    )
