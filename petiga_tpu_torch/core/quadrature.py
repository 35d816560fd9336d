"""1-D quadrature rules on the reference interval [-1, 1].

Analog of ``IGARule`` (PetIGA's ``src/petigarule.c``): Gauss-Legendre
(exactness 2q-1), Gauss-Lobatto (exactness 2q-3), and the "reduced"
Legendre rule (one fewer point on interior elements, handled at
tabulation time, petigabasis.c:144-172).  The reference hard-codes
abscissae for q<=10; we compute them at setup time in float64 — the
values agree with the hard-coded tables to machine precision, and
arbitrary q comes for free.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Rule", "gauss_legendre", "gauss_lobatto"]


def gauss_legendre(q: int) -> tuple[np.ndarray, np.ndarray]:
    """q-point Gauss-Legendre nodes/weights on [-1, 1] (float64)."""
    if q < 1:
        raise ValueError("need at least one quadrature point")
    x, w = np.polynomial.legendre.leggauss(q)
    return x.astype(np.float64), w.astype(np.float64)


def gauss_lobatto(q: int) -> tuple[np.ndarray, np.ndarray]:
    """q-point Gauss-Lobatto nodes/weights on [-1, 1] (float64).

    Interior nodes are the roots of P'_{q-1}; weights
    w_i = 2 / (q (q-1) P_{q-1}(x_i)^2).
    """
    if q < 2:
        raise ValueError("Lobatto rule needs at least two points")
    n = q - 1
    # roots of d/dx P_n = roots of the Jacobi polynomial P^{(1,1)}_{n-1}
    Pn = np.polynomial.legendre.Legendre.basis(n)
    dPn = Pn.deriv()
    interior = dPn.roots() if n >= 2 else np.empty(0)
    x = np.concatenate(([-1.0], np.sort(np.real(interior)), [1.0]))
    w = 2.0 / (q * n * Pn(x) ** 2)
    return x.astype(np.float64), w.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A 1-D quadrature rule on [-1, 1].

    ``kind`` in {"legendre", "lobatto", "reduced", "user"}.  For
    "reduced", ``points``/``weights`` hold the full q-point Legendre rule;
    interior elements use the (q-1)-point rule (see
    :func:`petiga_tpu.core.basis.tabulate`), zero-padded to keep shapes
    static on TPU.
    """

    kind: str
    points: np.ndarray
    weights: np.ndarray

    @staticmethod
    def legendre(q: int) -> "Rule":
        x, w = gauss_legendre(q)
        return Rule("legendre", x, w)

    @staticmethod
    def lobatto(q: int) -> "Rule":
        x, w = gauss_lobatto(q)
        return Rule("lobatto", x, w)

    @staticmethod
    def reduced(q: int) -> "Rule":
        x, w = gauss_legendre(q)
        return Rule("reduced", x, w)

    @staticmethod
    def user(points, weights) -> "Rule":
        x = np.asarray(points, dtype=np.float64)
        w = np.asarray(weights, dtype=np.float64)
        if x.shape != w.shape or x.ndim != 1:
            raise ValueError("points/weights must be 1-D of equal length")
        return Rule("user", x, w)

    @staticmethod
    def make(kind: str, q: int) -> "Rule":
        if kind in ("legendre", "gauss"):
            return Rule.legendre(q)
        if kind == "lobatto":
            return Rule.lobatto(q)
        if kind == "reduced":
            return Rule.reduced(q)
        raise ValueError(f"unknown rule type {kind!r}")

    @property
    def nqp(self) -> int:
        return len(self.points)
