"""1-D discretization axis: knot vectors, spans, Greville abscissae.

TPU-native analog of the reference ``IGAAxis`` object
(PetIGA's ``src/petigaaxis.c``): an open (clamped) or periodic
B-spline knot vector of degree ``p`` with prescribed inter-element
continuity.  All of this is *setup-time* metadata computed on the host in
float64 numpy; device code only ever sees the dense tabulation arrays
derived from it (see :mod:`petiga_tpu.core.basis`).

Conventions (matching the reference semantics, petigaaxis.c:419-452):
  * knots ``U[0..m]``, degree ``p``, number of basis functions
    ``n + 1 = m - p``.
  * an *element* (nonzero span) is an interval ``[U[k], U[k+1])`` with
    ``U[k+1] > U[k]``; ``spans[e]`` is the knot index ``k`` of element ``e``.
  * a *uniform* axis with ``N`` elements and continuity ``C`` repeats each
    interior break ``s = p - C`` times.
  * periodic axes unwrap the first/last ``C+1`` knots so the basis wraps
    around; the number of *unique* control points is ``nnp = n - C``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["Axis"]


def _next_knot(U: np.ndarray, k: int, direction: int = 1) -> int:
    """Index of the next strictly different knot (petigaaxis.c:482-494)."""
    m = len(U) - 1
    if direction >= 0:
        if k < 0:
            return 0
        for j in range(k + 1, m):
            if U[j] > U[k]:
                return j
        return m
    else:
        if k > m:
            return m
        for j in range(k - 1, 0, -1):
            if U[j] < U[k]:
                return j
        return 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """An immutable 1-D B-spline axis.

    Attributes:
      p: polynomial degree.
      U: knot vector, shape ``(m+1,)``, float64, non-decreasing.
      periodic: whether the axis is periodic.
    """

    p: int
    U: np.ndarray
    periodic: bool = False

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def uniform(
        p: int,
        nel: int,
        u0: float = 0.0,
        u1: float = 1.0,
        continuity: Optional[int] = None,
        periodic: bool = False,
    ) -> "Axis":
        """Uniform axis with ``nel`` equal elements and continuity ``C``.

        Mirrors ``IGAAxisInitUniform`` (petigaaxis.c:402-455): interior
        breaks have multiplicity ``s = p - C``; periodic axes additionally
        unwrap the clamped ends so that basis functions wrap around.
        """
        C = p - 1 if continuity is None else continuity
        if p < 1:
            raise ValueError("degree must be >= 1")
        if nel < 1:
            raise ValueError("number of elements must be >= 1")
        if not (0 <= C < p):
            raise ValueError(f"continuity must be in [0,{p-1}], got {C}")
        if u0 >= u1:
            raise ValueError("u0 must be < u1")
        s = p - C
        m = 2 * (p + 1) + (nel - 1) * s - 1
        n = m - p - 1
        U = np.empty(m + 1, dtype=np.float64)
        U[: p + 1] = u0
        U[m - p :] = u1
        k = p + 1
        for i in range(1, nel):
            U[k : k + s] = u0 + (u1 - u0) * (i / nel)
            k += s
        if periodic:
            # unwrap ends (petigaaxis.c:444-449)
            for k in range(C + 1):
                U[C - k] = U[p] - U[m - p] + U[n - k]
                U[m - C + k] = U[m - p] - U[p] + U[p + 1 + k]
        return Axis(p=p, U=U, periodic=periodic)

    @staticmethod
    def breaks(
        p: int,
        breaks: Sequence[float],
        continuity: Optional[int] = None,
        periodic: bool = False,
    ) -> "Axis":
        """Axis from arbitrary (strictly increasing) break points."""
        C = p - 1 if continuity is None else continuity
        b = np.asarray(breaks, dtype=np.float64)
        if b.ndim != 1 or len(b) < 2:
            raise ValueError("need at least two break points")
        if np.any(np.diff(b) <= 0):
            raise ValueError("breaks must be strictly increasing")
        if not (0 <= C < p):
            raise ValueError(f"continuity must be in [0,{p-1}], got {C}")
        s = p - C
        nel = len(b) - 1
        m = 2 * (p + 1) + (nel - 1) * s - 1
        n = m - p - 1
        U = np.empty(m + 1, dtype=np.float64)
        U[: p + 1] = b[0]
        U[m - p :] = b[-1]
        k = p + 1
        for i in range(1, nel):
            U[k : k + s] = b[i]
            k += s
        if periodic:
            for k in range(C + 1):
                U[C - k] = U[p] - U[m - p] + U[n - k]
                U[m - C + k] = U[m - p] - U[p] + U[p + 1 + k]
        return Axis(p=p, U=U, periodic=periodic)

    @staticmethod
    def from_knots(p: int, U: Sequence[float], periodic: bool = False) -> "Axis":
        """Axis from an explicit knot vector (validated)."""
        U = np.asarray(U, dtype=np.float64)
        m = len(U) - 1
        if m < 2 * p + 1:
            raise ValueError("knot vector too short for degree")
        if np.any(np.diff(U) < 0):
            raise ValueError("knot vector must be non-decreasing")
        return Axis(p=p, U=U, periodic=periodic)

    # ---- derived quantities ----------------------------------------------

    @property
    def m(self) -> int:
        """Last knot index."""
        return len(self.U) - 1

    @property
    def n(self) -> int:
        """Last basis-function index."""
        return self.m - self.p - 1

    @property
    def nbasis(self) -> int:
        """Number of basis functions (including periodic duplicates)."""
        return self.n + 1

    @property
    def continuity(self) -> int:
        """Continuity order across the wrap point (periodic) / interior."""
        if self.periodic:
            k = self.n + 1
            j = _next_knot(self.U, k, 1)
            return self.p - (j - k)
        # interior continuity of a uniform axis; for general knots this is
        # the minimum over interior breaks.
        p, U = self.p, self.U
        c = p - 1
        k = p
        while True:
            j = _next_knot(U, k, 1)
            if j >= self.m - p:
                break
            mult = 0
            while j + mult <= self.m and U[j + mult] == U[j]:
                mult += 1
            c = min(c, p - mult)
            k = j
        return c

    @property
    def nnp(self) -> int:
        """Number of unique control points (petigaaxis.c:469-476)."""
        if self.periodic:
            k = self.n + 1
            j = _next_knot(self.U, k, 1)
            s = j - k
            C = self.p - s
            return self.n - C
        return self.n + 1

    @property
    def spans(self) -> np.ndarray:
        """Knot indices of the nonzero spans (elements)."""
        p, m, U = self.p, self.m, self.U
        return np.array(
            [k for k in range(p, m - p) if U[k + 1] > U[k]], dtype=np.int64
        )

    @property
    def nel(self) -> int:
        return len(self.spans)

    @property
    def limits(self) -> tuple[float, float]:
        return float(self.U[self.p]), float(self.U[self.m - self.p])

    def greville(self) -> np.ndarray:
        """Greville abscissae: averages of p consecutive interior knots
        (petigabasis.c:320-326), clipped to the parametric domain."""
        p, U = self.p, self.U
        n = self.n
        g = np.array([np.mean(U[i + 1 : i + p + 1]) for i in range(n + 1)])
        u0, u1 = self.limits
        if not self.periodic:
            g = np.clip(g, u0, u1)
        return g

    def find_span(self, u: np.ndarray) -> np.ndarray:
        """Knot span index containing parametric point(s) u (clamped)."""
        p, m, U = self.p, self.m, self.U
        u = np.asarray(u)
        lo, hi = p, m - p - 1
        k = np.searchsorted(U[: m - p], u, side="right") - 1
        return np.clip(k, lo, hi)

    def element_of(self, u: np.ndarray) -> np.ndarray:
        """Element index containing parametric point(s) u."""
        spans = self.spans
        k = self.find_span(u)
        return np.searchsorted(spans, k, side="right") - 1
