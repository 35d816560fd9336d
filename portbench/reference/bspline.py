"""Plain B-spline tables for the reference: uniform knot vectors, Gauss
rules and basis values with derivatives at the quadrature points of every
element, in float64 numpy.

Uniform axes on [0, 1] with ``nel`` elements of degree ``p`` and maximal
continuity C^(p-1).  An open axis has ``nel + p`` basis functions, the
first and last interpolating the ends.  A periodic axis has ``nel`` basis
functions, all translates of the cardinal B-spline; element ``e`` carries
functions ``(e + a) mod nel``, ``a = 0..p``.  On an open axis element ``e``
carries functions ``e + a``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_legendre", "element_tables", "band_matrix", "load_1d", "multiplicity"]


def gauss_legendre(q: int):
    """Points and weights of the q-point Gauss–Legendre rule on [-1, 1]."""
    return np.polynomial.legendre.leggauss(q)


def _knots(p: int, nel: int, periodic: bool) -> np.ndarray:
    h = 1.0 / nel
    if periodic:
        return (np.arange(-p, nel + p + 1)) * h
    return np.concatenate([np.zeros(p), np.arange(nel + 1) * h, np.ones(p)])


def _ders(U: np.ndarray, p: int, span: int, x: float, n: int) -> np.ndarray:
    """(n+1, p+1) derivatives 0..n of the p+1 functions nonzero on knot
    span ``span`` at ``x`` (The NURBS Book, A2.3)."""
    ndu = np.zeros((p + 1, p + 1))
    left = np.zeros(p + 1)
    right = np.zeros(p + 1)
    ndu[0, 0] = 1.0
    for j in range(1, p + 1):
        left[j] = x - U[span + 1 - j]
        right[j] = U[span + j] - x
        saved = 0.0
        for r in range(j):
            ndu[j, r] = right[r + 1] + left[j - r]
            tmp = ndu[r, j - 1] / ndu[j, r]
            ndu[r, j] = saved + right[r + 1] * tmp
            saved = left[j - r] * tmp
        ndu[j, j] = saved
    ders = np.zeros((n + 1, p + 1))
    ders[0] = ndu[:, p]
    a = np.zeros((2, p + 1))
    for r in range(p + 1):
        s1, s2 = 0, 1
        a[0, 0] = 1.0
        for k in range(1, n + 1):
            d = 0.0
            rk, pk = r - k, p - k
            if r >= k:
                a[s2, 0] = a[s1, 0] / ndu[pk + 1, rk]
                d = a[s2, 0] * ndu[rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if r - 1 <= pk else p - r
            for j in range(j1, j2 + 1):
                a[s2, j] = (a[s1, j] - a[s1, j - 1]) / ndu[pk + 1, rk + j]
                d += a[s2, j] * ndu[rk + j, pk]
            if r <= pk:
                a[s2, k] = -a[s1, k - 1] / ndu[pk + 1, r]
                d += a[s2, k] * ndu[r, pk]
            ders[k, r] = d
            s1, s2 = s2, s1
    fac = p
    for k in range(1, n + 1):
        ders[k] *= fac
        fac *= p - k
    return ders


def element_tables(p: int, nel: int, q: int, nders: int, periodic: bool = False):
    """Per element: quadrature points ``x (nel, q)``, weights ``w (nel, q)``
    (the element's length included) and basis derivatives
    ``B (nders+1, nel, q, p+1)`` in the physical coordinate; ``nodes
    (nel, p+1)`` the global basis index of each local function."""
    U = _knots(p, nel, periodic)
    xi, wi = gauss_legendre(q)
    h = 1.0 / nel
    x = np.empty((nel, q))
    w = np.empty((nel, q))
    B = np.empty((nders + 1, nel, q, p + 1))
    for e in range(nel):
        a = e * h
        span = e + p
        for k in range(q):
            xk = a + 0.5 * (xi[k] + 1.0) * h
            x[e, k] = xk
            w[e, k] = 0.5 * h * wi[k]
            B[:, e, k, :] = _ders(U, p, span, xk, nders)
    nn = nel if periodic else nel + p
    nodes = (np.arange(nel)[:, None] + np.arange(p + 1)[None, :]) % nn
    return x, w, B, nodes


def band_matrix(p: int, nel: int, q: int, da: int, db: int, g=None) -> np.ndarray:
    """Band ``(N, 2p+1)`` of the open-axis 1-D matrix
    ``A[i, j] = ∫ g(x) D^da N_i D^db N_j dx``: ``band[i, o + p] = A[i, i + o]``
    (zero where ``i + o`` is out of range).  ``g`` maps points to weights
    (None: 1)."""
    x, w, B, nodes = element_tables(p, nel, q, max(da, db))
    wg = w if g is None else w * g(x)
    Ke = np.einsum("eq,eqa,eqb->eab", wg, B[da], B[db])
    N = nel + p
    band = np.zeros((N, 2 * p + 1))
    for a in range(p + 1):
        for b in range(p + 1):
            np.add.at(band, (nodes[:, a], b - a + p), Ke[:, a, b])
    return band


def load_1d(p: int, nel: int, q: int, g) -> np.ndarray:
    """(N,) open-axis 1-D load ``∫ g(x) N_i dx``."""
    x, w, B, nodes = element_tables(p, nel, q, 0)
    fe = np.einsum("eq,eqa->ea", w * g(x), B[0])
    out = np.zeros(nel + p)
    np.add.at(out, nodes, fe)
    return out


def multiplicity(p: int, nel: int) -> np.ndarray:
    """(N,) number of elements whose closure holds each open-axis basis
    function."""
    out = np.zeros(nel + p)
    for a in range(p + 1):
        np.add.at(out, np.arange(nel) + a, 1.0)
    return out
