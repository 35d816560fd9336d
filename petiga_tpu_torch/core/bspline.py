"""Vectorized B-spline / Lagrange / Bernstein basis evaluation with derivatives.

Setup-time numpy implementation of the reference's Fortran kernels
(PetIGA's ``src/petigabsb.f90.in`` — the classic Cox-de Boor
"DersBasisFuns" recursion, Piegl & Tiller A2.3 — and
``petigabsp.F90``/``petigalgb.f90.in`` for Lagrange/spectral bases).
Everything is vectorized over a batch of evaluation points; the results
feed the per-axis tabulation tables that device code consumes.

All routines return ``ders`` with shape ``(npts, nder+1, p+1)``:
``ders[b, k, a]`` is the k-th derivative of the a-th nonzero basis
function at point b.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bspline_ders",
    "lagrange_ders",
    "bernstein_ders",
    "newton_cotes_points",
]

MAX_DER = 4  # reference tabulates derivatives 0..4 (petiga.h:122-149)


def bspline_ders(
    U: np.ndarray, p: int, spans: np.ndarray, u: np.ndarray, nder: int
) -> np.ndarray:
    """Nonzero B-spline basis functions and derivatives at points ``u``.

    Args:
      U: knot vector, shape (m+1,).
      p: degree.
      spans: knot span index per point, shape (B,), with
        ``U[spans[b]] <= u[b] < U[spans[b]+1]`` (clamped at the right end).
      u: evaluation points, shape (B,).
      nder: number of derivatives (0..nder), nder <= p allowed above which
        derivatives are identically zero (still returned as zeros).

    Returns:
      ders, shape (B, nder+1, p+1), float64.
    """
    U = np.asarray(U, dtype=np.float64)
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    spans = np.atleast_1d(np.asarray(spans, dtype=np.int64))
    B = len(u)
    d = min(nder, p)

    if B >= 4096:
        # large tabulations go through the native C++ kernel (same
        # algorithm; see csrc/host/native_core.cpp)
        from .. import native

        if native.available():
            return native.bspline_ders(U, p, spans, u, nder)

    # triangular table of basis values: ndu[b, j, r]
    ndu = np.zeros((B, p + 1, p + 1))
    left = np.zeros((B, p + 1))
    right = np.zeros((B, p + 1))
    ndu[:, 0, 0] = 1.0
    for j in range(1, p + 1):
        left[:, j] = u - U[spans + 1 - j]
        right[:, j] = U[spans + j] - u
        saved = np.zeros(B)
        for r in range(j):
            # lower triangle: knot differences
            ndu[:, j, r] = right[:, r + 1] + left[:, j - r]
            temp = ndu[:, r, j - 1] / ndu[:, j, r]
            # upper triangle: basis values
            ndu[:, r, j] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        ndu[:, j, j] = saved

    ders = np.zeros((B, nder + 1, p + 1))
    ders[:, 0, :] = ndu[:, :, p]

    # derivative part (Piegl & Tiller A2.3): two alternating rows of
    # coefficients a[2, p+1]
    a = np.zeros((B, 2, p + 1))
    for r in range(p + 1):
        s1, s2 = 0, 1
        a[:] = 0.0
        a[:, 0, 0] = 1.0
        for k in range(1, d + 1):
            dv = np.zeros(B)
            rk = r - k
            pk = p - k
            if r >= k:
                a[:, s2, 0] = a[:, s1, 0] / ndu[:, pk + 1, rk]
                dv = a[:, s2, 0] * ndu[:, rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if (r - 1 <= pk) else p - r
            for j in range(j1, j2 + 1):
                a[:, s2, j] = (a[:, s1, j] - a[:, s1, j - 1]) / ndu[:, pk + 1, rk + j]
                dv = dv + a[:, s2, j] * ndu[:, rk + j, pk]
            if r <= pk:
                a[:, s2, k] = -a[:, s1, k - 1] / ndu[:, pk + 1, r]
                dv = dv + a[:, s2, k] * ndu[:, r, pk]
            ders[:, k, r] = dv
            s1, s2 = s2, s1

    # multiply through by the correct factors p!/(p-k)!
    r = float(p)
    for k in range(1, d + 1):
        ders[:, k, :] *= r
        r *= p - k
    return ders


def newton_cotes_points(n: int, u0: float, u1: float) -> np.ndarray:
    """n equally spaced points on [u0, u1] (petigabsp.F90:36-47)."""
    return np.linspace(u0, u1, n)


def lagrange_ders(nodes: np.ndarray, u: np.ndarray, nder: int) -> np.ndarray:
    """Lagrange basis on arbitrary nodes, derivatives 0..nder.

    Built from explicit polynomial coefficients (stable for the small
    p <= 10 the reference supports).  Returns (B, nder+1, p+1).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    p = len(nodes) - 1
    B = len(u)
    ders = np.zeros((B, nder + 1, p + 1))
    for i in range(p + 1):
        roots = np.delete(nodes, i)
        poly = np.polynomial.Polynomial.fromroots(roots)
        poly = poly / poly(nodes[i])
        for k in range(nder + 1):
            ders[:, k, i] = poly.deriv(k)(u) if k > 0 else poly(u)
    return ders


def bernstein_ders(p: int, u0: float, u1: float, u: np.ndarray, nder: int) -> np.ndarray:
    """Bernstein basis of degree p on [u0, u1], derivatives 0..nder.

    B_{i,p}(t) = C(p,i) t^i (1-t)^(p-i) with t = (u-u0)/(u1-u0).
    Returns (B, nder+1, p+1).
    """
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    B = len(u)
    h = u1 - u0
    t = (u - u0) / h
    from math import comb

    ders = np.zeros((B, nder + 1, p + 1))
    # values via polynomial coefficients, derivatives by chain rule in t
    for i in range(p + 1):
        poly = comb(p, i) * (
            np.polynomial.Polynomial([0.0, 1.0]) ** i
            * np.polynomial.Polynomial([1.0, -1.0]) ** (p - i)
        )
        for k in range(nder + 1):
            pk = poly.deriv(k) if k > 0 else poly
            ders[:, k, i] = pk(t) / h**k
    return ders
