"""Process-grid partitioning — analog of the reference's
``IGA_Partition``/``IGA_Distribute`` (petigapart.c): factor the device
count into a dim-D grid minimizing the communication surface, and
block-distribute grid entities per axis.

The objective matches the reference's: among all factorizations
``prod(m_d) = nproc``, pick the one minimizing the total cut surface of
the element grid (sum over axes of (m_d - 1) * prod_{e≠d} N_e), with
ties broken toward balanced aspect ratios.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

__all__ = ["factor_grid", "block_sizes", "block_ranges"]


def _factorizations(n: int, dims: int):
    """All ordered tuples (m_0..m_{dims-1}) with product n."""
    if dims == 1:
        yield (n,)
        return
    for m in range(1, n + 1):
        if n % m == 0:
            for rest in _factorizations(n // m, dims - 1):
                yield (m,) + rest


def factor_grid(nproc: int, sizes: Sequence[int]) -> tuple:
    """Choose the process grid (m_0..m_{dim-1}) for a grid of ``sizes``.

    Minimizes the cut surface; refuses factors larger than the axis size.
    """
    sizes = tuple(int(s) for s in sizes)
    dim = len(sizes)
    best, best_cost = None, None
    for m in _factorizations(nproc, dim):
        if any(mi > si for mi, si in zip(m, sizes)):
            continue
        cost = 0.0
        for d in range(dim):
            area = 1.0
            for e in range(dim):
                if e != d:
                    area *= sizes[e]
            cost += (m[d] - 1) * area
        # tie-break: prefer balanced local boxes
        local = [sizes[d] / m[d] for d in range(dim)]
        imbalance = max(local) / max(min(local), 1e-12)
        key = (cost, imbalance)
        if best is None or key < best_cost:
            best, best_cost = m, key
    if best is None:
        raise ValueError(
            f"cannot factor {nproc} devices over grid {sizes} "
            "(more devices than entities along every axis)"
        )
    return best


def block_sizes(N: int, m: int) -> np.ndarray:
    """Contiguous block distribution: N//m + (N%m > rank) like the
    reference's IGA_Dist1D (petigapart.c:170-202)."""
    base = N // m
    extra = N % m
    return np.array([base + (1 if r < extra else 0) for r in range(m)])


def block_ranges(N: int, m: int) -> list:
    s = block_sizes(N, m)
    ends = np.cumsum(s)
    starts = ends - s
    return list(zip(starts.tolist(), ends.tolist()))
