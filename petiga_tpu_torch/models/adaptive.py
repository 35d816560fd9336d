"""Adaptive L2 projection (port of :mod:`petiga_tpu.models.adaptive`),
PetIGA's demo/AdaptiveL2Projection.c: greedy knot insertion ("which
knot reduces the global L2 error the most?") on non-uniform breaks."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.axis import Axis
from ..core.space import Space
from .projection import l2_project, projection_error

__all__ = ["adaptive_l2_projection"]


def _project_err(breaks, p, f, dtype, device):
    sp = Space([Axis.breaks(p=p, breaks=b) for b in breaks], dtype=dtype, device=device)
    U = l2_project(sp, f)
    return sp, U, projection_error(sp, U, f)


def adaptive_l2_projection(f: Callable, dim: int = 2, p: int = 2, n0: int = 4,
                           iters: int = 4, dtype=torch.float64, verbose: bool = False,
                           device=None):
    """Greedy refinement: at each step, try inserting the midpoint of
    every span on every axis and keep the insertion with the lowest
    resulting global L2 error (AdaptiveL2Projection.c's brute-force
    strategy).  ``f`` takes one point (the projection's load) and a
    batch of points (its error), as
    :func:`~petiga_tpu_torch.models.projection.projection_error` says.

    Returns (space, U, history) with history the error per iteration."""
    breaks = [np.linspace(0.0, 1.0, n0 + 1) for _ in range(dim)]
    sp, U, err = _project_err(breaks, p, f, dtype, device)
    history = [err]
    for _ in range(iters):
        best = None
        for d in range(dim):
            for c in 0.5 * (breaks[d][:-1] + breaks[d][1:]):
                trial = [b.copy() for b in breaks]
                trial[d] = np.sort(np.append(trial[d], c))
                e = _project_err(trial, p, f, dtype, device)[2]
                if best is None or e < best[0]:
                    best = (e, d, c)
        e, d, c = best
        breaks[d] = np.sort(np.append(breaks[d], c))
        history.append(e)
        if verbose:
            print(f"insert axis {d} at {c:.4f}: err {e:.3e}")
    sp, U, err = _project_err(breaks, p, f, dtype, device)
    return sp, U, history
