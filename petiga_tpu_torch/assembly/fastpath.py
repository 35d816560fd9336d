"""Regular-patch predicates (port of the predicates of
:mod:`petiga_tpu.assembly.fastpath`).

A space is *regular* when its per-axis element offsets are in arithmetic
progression (uniform multiplicity, open or periodic), and *unit-step*
when that step is 1 on every axis (maximal continuity) — the
precondition of the coefficient-form plane assembly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["is_regular", "is_unit_step"]


def is_unit_step(space) -> bool:
    """Regular AND unit element step on every axis."""
    return is_regular(space) and all(s == 1 for s in _steps(space))


def is_regular(space) -> bool:
    """Offsets in arithmetic progression on every axis."""
    for d, t in enumerate(space.tabs):
        off = t.offset
        if len(off) > 1:
            dd = np.diff(off)
            if not np.all(dd == dd[0]):
                return False
            if space.periodic[d] and dd[0] != 1:
                return False
    return True


def _steps(space):
    return tuple(
        int(t.offset[1] - t.offset[0]) if t.nel > 1 else 1 for t in space.tabs
    )
