"""Peaks of one NVIDIA H100 SXM and the least time of a stencil product.

Peaks from NVIDIA's data sheet (dense rates at the 700 W power limit):
device memory 3.35 TB/s, 67 TFLOP/s in float32 and 34 TFLOP/s in float64
outside the tensor cores.

A stencil product ``y = A x`` on slot-major planes needs, at the least, the
stored planes' node columns read once (the halo columns of a periodic
layout hold zeros the product does not need), ``x`` read once and ``y``
written once; it performs two operations per stored entry, twice that for
symmetric storage, whose planes act once directly and once mirrored.
These counts follow from the shapes alone, whatever implements the
product.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_S", "PEAK_FLOP_S", "stencil_bytes", "stencil_flops", "stencil_bound_s"]

HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {4: 67e12, 8: 34e12}  # by item size


def stencil_bytes(nplanes: int, nnodes: int, dof: int, itemsize: int) -> int:
    return (nplanes * nnodes + 2 * nnodes * dof) * itemsize


def stencil_flops(nplanes: int, nnodes: int, symmetric: bool) -> int:
    return 2 * nplanes * nnodes * (2 if symmetric else 1)


def stencil_bound_s(nplanes: int, nnodes: int, dof: int, itemsize: int,
                    symmetric: bool) -> float:
    """The least seconds one product can take on the card: the larger of
    its bytes over the memory rate and its operations over the peak."""
    return max(stencil_bytes(nplanes, nnodes, dof, itemsize) / HBM_BYTES_S,
               stencil_flops(nplanes, nnodes, symmetric) / PEAK_FLOP_S[itemsize])
