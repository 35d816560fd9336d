"""The reference computed in TF32, for the control of float32 cells.

TF32 keeps 10 of float32's 23 mantissa bits in each operand of a product
and sums in float32, as the tensor cores do with TF32 enabled.  Here every
operand of every product is rounded to TF32 (to nearest, ties away from
zero) and everything else stays float32: the operator's entries, the
load vector, the product with a vector and a Jacobi-CG solve.

:class:`Operator` and :func:`cg` stand in for the program's operator and
solve with the same names the benchmark's check reads (``DT``, ``kind``,
``nplanes``, ``dof``, ``st.nnodes``, ``matvec``; ``x``, ``iters``).
"""

from __future__ import annotations

from collections import namedtuple
from types import SimpleNamespace

import torch

from .poisson import System, forcing_modes_1d

__all__ = ["tf32", "Operator", "load", "cg", "Result"]

Result = namedtuple("Result", ["x", "iters", "residual"])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Operator:
    """The fixed operator of ``system`` with TF32 entries, stored as the
    program stores it: one float32 plane per stored slot (the upper slots
    when ``symmetric``)."""

    def __init__(self, system: System, symmetric: bool):
        self.S = system
        self.kind = "sym" if symmetric else "full"
        self.dof = 1
        self.st = SimpleNamespace(nnodes=system.N ** system.dim)
        for i, (c, bands) in enumerate(system.terms):
            system.terms[i] = (c, [tf32(b.float()).double() for b in bands])
        slots = range(system.diag_slot if symmetric else 0, system.nslots)
        N = system.N
        self.DT = torch.empty((len(slots), self.st.nnodes), dtype=torch.float32,
                              device=system.device)
        for k, s in enumerate(slots):
            self.DT[k] = tf32(system.slot_block(s, 0, N).float()).reshape(-1)
        self.nplanes = len(slots)
        d = system.slot_block(system.diag_slot, 0, N)
        self.dinv = (1.0 / tf32(d.float())).reshape(-1, 1)

    def _band(self, band, x, g):
        p, N = self.S.p, self.S.N
        xm = torch.movedim(x, g, -1)
        xp = tf32(torch.nn.functional.pad(xm, (p, p)))
        y = torch.zeros_like(xm)
        b = tf32(band.float())
        for o in range(2 * p + 1):
            y += b[:, o] * xp[..., o:o + N]
        return torch.movedim(y, -1, g)

    def matvec(self, x):
        S = self.S
        shape = x.shape
        x = x.reshape(S.grid).float()
        keep = S.keep.float()
        xk = x * keep
        y = torch.zeros_like(x)
        for c, bands in S.terms:
            v = xk
            for g in range(S.dim):
                v = self._band(bands[S.dim - 1 - g], v, g)
            y += tf32(torch.full((), c, dtype=torch.float32, device=y.device)) * tf32(v)
        y = y * keep + tf32(S.fixed_diag.float()) * tf32(x)
        return y.reshape(shape)


def load(system: System, modes):
    """The fixed load vector with TF32 products, ``(nnodes, 1)``."""
    b = torch.zeros(system.grid, dtype=torch.float32, device=system.device)
    for amp, loads in forcing_modes_1d(system.p, system.nel, system.q, modes):
        v = None
        for g in range(system.dim):
            col = tf32(torch.as_tensor(loads[system.dim - 1 - g], dtype=torch.float32,
                                       device=system.device))
            shape = [1] * system.dim
            shape[g] = system.N
            v = col.reshape(shape) if v is None else tf32(v) * col.reshape(shape)
        b += tf32(torch.full((), amp, dtype=torch.float32, device=b.device)) * tf32(v)
    return (b * system.keep.float()).reshape(-1, 1)


def cg(op: Operator, b, rtol, maxiter):
    """Jacobi-CG in float32 on :meth:`Operator.matvec`."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r * op.dinv
    p = z
    rz = torch.dot(r.view(-1), z.view(-1))
    tol2 = (rtol * float(torch.linalg.vector_norm(b))) ** 2
    k = 0
    while k < maxiter and float(torch.dot(r.view(-1), r.view(-1))) > tol2:
        Ap = op.matvec(p)
        alpha = rz / torch.dot(p.view(-1), Ap.view(-1))
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * op.dinv
        rz_new = torch.dot(r.view(-1), z.view(-1))
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return Result(x=x, iters=k, residual=torch.linalg.vector_norm(r))
