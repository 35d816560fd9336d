"""Entry point of the port (the counterpart of the JAX package's
``__graft_entry__.entry``).

``entry()`` — a single-device forward step on the flagship configuration
(3-D Poisson, p=2, 8³ elements): assemble the stencil operator with the
pointwise engine, then a fixed number of Jacobi-preconditioned CG
iterations through the stencil kernel.  The distributed dry run
(``dryrun_multichip``) waits for the distributed layer (ROADMAP Queue 1
item 15).
"""

from __future__ import annotations

import torch

from .assembly.assemble import assemble_system
from .models.poisson import make_space, poisson_system
from .solve.krylov import cg, jacobi_preconditioner

__all__ = ["entry", "dryrun_multichip"]


def _build(nel: int = 8, dtype=torch.float32, device=None):
    sp = make_space(3, p=2, nel=nel, dtype=dtype, device=device)

    def step(src_scale):
        A, b = assemble_system(sp, poisson_system, {"c": 0.0, "k": 1.0})
        b = b * src_scale
        res = cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=1e-5,
                 maxiter=30)
        return res.x, res.residual

    return sp, step


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(src_scale) -> (x, residual)``
    assembles the f32 system at 8³ elements, scales the load by
    ``src_scale`` and runs at most 30 Jacobi-CG iterations to rtol 1e-5.
    ``device=None`` is the CUDA device."""
    sp, step = _build(nel=8, device=device)
    return step, (torch.ones((), dtype=sp.dtype, device=sp.device),)


def dryrun_multichip(n_devices: int) -> None:
    raise NotImplementedError(
        "dryrun_multichip waits for the distributed layer (ROADMAP Queue 1 item 15)"
    )
