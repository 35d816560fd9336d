"""Linear elasticity — vector dof = dim, blocked (BSR-analog) assembly
(PetIGA demo/Elasticity.c, demo/Elasticity3D.c:14-48; port of the JAX
package's examples/elasticity.py).

    python -m petiga_tpu_torch.examples.elasticity --dim 2 -p 2 -N 16 --check-error 1e-3

All faces are clamped and the body force is manufactured by AD from a
smooth displacement field (demo-style ``-check_error`` self-validation);
solves with block-Jacobi CG on the stencil kernel and reports the
displacement L2 error.  The rigid-body near-nullspace
(petigansp.c:119-131) is printed for reference.  ``--device cpu`` runs on
the CPU.
"""

import math
import sys

import torch

from petiga_tpu_torch.config import bind_cli, print_info
from petiga_tpu_torch.examples import DEVICE_FLAG

# element chunk of the pointwise assembly: the AD body force's tables at
# 48³ would not fit on the card in one batch
CHUNK = 1 << 14


def main(argv=None):
    opts, ns = bind_cli(
        argv,
        extra=[
            ("lam", float, 1.0, "first Lame parameter"),
            ("mu", float, 1.0, "shear modulus"),
            ("check-error", float, 0.0, "fail if L2 error exceeds this"),
            DEVICE_FLAG,
        ],
    )
    from petiga_tpu_torch.assembly.assemble import assemble_system, compute_error_norm
    from petiga_tpu_torch.core.axis import Axis
    from petiga_tpu_torch.core.space import Space
    from petiga_tpu_torch.models import elasticity as el
    from petiga_tpu_torch.solve.krylov import block_jacobi_preconditioner, cg

    dim = opts.dim or 2
    p = opts.degree if isinstance(opts.degree, int) else opts.degree[0]
    nel = (opts.elements if isinstance(opts.elements, int)
           else opts.elements[0])
    space = Space([Axis.uniform(p=p, nel=nel)] * dim, dof=dim,
                  dtype=getattr(torch, opts.dtype), device=ns.device)
    for d in range(dim):
        for s in range(2):
            for c in range(dim):
                space.set_boundary_value(d, s, c, 0.0)
    print_info(space)
    modes = el.rigid_body_modes(space)
    print(f"rigid-body modes: {modes.shape}")

    def exact(x):
        # one point (dim,) or a batch (..., dim)
        u0 = torch.prod(torch.sin(math.pi * x), dim=-1)
        rest = torch.prod(x * (1 - x), dim=-1)
        return torch.stack([u0] + [rest * (i + 1) for i in range(dim - 1)], dim=-1)

    ctx = {"lambda": ns.lam, "mu": ns.mu}
    A, b = assemble_system(space, el.body_force_system(exact), ctx, chunk=CHUNK)
    res = cg(A.fast_operator(), b, M=block_jacobi_preconditioner(A),
             rtol=1e-10)
    err = float(compute_error_norm(space, res.x, exact, k=0))
    print(f"iters={int(res.iters)} residual={float(res.residual):.3e} "
          f"L2={err:.6e}")
    tol = getattr(ns, "check_error")
    if tol and err > tol:
        print(f"FAIL: L2 error {err:.3e} > {tol:.3e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
