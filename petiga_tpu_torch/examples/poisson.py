"""Poisson — the canonical linear solve (PetIGA demo/Poisson.c:48-110,
demo/Poisson{1,2,3}D.c; port of the JAX package's examples/poisson.py).

    python -m petiga_tpu_torch.examples.poisson --dim 3 -p 2 -N 16 --check-error 1e-4

Builds the space from command-line options (IGASetFromOptions analog),
applies homogeneous Dirichlet BCs, assembles the Galerkin system, solves
with Jacobi-CG on the stencil kernel, and reports the L2/H1 error against
the manufactured solution.  Pass ``--collocation`` for the
Greville-collocation variant (Poisson.c:11-46 has both forms); its
BiCGStab also runs on the kernel (``A.fast_operator()``), where the
reference applies the slot loop.  ``--device cpu`` runs on the CPU.
"""

import math
import sys

import torch

from petiga_tpu_torch.config import bind_cli, print_info
from petiga_tpu_torch.examples import DEVICE_FLAG

# element chunk of the H1 functional: its tables at 128³ p=2 would not fit
# on the card in one batch
H1_CHUNK = 1 << 15


def main(argv=None):
    opts, ns = bind_cli(
        argv,
        extra=[("check-error", float, 0.0, "fail if L2 error exceeds this"), DEVICE_FLAG],
    )
    space = opts.build_space(device=ns.device)
    for d in range(space.dim):
        for s in range(2):
            space.set_boundary_value(d, s, 0, 0.0)
    print_info(space)

    if opts.collocation:
        from petiga_tpu_torch.assembly.collocation import assemble_collocation
        from petiga_tpu_torch.solve.krylov import bicgstab, jacobi_preconditioner

        def laplace_colloc(pt, ctx):
            # -Δu = f at the collocation point (Poisson.c:33-46)
            f = space.dim * math.pi**2 * torch.prod(torch.sin(math.pi * pt.x))
            lapN = torch.diagonal(pt.shape2, dim1=-2, dim2=-1).sum(-1)
            return -lapN[None, :], f.reshape(1)

        A, b = assemble_collocation(space, laplace_colloc)
        res = bicgstab(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=1e-12,
                       maxiter=3000)
        U = res.x
        info = {"iters": int(res.iters), "residual": float(res.residual)}
    else:
        from petiga_tpu_torch.models.poisson import solve_poisson

        U, info = solve_poisson(space)
    from petiga_tpu_torch.models.poisson import h1_error, l2_error

    e0, e1 = l2_error(space, U), h1_error(space, U, chunk=H1_CHUNK)
    print(f"iters={info['iters']} residual={info['residual']:.3e} "
          f"L2={e0:.6e} H1={e1:.6e}")
    tol = getattr(ns, "check_error")
    if tol and e0 > tol:
        print(f"FAIL: L2 error {e0:.3e} > {tol:.3e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
