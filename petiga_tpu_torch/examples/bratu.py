"""Bratu — nonlinear Newton-Krylov solve (PetIGA demo/Bratu.c; port of the
JAX package's examples/bratu.py).

    python -m petiga_tpu_torch.examples.bratu --dim 2 -p 2 -N 16 --lam 6.8 [--hand-jacobian]

Solves -Δu = λ e^u with homogeneous Dirichlet BCs; the Jacobian comes
from forward-mode AD of the residual by default (``--hand-jacobian`` uses
the hand-written one).  Every inner CG product runs on the stencil
kernel (``operator="fast"``).  ``--device cpu`` runs on the CPU.
"""

import sys

from petiga_tpu_torch.config import Options, bind_cli, print_info
from petiga_tpu_torch.examples import DEVICE_FLAG


def main(argv=None):
    opts, ns = bind_cli(
        argv,
        defaults=Options(dtype="float64"),  # Newton to 1e-8 needs f64
        extra=[("lam", float, 6.80, "Bratu parameter λ"),
               ("hand-jacobian", int, 0, "use the hand-written Jacobian"),
               DEVICE_FLAG],
    )
    space = opts.build_space(device=ns.device)
    for d in range(space.dim):
        for s in range(2):
            space.set_boundary_value(d, s, 0, 0.0)
    print_info(space)

    from petiga_tpu_torch.models.bratu import solve_bratu

    res = solve_bratu(space, lam=ns.lam, use_ad=not getattr(ns, "hand_jacobian"),
                      operator="fast")
    print(f"newton iters={int(res.iters)} |F|={float(res.fnorm):.3e} "
          f"converged={bool(res.converged)} max(u)={float(res.U.max()):.6f}")
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main())
