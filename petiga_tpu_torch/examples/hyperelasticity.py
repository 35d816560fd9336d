"""Finite-strain hyperelasticity — Newton with AD tangents and selectable
material models (PetIGA demo/HyperElasticity.c:18-21: Neo-Hookean /
St-Venant / Mooney-Rivlin; port of the JAX package's
examples/hyperelasticity.py: the material is a first-Piola closure and the
consistent tangent is forward-mode AD of the residual).

    python -m petiga_tpu_torch.examples.hyperelasticity --dim 2 -p 2 -N 6 \\
        --material neo_hookean --stretch 0.2

Clamps the x=0 face, prescribes a stretch at x=1, and Newton-solves (CG on
the stencil kernel), ramping the load in ``--steps`` continuation steps.
``--device cpu`` runs on the CPU.
"""

import sys

import torch

from petiga_tpu_torch.config import bind_cli, print_info
from petiga_tpu_torch.examples import DEVICE_FLAG


def main(argv=None):
    opts, ns = bind_cli(
        argv,
        extra=[
            ("material", str, "neo_hookean",
             "neo_hookean | st_venant | mooney_rivlin"),
            ("stretch", float, 0.1, "prescribed end displacement"),
            ("lam", float, 1.0, "first Lame parameter"),
            ("mu", float, 1.0, "shear modulus"),
            ("steps", int, 1, "load-continuation steps"),
            DEVICE_FLAG,
        ],
    )
    from petiga_tpu_torch.models import hyperelasticity as hel

    dim = opts.dim or 2
    p = opts.degree if isinstance(opts.degree, int) else opts.degree[0]
    nel = (opts.elements if isinstance(opts.elements, int)
           else opts.elements[0])
    space = hel.make_space(dim=dim, p=p, nel=nel, dtype=getattr(torch, opts.dtype),
                           stretch=ns.stretch, device=ns.device)
    print_info(space)

    if ns.material == "neo_hookean":
        mat = hel.neo_hookean(ns.lam, ns.mu)
    elif ns.material == "st_venant":
        mat = hel.st_venant(ns.lam, ns.mu)
    elif ns.material == "mooney_rivlin":
        mat = hel.mooney_rivlin(0.5 * ns.mu, 0.1 * ns.mu, ns.lam)
    else:
        raise SystemExit(f"unknown material {ns.material!r}")

    U, res = hel.solve(space, material=mat, rtol=1e-8,
                       continuation=ns.steps)
    umax = float(U.abs().max())
    print(f"newton iters={int(res.iters)} |F|={float(res.fnorm):.3e} "
          f"max|u|={umax:.4f}")
    return 0 if float(res.fnorm) < 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
