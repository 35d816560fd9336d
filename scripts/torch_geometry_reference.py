#!/usr/bin/env python3
"""The JAX package's values for the geometry, collocation and I/O phases
of ``chip_smoke.py`` (``mapped128``, ``colloc``, ``bratu_colloc``,
``io_post``), run on the CPU in float64, one case per process; prints one
JSON line.

Cases:

  mapped --nel N   3-D p=2 Poisson on the unit cube under the warp
                   ``x += 0.05 sin(πx) sin(πy) sin(πz)`` of the Greville
                   control points (first coordinate; boundary points stay
                   on their faces, det J ≥ 1 - 0.05π), forcing
                   ``3π² Π sin(πx_i)`` at the physical points: the conv
                   planes, Jacobi-CG to rtol 1e-12, the L2 error;
  colloc --nel N   3-D p=2 Poisson collocation, Jacobi-BiCGStab to rtol
                   1e-12, the L2 error on a Galerkin clone;
  bratu --nel N    2-D p=2 Bratu collocation at λ = 4 from U = 0: Newton
                   with the AD Jacobian and Jacobi-BiCGStab (rtol 1e-10)
                   to ‖F‖ < 1e-10 ‖F₀‖ (at 256² the f64 residual stalls
                   near 1.2e-9, so an absolute 1e-10 is never met); the
                   Newton iterations and max U;
  sha              SHA-256 of the PetIGA binary files of a seeded 8³
                   NURBS space (the warp above, weights
                   ``1 + 0.3 Π sin(πG_i)``) and of a seeded vector.

    JAX_PLATFORMS=cpu python3 scripts/torch_geometry_reference.py mapped --nel 32
"""

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from petiga_tpu.assembly.assemble import compute_error_norm  # noqa: E402
from petiga_tpu.assembly.collocation import (  # noqa: E402
    assemble_collocation, assemble_collocation_function, assemble_collocation_jacobian)
from petiga_tpu.assembly.convform import (  # noqa: E402
    assemble_coefficient_planes, poisson_coefficients)
from petiga_tpu.core.axis import Axis  # noqa: E402
from petiga_tpu.core.space import Space  # noqa: E402
from petiga_tpu.io.checkpoint import write_space, write_vec  # noqa: E402
from petiga_tpu.models.bratu import bratu_collocation_residual  # noqa: E402
from petiga_tpu.models.poisson import _jacobi_inv, exact_solution, make_space  # noqa: E402
from petiga_tpu.solve.krylov import bicgstab, cg, jacobi_preconditioner  # noqa: E402


def warp(G):
    """The warped control points of Greville points ``G`` (nnodes, 3)."""
    X = np.array(G, dtype=np.float64)
    X[:, 0] += 0.05 * np.prod(np.sin(np.pi * G), axis=1)
    return X


def nurbs_weights(G):
    return 1.0 + 0.3 * np.prod(np.sin(np.pi * G), axis=1)


def forcing(x, ctx=None):
    return 3 * jnp.pi**2 * jnp.prod(jnp.sin(jnp.pi * x), axis=-1)


def case_mapped(nel):
    sp = make_space(3, p=2, nel=nel, dtype=jnp.float64)
    sp.init_geometry(warp(np.asarray(sp.greville_coordinates())))
    op, b = assemble_coefficient_planes(sp, poisson_coefficients, {"c": 0.0, "k": 1.0},
                                        forcing=forcing)
    dinv = _jacobi_inv(op)
    res = cg(op, b, M=lambda r: r * dinv, rtol=1e-12, maxiter=20000)
    l2 = float(compute_error_norm(sp, res.x, exact_solution, k=0))
    return {"cg_iters": int(res.iters), "l2_error": l2}


def laplace_colloc(pt, ctx):
    f = pt.dim * jnp.pi**2 * jnp.prod(jnp.sin(jnp.pi * pt.x))
    return -jnp.trace(pt.shape2, axis1=-2, axis2=-1)[None, :], jnp.asarray([f])


def colloc_space(dim, nel):
    sp = Space([Axis.uniform(p=2, nel=nel) for _ in range(dim)], collocation=True,
               dtype=jnp.float64)
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def case_colloc(nel):
    sp = colloc_space(3, nel)
    A, b = assemble_collocation(sp, laplace_colloc)
    res = bicgstab(A, b, M=jacobi_preconditioner(A), rtol=1e-12, maxiter=20000)
    spg = Space([Axis.uniform(p=2, nel=nel) for _ in range(3)], dtype=jnp.float64)
    l2 = float(compute_error_norm(spg, res.x, exact_solution, k=0))
    return {"bicgstab_iters": int(res.iters), "l2_error": l2}


def case_bratu(nel):
    sp = colloc_space(2, nel)
    ctx = {"lambda": 4.0}
    U = jnp.zeros((sp.nnodes, 1))
    its, hist = 0, []
    while True:
        F = assemble_collocation_function(sp, bratu_collocation_residual, U, ctx)
        hist.append(float(jnp.linalg.norm(F)))
        if hist[-1] < 1e-10 * hist[0] or its == 30:
            break
        J = assemble_collocation_jacobian(sp, bratu_collocation_residual, U, ctx)
        U = U - bicgstab(J, F, M=jacobi_preconditioner(J), rtol=1e-10, maxiter=20000).x
        its += 1
    return {"newton_iters": its, "fnorm": hist, "max_u": float(U.max())}


def case_sha():
    sp = make_space(3, p=2, nel=8, dtype=jnp.float64)
    G = np.asarray(sp.greville_coordinates())
    sp.init_geometry(warp(G), nurbs_weights(G))
    U = np.random.default_rng(8).normal(size=(sp.nnodes, 1))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        write_space(sp, f"{d}/space.dat")
        write_vec(sp, U, f"{d}/vec.dat")
        for name in ("space", "vec"):
            out[f"{name}_sha256"] = hashlib.sha256(Path(f"{d}/{name}.dat").read_bytes()).hexdigest()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("mapped", "colloc", "bratu", "sha"))
    ap.add_argument("--nel", type=int, default=32)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.case == "sha":
        out = case_sha()
    else:
        out = {"mapped": case_mapped, "colloc": case_colloc, "bratu": case_bratu}[args.case](
            args.nel)
    nel = None if args.case == "sha" else args.nel
    print(json.dumps({"case": args.case, "nel": nel, **out,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
