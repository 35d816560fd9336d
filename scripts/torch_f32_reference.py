#!/usr/bin/env python3
"""Reference f32 L2 errors for the m128 and m256 checks of ``chip_smoke.py``.

In f32 the L2 error of the 3-D Poisson p=2 solve at 128³ and 256³ is set
by how the one interior stencil is rounded, so ``chip_smoke.py`` holds the
port to the JAX package's own f32 system.  This script makes those
numbers: the JAX package assembles its f32 system (planes and load vector,
k = 1, Dirichlet post-fix) on the host CPU; the system is carried onto the
card through ``petiga_tpu_torch.interop`` and solved there by the port's
Jacobi-CG at ``chip_smoke.py``'s tolerances (m128: full storage, rtol
1e-6; m256: symmetric storage, rtol 1e-8); the L2 error is taken by both
packages' functionals (the JAX one on the CPU).  For comparison it also
checks the port's f32 planes against the JAX ones bit for bit and solves
the port's own system (its planes are the same, its load vector is
summed in another order).

Run from the repository root on a machine with one CUDA card and JAX for
the CPU, one mesh per process (at 256³ the JAX assembly and functional
take a few minutes of host time, and two meshes in one process outgrew a
96 GiB host):

    JAX_PLATFORMS=cpu python3 scripts/torch_f32_reference.py --nel 128
    JAX_PLATFORMS=cpu python3 scripts/torch_f32_reference.py --nel 256

Prints one JSON line for the assembled systems and one per solve;
``l2_jax_fn`` of the ``jax_b`` line is the value ``chip_smoke.py`` keeps
as ``L2_REF``.
"""

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as the JAX package's tests run

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from petiga_tpu.assembly.convform import assemble_coefficient_planes as jassemble  # noqa: E402
from petiga_tpu.assembly.convform import poisson_coefficients as jcoef  # noqa: E402
from petiga_tpu.models import poisson as jpoisson  # noqa: E402
from petiga_tpu_torch import interop  # noqa: E402
from petiga_tpu_torch.models import poisson as tpoisson  # noqa: E402

# mesh -> (symmetric storage, CG rtol), as chip_smoke.py solves it
SOLVES = {128: (False, 1e-6), 256: (True, 1e-8)}
# elements per chunk of the JAX functional: unchunked, its tabulation at
# 256³ alone outgrows the host
L2_CHUNK = 2**16


def emit(obj):
    print(json.dumps(obj), flush=True)


def main(nel, device):
    emit({"jax": jax.__version__, "torch": torch.__version__,
          "device": torch.cuda.get_device_name(0) if device == "cuda" else device})
    sym, rtol = SOLVES[nel]
    jsp = jpoisson.make_space(3, p=2, nel=nel, dtype=jnp.float32)
    t0 = time.perf_counter()
    jop, jb = jassemble(jsp, jcoef, {"c": 0.0, "k": 1.0},
                        forcing=jpoisson.poisson_forcing(0.0, 1.0), symmetric=sym)
    b_ref = torch.tensor(np.asarray(jb), device=device)
    ref = interop.operator_from_jax_planes(jop.stencil, np.asarray(jop.DT),
                                           align=jop.align, symmetric=sym, device=device)
    del jop, jb
    t_jax = time.perf_counter() - t0

    tsp = tpoisson.make_space(3, p=2, nel=nel, dtype=torch.float32, device=device)
    op, b = tpoisson.assemble_poisson(tsp, symmetric=sym)
    emit({"nel": nel, "kind": ref.kind, "jax_assembly_s": t_jax,
          "planes_equal": bool(torch.equal(op.DT, ref.DT)),
          "b_rel": float((b - b_ref).abs().max() / b_ref.abs().max())})
    del op

    for name, rhs in (("jax_b", b_ref), ("port_b", b)):
        U, res = tpoisson.solve_system(ref, rhs, rtol=rtol, maxiter=5000)
        row = {"nel": nel, "b": name, "cg_iters": res.iters,
               "cg_residual": float(res.residual), "l2_port_fn": tpoisson.l2_error(tsp, U)}
        if name == "jax_b":
            t0 = time.perf_counter()
            row["l2_jax_fn"] = float(jpoisson.compute_error_norm(
                jsp, jnp.asarray(U.cpu().numpy()), jpoisson.exact_solution, k=0,
                chunk=L2_CHUNK))
            row["jax_l2_s"] = time.perf_counter() - t0
        emit(row)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nel", type=int, required=True, choices=sorted(SOLVES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.nel, args.device)
