#!/usr/bin/env python3
"""The JAX package's adaptive Cahn–Hilliard run, for the ``ch_adapt``
phases of ``chip_smoke.py``.

Runs ``examples/cahnhilliard.py --adaptive``'s settings (2-D periodic C¹
p=2, f64, generalized-α with ρ∞ = 0.5, Newton–BiCGStab to rtol 1e-6, the
basic controller from dt 1e-11 to 5e-9 at rtol = atol = 1e-3) through the
JAX package on the CPU, one mesh per process, and prints one JSON line:
the adaptive run's steps, rejections and final dt, or the controller's
dt-underflow error, and the weighted error estimate of the first step
at each dt the controller tries before it stops or first accepts (the
estimate ``integrate_adaptive`` computes: the α step against the
embedded backward-Euler solution, in the weighted RMS norm).

    JAX_PLATFORMS=cpu python3 scripts/ch_adapt_reference.py --nel 512
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as the example runs

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from petiga_tpu.models import cahnhilliard as ch  # noqa: E402
from petiga_tpu.solve.ts import AlphaStepper, integrate_adaptive  # noqa: E402

CTX = {"theta": 1.5, "alpha": 3000.0, "cbar": 0.63}
DT0, T_END, TOL = 1e-11, 5e-9, 1e-3


def first_step_estimates(st, U0, V0):
    """The error estimate of the first step at each dt the basic
    controller tries, until it accepts or dt falls below 1e-12."""
    out, dt = [], DT0
    while dt >= 1e-12:
        U1, V1, info = st.step(U0, V0, 0.0, dt)
        w = TOL + TOL * jnp.maximum(jnp.abs(U0), jnp.abs(U1))
        err = float(jnp.sqrt(jnp.mean(((U1 - (U0 + dt * V1)) / w) ** 2)))
        out.append({"dt": dt, "err": err, "newton_iters": int(info[0])})
        if err < 1.0:
            break
        dt *= min(max(0.9 * err ** (-1.0 / 3.0), 0.1), 10.0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=512)
    args = ap.parse_args(argv)
    sp = ch.make_space(dim=2, nel=args.nel)
    U0 = ch.initial_condition(sp, cbar=0.63, seed=0)
    st = AlphaStepper(sp, ch.residual, rho_inf=0.5, ctx=CTX,
                      newton_kw=dict(rtol=1e-6, linear_solver="bicgstab"))
    t0 = time.perf_counter()
    V0 = st.initial_velocity(U0, 0.0)
    row = {"nel": args.nel, "first_step": first_step_estimates(st, U0, V0)}
    try:
        _, _, r = integrate_adaptive(st, U0, 0.0, DT0, T_END, V0=V0, rtol=TOL, atol=TOL)
        row["result"] = r._asdict()
    except RuntimeError as e:  # the controller's dt floor
        row["result"] = str(e)
    row["host_s"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
