"""Cahn-Hilliard spinodal decomposition (PetIGA demo/CahnHilliard2D.c; port
of the JAX package's examples/cahnhilliard.py).

    python -m petiga_tpu_torch.examples.cahnhilliard --nel 32 --nsteps 20 --adaptive

C1 periodic B-splines, degenerate mobility, generalized-α stepping with
the free-energy/statistics monitor; ``--adaptive`` switches to the
error-controlled controller (PetIGA runs with ``-ts_adapt_type basic``),
``--conv-jacobian`` conv-assembles the Jacobian each Newton step
(``run_conv``).  Writes the final concentration field to a VTK structured
grid with ``--vtk out.vts``.  Runs in float64 (stiff, fourth order);
every Newton solve runs on the stencil kernel (``operator="fast"`` for the
AD Jacobian); ``--device cpu`` runs on the CPU.
"""

import argparse
import sys

NEWTON_KW = dict(rtol=1e-6, linear_solver="bicgstab", operator="fast")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=32)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--cbar", type=float, default=0.63)
    ap.add_argument("--alpha", type=float, default=3000.0)
    ap.add_argument("--theta", type=float, default=1.5)
    ap.add_argument("--dt", type=float, default=1e-11)
    ap.add_argument("--nsteps", type=int, default=5)
    ap.add_argument("--t-end", type=float, default=None,
                    help="with --adaptive: integrate to this time")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--conv-jacobian", action="store_true",
                    help="conv-assemble the Jacobian each Newton step (run_conv)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vtk", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA device by default, or 'cpu'")
    ns = ap.parse_args(argv)

    from petiga_tpu_torch.models import cahnhilliard as ch

    space = ch.make_space(dim=ns.dim, nel=ns.nel, device=ns.device)
    U0 = ch.initial_condition(space, cbar=ns.cbar, seed=ns.seed)
    ctx = {"theta": ns.theta, "alpha": ns.alpha, "cbar": ns.cbar}

    if ns.adaptive:
        from petiga_tpu_torch.assembly.assemble import compute_scalar
        from petiga_tpu_torch.solve.ts import AlphaStepper, integrate_adaptive

        stepper = AlphaStepper(space, ch.residual, rho_inf=0.5, ctx=ctx,
                               newton_kw=dict(NEWTON_KW))

        def mon(step, t, U):
            s = compute_scalar(space, ch.free_energy_stats, U, ctx, order=1).cpu().numpy()
            print(f"step {step:4d} t={t:.4e} energy={s[0]:.6e}")

        t_end = ns.t_end if ns.t_end is not None else ns.nsteps * ns.dt * 100
        U, _, stats = integrate_adaptive(
            stepper, U0, 0.0, ns.dt, t_end, rtol=1e-3, atol=1e-3, monitor=mon,
        )
        print(f"adaptive: {stats.steps} steps, {stats.rejections} "
              f"rejections, final dt={stats.dt_final:.3e}")
    else:
        def mon(step, t, U, s):
            print(f"step {step:4d} t={t:.4e} energy={s[0]:.6e} "
                  f"mass={s[1]:.6e}")

        kw = dict(theta=ns.theta, alpha=ns.alpha, cbar=ns.cbar, dt=ns.dt,
                  nsteps=ns.nsteps, monitor=mon)
        if ns.conv_jacobian:
            U, _ = ch.run_conv(space, U0, **kw)
        else:
            U, _ = ch.run(space, U0, newton_kw=dict(NEWTON_KW), **kw)

    if ns.vtk:
        from petiga_tpu_torch.post.sample import sample_grid, write_vts

        coords, vals, shape = sample_grid(space, U)
        write_vts(ns.vtk, coords, shape, point_data={"c": vals})
        print(f"wrote {ns.vtk}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
