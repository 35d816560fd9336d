"""The port's Cahn–Hilliard integrations against the JAX package's, f64 on the
CPU, from the same numpy-drawn initial state: ``run`` (AlphaStepper with
the AD Jacobian, consistent initial velocity, free-energy monitor) and
``run_conv`` (conv Jacobian and conv residual, BiCGStab in the packed
kernel layout, mass solve for V0), plus the reference's Newton
regression for the α-scheme mass channel.

Tolerances: U 1e-10 absolute, the stats log 1e-9 relative, Newton
iteration counts equal; ``run_conv`` against ``run`` 2e-9 (the JAX
package's own test), as the two differ by the Jacobian's rounding and
the inner solves' tolerance."""

import numpy as np
import jax.numpy as jnp
import torch

from petiga_tpu.models import cahnhilliard as jch
from petiga_tpu_torch import interop
from petiga_tpu_torch.models import cahnhilliard as tch
from petiga_tpu_torch.solve.ts import AlphaStepper

NEWTON = dict(rtol=1e-10, linear_solver="bicgstab", maxit=2)


def _pair(nel=4):
    js = jch.make_space(2, nel=nel, dtype=jnp.float64)
    ts = interop.space_from_reference(js, device="cpu")
    U0 = jch.initial_condition(js, seed=3)
    return js, ts, U0, tch.initial_condition(ts, seed=3)


def _log_rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return np.max(np.abs(a - b) / np.abs(b))


def test_initial_condition_and_alpha_coefficients():
    js, ts, U0, U0t = _pair()
    assert np.array_equal(U0t.numpy(), np.asarray(U0))
    am, af, g = AlphaStepper(ts, tch.residual, rho_inf=0.5).coeffs()
    assert (am, af, g) == (0.5 * 2.5 / 1.5, 1 / 1.5, 0.5 + 0.5 * 2.5 / 1.5 - 1 / 1.5)


def test_run_and_run_conv_match_jax():
    """One α step of each integration against the JAX package's: ``run``
    (initial velocity by Newton in V, then Newton in X with the AD
    Jacobian, and the statistics monitor) and ``run_conv``; then the
    two against each other."""
    js, ts, U0, U0t = _pair()
    Uj, logj = jch.run(js, U0, dt=1e-11, nsteps=1, newton_kw=NEWTON)
    Ut, logt = tch.run(ts, U0t, dt=1e-11, nsteps=1, newton_kw=NEWTON)
    assert np.max(np.abs(Ut.numpy() - np.asarray(Uj))) <= 1e-10
    assert _log_rel(logt, logj) <= 1e-9
    # the mean concentration is conserved (periodic, no flux)
    assert abs(float(Ut.mean()) - float(U0t.mean())) <= 1e-12
    cj, ct = {}, {}
    Ucj, logcj = jch.run_conv(js, U0, dt=1e-11, nsteps=1, rtol_newton=1e-10, max_newton=2,
                              counters=cj)
    Uct, logct = tch.run_conv(ts, U0t, dt=1e-11, nsteps=1, rtol_newton=1e-10, max_newton=2,
                              counters=ct)
    assert ct["newton_iters"] == cj["newton_iters"]
    assert np.max(np.abs(Uct.numpy() - np.asarray(Ucj))) <= 1e-10
    assert _log_rel(logct, logcj) <= 1e-9
    assert np.max(np.abs(Uct.numpy() - Ut.numpy())) <= 2e-9
    assert _log_rel(np.asarray(logct)[:, 2:], np.asarray(logt)[:, 2:]) <= 1e-7


def test_run_conv_newton_is_newton():
    """Regression: the conv Jacobian's mass channel carries
    dVam/dX = αm/(γ·dt) with no αf factor.  With the extra αf the
    iteration degrades to a fixed-point contraction of |1 − 1/αf| = 0.5
    per iteration; Newton on a mass-dominated step gains at least three
    orders in the first two corrections."""
    _, ts, _, U0t = _pair(nel=6)
    cnt = {}
    tch.run_conv(ts, U0t, dt=1e-9, nsteps=1, rtol_newton=1e-12, max_newton=6, counters=cnt)
    h = cnt["rhist"][0]
    assert h[2] < 1e-3 * h[0], h


def test_run_conv_counts_true_linear_residual():
    """``counters["lin_true_rel"]`` holds each BiCGStab solve's true
    relative residual ‖−R − J·dX‖/‖R‖ in f64, one per Newton correction;
    in f64 it stays at the solve's rtol_inner (1e-8) up to the packed
    right-hand side's halo copies."""
    _, ts, _, U0t = _pair()
    cnt = {}
    tch.run_conv(ts, U0t, dt=1e-9, nsteps=1, rtol_newton=1e-10, max_newton=2, counters=cnt)
    rel = cnt["lin_true_rel"][0]
    assert len(rel) == len(cnt["lin_iters"][0]) == cnt["newton_iters"][0] > 0
    assert all(r <= 3e-8 for r in rel), rel


def test_run_conv_pointwise_residual_route():
    """``conv_residual=False`` assembles each Newton residual pointwise:
    the same step as the conv residual route."""
    _, ts, _, U0t = _pair()
    Ua, _ = tch.run_conv(ts, U0t, dt=1e-11, nsteps=1, rtol_newton=1e-10, max_newton=2)
    Ub, _ = tch.run_conv(ts, U0t, dt=1e-11, nsteps=1, rtol_newton=1e-10, max_newton=2,
                         conv_residual=False)
    assert float((Ua - Ub).abs().max()) <= 1e-12


def test_alpha_stepper_iefunction_form():
    """An IEFunction form (extra ``t0, U0`` arguments) that ignores them
    steps exactly like the IFunction form."""
    from petiga_tpu_torch.models import bratu

    sp = bratu.make_space(2, p=2, nel=4, dtype=torch.float64, device="cpu")
    U0 = torch.zeros((sp.nnodes, 1), dtype=torch.float64)
    kw = dict(ctx={"lambda": 1.0}, newton_kw=dict(rtol=1e-10))
    a = AlphaStepper(sp, bratu.bratu_ifunction, **kw)

    def ie(pt, shift, Ve, t, Ue, t0, U0e, c):
        return bratu.bratu_ifunction(pt, shift, Ve, t, Ue, c)

    b = AlphaStepper(sp, iefunction=ie, **kw)
    Va, Vb = a.initial_velocity(U0, 0.0), b.initial_velocity(U0, 0.0)
    Ua, _, (ia, _, ca) = a.step(U0, Va, 0.0, 0.01)
    Ub, _, (ib, _, cb) = b.step(U0, Vb, 0.0, 0.01)
    assert ca and cb and ia == ib and torch.equal(Ua, Ub) and float(Ua.abs().max()) > 0


def test_run_conv_stol_ends_step_without_residual():
    """``stol`` ends a step once ‖dX‖ ≤ stol·‖X‖, skipping the final
    residual assembly: one residual per step in the history."""
    _, ts, _, U0t = _pair()
    cnt = {}
    tch.run_conv(ts, U0t, dt=1e-11, nsteps=2, rtol_newton=1e-10, max_newton=4, stol=1e-3,
                 counters=cnt)
    assert cnt["newton_iters"] == [1, 1]
    assert [len(h) for h in cnt["rhist"]] == [1, 1]
