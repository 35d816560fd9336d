"""The port's time steppers against the JAX package, f64 on the CPU: the
θ-method, generalized-α2 and explicit (Euler, SSP-RK3) steppers on the
reference's 1-D heat and wave problems, error-controlled generalized-α
on the host and with the controller on the device, ``integrate``'s
dispatch, and the adaptive Cahn–Hilliard path
(``examples/cahnhilliard.py --adaptive``) at 2-D nel 8.

Tolerances: U to 1e-10 of its largest entry (the Newton solves stop at
rtol 1e-12 on O(1) residuals, their inner solves at 1e-8, and the two
packages sum the same products in another order; the explicit steppers'
mass solves stop at 1e-10); Newton iterations per step, adaptive steps,
rejections equal; ``dt_final`` to 1e-9 relative (the controller's
arithmetic is the reference's, but its error estimate is the difference
of two nearly equal states, which amplifies their round-off, and dt
carries it from step to step); the adaptive Cahn–Hilliard U to 1e-9
(α = 3000 amplifies the inner solves' round-off into the state); host and device adaptive
variants of the port to 1e-10 with equal counts (the reference's own
criterion, tests/test_ts.py:164-186).  56 s alone on one core (pytest,
one run), most of it the JAX side's compiles."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly.assemble import assemble_system as jassemble_system
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import cahnhilliard as jch
from petiga_tpu.solve import ts as jts
from petiga_tpu.solve.krylov import cg as jcg, jacobi_preconditioner as jjacobi
from petiga_tpu_torch import interop
from petiga_tpu_torch.models import cahnhilliard as tch
from petiga_tpu_torch.solve import ts as tts

F64 = jnp.float64
T_ADAPT = 0.05


def heat_ifunction(pt, shift, Ve, t, Ue, ctx):
    """u_t = u_xx, written once for both packages."""
    return pt.value(Ve)[0] * pt.shape0 + pt.shape1 @ pt.grad(Ue)[0]


def wave_i2function(pt, sA, Ae, sV, Ve, t, Ue, ctx):
    """u_tt = u_xx."""
    return pt.value(Ae)[0] * pt.shape0 + pt.shape1 @ pt.grad(Ue)[0]


def heat_rhs(pt, t, Ue, ctx):
    return -(pt.shape1 @ pt.grad(Ue)[0])


def _spaces(nel, p):
    js = JSpace([JAxis.uniform(p=p, nel=nel)], dtype=F64)
    js.set_boundary_value(0, 0, 0, 0.0)
    js.set_boundary_value(0, 1, 0, 0.0)
    return js, interop.space_from_reference(js, device="cpu")


def _project(js, f):
    """L2 projection of f onto the reference space (its test's helper)."""
    def proj(pt, ctx):
        return jnp.outer(pt.shape0, pt.shape0), f(pt.x) * pt.shape0

    A, b = jassemble_system(js, proj, apply_fix=False)
    return jcg(A, b, M=jjacobi(A), rtol=1e-13).x


def _sin(x):
    return jnp.sin(jnp.pi * x[0])


def _port(a):
    return interop.state_from_reference(np.asarray(a), device="cpu")


def _close(t, j, tol):
    j = np.asarray(j).reshape(t.shape)
    return float(np.abs(t.numpy() - j).max()) <= tol * float(np.abs(j).max())


@pytest.fixture(scope="module")
def heat16():
    """nel 16, p 2 heat space and the projected sin(πx)."""
    js, ts = _spaces(16, 2)
    U0 = _project(js, _sin)
    return js, ts, U0


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_theta_stepper(heat16, theta):
    """Four θ-steps (backward Euler, midpoint) of the heat problem."""
    js, ts, U0 = heat16
    jst = jts.ThetaStepper(js, heat_ifunction, theta=theta, newton_kw=dict(rtol=1e-12))
    tst = tts.ThetaStepper(ts, heat_ifunction, theta=theta, newton_kw=dict(rtol=1e-12))
    Uj, Ut, dt = U0, _port(U0), 0.02
    for k in range(4):
        Uj, ij = jst.step(Uj, k * dt, dt)
        Ut, it = tst.step(Ut, k * dt, dt)
        assert it[0] == int(ij[0]) and it[2]
    assert _close(Ut, Uj, 1e-10)


def test_alpha2_stepper(heat16):
    """Eight generalized-α2 steps of the wave problem (ρ∞ = 0.9), V and
    A carried through ``integrate``."""
    js, ts, U0 = heat16
    A0 = _project(js, lambda x: -jnp.pi**2 * jnp.sin(jnp.pi * x[0]))
    V0 = jnp.zeros_like(U0)
    jst = jts.Alpha2Stepper(js, wave_i2function, rho_inf=0.9, newton_kw=dict(rtol=1e-12))
    tst = tts.Alpha2Stepper(ts, wave_i2function, rho_inf=0.9, newton_kw=dict(rtol=1e-12))
    assert tst.coeffs() == jst.coeffs()
    jout = jts.integrate(jst, U0, 0.0, 0.5 / 32, 8, V0=V0, A0=A0)
    tout = tts.integrate(tst, _port(U0), 0.0, 0.5 / 32, 8, V0=_port(V0), A0=_port(A0))
    for t, j in zip(tout, jout):
        assert _close(t, j, 1e-10)


@pytest.mark.parametrize("scheme", ["euler", "rk3"])
def test_explicit_stepper(heat16, scheme):
    """Ten explicit steps at the reference test's dt (2e-5): every stage
    a consistent-mass Jacobi-CG solve on the kernel operator."""
    js, ts, U0 = heat16
    jU = jts.integrate(jts.ExplicitStepper(js, heat_rhs, scheme=scheme), U0, 0.0, 2e-5, 10)
    tU = tts.integrate(tts.ExplicitStepper(ts, heat_rhs, scheme=scheme), _port(U0), 0.0,
                       2e-5, 10)
    assert _close(tU, jU, 1e-10)
    assert not _close(tU, U0, 1e-6)  # the state moved


@pytest.fixture(scope="module")
def heat_alpha(heat16):
    """One generalized-α stepper (ρ∞ = 0.5) of each package for the
    adaptive cases (the JAX one compiles once)."""
    js, ts, _ = heat16
    return (jts.AlphaStepper(js, heat_ifunction, rho_inf=0.5, newton_kw=dict(rtol=1e-12)),
            tts.AlphaStepper(ts, heat_ifunction, rho_inf=0.5, newton_kw=dict(rtol=1e-12)))


@pytest.mark.parametrize("dt0", [1e-4, 0.2])
def test_adaptive_host_and_device(heat16, heat_alpha, dt0):
    """The basic controller from a too-small step (it grows the step)
    and from an oversized one (it rejects, then recovers): the port's
    host and device variants take the reference's steps, rejections and
    final dt and reach t_end."""
    U0 = heat16[2]
    jst, tst = heat_alpha
    kw = dict(rtol=1e-4, atol=1e-4)
    jU, _, jr = jts.integrate_adaptive(jst, U0, 0.0, dt0, T_ADAPT, **kw)
    seen = []
    hU, _, hr = tts.integrate_adaptive(tst, _port(U0), 0.0, dt0, T_ADAPT,
                                       monitor=lambda k, t, U: seen.append(k), **kw)
    dU, _, dr = tts.integrate_adaptive_device(tst, _port(U0), 0.0, dt0, T_ADAPT, **kw)
    for r in (hr, dr):
        assert (r.steps, r.rejections) == (jr.steps, jr.rejections)
        assert abs(r.t - T_ADAPT) < 1e-12
        assert abs(r.dt_final - jr.dt_final) <= 1e-9 * jr.dt_final
    assert seen == list(range(1, jr.steps + 1))
    assert _close(hU, jU, 1e-10)
    assert float((dU - hU).abs().max()) <= 1e-10 * float(hU.abs().max())
    if dt0 > T_ADAPT:
        assert jr.rejections >= 1
    else:
        assert jr.dt_final > 5e-4


def test_adaptive_stops_at_dt_min(heat16, heat_alpha):
    """At an unreachable tolerance every step is rejected: from 1e-11 the
    0.1 clip lands exactly on dt_min = 1e-12, where the host variant goes
    on, and the next rejection falls below it, where the host variant
    raises and the device variant's loop ends, with the same rejections
    and U unchanged."""
    U0 = _port(heat16[2])
    st = heat_alpha[1]
    kw = dict(rtol=1e-20, atol=1e-20)
    with pytest.raises(RuntimeError, match="dt underflow"):
        tts.integrate_adaptive(st, U0, 0.0, 1e-11, T_ADAPT, **kw)
    U, _, r = tts.integrate_adaptive_device(st, U0, 0.0, 1e-11, T_ADAPT, **kw)
    assert (r.t, r.steps, r.rejections) == (0.0, 0, 2) and r.dt_final < 1e-12
    assert torch.equal(U, U0)


def test_adaptive_attempt_monitor_and_newton_counters(heat16, heat_alpha):
    """``attempt_monitor`` sees every attempt of the oversized-step run
    (accepted exactly when its estimate is below 1, each next dt the
    controller's proposal, the first estimate the reference's formula on
    the reference's first step to 1e-9 relative: a difference of two
    nearly equal states); Newton's ``counters`` record one solve per
    attempt; neither hook changes the run."""
    U0 = heat16[2]
    jst, tst = heat_alpha
    kw = dict(rtol=1e-4, atol=1e-4)
    base = tts.integrate_adaptive(tst, _port(U0), 0.0, 0.2, T_ADAPT, **kw)
    cnt, seen = {}, []
    st = tts.AlphaStepper(tst.space, heat_ifunction, rho_inf=0.5,
                          newton_kw=dict(rtol=1e-12, counters=cnt))
    U, _, r = tts.integrate_adaptive(
        st, _port(U0), 0.0, 0.2, T_ADAPT,
        attempt_monitor=lambda t, dt, err, ok: seen.append((t, dt, err, ok)), **kw)
    assert torch.equal(U, base[0]) and r == base[2]
    assert len(seen) == r.steps + r.rejections and sum(a[3] for a in seen) == r.steps
    for (t, dt, err, ok), nxt in zip(seen, seen[1:] + [None]):
        assert ok == (err < 1.0)
        prop = dt * min(max(0.9 * err ** (-1.0 / 3.0), 0.1), 10.0)
        if nxt is None:
            assert prop == r.dt_final
        else:
            assert nxt[0] == (t + dt if ok else t)
            assert nxt[1] == min(prop, T_ADAPT - nxt[0])
    dt = seen[0][1]  # 0.2 clipped to t_end
    V0 = jst.initial_velocity(jnp.asarray(U0), 0.0)
    jU1, jV1, _ = jst.step(jnp.asarray(U0), V0, 0.0, dt)
    free = ~heat16[1].dirichlet_mask()[0]
    w = 1e-4 + 1e-4 * np.maximum(np.abs(U0), np.abs(np.asarray(jU1)))
    d = ((np.asarray(jU1) - (U0 + dt * np.asarray(jV1))) / w)[free]
    ref = float(np.sqrt(np.mean(d ** 2)))
    assert abs(seen[0][2] - ref) <= 1e-9 * ref
    # V0's solve and one per attempt, each converged
    assert len(cnt["rhist"]) == 1 + len(seen)
    for h, li, rs, js_, ss in zip(*(cnt[k] for k in ("rhist", "lin_iters", "residual_s",
                                                    "jacobian_s", "solve_s"))):
        assert len(h) == len(rs) == len(li) + 1 and len(js_) == len(ss) == len(li)
        assert h[-1] <= 1e-12 * h[0] and min(rs + js_ + ss) >= 0.0


def test_adaptive_needs_alpha_stepper(heat16):
    _, ts, U0 = heat16
    st = tts.ThetaStepper(ts, heat_ifunction)
    for fn in (tts.integrate_adaptive, tts.integrate_adaptive_device):
        with pytest.raises(TypeError):
            fn(st, _port(U0), 0.0, 1e-3, 0.01)


def test_integrate_dispatch(heat16):
    """``integrate`` returns ``U`` (θ, explicit), ``(U, V)`` (α, V0 by
    the consistent initial velocity) or ``(U, V, A)`` (α2), takes the
    reference's positional ``ctx``, and calls the monitor after each
    step."""
    _, ts, U0 = heat16
    U = _port(U0)
    calls = []
    out = tts.integrate(tts.ThetaStepper(ts, heat_ifunction, newton_kw=dict(rtol=1e-10)),
                        U, 0.0, 0.01, 2, {"unused": 1},
                        monitor=lambda k, t, X: calls.append((k, t)))
    assert isinstance(out, torch.Tensor) and out.shape == (ts.nnodes, 1)
    assert calls == [(1, 0.01), (2, 0.02)]
    al = tts.AlphaStepper(ts, heat_ifunction, newton_kw=dict(rtol=1e-10))
    Ua, Va = tts.integrate(al, U, 0.0, 0.01, 1)
    Ub, Vb = tts.integrate(al, U, 0.0, 0.01, 1, V0=al.initial_velocity(U, 0.0))
    assert torch.equal(Ua, Ub) and torch.equal(Va, Vb)
    out = tts.integrate(tts.Alpha2Stepper(ts, wave_i2function, newton_kw=dict(rtol=1e-10)),
                        U, 0.0, 0.01, 1, V0=torch.zeros_like(U), A0=torch.zeros_like(U))
    assert len(out) == 3 and all(x.shape == (ts.nnodes, 1) for x in out)
    out = tts.integrate(tts.ExplicitStepper(ts, heat_rhs, scheme="euler"), U, 0.0, 1e-5, 1)
    assert isinstance(out, torch.Tensor)


def test_state_from_reference_carries_tuples(heat16):
    js, _, U0 = heat16
    V0 = 2.0 * U0
    U, V, A = interop.state_from_reference((U0, V0, None), device="cpu")
    assert A is None and torch.equal(V, 2.0 * U) and U.dtype == torch.float64


def test_adaptive_cahnhilliard_2d():
    """``examples/cahnhilliard.py --adaptive`` at 2-D nel 8: generalized-α
    (ρ∞ = 0.5) with Newton–BiCGStab to rtol 1e-6, the basic controller
    from dt 1e-11 to t_end 5e-9 at rtol = atol = 1e-3.  The port runs
    Newton on the kernel operator (the model default)."""
    ctx = {"theta": 1.5, "alpha": 3000.0, "cbar": 0.63}
    js = jch.make_space(dim=2, nel=8)
    ts = interop.space_from_reference(js, device="cpu")
    U0 = jch.initial_condition(js, cbar=0.63, seed=0)
    tU0 = tch.initial_condition(ts, cbar=0.63, seed=0)
    assert torch.equal(tU0, _port(U0))
    kw = dict(rtol=1e-3, atol=1e-3)
    jst = jts.AlphaStepper(js, jch.residual, rho_inf=0.5, ctx=ctx,
                           newton_kw=dict(rtol=1e-6, linear_solver="bicgstab"))
    tst = tts.AlphaStepper(ts, tch.residual, rho_inf=0.5, ctx=ctx,
                           newton_kw=dict(rtol=1e-6, linear_solver="bicgstab",
                                          operator="fast"))
    jU, _, jr = jts.integrate_adaptive(jst, U0, 0.0, 1e-11, 5e-9, **kw)
    tU, _, tr = tts.integrate_adaptive(tst, tU0, 0.0, 1e-11, 5e-9, **kw)
    assert (tr.steps, tr.rejections) == (jr.steps, jr.rejections)
    assert abs(tr.t - 5e-9) <= 1e-10 * 5e-9
    assert _close(tU, jU, 1e-9)
