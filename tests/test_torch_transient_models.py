"""The scalar and vector transient models in the port against the JAX
package, f64 on the CPU: Richards and two-phase flow (θ-method, the
two-phase injection as a boundary form), the elastic rod
(generalized-α2), pattern formation (implicit and semi-implicit
splittings), phase-field crystal, shallow water and
Navier–Stokes–Korteweg (generalized-α).

Each model's forms step the same seeded state in both packages, with the
model's default Newton settings (the port's add ``operator="fast"``, so
its products run on the kernel operator), and the port's ``run`` is held
to its own steps.  The α models start both packages from the port's
consistent initial velocity (the JAX one would compile a second program;
``initial_velocity`` is held to the reference in
``tests/test_torch_cahnhilliard.py``).

Tolerances: Newton iterations per step equal; each final state (U, and
V or A where the stepper carries them) to 1e-9 of its largest entry
(``TOL``; measured gaps 1e-19 to 4.3e-12).  Two cases are held to 1e-8,
each for its measured gap: semi-implicit pattern formation (V 1.2e-9)
and phase-field crystal (U and V 2.4e-9).  Their Newton stops at rtol
1e-6 after one iteration, so the last correction is a BiCGStab solve
stopped at 1e-8 relative residual, and the two packages' iterates, which
sum the same products in another order, part at that level.  Two-phase
flow is held to 1e-7 (measured 1.1e-19 at this size), because its
residual differentiates the saturation by a forward difference with
eps = 1e-6, which amplifies rounding by about 1e6.  72 s alone on one
core (pytest, one run), most of it the JAX side's compiles (one step
program per model)."""

import numpy as np
import pytest
import torch

from petiga_tpu.models import elasticrod as jrod
from petiga_tpu.models import nsk as jnsk
from petiga_tpu.models import patternformation as jpf
from petiga_tpu.models import phasefieldcrystal as jpfc
from petiga_tpu.models import richards as jric
from petiga_tpu.models import shallowwater as jsw
from petiga_tpu.models import twophase as jtp
from petiga_tpu.solve import ts as jts
from petiga_tpu_torch import interop
from petiga_tpu_torch.models import elasticrod as trod
from petiga_tpu_torch.models import nsk as tnsk
from petiga_tpu_torch.models import patternformation as tpf
from petiga_tpu_torch.models import phasefieldcrystal as tpfc
from petiga_tpu_torch.models import richards as tric
from petiga_tpu_torch.models import shallowwater as tsw
from petiga_tpu_torch.models import twophase as ttp
from petiga_tpu_torch.solve import ts as tts

TOL = 1e-9


def _port(a):
    return interop.state_from_reference(np.asarray(a), device="cpu")


def _space(js):
    return interop.space_from_reference(js, device="cpu")


def _maxrel(t, j):
    j = np.asarray(j).reshape(t.shape)
    return float(np.abs(t.numpy() - j).max()) / float(np.abs(j).max())


def _step_both(jst, tst, state, t0, dt, nsteps):
    """``nsteps`` steps of both packages' steppers from the same state (a
    tuple of node vectors: (U,), (U, V) or (U, V, A)); returns the final
    states and each package's Newton iterations per step."""
    js_, ts_ = tuple(state), tuple(_port(x) for x in state)
    ji, ti = [], []
    for k in range(nsteps):
        t = t0 + k * dt
        *js_, jinfo = jst.step(*js_, t, dt)
        *ts_, tinfo = tst.step(*ts_, t, dt)
        ji.append(int(jinfo[0]))
        ti.append(tinfo[0])
        assert tinfo[2], tinfo
    return js_, ts_, ji, ti


def _held(js_, ts_, ji, ti, tol=TOL):
    assert ti == ji
    for t, j in zip(ts_, js_):
        assert _maxrel(t, j) <= tol


def test_richards():
    """1-D nel 16, backward Euler, 2 steps of 1e-3 from ψ = −2, ponded top."""
    js = jric.make_space(nel=16, dim=1)
    ts = _space(js)
    U0 = np.full((js.nnodes, 1), -2.0)
    kw = dict(rtol=1e-8, linear_solver="bicgstab", maxit=30)
    jst = jts.ThetaStepper(js, jric.ifunction, theta=1.0, ctx={}, newton_kw=kw)
    tst = tts.ThetaStepper(ts, tric.ifunction, theta=1.0, ctx={},
                           newton_kw=dict(kw, operator="fast"))
    out = _step_both(jst, tst, (U0,), 0.0, 1e-3, 2)
    _held(*out)
    tU0, tU = tric.run(ts, dt=1e-3, nsteps=2)
    assert torch.equal(tU0, _port(U0)) and torch.equal(tU, out[1][0])
    u = tU.numpy().ravel()
    assert u[-1] > -1e-6 and u[0] < -1.8  # wetting front: ponded top, dry below


def test_twophase():
    """1-D nel 16 p 1, dof 2, backward Euler, 2 steps of 0.02, hydrogen
    injected through the left face's boundary form."""
    js = jtp.make_space(nel=16)
    ts = _space(js)
    U0 = np.zeros((js.nnodes, 2))
    U0[:, 0] = 1.0
    ctx = {"inflow": 0.1}
    kw = dict(rtol=1e-8, linear_solver="bicgstab", maxit=30)
    jst = jts.ThetaStepper(js, jtp.ifunction, theta=1.0, ctx=ctx,
                           newton_kw=dict(kw, boundary=jtp.injection_boundary))
    tst = tts.ThetaStepper(ts, ttp.ifunction, theta=1.0, ctx=ctx,
                           newton_kw=dict(kw, boundary=ttp.injection_boundary, operator="fast"))
    out = _step_both(jst, tst, (U0,), 0.0, 0.02, 2)
    _held(*out, tol=1e-7)
    tU0, tU = ttp.run(ts, dt=0.02, nsteps=2)
    assert torch.equal(tU0, _port(U0)) and torch.equal(tU, out[1][0])
    assert tU[0, 1] > 1e-4 and abs(float(tU[-1, 1])) < 1e-8


def test_elasticrod():
    """1-D nel 16, the plucked rod, 2 generalized-α2 steps of 0.01."""
    js = jrod.make_space(nel=16)
    ts = _space(js)
    U0 = np.zeros((js.nnodes, 1))
    U0[js.nnodes // 2, 0] = 1.0
    Z = np.zeros_like(U0)
    ctx = {"rho": 1.0, "E": 1.0}
    jst = jts.Alpha2Stepper(js, jrod.i2function, rho_inf=0.5, ctx=ctx,
                            newton_kw=dict(rtol=1e-10))
    tst = tts.Alpha2Stepper(ts, trod.i2function, rho_inf=0.5, ctx=ctx,
                            newton_kw=dict(rtol=1e-10, operator="fast"))
    out = _step_both(jst, tst, (U0, Z, Z), 0.0, 0.01, 2)
    _held(*out)
    tout = trod.run(ts, dt=0.01, nsteps=2)
    assert all(torch.equal(a, b) for a, b in zip(tout, out[1]))


def _alpha_case(js, jfn, tfn, ctx, U0, kw, dt, nsteps, ie=False, V0=None, tol=TOL):
    """Both packages' α steppers from U0 and V0 (by default the port's
    consistent initial velocity), the final states held to ``tol``."""
    ts = _space(js)
    name = "iefunction" if ie else "ifunction"
    jst = jts.AlphaStepper(js, ctx=ctx, newton_kw=kw, **{name: jfn})
    tst = tts.AlphaStepper(ts, ctx=ctx, newton_kw=dict(kw, operator="fast"), **{name: tfn})
    if V0 is None:
        V0 = tst.initial_velocity(_port(U0), 0.0).numpy()
    out = _step_both(jst, tst, (np.asarray(U0), V0), 0.0, dt, nsteps)
    _held(*out, tol=tol)
    return ts, out[1][0]


@pytest.mark.parametrize("implicit", [True, False])
def test_patternformation(implicit):
    """2-D nel 8 periodic, dof 2, one step of 0.005, the reaction at the
    new (implicit) or old (semi-implicit) state."""
    js = jpf.make_space(nel=8)
    U0 = jpf.initial_condition(js, seed=3)
    ctx = {"delta": 0.0045, "D1": 0.5, "D2": 1.0, "alpha": 0.899, "beta": -0.91,
           "gamma": -0.899, "tau1": 0.02, "tau2": 0.2, "implicit": implicit}
    kw = dict(rtol=1e-6, linear_solver="bicgstab", maxit=12)
    # semi-implicit: V 1.2e-9 apart (module docstring)
    ts, tU = _alpha_case(js, jpf.iefunction, tpf.iefunction, ctx, U0, kw, 0.005, 1, ie=True,
                         tol=TOL if implicit else 1e-8)
    tU0 = tpf.initial_condition(ts, seed=3)
    assert torch.equal(tU0, _port(U0))
    assert torch.equal(tpf.run(ts, tU0, dt=0.005, nsteps=1, implicit=implicit), tU)
    assert float((tU - tU0).abs().max()) > 1e-8


def test_phasefieldcrystal():
    """2-D nel 8 periodic on [0, 16π]², dof 2, order 2, one step of 0.05
    from V0 = 0 (the port's ``run``: the consistent-velocity solve has
    no solution for the algebraic μ row, and the reference's gives NaN,
    so its own ``run`` never moves U); φ's mean is conserved."""
    js = jpfc.make_space(nel=8)
    U0 = jpfc.initial_condition(js, seed=5)
    kw = dict(rtol=1e-6, linear_solver="bicgstab", maxit=15)
    # U and V 2.4e-9 apart (module docstring)
    ts, tU = _alpha_case(js, jpfc.ifunction, tpfc.ifunction, {"epsilon": 0.25}, U0, kw,
                         0.05, 1, V0=np.zeros(np.shape(U0)), tol=1e-8)
    tU0 = tpfc.initial_condition(ts, seed=5)
    assert torch.equal(tU0, _port(U0))
    assert torch.equal(tpfc.run(ts, tU0, dt=0.05, nsteps=1), tU)
    np.testing.assert_allclose(float(tU[:, 0].mean()), float(tU0[:, 0].mean()), rtol=1e-7)
    assert float((tU - tU0).abs().max()) > 1e-3  # the state moved


def test_shallowwater():
    """2-D nel 8 periodic, dof 3, two steps of 0.005 from the Gaussian
    hump; the water volume is conserved."""
    js = jsw.make_space(nel=8)
    ts0 = _space(js)
    tU0, _ = tsw.run(ts0, dt=0.005, nsteps=0)
    U0 = tU0.numpy()
    kw = dict(rtol=1e-8, linear_solver="bicgstab")
    ts, tU = _alpha_case(js, jsw.ifunction, tsw.ifunction, {"gravity": 1.0}, U0, kw, 0.005, 2)
    assert torch.equal(tsw.run(ts, dt=0.005, nsteps=2)[1], tU)
    np.testing.assert_allclose(float(tU[:, 0].mean()), float(U0[:, 0].mean()), rtol=1e-6)


def test_nsk():
    """2-D nel 8 periodic, dof 3, order 2 (Hessians), one step of 5e-5 of
    the van der Waals bubble."""
    js = jnsk.make_space(nel=8)
    U0 = jnsk.vdw_bubble_ic(js)
    ctx = {"Ca": 0.05, "Re": 100.0, "theta": 0.85}
    kw = dict(rtol=1e-6, linear_solver="bicgstab", maxit=15)
    ts, tU = _alpha_case(js, jnsk.residual, tnsk.residual, ctx, U0, kw, 5e-5, 1)
    tU0 = tnsk.vdw_bubble_ic(ts)
    assert torch.equal(tU0, _port(U0))
    assert torch.equal(tnsk.run(ts, tU0, dt=5e-5, nsteps=1), tU)
    assert 0.05 < float(tU[:, 0].min()) and float(tU[:, 0].max()) < 0.95
