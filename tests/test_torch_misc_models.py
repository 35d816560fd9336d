"""The manifold, boundary-form and adaptive models in the port against the
JAX package, f64 on the CPU: the Laplace–Beltrami operator on a flat
plate embedded in R³ (untilted and tilted), the clamped Kirchhoff plate
(p = 3), Nitsche's weak Dirichlet and the boundary-integral Neumann
condition (both assembled with boundary forms and solved by Jacobi-CG on
the kernel operator), the greedy adaptive L2 projection, and the new
models' default device.

Tolerances: assembled planes and load vectors to 1e-12 of their largest
entry (the same quadrature sums, accumulated in another order); CG
solutions to 1e-10 of their largest entry (CG stops at rtol 1e-12) with
equal iteration counts; the untilted and tilted Laplace–Beltrami
solutions to 1e-10 (the reference test's criterion); the adaptive
projection's error history to 1e-10 relative and the same final breaks
(its insertion sequence), in 1-D with two insertions — every trial space
is a new JAX program, about 2 s of compile each.  46 s alone on one core
(pytest, one run), most of it the JAX side's compiles."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly.assemble import assemble_system as jassemble_system
from petiga_tpu.models import adaptive as jada
from petiga_tpu.models import boundary as jbnd
from petiga_tpu.models import projection as jproj
from petiga_tpu.models import shell as jshell
from petiga_tpu.solve.krylov import cg as jcg, jacobi_preconditioner as jjacobi
from petiga_tpu_torch.assembly.assemble import assemble_system as tassemble_system
from petiga_tpu_torch.models import adaptive as tada
from petiga_tpu_torch.models import boundary as tbnd
from petiga_tpu_torch.models import elasticrod as trod
from petiga_tpu_torch.models import nsk as tnsk
from petiga_tpu_torch.models import patternformation as tpf
from petiga_tpu_torch.models import phasefieldcrystal as tpfc
from petiga_tpu_torch.models import richards as tric
from petiga_tpu_torch.models import shallowwater as tsw
from petiga_tpu_torch.models import shell as tshell
from petiga_tpu_torch.models import twophase as ttp
from petiga_tpu_torch.solve.krylov import cg as tcg, jacobi_preconditioner as tjacobi


def _rel(t, j):
    j = np.asarray(j).reshape(t.shape)
    return float(np.abs(t.numpy() - j).max()) / float(np.abs(j).max())


def _same_system(tA, tb, jA, jb):
    assert _rel(tA.data, jA.data) <= 1e-12
    assert _rel(tb, jb) <= 1e-12


def _solve_both(tA, tb, jA, jb, maxiter=10000):
    """Jacobi-CG to rtol 1e-12: the port on the kernel operator, the
    reference on its slot loop (as its tests solve)."""
    tr = tcg(tA.fast_operator(), tb, M=tjacobi(tA), rtol=1e-12, maxiter=maxiter)
    jr = jcg(jA, jb, M=jjacobi(jA), rtol=1e-12, maxiter=maxiter)
    assert tr.iters == int(jr.iters)
    assert _rel(tr.x, jr.x) <= 1e-10
    return tr.x


def _unit_forcing(x):
    return 1.0


def test_laplace_beltrami_tilted_plane():
    """nel 8, p 2, all edges fixed, unit source: the surface Laplacian on
    the plate rotated by 0.7 rad equals the untilted one."""
    sols = []
    for tilt in (None, 0.7):
        js = jshell.make_plate_space(nel=8, p=2, tilt=tilt)
        ts = tshell.make_plate_space(nel=8, p=2, tilt=tilt, device="cpu")
        for sp in (js, ts):
            for d in range(2):
                for s in range(2):
                    sp.set_boundary_value(d, s, 0, 0.0)
        np.testing.assert_array_equal(ts.geometry, js.geometry)
        ctx = {"forcing": _unit_forcing}
        jA, jb = jassemble_system(js, jshell.laplace_beltrami_system, ctx)
        tA, tb = tassemble_system(ts, tshell.laplace_beltrami_system, ctx)
        _same_system(tA, tb, jA, jb)
        sols.append(_solve_both(tA, tb, jA, jb))
    assert float((sols[0] - sols[1]).abs().max()) <= 1e-10
    assert float(sols[0].max()) > 0.05


def test_kirchhoff_plate():
    """nel 8, p 3, the two outer control-point rings clamped, unit load,
    D = 1; the deflection is near the clamped-plate value 0.00126."""
    js = jshell.clamp_plate(jshell.make_plate_space(nel=8, p=3))
    ts = tshell.make_plate_space(nel=8, p=3, device="cpu")
    ts.tensor("dirichlet")  # a fix table built before the clamp ...
    tshell.clamp_plate(ts)  # ... is dropped by it
    assert int(ts.tensor("dirichlet")[0].sum()) == int(js.dirichlet_mask()[0].sum())
    ctx = {"D": 1.0, "load": 1.0}
    jA, jb = jassemble_system(js, jshell.kl_shell_system, ctx)
    tA, tb = tassemble_system(ts, tshell.kl_shell_system, ctx)
    _same_system(tA, tb, jA, jb)
    w = _solve_both(tA, tb, jA, jb, maxiter=20000)
    assert abs(float(w.max()) - 0.00126) <= 0.1 * 0.00126


def exact(x):
    """u = Π sin(πx_i + 0.3) on one point (dim,) or a batch (..., dim),
    in either package's arrays."""
    m = torch if isinstance(x, torch.Tensor) else jnp
    return m.prod(m.sin(np.pi * x + 0.3), -1)[..., None]


def forcing(x):
    m = torch if isinstance(x, torch.Tensor) else jnp
    return 2 * np.pi**2 * m.prod(m.sin(np.pi * x + 0.3), -1)


def flux(x, n):
    m = torch if isinstance(x, torch.Tensor) else jnp
    gx = np.pi * m.cos(np.pi * x[0] + 0.3) * m.sin(np.pi * x[1] + 0.3)
    gy = m.sin(np.pi * x[0] + 0.3) * np.pi * m.cos(np.pi * x[1] + 0.3)
    return gx * n[0] + gy * n[1]


def _record(monkeypatch, module):
    """Record the systems ``module.assemble_system`` returns."""
    seen = []
    orig = module.assemble_system

    def wrapped(*a, **k):
        out = orig(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "assemble_system", wrapped)
    return seen


def _held_solution(tU, tinfo, jU, jinfo):
    assert tinfo["iters"] == jinfo["iters"]
    assert _rel(tU, jU) <= 1e-10


def test_nitsche(monkeypatch):
    """nel 8, p 2, Dirichlet u = exact imposed weakly on all faces."""
    js = jbnd.make_open_space(2, p=2, nel=8)
    ts = tbnd.make_open_space(2, p=2, nel=8, device="cpu")
    jsys, tsys = _record(monkeypatch, jbnd), _record(monkeypatch, tbnd)
    jU, jinfo = jbnd.nitsche_poisson(js, exact, forcing)
    tU, tinfo = tbnd.nitsche_poisson(ts, exact, forcing)
    _same_system(*tsys[0], *jsys[0])
    _held_solution(tU, tinfo, jU, jinfo)


def test_boundary_integral_neumann(monkeypatch):
    """nel 8, p 2: the natural flux on the x faces by a surface
    integral, strong values on the y faces from the projected exact
    solution (a fix table)."""
    js = jbnd.make_open_space(2, p=2, nel=8)
    ts = tbnd.make_open_space(2, p=2, nel=8, device="cpu")
    proj = np.asarray(jproj.l2_project(js, exact))
    for sp in (js, ts):
        sp.bc_visit = [[True, True], [False, False]]
        sp.set_fix_table(proj)
        sp.set_boundary_value(1, 0, 0, 0.0)
        sp.set_boundary_value(1, 1, 0, 0.0)
    jsys, tsys = _record(monkeypatch, jbnd), _record(monkeypatch, tbnd)
    jU, jinfo = jbnd.boundary_integral_poisson(js, forcing, flux, fixed_faces=[])
    tU, tinfo = tbnd.boundary_integral_poisson(ts, forcing, flux, fixed_faces=[])
    _same_system(*tsys[0], *jsys[0])
    _held_solution(tU, tinfo, jU, jinfo)


def gaussian(x):
    """The reference's off-center Gaussian (AdaptiveL2Projection.c:13-18),
    along x."""
    m = torch if isinstance(x, torch.Tensor) else jnp
    return m.exp(-((x[..., 0:1] - 0.85) ** 2) / 0.03125)


def test_adaptive_l2_projection():
    """1-D, p 2, from 3 spans, two greedy midpoint insertions."""
    jsp, jU, jh = jada.adaptive_l2_projection(gaussian, dim=1, p=2, n0=3, iters=2)
    tsp, tU, th = tada.adaptive_l2_projection(gaussian, dim=1, p=2, n0=3, iters=2,
                                              device="cpu")
    np.testing.assert_array_equal(tsp.axes[0].U, np.asarray(jsp.axes[0].U))
    np.testing.assert_allclose(th, jh, rtol=1e-10)
    assert all(th[i + 1] < th[i] for i in range(len(th) - 1))
    assert _rel(tU, jU) <= 1e-10


@pytest.mark.parametrize("make", [
    lambda d: tric.make_space(nel=2, device=d), lambda d: ttp.make_space(nel=2, device=d),
    lambda d: trod.make_space(nel=2, device=d), lambda d: tpf.make_space(nel=2, device=d),
    lambda d: tpfc.make_space(nel=2, device=d), lambda d: tsw.make_space(nel=2, device=d),
    lambda d: tnsk.make_space(nel=2, device=d),
    lambda d: tshell.make_plate_space(nel=2, device=d),
    lambda d: tbnd.make_open_space(nel=2, device=d),
    lambda d: tada.adaptive_l2_projection(gaussian, dim=1, n0=2, iters=0, device=d)[0],
], ids=["richards", "twophase", "elasticrod", "patternformation", "phasefieldcrystal",
        "shallowwater", "nsk", "shell", "boundary", "adaptive"])
def test_entry_points_default_to_the_card(make):
    """Every new model's space lands on the CUDA device unless the caller
    names another, and raises where there is none."""
    assert make("cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
