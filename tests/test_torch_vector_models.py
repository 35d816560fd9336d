"""The nonlinear vector models and the rest of the reference's vector
oracle set in the port against the JAX package, f64 on the CPU:
hyperelasticity (Neo-Hooke, St-Venant–Kirchhoff, Mooney–Rivlin by AD of
its energy), the stabilized Navier–Stokes cavity (Newton–BiCGStab), the
transient RBVMS Taylor–Green vortex (generalized-α), L2 projection and
Galerkin/SUPG advection–diffusion.

Tolerances: Newton and Krylov iteration counts equal; solutions ≤ 1e-10
absolute (the nonlinear solves stop at rtol 1e-10 on O(1) residuals,
their inner solves at 1e-8, and the two packages sum the same products
in another order); energies and errors ≤ 1e-10 relative.  The port's
inner products run on the kernel operator, here its plain version."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.models import advection_diffusion as jad
from petiga_tpu.models import hyperelasticity as jhel
from petiga_tpu.models import navierstokes as jns
from petiga_tpu.models import poisson as jpois
from petiga_tpu.models import projection as jproj
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.core.axis import Axis as TAxis
from petiga_tpu_torch.core.space import Space as TSpace
from petiga_tpu_torch.models import advection_diffusion as tad
from petiga_tpu_torch.models import elasticity as tel
from petiga_tpu_torch.models import hyperelasticity as thel
from petiga_tpu_torch.models import navierstokes as tns
from petiga_tpu_torch.models import projection as tproj
from petiga_tpu_torch.solve import krylov as tkry

F64 = jnp.float64


def _maxdiff(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


MATERIALS = {
    "neo_hookean": lambda m: m.neo_hookean(1.0, 1.0),
    "st_venant": lambda m: m.st_venant(1.0, 1.0),
    "mooney_rivlin": lambda m: m.mooney_rivlin(0.5, 0.1, 1.0),
}


@pytest.mark.parametrize("material", list(MATERIALS))
def test_hyperelastic_materials(material):
    """2-D block clamped at x = 0, stretched by 0.05 at x = 1: Newton
    with the AD tangent (for Mooney–Rivlin, AD of the AD stress)."""
    js = jhel.make_space(2, p=2, nel=4, dtype=F64, stretch=0.05)
    ts = interop.space_from_reference(js, device="cpu")
    jU, jres = jhel.solve(js, material=MATERIALS[material](jhel), rtol=1e-10)
    tU, tres = thel.solve(ts, material=MATERIALS[material](thel), rtol=1e-10)
    assert tres.converged and tres.iters == int(jres.iters)
    assert _maxdiff(tU, jU) <= 1e-10
    Ug = tU.numpy().reshape(*ts.node_shape[::-1], 2)
    np.testing.assert_allclose(Ug[:, -1, 0], 0.05, atol=1e-10)
    np.testing.assert_allclose(Ug[:, 0, :], 0.0, atol=1e-10)


def test_hyperelastic_load_steps():
    """``continuation=3`` ramps the stretch in three load steps (the
    reference re-runs Newton at the full stretch instead) and ends at
    the reference's one-step solution, to Newton's tolerance; the
    space's boundary values are restored."""
    js = jhel.make_space(2, p=2, nel=4, dtype=F64, stretch=0.05)
    ts = interop.space_from_reference(js, device="cpu")
    jU, _ = jhel.solve(js, rtol=1e-10)
    tU, tres = thel.solve(ts, rtol=1e-10, continuation=3)
    assert tres.converged and _maxdiff(tU, jU) <= 1e-10
    assert ts.bc[0][1].value == [(0, 0.05)]


def test_hyperelastic_small_strain_matches_linear():
    """At stretch 1e-4 Neo-Hooke is linear elasticity to 1e-3 relative
    (the reference's own criterion), both solved in the port."""
    eps = 1e-4
    sp = thel.make_space(2, p=2, nel=4, dtype=torch.float64, stretch=eps, device="cpu")
    U, res = thel.solve(sp, rtol=1e-12)
    sp2 = TSpace([TAxis.uniform(p=2, nel=4)] * 2, dof=2, dtype=torch.float64, device="cpu")
    for c in range(2):
        sp2.set_boundary_value(0, 0, c, 0.0)
    sp2.set_boundary_value(0, 1, 0, eps)
    A, b = tasm.assemble_system(sp2, tel.elasticity_system, {"lambda": 1.0, "mu": 1.0})
    Ul = tkry.cg(A.fast_operator(), b, M=tkry.block_jacobi_preconditioner(A), rtol=1e-12).x
    assert res.converged
    assert float((U - Ul).abs().max()) / eps < 1e-3


def test_cavity():
    """The stabilized lid-driven cavity at 6², ν = 0.5: Newton–BiCGStab
    iterations and the zero-mean-pressure solution match the reference;
    the lid and no-slip values hold and the flow recirculates."""
    js = jns.make_cavity_space(nel=6, p=2)
    ts = interop.space_from_reference(js, device="cpu")
    jU, jres = jns.solve_cavity(js, nu=0.5, rtol=1e-8, maxit=25)
    tU, tres = tns.solve_cavity(ts, nu=0.5, rtol=1e-8, maxit=25)
    assert tres.converged and tres.iters == int(jres.iters)
    assert _maxdiff(tU, jU) <= 1e-10
    Ug = tU.numpy().reshape(*ts.node_shape[::-1], 3)
    np.testing.assert_allclose(Ug[-1, 1:-1, 0], 1.0, atol=1e-10)
    np.testing.assert_allclose(Ug[0, :, 0], 0.0, atol=1e-10)
    assert Ug[1:-1, :, 0].min() < -1e-3
    assert abs(float(tU[:, 2].mean())) <= 1e-12


def test_taylor_green():
    """Two generalized-α RBVMS steps on the periodic Taylor–Green vortex
    at 6²: the state and its kinetic energy match the reference; the
    energy decays at about exp(−16π²νt) and the divergence stays small."""
    nu, dt = 0.02, 5e-3
    js = jns.taylor_green_space(nel=6, p=2)
    ts = interop.space_from_reference(js, device="cpu")
    jU0 = jnp.asarray(jns.taylor_green_init(js, nu))
    tU0 = tns.taylor_green_init(ts, nu)
    assert _maxdiff(tU0, jU0) <= 1e-14
    lam = 8 * np.pi**2 * nu
    rate = np.asarray([-lam, -lam, -2 * lam])
    jU, _, jt = jns.solve_transient_vms(js, jU0, nu=nu, dt=dt, nsteps=2, V0=jU0 * rate)
    tU, _, t = tns.solve_transient_vms(ts, tU0, nu=nu, dt=dt, nsteps=2,
                                       V0=tU0 * torch.as_tensor(rate))
    assert t == jt and _maxdiff(tU, jU) <= 1e-10
    E0 = float(tns.kinetic_energy(ts, tU0))
    E1 = float(tns.kinetic_energy(ts, tU))
    assert abs(E1 - float(jns.kinetic_energy(js, jU))) <= 1e-10 * E1
    assert E1 < E0
    np.testing.assert_allclose(E1 / E0, math.exp(-16 * math.pi**2 * nu * t), rtol=0.05)
    assert float(tns.divergence_l2(ts, tU)) < 0.5


def test_l2_projection():
    """Projection at 4² against the reference, and the p=2 rate from 4²
    to 8² in the port."""
    errs = []
    for nel in (4, 8):
        js = jpois.make_space(2, p=2, nel=nel, dtype=F64)
        ts = interop.space_from_reference(js, device="cpu")
        f = lambda x: torch.exp(x[..., 0]) * torch.cos(2 * x[..., 1])  # noqa: E731
        U = tproj.l2_project(ts, f)
        errs.append(tproj.projection_error(ts, U, f))
        if nel == 4:
            jf = lambda x: jnp.asarray([jnp.exp(x[0]) * jnp.cos(2 * x[1])])  # noqa: E731
            jU = jproj.l2_project(js, jf)
            assert _maxdiff(U, jU) <= 1e-10
            assert abs(errs[0] - jproj.projection_error(js, jU, jf)) <= 1e-10 * errs[0]
    assert abs(np.log2(errs[0] / errs[1]) - 3) < 0.2, errs


def test_supg_against_galerkin():
    """1-D advection–diffusion at a cell Péclet number of about 3:
    Galerkin oscillates, SUPG stays monotone.  SUPG equals the
    reference's solution and BiCGStab count.  The Galerkin system is
    ill-conditioned: the two packages' BiCGStab residuals agree to 11
    digits for 5 iterations and then part, so its count is left free
    (61 against 65 here), and its solution, stopped at a relative
    residual of 1e-10, is held to 1e-8 (the two differ by 5e-10)."""
    out = {}
    for supg in (False, True):
        js = jad.make_space(1, p=1, nel=32)
        js.set_boundary_value(0, 0, 0, 0.0).set_boundary_value(0, 1, 0, 1.0)
        ts = interop.space_from_reference(js, device="cpu")
        jU, jinfo = jad.solve(js, [200.0], supg=supg)
        tU, tinfo = tad.solve(ts, [200.0], supg=supg)
        if supg:
            assert tinfo["iters"] == jinfo["iters"]
        assert _maxdiff(tU, jU) <= (1e-10 if supg else 1e-8)
        out[supg] = tU
    assert max(float(out[False].max()) - 1.0, -float(out[False].min())) > 0.05
    assert float(out[True].max()) - 1.0 < 1e-8 and float(out[True].min()) > -1e-8
