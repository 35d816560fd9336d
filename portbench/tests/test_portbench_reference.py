"""The plain reference agrees with ``petiga_tpu_torch`` on the CPU in
float64 at tiny meshes, for what each mix's check compares."""

import math

import numpy as np
import pytest
import torch

from portbench.problems.poisson import coefficient_fn, forcing_fn
from portbench.reference import bspline
from portbench.reference.cahnhilliard import CahnHilliard
from portbench.reference.poisson import System

MODES = [(0.7, [(2 * math.pi, 0.3), (math.pi, 1.1), (3 * math.pi, 0.2)]),
         (-0.4, [(5 * math.pi, 0.0), (2 * math.pi, 2.0), (math.pi, 0.5)])]
COEF = (0.5, [(2 * math.pi, 0.4), (6 * math.pi, 1.3), (4 * math.pi, 2.2)])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("coef", [None, COEF], ids=["rhs_stream", "assemble_solve"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "full"])
def test_poisson_planes_load_product_solution(coef, symmetric):
    from petiga_tpu_torch.assembly import assemble, convform
    from petiga_tpu_torch.models import poisson

    nel = 6
    sp = poisson.make_space(3, p=2, nel=nel, dtype=torch.float64, device="cpu")
    if coef is None:
        op, _ = convform.assemble_coefficient_planes(
            sp, convform.poisson_coefficients, {"c": 0.0, "k": 1.0}, symmetric=symmetric)
        b = convform.assemble_load_vector(sp, forcing_fn(MODES))
        op, b = assemble.dirichlet_post_fix_homogeneous(sp, op, b)
    else:
        # conv_min below the interior box's size: the conv path, as at 256³
        op, b = convform.assemble_coefficient_planes(
            sp, coefficient_fn(coef, 3), None, forcing=forcing_fn(MODES),
            symmetric=symmetric, conv_min=8)
    S = System(3, 2, nel, 3, coef=coef)
    N = S.N
    assert [list(o) for o in op.st.slot_offsets()] == [S.slot_offsets(s) for s in range(S.nslots)]
    slots = range(S.diag_slot, S.nslots) if symmetric else range(S.nslots)
    for k, s in enumerate(slots):
        R = S.slot_block(s, 0, N)
        assert float((op.DT[k].reshape(N, N, N) - R).abs().max()) <= 1e-13 * 64
    br = S.load(MODES)
    assert _rel(b.reshape(N, N, N), br) <= 1e-13
    x = torch.randn((N, N, N), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    assert _rel(op.matvec(x.reshape(-1, 1)).reshape(N, N, N), S.apply(x)) <= 1e-13
    U, res = poisson.solve_system(op, b, rtol=1e-12)
    assert S.rel_residual(br, U.reshape(N, N, N)) <= 1e-11
    Ur = S.solve(br)
    assert S.rel_residual(br, Ur) <= 1e-13
    assert float((U.reshape(N, N, N) - Ur).norm() / Ur.norm()) <= 1e-10


def test_band_matrix_against_dense_quadrature():
    """One entry of a 1-D stiffness band by a dense evaluation of the basis."""
    p, nel, q = 2, 5, 3
    band = bspline.band_matrix(p, nel, q, 1, 1)
    x, w, B, nodes = bspline.element_tables(p, nel, q, 1)
    A = np.zeros((nel + p, nel + p))
    for e in range(nel):
        for a in range(p + 1):
            for c in range(p + 1):
                A[nodes[e, a], nodes[e, c]] += np.sum(w[e] * B[1, e, :, a] * B[1, e, :, c])
    for i in range(nel + p):
        for o in range(-p, p + 1):
            j = i + o
            want = A[i, j] if 0 <= j < nel + p else 0.0
            assert abs(band[i, o + p] - want) <= 1e-13


def test_cahnhilliard_residual_and_initial_velocity():
    from petiga_tpu_torch.assembly.assemble import assemble_function
    from petiga_tpu_torch.models import cahnhilliard as ch
    from petiga_tpu_torch.solve.ts import AlphaStepper

    nel, dt = 8, 1e-11
    sp = ch.make_space(2, nel=nel, device="cpu")
    U0 = ch.initial_condition(sp, seed=3)
    ctx = {"theta": 1.5, "alpha": 3000.0, "cbar": 0.63}
    st = AlphaStepper(sp, ch.residual, rho_inf=0.5, ctx=ctx,
                      newton_kw=dict(rtol=1e-6, linear_solver="bicgstab", operator="fast"))
    R = CahnHilliard(nel, theta=1.5, alpha=3000.0, rho_inf=0.5, dt=dt)
    V0 = st.initial_velocity(U0, 0.0)
    V0r = R.initial_velocity(U0.reshape(nel, nel))
    assert float((V0.reshape(nel, nel) - V0r).norm() / V0r.norm()) <= 1e-7
    am, af, g = st.coeffs()
    assert (am, af, g) == (R.am, R.af, R.g)

    def form(pt, Xe, aux_e, c):
        U0e, V0e = aux_e["U0"], aux_e["V0"]
        V1e = (Xe - U0e) / (g * dt) + (1 - 1 / g) * V0e
        return ch.residual(pt, 0.0, V0e + am * (V1e - V0e), 0.0, U0e + af * (Xe - U0e), c)

    X = U0 + 1e-3 * torch.randn(U0.shape, dtype=U0.dtype,
                                generator=torch.Generator().manual_seed(1))
    Rp = assemble_function(sp, form, X, ctx, aux={"U0": U0, "V0": V0})
    Rr = R.step_residual(X.reshape(nel, nel), U0.reshape(nel, nel), V0.reshape(nel, nel))
    assert float((Rp.reshape(nel, nel) - Rr).norm() / Rr.norm()) <= 1e-13
    U1, V1, (iters, _, ok) = st.step(U0, V0, 0.0, dt)
    assert ok
    assert R.newton_reduction(U1.reshape(nel, nel), U0.reshape(nel, nel), V0r) <= 1e-6
    assert torch.allclose(V1.reshape(nel, nel),
                          R.velocity(U1.reshape(nel, nel), U0.reshape(nel, nel),
                                     V0.reshape(nel, nel)), rtol=1e-12, atol=0)
