"""Mixed-precision refinement (petiga_tpu_torch.solve.refine) against the
JAX package on the CPU: f32 operator and inner solves, f64 matrix-free
residual, 3-D p=2 at 6³ elements, c = 0.3.

The two f32 operators are round-off apart and their inner CG solves take
different f32 paths, but both refinements converge to the same f64
solution: the refined x agree to 1e-9 relative (both residuals are below
1e-11), while ``b64`` — same contractions in the same order — agrees at
1e-13.

The second half drives the slice as a whole on both sides: coefficient-
form assembly (f32) -> Jacobi-CG -> refinement -> L2 error on the f64
clone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.assembly.convform import assemble_coefficient_planes as jconv
from petiga_tpu.assembly.convform import poisson_coefficients as jcoef
from petiga_tpu.models import poisson as jpoisson
from petiga_tpu.solve import refine as jrefine
from petiga_tpu.sparse.matfree import MatFreeOperator as JMatFree
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.models import poisson as tpoisson
from petiga_tpu_torch.solve import refine as trefine
from petiga_tpu_torch.sparse.matfree import MatFreeOperator

C, K, NEL = 0.3, 1.0, 6
KW = dict(c=C, kappa=K, rtol=1e-11, rtol_inner=1e-6)


def jforcing(x):
    return (C + K * 3 * jnp.pi**2) * jnp.prod(jnp.sin(jnp.pi * x))


def tforcing(x):
    return (C + K * 3 * torch.pi**2) * torch.prod(torch.sin(torch.pi * x), dim=-1)


@pytest.fixture(scope="module")
def jax_side():
    sp = jpoisson.make_space(3, p=2, nel=NEL, dtype=jnp.float32)
    sp64 = jrefine.clone_f64(sp)
    A64 = JMatFree(sp64, c=C, kappa=K)
    b64 = jrefine.assemble_rhs_f64(sp64, A64, jforcing)
    return sp, sp64, A64, b64


@pytest.fixture(scope="module")
def torch_side():
    sp = tpoisson.make_space(3, p=2, nel=NEL, dtype=torch.float32, device="cpu")
    sp64 = trefine.clone_f64(sp)
    A64 = MatFreeOperator(sp64, c=C, kappa=K, zchunk=2)
    b64 = trefine.assemble_rhs_f64(sp64, A64, tforcing)
    return sp, sp64, A64, b64


def _rel(t, j):
    j = np.asarray(j)
    return float(np.abs(t.numpy() - j).max() / np.abs(j).max())


def test_clone_and_rhs(jax_side, torch_side):
    _, _, _, jb = jax_side
    sp, sp64, _, tb = torch_side
    assert sp64.dtype == torch.float64 and sp64.device == sp.device
    assert sp64.bc is sp.bc and sp64.rules == sp.rules
    assert tb.dtype == torch.float64
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-13)


def test_rhs_inhomogeneous_and_tabulated_route():
    """``_fix_rhs`` with non-zero boundary values lifts through the
    matrix-free operator, and the tabulated load (mapped spaces) equals
    the sum-factorized one on the identity map; both = the assembled
    f64 right-hand side, the JAX package's and the port's.

    The JAX ``_fix_rhs`` itself is no reference for this branch: it
    lifts through ``A64.matvec``, which zeroes the fixed columns first,
    so its lift vanishes (shown below); the JAX *assembled* system is
    what both packages' refinement is meant to solve."""
    sp = tpoisson.make_space(2, p=2, nel=5, dtype=torch.float64, device="cpu")
    sp.set_boundary_value(0, 1, 0, 0.75)
    A64 = MatFreeOperator(sp, c=C, kappa=K)

    def f2(x):
        return (C + K * 2 * torch.pi**2) * torch.prod(torch.sin(torch.pi * x), dim=-1)

    b = trefine.assemble_rhs_f64(sp, A64, f2)
    jsp = jpoisson.make_space(2, p=2, nel=5, dtype=jnp.float64)
    jsp.set_boundary_value(0, 1, 0, 0.75)
    _, jb = jasm.assemble_system(jsp, jpoisson.poisson_system, {"c": C, "k": K})
    assert np.asarray(jb).dtype == np.float64
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-12)
    jb_fix = jrefine.assemble_rhs_f64(
        jsp, JMatFree(jsp, c=C, kappa=K),
        lambda x: (C + K * 2 * jnp.pi**2) * jnp.prod(jnp.sin(jnp.pi * x)))
    assert float(np.abs(np.asarray(jb_fix) - np.asarray(jb)).max()) > 1e-3
    _, b_ref = tasm.assemble_system(sp, tpoisson.poisson_system, {"c": C, "k": K})
    np.testing.assert_allclose(b.numpy(), b_ref.numpy(), rtol=0, atol=1e-13)
    tab = tasm.assemble_vector(sp, lambda pt, ctx: f2(pt.x) * pt.shape0, order=0, chunk=7)
    np.testing.assert_allclose(trefine._fix_rhs(sp, A64, tab).numpy(), b.numpy(),
                               rtol=0, atol=1e-13)


def test_refined_solve_matches_jax(jax_side, torch_side):
    jsp, jsp64, jA64, jb64 = jax_side
    tsp, tsp64, tA64, tb64 = torch_side
    ctx = {"c": C, "k": K}
    jop, _ = jasm.assemble_system_planes(jsp, jpoisson.poisson_system_q, ctx,
                                         interpret=True)
    jx, jinfo = jrefine.refined_solve(jsp, jop, jb64, A64=jA64, sp64=jsp64, **KW)
    top, _ = tasm.assemble_system_planes(tsp, tpoisson.poisson_system_q, ctx)
    assert top.DT.dtype == torch.float32
    tx, tinfo = trefine.refined_solve(tsp, top, tb64, A64=tA64, sp64=tsp64, **KW)
    assert tx.dtype == torch.float64
    assert tinfo["relative_residual"] < 1e-11, tinfo
    assert len(tinfo["inner_iters"]) <= 4, tinfo
    assert len(tinfo["residuals"]) == len(tinfo["inner_iters"]) + 2
    assert _rel(tx, jx) < 1e-9, (tinfo, jinfo)
    assert abs(len(tinfo["inner_iters"]) - len(jinfo["inner_iters"])) <= 1
    # the refined solution is the f64 assembled system's
    A, b = tasm.assemble_system(tsp64, tpoisson.poisson_system, ctx)
    r = b - A.matvec(tx)
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)) < 1e-10


def test_slice_as_a_whole(jax_side, torch_side):
    """conv assembly (f32, symmetric storage) -> CG -> refine -> L2 on
    the f64 clone, port = JAX at 1e-9."""
    jsp, jsp64, jA64, jb64 = jax_side
    tsp, tsp64, tA64, tb64 = torch_side
    jop, _ = jconv(jsp, jcoef, {"c": C, "k": K}, symmetric=True, interpret=True)
    jx, jinfo = jrefine.refined_solve(jsp, jop, jb64, A64=jA64, sp64=jsp64, **KW)
    jl2 = float(jasm.compute_error_norm(jsp64, jx, jpoisson.exact_solution, k=0))

    U, info = tpoisson.solve_poisson(tsp, c=C, k=K, rtol=1e-6, symmetric=True)
    assert info["engine"] == "conv" and info["A"].kind == "sym"
    tx, tinfo = trefine.refined_solve(tsp, info["A"], tb64, zchunk=3, **KW)
    assert tinfo["relative_residual"] < 1e-11, tinfo
    assert _rel(tx, jx) < 1e-9
    tl2 = tpoisson.l2_error(tsp64, tx)
    assert abs(tl2 - jl2) <= 1e-9 * jl2, (tl2, jl2)
    # refinement improved on the f32 solve it started from
    assert tl2 <= tpoisson.l2_error(tsp, U)


def test_nonfinite_residual_keeps_best_iterate(torch_side):
    """The guard: once residual evaluations turn non-finite the loop
    stops and the best finite iterate so far is returned."""
    tsp, tsp64, tA64, tb64 = torch_side
    op, _ = tpoisson.assemble_poisson(tsp, c=C, k=K)

    class Flaky:
        calls = 0

        def matvec(self, x):
            Flaky.calls += 1
            y = tA64.matvec(x)
            return y * float("nan") if Flaky.calls >= 3 else y

    x, info = trefine.refined_solve(tsp, op, tb64, A64=Flaky(), sp64=tsp64, **KW)
    assert len(info["inner_iters"]) == 2 and np.isnan(info["residuals"][2:]).all()
    bnorm = float(torch.linalg.vector_norm(tb64))
    assert info["relative_residual"] == info["residuals"][1] / bnorm < 1e-3
    assert bool(torch.isfinite(x).all())
