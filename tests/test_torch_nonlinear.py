"""The port's nonlinear path against the JAX package, f64 on the CPU, on
the same seeded inputs: the rest of the Krylov solvers (BiCGStab, GMRES,
block-Jacobi), ``assemble_function``/``assemble_jacobian`` (AD and
hand-written, with ``aux`` closures and boundary forms),
``JacobianFreeOperator``, ``newton`` with every operator and linear
solver, and the Bratu model by both routes.

Tolerances: residuals and Jacobians 1e-12 relative (the same element sums
in another order); solves' U 1e-10 absolute; Krylov and Newton iteration
counts equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.models import bratu as jbratu
from petiga_tpu.solve import krylov as jkrylov
from petiga_tpu.solve import newton as jnewton
from petiga_tpu.sparse.stencil import Stencil as JStencil
from petiga_tpu.sparse.stencil import StencilMatrix as JStencilMatrix
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.models import bratu as tbratu
from petiga_tpu_torch.solve import krylov as tkrylov
from petiga_tpu_torch.solve import newton as tnewton
from petiga_tpu_torch.sparse.matfree import JacobianFreeOperator
from petiga_tpu_torch.sparse.stencil import StencilMatrix

F64 = jnp.float64


def _rel(t, j):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    return np.max(np.abs(t - j)) / np.max(np.abs(j))


def _maxdiff(t, j):
    return np.max(np.abs(t.detach().numpy() - np.asarray(j).reshape(t.shape)))


def _bratu_pair(nel=5):
    js = jbratu.make_space(2, p=2, nel=nel, dtype=F64)
    return js, interop.space_from_reference(js, device="cpu")


def _iterate(js, seed=3, scale=0.1):
    return np.random.default_rng(seed).normal(scale=scale, size=(js.nnodes, 1))


# ------------------------------------------------------------------ Krylov


def _nonsymmetric(dof, seed):
    """A seeded, diagonally dominant, nonsymmetric stencil operator on
    both sides."""
    st = JStencil(node_shape=(6, 5), widths=(1, 1), periodic=(False, False), dof=dof)
    data = interop.random_stencil_data(st, seed)
    rowsum = np.abs(data).sum(axis=(1, 3))
    for a in range(dof):
        data[:, st.diag_slot, a, a] += rowsum[:, a]
    tst = interop.as_stencil(st)
    return (JStencilMatrix(st, jnp.asarray(data)), StencilMatrix(tst, torch.as_tensor(data)),
            np.random.default_rng(seed + 1).normal(size=(st.nnodes, dof)))


@pytest.mark.parametrize("solver,dof,pc", [
    ("bicgstab", 1, "jacobi"), ("bicgstab", 2, "block"), ("gmres", 1, None),
])
def test_krylov_matches_jax(solver, dof, pc):
    JA, TA, b = _nonsymmetric(dof, seed=7 + dof)
    jpc = {"jacobi": jkrylov.jacobi_preconditioner,
           "block": jkrylov.block_jacobi_preconditioner}.get(pc)
    tpc = {"jacobi": tkrylov.jacobi_preconditioner,
           "block": tkrylov.block_jacobi_preconditioner}.get(pc)
    kw = dict(rtol=1e-10, restart=5) if solver == "gmres" else dict(rtol=1e-10)
    jr = getattr(jkrylov, solver)(JA, jnp.asarray(b), M=jpc(JA) if jpc else None, **kw)
    tr = getattr(tkrylov, solver)(TA, torch.as_tensor(b), M=tpc(TA) if tpc else None, **kw)
    assert tr.iters == int(jr.iters) and tr.iters > 2
    assert _rel(tr.x, jr.x) <= 1e-10
    assert float(tr.residual) <= 1e-10 * np.linalg.norm(b)


# ------------------------------------------------------ nonlinear assembly


def _ifunction_args(js):
    """A transient Bratu stage form with ``aux`` closures on both sides."""
    rng = np.random.default_rng(11)
    aux = {"U0": rng.normal(scale=0.1, size=(js.nnodes, 1)),
           "V0": rng.normal(size=(js.nnodes, 1))}

    def jform(pt, Xe, aux_e, c):
        return jbratu.bratu_ifunction(pt, 3.0, Xe - aux_e["U0"] + aux_e["V0"], 0.0, Xe, c)

    def tform(pt, Xe, aux_e, c):
        return tbratu.bratu_ifunction(pt, 3.0, Xe - aux_e["U0"] + aux_e["V0"], 0.0, Xe, c)

    return aux, jform, tform


def test_function_and_jacobian_match_jax():
    """A transient stage form with ``aux`` closures and a boundary form
    on one face: residual, AD Jacobian, its kernel operator and the
    Jacobian-free action."""
    js, ts = _bratu_pair()
    ctx = {"lambda": 3.0}
    U = _iterate(js)
    aux, jf, tf = _ifunction_args(js)
    for sp in (js, ts):
        sp.set_boundary_form(0, 1)

    def jbnd(pt, Ue, aux_e, c):
        return 0.7 * pt.value(Ue)[0] ** 2 * pt.shape0 + pt.value(aux_e["V0"])[0] * pt.shape0

    def tbnd(pt, Ue, aux_e, c):
        return 0.7 * pt.value(Ue)[0] ** 2 * pt.shape0 + pt.value(aux_e["V0"])[0] * pt.shape0

    kw_j = {"aux": {k: jnp.asarray(v) for k, v in aux.items()}, "boundary": jbnd}
    kw_t = {"aux": interop.state_from_reference(aux, device="cpu"), "boundary": tbnd}
    Fj = jasm.assemble_function(js, jf, jnp.asarray(U), ctx, **kw_j)
    Ft = tasm.assemble_function(ts, tf, torch.as_tensor(U), ctx, **kw_t)
    assert _rel(Ft, Fj) <= 1e-12
    Jj = jasm.assemble_jacobian(js, jf, jnp.asarray(U), ctx, **kw_j)
    Jt = tasm.assemble_jacobian(ts, tf, torch.as_tensor(U), ctx, **kw_t)
    assert _rel(Jt.data, Jj.data) <= 1e-12
    # the kernel operator of the assembled Jacobian applies the same matrix
    x = torch.as_tensor(_iterate(js, seed=5, scale=1.0))
    assert _rel(Jt.fast_operator().matvec(x), Jj.matvec(jnp.asarray(x.numpy()))) <= 1e-12
    # the Jacobian-free action equals the assembled Jacobian's
    J0 = JacobianFreeOperator(ts, tf, torch.as_tensor(U), ctx, **kw_t)
    assert _rel(J0.matvec(x), Jt.matvec(x)) <= 1e-12
    assert _rel(J0.matvec(x.reshape(-1)), Jt.matvec(x).reshape(-1)) <= 1e-12


def test_hand_jacobian_matches_ad():
    """The hand-written Jacobian form equals the AD Jacobian (which the
    test above holds to the JAX package's)."""
    _, ts = _bratu_pair(nel=4)
    U = torch.as_tensor(_iterate(ts))
    ctx = {"lambda": 3.0}
    Jh = tasm.assemble_jacobian(ts, tbratu.bratu_residual, U, ctx,
                                jacobian=tbratu.bratu_jacobian)
    Jad = tasm.assemble_jacobian(ts, tbratu.bratu_residual, U, ctx)
    assert _rel(Jh.data, Jad.data) <= 1e-12


def test_residual_holds_fix_rows():
    """Fixed rows of the residual are ``u - v`` and their Jacobian rows
    are identity rows times the node's element multiplicity."""
    js, ts = _bratu_pair(nel=3)
    U = torch.as_tensor(_iterate(js))
    F = tasm.assemble_function(ts, tbratu.bratu_residual, U, {"lambda": 1.0})
    J = tasm.assemble_jacobian(ts, tbratu.bratu_residual, U, {"lambda": 1.0})
    mask = ts.tensor("dirichlet")[0][:, 0]
    mult = tasm._node_multiplicity(ts)
    assert torch.allclose(F[mask, 0], mult[mask] * U[mask, 0], rtol=0, atol=1e-14)
    dslot = tasm.stencil_of(ts).diag_slot
    rows = J.data[mask, :, 0, 0]
    assert torch.allclose(rows[:, dslot], mult[mask], rtol=0, atol=1e-14)
    rows[:, dslot] = 0
    assert float(rows.abs().max()) == 0.0


# ------------------------------------------------------------------ Newton


@pytest.mark.parametrize("operator,solver", [
    ("jfnk", "cg"), ("fast", "gmres"),
])
def test_newton_matches_jax(operator, solver):
    """Every operator and linear solver (``stencil`` with CG is the route
    of :func:`test_solve_bratu_both_routes_match_jax`, with BiCGStab the
    Cahn–Hilliard ``run`` of ``test_torch_cahnhilliard.py``)."""
    js, ts = _bratu_pair()
    kw = dict(rtol=1e-10, operator=operator, linear_solver=solver)
    jr = jnewton.newton(js, jbratu.bratu_residual, jnp.zeros((js.nnodes, 1)),
                        {"lambda": 6.0}, **kw)
    tr = tnewton.newton(ts, tbratu.bratu_residual,
                        torch.zeros((ts.nnodes, 1), dtype=torch.float64), {"lambda": 6.0}, **kw)
    assert tr.converged and bool(jr.converged)
    assert tr.iters == int(jr.iters)
    assert _maxdiff(tr.U, jr.U) <= 1e-10
    assert abs(tr.fnorm - float(jr.fnorm)) <= 1e-10


def test_solve_bratu_both_routes_match_jax():
    """The hand-Jacobian route of ``solve_bratu`` (the AD route is
    ``newton``'s default, held above) and the conv route
    ``solve_bratu_conv`` (conv-assembled Jacobians with the iterate as a
    state field, CG through the kernel operator) reach the JAX package's
    solution in as many Newton iterations."""
    js, ts = _bratu_pair(nel=6)
    jr = jbratu.solve_bratu(js, lam=6.0, use_ad=False, rtol=1e-10)
    tr = tbratu.solve_bratu(ts, lam=6.0, use_ad=False, rtol=1e-10)
    assert tr.iters == int(jr.iters) and tr.converged
    assert _maxdiff(tr.U, jr.U) <= 1e-10
    Ut, info = tbratu.solve_bratu_conv(ts, lam=6.0, rtol=1e-10)
    assert info["iters"] == int(jr.iters) and len(info["cg_iters"]) == info["iters"]
    assert _maxdiff(Ut, jr.U) <= 1e-10


def test_newton_damping_and_jfnk_preconditioner():
    """``damping`` scales each correction (more iterations, same root);
    ``jfnk_pc`` preconditions the Jacobian-free solves (fewer inner
    iterations are not observable here; the root is the same)."""
    _, ts = _bratu_pair(nel=4)
    U0 = torch.zeros((ts.nnodes, 1), dtype=torch.float64)
    ctx = {"lambda": 6.0}
    full = tnewton.newton(ts, tbratu.bratu_residual, U0, ctx, rtol=1e-10)
    damped = tnewton.newton(ts, tbratu.bratu_residual, U0, ctx, rtol=1e-10, damping=0.5,
                            maxit=100)
    assert damped.converged and damped.iters > full.iters
    assert float((damped.U - full.U).abs().max()) <= 1e-10

    def pc(U):
        return tkrylov.jacobi_preconditioner(
            tasm.assemble_jacobian(ts, tbratu.bratu_residual, U, ctx))

    jf = tnewton.newton(ts, tbratu.bratu_residual, U0, ctx, rtol=1e-10, operator="jfnk",
                        jfnk_pc=pc)
    assert jf.converged and jf.iters == full.iters
    assert float((jf.U - full.U).abs().max()) <= 1e-10
