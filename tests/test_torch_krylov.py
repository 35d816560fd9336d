"""Port CG (petiga_tpu_torch.solve.krylov) against the JAX package's cg on
the same seeded SPD stencil operator: identical iteration count and x at
rel <= 1e-10 in f64 (round-off in the dots and the matvec sum order is
~1e-15 per step; CG amplifies it by at most the condition number)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.solve import krylov as jkrylov
from petiga_tpu.sparse.pallas_spmv import PallasStencilOperator
from petiga_tpu.sparse.stencil import Stencil as JStencil
from petiga_tpu.sparse.stencil import StencilMatrix, SymmetricStencilMatrix
from petiga_tpu_torch import interop
from petiga_tpu_torch.solve import krylov as tkrylov


def _spd_upper(st, seed):
    """Upper-slot data of a symmetric, diagonally dominant (so SPD)
    stencil operator, out-of-range slots zero."""
    rng = np.random.default_rng(seed)
    multi = np.unravel_index(np.arange(st.nnodes), st.node_shape, order="F")
    offs = st.slot_offsets()[st.diag_slot:]
    valid = np.ones((st.nnodes, len(offs)), bool)
    for d in range(st.dim):
        j = multi[d][:, None] + offs[None, :, d]
        valid &= (j >= 0) & (j < st.node_shape[d])
    up = rng.uniform(-1, 1, size=valid.shape + (st.dof, st.dof)) * valid[..., None, None]
    up[:, 0] = 0.5 * (up[:, 0] + np.swapaxes(up[:, 0], -1, -2))
    full = np.asarray(SymmetricStencilMatrix(st, jnp.asarray(up)).to_full().data)
    rowsum = np.abs(full).sum(axis=(1, 3))  # (nnodes, dof)
    for a in range(st.dof):
        up[:, 0, a, a] += rowsum[:, a] + 1.0
    return up


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("shape,widths,sym", [
    ((9, 8), (1, 1), False),
    ((5, 4, 6), (1, 1, 1), True),
])
def test_packed_cg_matches(shape, widths, sym):
    st = JStencil(node_shape=shape, widths=widths, periodic=(False,) * len(shape), dof=1)
    up = _spd_upper(st, seed=len(shape))
    S = SymmetricStencilMatrix(st, jnp.asarray(up))
    if sym:
        jop = PallasStencilOperator.from_symmetric(S, interpret=True)
        op = interop.operator_from_stencil_data(st, up, symmetric=True, device="cpu")
    else:
        A = S.to_full()
        jop = PallasStencilOperator(A, interpret=True)
        op = interop.operator_from_stencil_data(st, np.asarray(A.data), device="cpu")
    b = np.random.default_rng(5).normal(size=(st.nnodes, 1))

    jd = jop.packed_diag_inv()
    jr = jkrylov.cg(lambda v: jop.matvec_xb(jop.DT, v), jop.pack_vec(jnp.asarray(b)),
                    M=lambda z: z * jd, rtol=1e-10)
    td = op.packed_diag_inv()
    tr = tkrylov.cg(lambda v: op.matvec_xb(op.DT, v), op.pack_vec(torch.as_tensor(b)),
                    M=lambda z: z * td, rtol=1e-10)
    assert tr.iters == int(jr.iters) > 3
    assert _rel(op.unpack_vec(tr.x).numpy(), jop.unpack_vec(jr.x)) <= 1e-10
    assert _rel(tr.residual.numpy(), jr.residual) <= 1e-6


def test_unpacked_cg_jacobi_matches():
    st = JStencil(node_shape=(7, 6), widths=(2, 2), periodic=(False, False), dof=2)
    A = SymmetricStencilMatrix(st, jnp.asarray(_spd_upper(st, seed=11))).to_full()
    op = interop.operator_from_stencil_data(st, np.asarray(A.data), device="cpu")
    b = np.random.default_rng(6).normal(size=(st.nnodes, 2))
    jr = jkrylov.cg(A, jnp.asarray(b), M=jkrylov.jacobi_preconditioner(A), rtol=1e-10)
    tr = tkrylov.cg(op, torch.as_tensor(b), M=tkrylov.jacobi_preconditioner(op), rtol=1e-10)
    assert isinstance(tr, tkrylov.KrylovResult)
    assert tr.iters == int(jr.iters)
    assert _rel(tr.x.numpy(), jr.x) <= 1e-10
    # maxiter caps the count, like the reference's while_loop
    assert tkrylov.cg(op, torch.as_tensor(b), rtol=1e-14, maxiter=2).iters == 2


# Systems whose BiCGStab breaks down on exact zeros (every value a binary
# fraction, so the zeros are exact on any machine): (r̂, r) = 0 with r ≠ 0,
# and s = 0 (so t = 0) in the second iteration.
BREAKDOWNS = {
    "rho": ([[-1.0, -2.0, 0.0], [0.0, 0.0, -1.0], [1.0, 1.0, 1.0]], [1.0, 0.0, 0.0]),
    "omega": ([[1.0, 1.0], [-1.0, 1.0]], [1.0, 0.0]),
}


@pytest.mark.parametrize("case", list(BREAKDOWNS))
def test_bicgstab_breakdowns(case):
    """The port restarts at (r̂, r) = 0 and takes ω = 0 at (t, t) = 0 and
    reaches the solution; the reference divides by zero there and returns
    a non-finite iterate (the deliberate difference of ROADMAP Queue 3)."""
    A, b = (np.asarray(a) for a in BREAKDOWNS[case])
    At = torch.as_tensor(A)
    res = tkrylov.bicgstab(lambda x: At @ x, torch.as_tensor(b), rtol=1e-12, maxiter=50)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b), rtol=0, atol=1e-12)
    jres = jkrylov.bicgstab(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-12, maxiter=50)
    assert not np.isfinite(np.asarray(jres.x)).all()
