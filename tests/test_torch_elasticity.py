"""Linear elasticity in the port against the JAX package, f64 on the CPU:
the blocked (dof = dim) assembly with an AD body force, the manufactured
2-D solve and its L2 rate, the 3-D block-Jacobi solve through the kernel
operator, the rigid-body null space, and the whole slice — the 3-D
operator solved by CG preconditioned with the multigrid V-cycle.

Tolerances: operators and load vectors ≤ 1e-12 relative (the same
products summed in another order), Krylov iteration counts equal,
solutions ≤ 1e-10 (absolute, on fields of size O(1e-2)), L2 errors
≤ 1e-10 relative."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import elasticity as jel
from petiga_tpu.solve import krylov as jkry
from petiga_tpu.solve import multigrid as jmg
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.models import elasticity as tel
from petiga_tpu_torch.solve import krylov as tkry
from petiga_tpu_torch.solve import multigrid as tmg

F64 = jnp.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _clamped(dim, nel):
    js = JSpace([JAxis.uniform(p=2, nel=nel)] * dim, dof=dim, dtype=F64)
    for d in range(dim):
        for s in range(2):
            for c in range(dim):
                js.set_boundary_value(d, s, c, 0.0)
    return js, interop.space_from_reference(js, device="cpu")


def _exact(xp):
    """The manufactured field of examples/elasticity.py, one point."""
    def exact(x):
        dim = x.shape[0]
        rest = x[0] * (1 - x[0])
        for i in range(1, dim):
            rest = rest * x[i] * (1 - x[i])
        return xp.stack([xp.prod(xp.sin(math.pi * x))] + [rest * (i + 1) for i in range(dim - 1)])
    return exact


def _exact_batched(x):
    """The same field on a batch of points (..., dim)."""
    dim = x.shape[-1]
    rest = torch.prod(x * (1 - x), dim=-1)
    return torch.stack([torch.prod(torch.sin(math.pi * x), dim=-1)]
                       + [rest * (i + 1) for i in range(dim - 1)], dim=-1)


def test_mms_2d_rate():
    """The manufactured 2-D problem: at 4² the AD body-force system,
    block-Jacobi CG and the L2 error match the reference; from 4² to 8²
    the port's error falls at the p=2 rate."""
    errs = []
    ctx = {"lambda": 1.0, "mu": 1.0}
    for nel in (4, 8):
        js, ts = _clamped(2, nel)
        tA, tb = tasm.assemble_system(ts, tel.body_force_system(_exact(torch)), ctx)
        tr = tkry.cg(tA.fast_operator(), tb, M=tkry.block_jacobi_preconditioner(tA), rtol=1e-12)
        errs.append(float(tasm.compute_error_norm(ts, tr.x, _exact_batched)))
        if nel == 4:
            jA, jb = jasm.assemble_system(js, jel.body_force_system(_exact(jnp)), ctx)
            assert _rel(tA.data, jA.data) <= 1e-12 and _rel(tb, jb) <= 1e-12
            jr = jkry.cg(jA, jb, M=jkry.block_jacobi_preconditioner(jA), rtol=1e-12)
            assert tr.iters == int(jr.iters)
            assert float(np.abs(tr.x.numpy() - np.asarray(jr.x)).max()) <= 1e-10
            jerr = float(jasm.compute_error_norm(js, jr.x, _exact(jnp), k=0))
            assert abs(errs[0] - jerr) <= 1e-10 * jerr
    assert abs(np.log2(errs[0] / errs[1]) - 3) < 0.3, errs


def test_solve_3d():
    """``elasticity.solve`` on a 3-D patch clamped at x = 0 and x = 1 under
    a body force: block-Jacobi CG through the kernel operator."""
    js = jel.make_space(3, p=2, nel=3, dtype=F64)
    ts = interop.space_from_reference(js, device="cpu")
    jU, jinfo = jel.solve(js, lam=1.5, rtol=1e-10,
                          ctx_extra={"body_force": lambda x: jnp.array([0.0, 0.3, -1.0])})
    tU, tinfo = tel.solve(ts, lam=1.5, rtol=1e-10,
                          ctx_extra={"body_force": lambda x: torch.tensor([0.0, 0.3, -1.0],
                                                                          dtype=x.dtype)})
    assert _rel(tinfo["A"].data, jinfo["A"].data) <= 1e-12
    assert tinfo["iters"] == jinfo["iters"]
    assert float(np.abs(tU.numpy() - np.asarray(jU)).max()) <= 1e-10


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_body_modes_in_null_space(dim):
    """The unconstrained stiffness annihilates every rigid-body mode."""
    js = JSpace([JAxis.uniform(p=2, nel=2)] * dim, dof=dim, dtype=F64)
    ts = interop.space_from_reference(js, device="cpu")
    modes = tel.rigid_body_modes(ts)
    np.testing.assert_array_equal(modes, jel.rigid_body_modes(js))
    assert modes.shape[0] == dim * (dim + 1) // 2
    A, _ = tasm.assemble_system(ts, tel.elasticity_system, {"lambda": 1.0, "mu": 1.0},
                                apply_fix=False)
    op = A.fast_operator()
    for m in modes:
        np.testing.assert_allclose(op.matvec(torch.as_tensor(m)).numpy(), 0.0, atol=1e-12)


def test_whole_slice_mg_cg_3d():
    """The slice end to end at 4³: the clamped 3-D problem under a body
    force, pointwise assembly per level, ``MGHierarchy.build`` (4³ → 2³),
    ``mg_preconditioner`` and CG on the kernel operator, against the
    reference's own assembly, hierarchy and solve."""
    js, ts = _clamped(3, 4)
    jctx = {"lambda": 1.0, "mu": 2.0, "body_force": lambda x: jnp.sin(jnp.pi * x)}
    tctx = {"lambda": 1.0, "mu": 2.0, "body_force": lambda x: torch.sin(math.pi * x)}
    jform, tform = jel.elasticity_system, tel.elasticity_system
    jA, jb = jasm.assemble_system(js, jform, jctx)
    tA, tb = tasm.assemble_system(ts, tform, tctx)
    jh = jmg.MGHierarchy.build(
        js, lambda s: jA if s is js else jasm.assemble_system(s, jform, jctx)[0], min_nel=2)
    th = tmg.MGHierarchy.build(
        ts, lambda s: tA if s is ts else tasm.assemble_system(s, tform, tctx)[0], min_nel=2)
    assert len(th.spaces) == len(jh.spaces) == 2
    for lvl, (A, jAl) in enumerate(zip(th.operators, jh.operators)):
        assert _rel(A.data, jAl.data) <= 1e-12, lvl
    jr = jkry.cg(jA, jb, M=jmg.mg_preconditioner(jh), rtol=1e-10)
    tr = tkry.cg(tA.fast_operator(), tb, M=tmg.mg_preconditioner(th), rtol=1e-10)
    assert tr.iters == int(jr.iters)
    assert float(np.abs(tr.x.numpy() - np.asarray(jr.x)).max()) <= 1e-10
