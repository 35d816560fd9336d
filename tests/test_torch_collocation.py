"""Collocation (``Space(collocation=True)``, ``assembly/collocation.py``)
against the JAX package, f64 on the CPU.

The collocation matrix, load vector, residual and AD Jacobian are held to
the reference's at 1e-12 relative to their largest entry (one point's row
is the same handful of products in both; only the order of sums differs),
on an open 2-D space and on a mapped one (where the tabulation leaves the
``detX`` weight out under collocation).  The Poisson rates are the cases of
``tests/test_collocation.py`` (≈ p for even p, p - 1 for odd), with the
L2 error measured on a Galerkin clone as there.  Bratu's collocation Newton
iterates are held to the reference's at 1e-10."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petiga_tpu.assembly import collocation as jcol
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models.bratu import bratu_collocation_residual as jbratu
from petiga_tpu.solve.krylov import bicgstab as jbicgstab
from petiga_tpu.solve.krylov import jacobi_preconditioner as jjacobi
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import collocation as tcol
from petiga_tpu_torch.assembly.assemble import compute_error_norm
from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space
from petiga_tpu_torch.models.bratu import bratu_collocation_residual
from petiga_tpu_torch.solve.krylov import bicgstab, jacobi_preconditioner

F64 = torch.float64


def _jspace(dim, p, nel, mapped=False):
    sp = JSpace([JAxis.uniform(p=p, nel=nel) for _ in range(dim)], collocation=True,
                dtype=jnp.float64)
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    if mapped:
        G = np.asarray(sp.greville_coordinates()).copy()
        G[:, 0] += 0.05 * np.sin(np.pi * G[:, 1]) * G[:, 0]
        sp.init_geometry(G)
    return sp


def _tspace(dim, p, nel):
    sp = Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], collocation=True,
               dtype=F64, device="cpu")
    for d in range(dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def laplace_colloc(lib):
    """-Δu = f at the collocation point."""
    def system(pt, ctx):
        dim = pt.x.shape[-1]
        f = dim * math.pi**2 * lib.prod(lib.sin(math.pi * pt.x))
        lap = pt.shape2[:, 0, 0]
        for d in range(1, dim):
            lap = lap + pt.shape2[:, d, d]
        return -lap[None, :], f.reshape(1)
    return system


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mapped", [False, True], ids=["open", "mapped"])
def test_collocation_system_function_jacobian(mapped):
    js = _jspace(2, 2, 6, mapped)
    ts = interop.space_from_reference(js, device="cpu")
    assert ts.collocation and ts.tabs[0].collocation
    jA, jb = jcol.assemble_collocation(js, laplace_colloc(jnp))
    tA, tb = tcol.assemble_collocation(ts, laplace_colloc(torch), chunk=17)
    assert _rel(tA.data.numpy(), jA.data) <= 1e-12
    assert _rel(tb.numpy(), jb) <= 1e-12
    U = np.random.default_rng(5).normal(size=(js.nnodes, 1)) * 0.3
    ctx = {"lambda": 2.0}
    jF = jcol.assemble_collocation_function(js, jbratu, jnp.asarray(U), ctx)
    tF = tcol.assemble_collocation_function(ts, bratu_collocation_residual,
                                            torch.as_tensor(U), ctx, chunk=17)
    assert _rel(tF.numpy(), jF) <= 1e-12
    jJ = jcol.assemble_collocation_jacobian(js, jbratu, jnp.asarray(U), ctx)
    tJ = tcol.assemble_collocation_jacobian(ts, bratu_collocation_residual,
                                            torch.as_tensor(U), ctx, chunk=17)
    assert _rel(tJ.data.numpy(), jJ.data) <= 1e-12


@pytest.mark.parametrize("dim,p", [(1, 2), (1, 3), (2, 2)])
def test_collocation_rates(dim, p):
    """Poisson collocation solved by Jacobi-BiCGStab on the kernel
    operator (its plain version here); L2 on a Galerkin clone."""
    errs = []
    for nel in ((8, 16) if dim == 2 else (16, 32)):
        sp = _tspace(dim, p, nel)
        A, b = tcol.assemble_collocation(sp, laplace_colloc(torch))
        U = bicgstab(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=1e-12,
                     maxiter=3000).x
        spg = Space([Axis.uniform(p=p, nel=nel) for _ in range(dim)], dtype=F64,
                    device="cpu")
        exact = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1, keepdim=True)
        errs.append(float(compute_error_norm(spg, U, exact, k=0)))
    rate = math.log2(errs[0] / errs[1])
    expect = p if p % 2 == 0 else p - 1
    assert abs(rate - expect) < 0.35, (rate, errs)


def test_collocation_bratu_newton():
    """Newton on the collocation residual with the AD Jacobian and
    Jacobi-BiCGStab, both packages from U = 0: the same iterates."""
    ctx = {"lambda": 4.0}
    js = _jspace(2, 2, 10)
    ts = interop.space_from_reference(js, device="cpu")
    jU = jnp.zeros((js.nnodes, 1))
    tU = torch.zeros((ts.nnodes, 1), dtype=F64)
    for _ in range(8):
        jF = jcol.assemble_collocation_function(js, jbratu, jU, ctx)
        tF = tcol.assemble_collocation_function(ts, bratu_collocation_residual, tU, ctx)
        if float(jnp.linalg.norm(jF)) < 1e-10:
            break
        jJ = jcol.assemble_collocation_jacobian(js, jbratu, jU, ctx)
        tJ = tcol.assemble_collocation_jacobian(ts, bratu_collocation_residual, tU, ctx)
        jU = jU - jbicgstab(jJ, jF, M=jjacobi(jJ), rtol=1e-12).x
        tU = tU - bicgstab(tJ.fast_operator(), tF, M=jacobi_preconditioner(tJ), rtol=1e-12).x
    assert float(torch.linalg.vector_norm(tF)) < 1e-10
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=0, atol=1e-10)
    assert float(tU.max()) > 0.05
