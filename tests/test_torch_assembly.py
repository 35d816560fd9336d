"""The port's pointwise assembly engine (tabulation, ``assemble_system``,
``assemble_system_planes``, functionals, node-major stencil matrices)
against the JAX package, f64 on the CPU, on the same spaces.

Both evaluate the same tensor-product tables and add the same element
blocks, so tabulation leaves agree at 1e-13 and assembled data at 1e-12
(entries of order 1; only the order of sums differs)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.assembly.tabulation import tabulate_elements as jtabulate
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import poisson as jpoisson
from petiga_tpu.sparse.stencil import StencilMatrix as JStencilMatrix
from petiga_tpu.sparse.stencil import SymmetricStencilMatrix as JSymmetric
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.assembly.tabulation import (
    tabulate_elements, validate_geometry)
from petiga_tpu_torch.models import poisson as tpoisson
from petiga_tpu_torch.sparse.stencil import StencilMatrix, SymmetricStencilMatrix

CTX = {"c": 0.3, "k": 1.2}


def _pair(js):
    return js, interop.space_from_reference(js, device="cpu")


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def _warp(js, weights=False):
    g = js.greville_coordinates()
    X = np.stack([g[:, 0] + 0.1 * np.sin(np.pi * g[:, 0]) * g[:, 1], g[:, 1]], axis=1)
    W = 1.0 + 0.3 * np.cos(g[:, 0] + 2 * g[:, 1]) if weights else None
    return js.init_geometry(X, W)


# ------------------------------------------------------------- tabulation


@pytest.mark.parametrize("geom,face", [
    ("identity", None), ("identity", (1, 1)), ("identity", (0, 0)),
    ("mapped", None), ("mapped", (0, 1)), ("rational", None), ("rational", (1, 0)),
])
def test_tabulate_elements_leaf_by_leaf(geom, face):
    js = JSpace([JAxis.uniform(p=2, nel=4), JAxis.uniform(p=3, nel=3)], dtype=jnp.float64)
    if geom != "identity":
        _warp(js, weights=geom == "rational")
    js, ts = _pair(js)
    ids = np.array([0, 5, 11, 7])
    jpb = jtabulate(js, jnp.asarray(ids), order=3, face=face)
    tpb = tabulate_elements(ts, torch.as_tensor(ids), order=3, face=face)
    for name in ("u", "x", "weight", "detX", "normal", "gmap1", "gmap2"):
        j, t = getattr(jpb, name), getattr(tpb, name)
        assert (j is None) == (t is None), name
        if j is not None:
            _close(t, j, 1e-13)
    assert len(tpb.shape) == 4
    for k in range(4):
        _close(tpb.shape[k], jpb.shape[k], 1e-13 * 10**k)  # k-th derivatives ~ nel^k


def test_validate_geometry():
    _, ts = _pair(_warp(JSpace([JAxis.uniform(p=2, nel=4)] * 2, dtype=jnp.float64)))
    validate_geometry(ts)
    X = ts.geometry.copy()
    X[:, 0] *= -1.0
    ts.init_geometry(X)
    with pytest.raises(ValueError, match="non-positive geometry Jacobian"):
        validate_geometry(ts)


# --------------------------------------------------------- assemble_system


@pytest.fixture(scope="module")
def poisson2d():
    return _pair(jpoisson.make_space(2, p=2, nel=5, dtype=jnp.float64))


@pytest.mark.parametrize("method,fix,chunk", [
    ("shift", "element", None), ("shift", "post", 10), ("scatter", "element", 7),
    ("scatter", "post", None), ("auto", "element", 10),
])
def test_assemble_system_matches_jax(poisson2d, method, fix, chunk):
    js, ts = poisson2d
    jA, jb = jasm.assemble_system(js, jpoisson.poisson_system, CTX, method=method,
                                  fix=fix, chunk=chunk)
    tA, tb = tasm.assemble_system(ts, tpoisson.poisson_system, CTX, method=method,
                                  fix=fix, chunk=chunk)
    _close(tA.data, jA.data, 1e-12)
    _close(tb, jb, 1e-12)


@pytest.mark.parametrize("kind", ["periodic", "C0", "3d-dof2-inhomogeneous"])
def test_assemble_system_other_spaces(kind):
    """Periodic wrap, reduced continuity (strided placement) and a dof-2
    form with inhomogeneous Dirichlet values, shift = scatter = JAX."""
    if kind == "periodic":
        js = JSpace([JAxis.uniform(p=2, nel=5, periodic=True), JAxis.uniform(p=2, nel=4)],
                    dtype=jnp.float64)
    elif kind == "C0":
        js = JSpace([JAxis.uniform(p=2, nel=4, continuity=0)] * 2, dtype=jnp.float64)
    else:
        js = JSpace([JAxis.uniform(p=1, nel=3)] * 3, dof=2, dtype=jnp.float64)
        js.set_boundary_value(2, 1, 1, 0.7)
    js.set_boundary_value(1, 0, 0, 0.5)
    js, ts = _pair(js)
    dof = js.dof

    def jform(pt, ctx):
        K = 0.4 * jnp.outer(pt.shape0, pt.shape0) + pt.shape1 @ pt.shape1.T
        K = jnp.kron(K, jnp.array([[2.0, 0.5], [0.5, 1.0]])[:dof, :dof])
        return K, jnp.repeat(pt.shape0 * (1.0 + pt.x[0]), dof)

    def tform(pt, ctx):
        K = 0.4 * torch.outer(pt.shape0, pt.shape0) + pt.shape1 @ pt.shape1.T
        K = torch.kron(K, torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=K.dtype)[:dof, :dof])
        return K, torch.repeat_interleave(pt.shape0 * (1.0 + pt.x[0]), dof)

    jA, jb = jasm.assemble_system(js, jform, chunk=8)
    for method in ("shift", "scatter"):
        tA, tb = tasm.assemble_system(ts, tform, method=method, chunk=8)
        _close(tA.data, jA.data, 1e-12)
        _close(tb, jb, 1e-12)


def test_boundary_form_and_load():
    """Nitsche weak Dirichlet terms on two flagged faces (2-D), plus a
    nodal boundary load on a third."""
    js = JSpace([JAxis.uniform(p=2, nel=5)] * 2, dtype=jnp.float64)
    js.set_boundary_form(0, 0).set_boundary_form(1, 1)
    js.set_boundary_load(0, 1, 0, 2.5)
    js.set_boundary_value(1, 0, 0, 0.0)
    js, ts = _pair(js)
    alpha = 5.0 * 3 * 5

    def jinterior(pt, ctx):
        f = 2 * jnp.pi**2 * jnp.prod(jnp.sin(jnp.pi * pt.x))
        return pt.shape1 @ pt.shape1.T, f * pt.shape0

    def jbnd(pt, ctx):
        dn = pt.shape1 @ pt.normal
        K = (-jnp.outer(pt.shape0, dn) - jnp.outer(dn, pt.shape0)
             + alpha * jnp.outer(pt.shape0, pt.shape0))
        return K, jnp.zeros_like(pt.shape0)

    def tinterior(pt, ctx):
        f = 2 * torch.pi**2 * torch.prod(torch.sin(torch.pi * pt.x))
        return pt.shape1 @ pt.shape1.T, f * pt.shape0

    def tbnd(pt, ctx):
        dn = pt.shape1 @ pt.normal
        K = (-torch.outer(pt.shape0, dn) - torch.outer(dn, pt.shape0)
             + alpha * torch.outer(pt.shape0, pt.shape0))
        return K, torch.zeros_like(pt.shape0)

    jA, jb = jasm.assemble_system(js, jinterior, boundary=jbnd)
    tA, tb = tasm.assemble_system(ts, tinterior, boundary=tbnd)
    _close(tA.data, jA.data, 1e-12)
    _close(tb, jb, 1e-12)
    _close(tasm.boundary_flux_vector(ts), jasm.boundary_flux_vector(js), 1e-14)
    np.testing.assert_array_equal(ts.flux_vector(), js.flux_vector())


def test_assemble_vector_and_matrix(poisson2d):
    js, ts = poisson2d
    jb = jasm.assemble_vector(js, lambda pt, ctx: pt.shape0 * jnp.sum(pt.x), chunk=9)
    tb = tasm.assemble_vector(ts, lambda pt, ctx: pt.shape0 * torch.sum(pt.x), chunk=9)
    _close(tb, jb, 1e-13)
    jA = jasm.assemble_matrix(js, lambda pt, ctx: pt.shape1 @ pt.shape1.T)
    tA = tasm.assemble_matrix(ts, lambda pt, ctx: pt.shape1 @ pt.shape1.T)
    _close(tA.data, jA.data, 1e-12)


@pytest.mark.parametrize("dim,nel,chunk", [(2, 5, 10), (3, 4, 32)])
def test_assemble_system_planes_matches_jax(dim, nel, chunk):
    js, ts = _pair(jpoisson.make_space(dim, p=2, nel=nel, dtype=jnp.float64))
    jop, jb = jasm.assemble_system_planes(js, jpoisson.poisson_system_q, CTX,
                                          chunk=chunk, order=1, interpret=True)
    top, tb = tasm.assemble_system_planes(ts, tpoisson.poisson_system_q, CTX,
                                          chunk=chunk, order=1)
    ref = interop.operator_from_jax_planes(jop.stencil, np.asarray(jop.DT),
                                           align=jop.align, device="cpu")
    _close(top.DT, ref.DT, 1e-12)
    _close(tb, jb, 1e-12)
    # the same operator as the node-major route
    tA, tb2 = tasm.assemble_system(ts, tpoisson.poisson_system, CTX, fix="post")
    _close(tA.fast_operator().DT, ref.DT, 1e-12)
    _close(tb2, jb, 1e-12)


def test_waiting_branches_raise():
    """``assemble_separable_planes`` (sum-factorized Kronecker element
    matrices) gives the reference's generic operator and load vector (the
    case of ``tests/test_planes_assembly.py::test_separable_assembly_identical``),
    in several slab chunks; it refuses what the reference refuses."""
    js, ts = _pair(jpoisson.make_space(3, p=2, nel=6, dtype=jnp.float64))
    ctx = {"c": 0.4, "k": 1.3}
    jA, jb = jasm.assemble_system(js, jpoisson.poisson_system, ctx)

    def f(x):
        return (0.4 + 1.3 * 3 * math.pi**2) * torch.prod(torch.sin(math.pi * x))

    op, b = tasm.assemble_separable_planes(ts, c=0.4, kappa=1.3, forcing=f, chunk=72)
    x = np.random.default_rng(0).normal(size=(js.nnodes, 1))
    _close(op.matvec(torch.as_tensor(x)), jA.matvec(jnp.asarray(x)), 1e-13)
    _close(b, jb, 1e-14)
    periodic = interop.space_from_reference(
        JSpace([JAxis.uniform(p=2, nel=4, periodic=True)], dtype=jnp.float64), device="cpu")
    with pytest.raises(ValueError, match="open axes"):
        tasm.assemble_separable_planes(periodic)
    ts.init_geometry(1.5 * ts.greville_coordinates())
    with pytest.raises(ValueError, match="identity map"):
        tasm.assemble_separable_planes(ts)


# ------------------------------------------------------------ functionals


def test_error_norms_and_scalar(poisson2d):
    js, ts = poisson2d
    U = np.random.default_rng(1).normal(size=(js.nnodes, 1))
    tU, jU = torch.as_tensor(U), jnp.asarray(U)
    for k, jex, tex in ((0, jpoisson.exact_solution, tpoisson.exact_solution),
                        (1, jpoisson.exact_gradient, tpoisson.exact_gradient)):
        want = float(jasm.compute_error_norm(js, jU, jex, k=k, chunk=7))
        got = float(tasm.compute_error_norm(ts, tU, tex, k=k, chunk=7))
        assert abs(got - want) <= 1e-12 * want, (k, got, want)
    # the general tabulated route = the sum-factorized k = 0 route
    general = float(tasm._error_norm_pointwise(ts, tU, tpoisson.exact_solution, 0,
                                               None, None, 7))
    fast = float(tasm._error_norm_l2_factorized(ts, tU, tpoisson.exact_solution))
    assert abs(general - fast) <= 1e-12 * fast
    assert tpoisson.h1_error(ts, tU) == pytest.approx(jpoisson.h1_error(js, jU), rel=1e-12)

    jval = jasm.compute_scalar(
        js, lambda pt, ue, ctx: jnp.stack([pt.value(ue)[0] ** 2, jnp.sum(pt.x)]), jU)
    tval = tasm.compute_scalar(
        ts, lambda pt, ue, ctx: torch.stack([pt.value(ue)[0] ** 2, torch.sum(pt.x)]), tU)
    _close(tval, jval, 1e-12)
    _close(tasm.compute_scalar(ts, lambda pt, ue, ctx: pt.x[0] * pt.x[1]),
           jasm.compute_scalar(js, lambda pt, ue, ctx: pt.x[0] * pt.x[1]), 1e-14)


def test_error_norm_mapped_geometry():
    js, ts = _pair(_warp(jpoisson.make_space(2, p=2, nel=4, dtype=jnp.float64)))
    U = np.random.default_rng(2).normal(size=(js.nnodes, 1))
    want = float(jasm.compute_error_norm(js, jnp.asarray(U), jpoisson.exact_solution))
    got = float(tasm.compute_error_norm(ts, torch.as_tensor(U), tpoisson.exact_solution))
    assert abs(got - want) <= 1e-12 * want


# ------------------------------------------------------ stencil matrices


@pytest.fixture(scope="module")
def matrices():
    jst = jasm.stencil_of(JSpace(
        [JAxis.uniform(p=2, nel=4, periodic=True), JAxis.uniform(p=1, nel=4)],
        dof=2, dtype=jnp.float64))
    data = interop.random_stencil_data(jst, 5)
    jA = JStencilMatrix(jst, jnp.asarray(data))
    return jA, interop.stencil_matrix_from_reference(jA, device="cpu")


def test_stencil_matrix_structure(matrices):
    jA, tA = matrices
    x = np.random.default_rng(0).normal(size=(jA.stencil.nnodes, 2))
    _close(tA.matvec(torch.as_tensor(x)), jA.matvec(jnp.asarray(x)), 1e-13)
    _close(tA.transpose().data, jA.transpose().data, 0.0)
    _close(tA.diagonal(), jA.diagonal(), 0.0)
    _close(tA.scalar_diagonal(), jA.scalar_diagonal(), 0.0)
    dense = tA.to_dense()
    np.testing.assert_array_equal(dense, jA.to_dense())
    np.testing.assert_array_equal(tA.transpose().to_dense(), dense.T)
    np.testing.assert_allclose(dense @ x.ravel(), tA.matvec(torch.as_tensor(x)).numpy().ravel(),
                               rtol=0, atol=1e-13)
    np.testing.assert_array_equal(tA.stencil.column_index(), jA.stencil.column_index())
    for t, j in zip(tA.to_coo(), jA.to_coo()):
        np.testing.assert_array_equal(t, j)
    n = dense.shape[0]
    indptr, indices, vals = tA.to_csr()
    csr = scipy.sparse.csr_matrix((vals, indices, indptr), shape=(n, n))
    np.testing.assert_array_equal(csr.toarray(), dense)
    op = tA.fast_operator()
    assert op.kind == "full" and op.device.type == "cpu"
    _close(op.matvec(torch.as_tensor(x)), jA.matvec(jnp.asarray(x)), 1e-13)


@pytest.mark.parametrize("periodic", [False, True])
def test_symmetric_stencil_matrix(periodic):
    jst = jasm.stencil_of(JSpace(
        [JAxis.uniform(p=2, nel=4, periodic=periodic), JAxis.uniform(p=1, nel=3)],
        dof=2, dtype=jnp.float64))
    up = interop.random_stencil_data(jst, 9, symmetric=True)
    up[:, 0] = up[:, 0] + np.swapaxes(up[:, 0], -1, -2)  # symmetric diagonal blocks
    jS = JSymmetric(jst, jnp.asarray(up))
    tS = interop.stencil_matrix_from_reference(jS, device="cpu")
    assert isinstance(tS, SymmetricStencilMatrix) and tS.Ku == jS.Ku
    full = tS.to_full()
    assert isinstance(full, StencilMatrix)
    _close(full.data, jS.to_full().data, 0.0)
    assert torch.equal(SymmetricStencilMatrix.from_full(full).data, tS.data)
    dense = full.to_dense()
    np.testing.assert_array_equal(dense, dense.T)
    x = np.random.default_rng(1).normal(size=(jst.nnodes, 2))
    want = np.asarray(jS.matvec(jnp.asarray(x)))
    _close(tS.matvec(torch.as_tensor(x)), want, 1e-13)
    _close(tS.scalar_diagonal(), jS.scalar_diagonal(), 0.0)
    op = tS.fast_operator()
    assert op.kind == ("full" if periodic else "sym")
    _close(op.matvec(torch.as_tensor(x)), want, 1e-13)


def test_post_fix_on_node_major_matrix(poisson2d):
    """``dirichlet_post_fix`` on a StencilMatrix = the per-element fix;
    the homogeneous variant zeroes the fixed right-hand-side rows."""
    js, ts = poisson2d
    jA0, jb0 = jasm.assemble_system(js, jpoisson.poisson_system, CTX, apply_fix=False)
    jA, jb = jasm.dirichlet_post_fix_homogeneous(js, jA0, jb0)
    tA0, tb0 = tasm.assemble_system(ts, tpoisson.poisson_system, CTX, apply_fix=False)
    tA, tb = tasm.dirichlet_post_fix_homogeneous(ts, tA0, tb0)
    _close(tA.data, jA.data, 1e-12)
    _close(tb, jb, 1e-12)
