"""The port's preconditioners against the JAX package's, f64 on the CPU,
on the same assembled operators (the port's assembly, handed to the
reference as its ``StencilMatrix``; the assemblies themselves are held to
each other in tests/test_torch_elasticity.py and test_torch_assembly.py)
and the same seeded residuals:
knot-insertion prolongation, the multigrid hierarchy and V-cycle,
element-by-element and block-by-block inverses, field split and two-level
Schwarz.

Tolerances: one preconditioner application ≤ 1e-12 relative to its
largest entry (the same arithmetic in another order), Krylov iteration
counts equal, solutions ≤ 1e-10.  The port's Krylov products run on the
kernel operator (``fast_operator()``), here its plain version."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.assembly.tabulation import tabulate_elements as jtab
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.bspline import bspline_ders
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import elasticity as jel
from petiga_tpu.models import poisson as jpois
from petiga_tpu.solve import blockpc as jbpc
from petiga_tpu.solve import fieldsplit as jfs
from petiga_tpu.solve import krylov as jkry
from petiga_tpu.solve import multigrid as jmg
from petiga_tpu.solve import schwarz as jsch
from petiga_tpu.sparse.stencil import Stencil as JStencil
from petiga_tpu.sparse.stencil import StencilMatrix as JStencilMatrix
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.core.axis import Axis as TAxis
from petiga_tpu_torch.models import elasticity as tel
from petiga_tpu_torch.models import poisson as tpois
from petiga_tpu_torch.solve import blockpc as tbpc
from petiga_tpu_torch.solve import fieldsplit as tfs
from petiga_tpu_torch.solve import krylov as tkry
from petiga_tpu_torch.solve import multigrid as tmg
from petiga_tpu_torch.solve import schwarz as tsch
from petiga_tpu_torch.sparse.stencil import StencilMatrix

F64 = jnp.float64
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.lru_cache(maxsize=None)
def _elastic(nel=4):
    """A clamped 2-D elasticity system in both packages (dof 2, body
    force), built once per size and shared by the tests."""
    js = JSpace([JAxis.uniform(p=2, nel=nel)] * 2, dof=2, dtype=F64)
    for d in range(2):
        for s in range(2):
            for c in range(2):
                js.set_boundary_value(d, s, c, 0.0)
    ts = interop.space_from_reference(js, device="cpu")
    tctx = {"lambda": 2.0, "mu": 1.0, "body_force": lambda x: torch.sin(np.pi * x)}
    return (js, ts) + _both(*tasm.assemble_system(ts, tel.elasticity_system, tctx))


def _both(tA, tb):
    """(jA, jb, tA, tb): the port's system and the same numbers as the
    reference's ``StencilMatrix`` and load vector."""
    st = tA.stencil
    jst = JStencil(node_shape=st.node_shape, widths=st.widths, periodic=st.periodic, dof=st.dof)
    return JStencilMatrix(jst, jnp.asarray(tA.data.numpy())), jnp.asarray(tb.numpy()), tA, tb


def _port_assembly(system, ctx):
    """``assemble(space)`` for the reference's ``MGHierarchy.build``: the
    port's assembly of the same level, as the reference's matrix."""
    def assemble(js):
        ts = interop.space_from_reference(js, device="cpu")
        return _both(*tasm.assemble_system(ts, system, ctx))[0]
    return assemble


@functools.lru_cache(maxsize=None)
def _poisson(nel=8, periodic=False):
    """A 2-D Poisson system in both packages, built once per case."""
    if periodic:
        js = JSpace([JAxis.uniform(p=2, nel=nel, periodic=True)] * 2, dtype=F64)
        ctx = {"c": 0.1, "k": 1.0}
    else:
        js = jpois.make_space(2, p=2, nel=nel, dtype=F64)
        ctx = {"c": 0.0, "k": 1.0}
    ts = interop.space_from_reference(js, device="cpu")
    return (js, ts) + _both(*tasm.assemble_system(ts, tpois.poisson_system, ctx))


def _probe(n, dof, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dof))


def _same_application(jM, tM, n, dof, seed=0):
    r = _probe(n, dof, seed)
    return _rel(tM(torch.as_tensor(r)), jM(jnp.asarray(r)))


def _same_solve(solver, jA, jb, jM, tA, tb, tM, rtol=1e-10):
    jres = getattr(jkry, solver)(jA, jb, M=jM, rtol=rtol, maxiter=4000)
    tres = getattr(tkry, solver)(tA.fast_operator(), tb, M=tM, rtol=rtol, maxiter=4000)
    assert tres.iters == int(jres.iters)
    assert float(np.max(np.abs(tres.x.numpy() - np.asarray(jres.x)))) <= 1e-10
    return tres.iters


# ---------------------------------------------------------------- multigrid


@pytest.mark.parametrize("p,periodic", [(1, False), (2, False), (3, False), (2, True)])
def test_knot_insertion(p, periodic):
    """The port's prolongation equals the reference's and reproduces the
    coarse basis exactly in the fine space."""
    coarse = TAxis.uniform(p=p, nel=4, periodic=periodic)
    fine = TAxis.uniform(p=p, nel=8, periodic=periodic)
    P = tmg.prolongation_1d(coarse, fine)
    Pj = jmg.prolongation_1d(JAxis.uniform(p=p, nel=4, periodic=periodic),
                             JAxis.uniform(p=p, nel=8, periodic=periodic))
    np.testing.assert_array_equal(P, Pj)
    u = np.linspace(0, 0.999, 53)

    def basis(ax):
        spans = ax.find_span(u)
        ders = bspline_ders(ax.U, ax.p, spans, u, 0)
        W = np.zeros((len(u), ax.nnp))
        for j in range(ax.p + 1):
            np.add.at(W, (np.arange(len(u)), (spans - ax.p + j) % ax.nnp), ders[:, 0, j])
        return W

    np.testing.assert_allclose(basis(fine) @ P, basis(coarse), atol=1e-12)


def test_vcycle_and_mg_cg():
    """Poisson, 2-D p=2, 8² → 4²: the hierarchy's prolongations, one
    V-cycle application, its contraction, and MG-CG."""
    js, ts, jA, jb, tA, tb = _poisson(8)
    ctx = {"c": 0.0, "k": 1.0}
    jh = jmg.MGHierarchy.build(js, _port_assembly(tpois.poisson_system, ctx), min_nel=4)
    th = tmg.MGHierarchy.build(ts, lambda s: tasm.assemble_system(s, tpois.poisson_system, ctx)[0],
                               min_nel=4)
    assert len(th.spaces) == len(jh.spaces) == 2
    for P, Pj in zip(th.prolongs[0], interop.prolongations_from_reference(jh, device="cpu")[0]):
        assert torch.equal(P, Pj)
    jM, tM = jmg.mg_preconditioner(jh), tmg.mg_preconditioner(th)
    assert _same_application(jM, tM, ts.nnodes, 1) <= RTOL
    # one V-cycle as an iteration: the residual contracts
    x = tM(tb)
    r1 = tb - tA.matvec(x)
    r2 = r1 - tA.matvec(tM(r1))
    assert float(torch.linalg.vector_norm(r2) / torch.linalg.vector_norm(r1)) < 0.25
    # MG-CG (its iteration count against the reference's: the whole-slice
    # test of tests/test_torch_elasticity.py)
    res = tkry.cg(tA.fast_operator(), tb, M=tM, rtol=1e-10)
    assert res.iters < 15
    assert tpois.l2_error(ts, res.x) < 1.0 / 8**2


def test_mg_restrict_is_prolong_transpose():
    js, ts, *_ = _poisson(8)
    th = tmg.MGHierarchy.build(ts, lambda s: tasm.assemble_system(s, tpois.poisson_system, {})[0],
                               min_nel=4)
    rng = np.random.default_rng(1)
    xc = torch.as_tensor(rng.normal(size=(th.spaces[0].nnodes, 1)))
    xf = torch.as_tensor(rng.normal(size=(ts.nnodes, 1)))
    lhs = float((th.prolong(0, xc) * xf).sum())
    rhs = float((xc * th.restrict(0, xf)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


# ------------------------------------------------------------- EBE and BBB


def _element_blocks(jsp, tsp, jsys, tsys, jctx, tctx):
    """Per-element Dirichlet-fixed blocks (nel, nen·dof, nen·dof) in both
    packages, held to each other."""
    nen, dof = jsp.nen, jsp.dof
    ids = jnp.arange(jsp.nel)
    pb = jtab(jsp, ids, order=1)

    def body(acc, pt, w):
        K, _ = jax.vmap(lambda p: jsys(p, jctx))(pt)
        K = jax.vmap(lambda k: jasm._normalize_K(k, nen, dof, F64))(K)
        return acc + w[:, None, None] * K

    Ke = jasm._scan_points(pb, body, jnp.zeros((jsp.nel, nen * dof, nen * dof), F64))
    m, v = jasm._fix_arrays(jsp, jsp.device("mapping")[ids])
    jKe, _ = jasm._fix_system(Ke, jnp.zeros((jsp.nel, nen * dof), F64), m, v)
    element_KF = tasm._make_element_KF(tsp, tctx, 1, True)
    tKe = element_KF(torch.arange(tsp.nel), None, tsys)[0]
    tKe = tKe.permute(0, 1, 3, 2, 4).reshape(tsp.nel, nen * dof, nen * dof)
    assert _rel(tKe, jKe) <= RTOL
    return jKe, tKe


def test_ebe():
    """EBE with the reference's pseudo-inverse cut-off on elasticity,
    whose element matrices are singular (rigid-body modes), so the
    cut-off decides the result."""
    js, ts, jA, jb, tA, tb = _elastic(4)
    ctx = {"lambda": 2.0, "mu": 1.0}
    jKe, tKe = _element_blocks(js, ts, jel.elasticity_system, tel.elasticity_system, ctx, ctx)
    jM = jbpc.ebe_preconditioner(js, jKe)
    tM = tbpc.ebe_preconditioner(ts, tKe)
    assert _same_application(jM, tM, ts.nnodes, ts.dof) <= RTOL
    # the EBE-CG residual falls from 8e-4 to about 2e-11 in its 8th
    # iteration, where rounding alone sets the value; rtol 1e-9 keeps the
    # stopping test off that value
    _same_solve("cg", jA, jb, jM, tA, tb, tM, rtol=1e-9)


@pytest.mark.parametrize("model,overlap", [("elasticity", 1), ("poisson", 2)])
def test_bbb(model, overlap):
    js, ts, jA, jb, tA, tb = (_elastic(4) if model == "elasticity"
                              else _poisson(8, periodic=model == "periodic"))
    jM = jbpc.bbb_preconditioner(jA, overlap=overlap)
    tM = tbpc.bbb_preconditioner(tA, overlap=overlap)
    assert _same_application(jM, tM, ts.nnodes, ts.dof) <= RTOL
    if model == "elasticity":
        _same_solve("bicgstab", jA, jb, jM, tA, tb, tM)


# ------------------------------------------------------------- field split


def test_field_split_blocks():
    """The diagonal sub-operators are the reference's slices, and each
    equals the full operator on single-field vectors."""
    js, ts, jA, jb, tA, tb = _elastic(4)
    x = torch.as_tensor(_probe(ts.nnodes, 2, 3))
    for f, (sub, jsub) in enumerate(zip(tfs.field_split(tA), jfs.field_split(jA))):
        assert _rel(sub.data, jsub.data) <= RTOL
        xf = torch.zeros_like(x)
        xf[:, f] = x[:, f]
        np.testing.assert_allclose(sub.matvec(x[:, f:f + 1])[:, 0], tA.matvec(xf)[:, f],
                                   atol=1e-12)


@pytest.mark.parametrize("kind,groups", [("additive", None), ("multiplicative", None),
                                         ("multiplicative", [(1,), (0,)])])
def test_fieldsplit(kind, groups):
    js, ts, jA, jb, tA, tb = _elastic(4)
    jM = jfs.fieldsplit_preconditioner(jA, groups=groups, kind=kind)
    tM = tfs.fieldsplit_preconditioner(tA, groups=groups, kind=kind)
    assert _same_application(jM, tM, ts.nnodes, 2) <= RTOL
    if groups is None:
        _same_solve("cg" if kind == "additive" else "bicgstab", jA, jb, jM, tA, tb, tM)


def test_fieldsplit_rectangular_coupling():
    """Groups of unequal size: the (0,1) × (2,) coupling blocks of a
    seeded dof 3 operator (diagonally dominated, so Jacobi is defined)."""
    jst = JStencil(node_shape=(6, 5), widths=(1, 1), periodic=(False, False), dof=3)
    data = interop.random_stencil_data(jst, 5)
    data[:, 4] += 20.0 * np.eye(3)  # the diagonal slot
    jA = JStencilMatrix(jst, jnp.asarray(data))
    tA = StencilMatrix(interop.as_stencil(jst), torch.as_tensor(data))
    jM = jfs.fieldsplit_preconditioner(jA, groups=[(0, 1), (2,)], kind="multiplicative")
    tM = tfs.fieldsplit_preconditioner(tA, groups=[(0, 1), (2,)], kind="multiplicative")
    assert _same_application(jM, tM, jst.nnodes, 3) <= RTOL


# ----------------------------------------------------------------- Schwarz


def test_subdomain_boxes():
    starts, sizes = tsch.subdomain_boxes((25, 17), (4, 3))
    js, jz = jsch.subdomain_boxes((25, 17), (4, 3))
    for a, b in zip(starts + sizes, js + jz):
        np.testing.assert_array_equal(a, b)
    for st, sz, n in zip(starts, sizes, (25, 17)):
        assert st[0] == 0 and st[-1] + sz[-1] == n


# (model, options, the solver of the one case solved in both packages)
SCHWARZ = {
    # unequal boxes (10 nodes into 3) at overlap == p: table entries past
    # the shorter extended boxes stay clamped and masked
    "constants-unequal-boxes": ("poisson", dict(subdomains=(2, 3), overlap=2), None),
    "restricted": ("poisson", dict(subdomains=(2, 2), overlap=1, restricted=True), "bicgstab"),
    "periodic": ("periodic", dict(subdomains=(2, 2)), None),
    "rigid-body": ("elasticity", dict(subdomains=(2, 2), rbm=True), "cg"),
}


@pytest.mark.parametrize("case", list(SCHWARZ))
def test_schwarz(case):
    model, kw, solver = SCHWARZ[case]
    kw = dict(kw)
    if model == "elasticity":
        js, ts, jA, jb, tA, tb = _elastic(4)
    else:
        js, ts, jA, jb, tA, tb = _poisson(8, periodic=model == "periodic")
    if kw.pop("rbm", False):
        modes = tel.rigid_body_modes(ts)
        np.testing.assert_array_equal(modes, jel.rigid_body_modes(js))
        kw["coarse_modes"] = modes
    jM = jsch.schwarz_preconditioner(jA, **kw)
    tM = tsch.schwarz_preconditioner(tA, **kw)
    assert _same_application(jM, tM, ts.nnodes, ts.dof) <= RTOL
    if solver is not None:
        _same_solve(solver, jA, jb, jM, tA, tb, tM)


def test_schwarz_block_guard_raises():
    ts = tpois.make_space(2, p=2, nel=62, dtype=torch.float64, device="cpu")
    st = tasm.stencil_of(ts)
    A = StencilMatrix(st, torch.zeros((1, 1, 1, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="max_block"):
        tsch.schwarz_preconditioner(A, subdomains=(1, 1))
