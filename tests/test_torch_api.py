"""The port's flat API (``petiga_tpu_torch/__init__.py``) and the operator
surface it names — ``StencilMatrix.zeros``, ``StencilOperator.from_matrix``
/ ``from_symmetric``, ``@``, ``stencil``, ``data``, ``stencil_matvec`` —
against the JAX package on the CPU in float64 (the reference's Pallas
operator in interpret mode, as tests/test_pallas_spmv.py runs it)."""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petiga_tpu
import petiga_tpu_torch
from petiga_tpu.sparse import stencil as jstencil
from petiga_tpu.sparse.pallas_spmv import PallasStencilOperator
from petiga_tpu_torch import interop
from petiga_tpu_torch.sparse.spmv import StencilOperator, stencil_matvec
from petiga_tpu_torch.sparse.stencil import Stencil, StencilMatrix, SymmetricStencilMatrix

REF_INIT = pathlib.Path(petiga_tpu.__file__)


def _reference_flat_names():
    """(name, reference module) of every import of the reference's
    ``__init__.py``."""
    tree = ast.parse(REF_INIT.read_text())
    return [(a.asname or a.name, node.module)
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def test_every_reference_name_resolves_to_the_mirroring_port_module():
    names = _reference_flat_names()
    assert sorted(n for n, _ in names) == sorted(petiga_tpu.__all__)
    renames = petiga_tpu_torch._RENAMES
    assert renames == {"PallasStencilOperator": "StencilOperator",
                       "pallas_matvec": "stencil_matvec"}
    for name, module in names:
        port_name = renames.get(name, name)
        port_module = module.replace("pallas_spmv", "spmv")
        mod = importlib.import_module(f"petiga_tpu_torch.{port_module}")
        want = mod if port_module.endswith(f".{port_name}") else getattr(mod, port_name)
        assert getattr(petiga_tpu_torch, port_name) is want, name
        assert port_name in petiga_tpu_torch.__all__
    assert petiga_tpu_torch.__version__ == petiga_tpu.__version__ == "0.2.0"
    with pytest.raises(AttributeError):
        petiga_tpu_torch.PallasStencilOperator  # noqa: B018 - the port's name differs


def test_star_import_gives_the_flat_api():
    ns = {}
    exec("from petiga_tpu_torch import *", ns)
    for name in petiga_tpu_torch.__all__:
        assert name in ns, name


def test_reference_quickstart_in_both_packages():
    """The quickstart of ``petiga_tpu/__init__.py:9-22`` at 2-D nel 8 in
    float64: the same CG count, the solutions to 1e-12."""
    from petiga_tpu import Axis as JAxis, Space as JSpace, assemble_system as jasm, cg as jcg
    from petiga_tpu_torch import Axis, Space, assemble_system, cg

    jsp = JSpace([JAxis.uniform(p=2, nel=8)] * 2, dtype=jnp.float64)
    jsp.set_boundary_value(0, 0, 0, 0.0)

    def jlaplace(pt, ctx):
        return pt.shape1 @ pt.shape1.T, pt.shape0

    jA, jb = jasm(jsp, jlaplace)
    jx, jiters, jres = jcg(jA.fast_operator(), jb)

    sp = Space([Axis.uniform(p=2, nel=8)] * 2, dtype=torch.float64, device="cpu")
    sp.set_boundary_value(0, 0, 0, 0.0)

    def laplace(pt, ctx):
        return pt.shape1 @ pt.shape1.T, pt.shape0

    A, b = assemble_system(sp, laplace)
    x, iters, res = cg(A.fast_operator(), b)
    assert int(iters) == int(jiters)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12)


def test_stencil_matrix_zeros(monkeypatch):
    st = Stencil(node_shape=(5, 4), widths=(2, 1), periodic=(False, True), dof=2)
    Z = StencilMatrix.zeros(st, dtype=torch.float64, device="cpu")
    J = jstencil.StencilMatrix.zeros(st, dtype=jnp.float64)
    assert tuple(Z.data.shape) == J.data.shape == (20, 15, 2, 2)
    assert Z.data.dtype == torch.float64 and Z.data.device.type == "cpu"
    assert not Z.data.any() and Z.stencil is st
    assert StencilMatrix.zeros(st, device="cpu").data.dtype == torch.float32
    x = torch.ones(st.nnodes, 2, dtype=torch.float64)
    assert not Z.matvec(x).any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        StencilMatrix.zeros(st)


CASES = {
    "3d-open": ((5, 4, 6), (2, 2, 2), (False,) * 3, 1),
    "2d-periodic-dof2": ((7, 6), (2, 2), (True, False), 2),
    "2d-open-p3-dof3": ((8, 7), (3, 1), (False, False), 3),
}


@pytest.mark.parametrize("case", CASES)
def test_from_matrix_and_stencil_matvec_match_pallas(case):
    shape, widths, periodic, dof = CASES[case]
    st = Stencil(node_shape=shape, widths=widths, periodic=periodic, dof=dof)
    data = interop.random_stencil_data(st, seed=len(case))
    x = np.random.default_rng(1).normal(size=(st.nnodes, dof))
    jA = jstencil.StencilMatrix(st, jnp.asarray(data))
    jop = PallasStencilOperator(jA, interpret=True)
    y_ref = np.asarray(jop.matvec(jnp.asarray(x)))

    A = StencilMatrix(st, torch.as_tensor(data))
    op = StencilOperator.from_matrix(A)
    assert op.kind == "full" and op.stencil is st and op.data is A.data
    xt = torch.as_tensor(x)
    np.testing.assert_allclose((op @ xt).numpy(), y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(stencil_matvec(A, xt).numpy(), y_ref, rtol=0, atol=1e-12)
    # the flat vector form, and fast_operator on the same packing path,
    # which does not keep the source matrix alive
    np.testing.assert_allclose((op @ xt.reshape(-1)).numpy(), y_ref.reshape(-1), atol=1e-12)
    fast = A.fast_operator()
    np.testing.assert_array_equal(fast.DT.numpy(), op.DT.numpy())
    assert fast.data is None and fast.A is None


@pytest.mark.parametrize("case", ["3d-open", "2d-open-p3-dof3"])
def test_from_symmetric_matches_pallas(case):
    shape, widths, periodic, dof = CASES[case]
    st = Stencil(node_shape=shape, widths=widths, periodic=periodic, dof=dof)
    data = interop.random_stencil_data(st, seed=7, symmetric=True)
    x = np.random.default_rng(2).normal(size=(st.nnodes, dof))
    jS = jstencil.SymmetricStencilMatrix(st, jnp.asarray(data))
    y_ref = np.asarray(PallasStencilOperator.from_symmetric(jS, interpret=True)
                       .matvec(jnp.asarray(x)))

    S = SymmetricStencilMatrix(st, torch.as_tensor(data))
    op = StencilOperator.from_symmetric(S)
    assert op.kind == "sym" and op.stencil is st and op.data is S.data
    xt = torch.as_tensor(x)
    np.testing.assert_allclose((op @ xt).numpy(), y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(stencil_matvec(S, xt).numpy(), y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(S.matvec(xt).numpy(), y_ref, rtol=0, atol=1e-12)


def test_operator_from_planes_has_no_data_and_sym_rejects_periodic():
    st = Stencil(node_shape=(6, 5), widths=(2, 2), periodic=(True, False), dof=1)
    A = StencilMatrix(st, torch.as_tensor(interop.random_stencil_data(st, seed=3)))
    op = StencilOperator.from_matrix(A)
    assert StencilOperator.from_planes(st, op.DT).data is None
    S = SymmetricStencilMatrix(st, A.data[:, st.diag_slot:])
    with pytest.raises(ValueError, match="open axes"):
        StencilOperator.from_symmetric(S)
    assert S.fast_operator().kind == "full"  # periodic: expanded to full storage
