"""Port host setup (petiga_tpu_torch.core) against the JAX package: the
numpy tables are bit-identical, and the port never imports jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.assembly import convform as jconv
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.basis import tabulate as jtabulate
from petiga_tpu.core.quadrature import Rule as JRule
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import poisson as jpoisson
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.assembly import convform as tconv
from petiga_tpu_torch.core.axis import Axis as TAxis
from petiga_tpu_torch.core.basis import tabulate as ttabulate
from petiga_tpu_torch.core.quadrature import Rule as TRule
from petiga_tpu_torch.core.space import Space as TSpace
from petiga_tpu_torch.models import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (p, nel, continuity, periodic)
AXES = [(1, 3, None, False), (2, 5, None, False), (2, 6, 0, False),
        (3, 4, None, True), (2, 7, 1, True)]


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("p,nel,C,per", AXES)
def test_axis_rule_tabulation_bit_identical(p, nel, C, per):
    ja = JAxis.uniform(p=p, nel=nel, continuity=C, periodic=per)
    ta = TAxis.uniform(p=p, nel=nel, continuity=C, periodic=per)
    assert _same(ja.U, ta.U) and ja.nnp == ta.nnp and _same(ja.spans, ta.spans)
    assert _same(ja.greville(), ta.greville())
    for kind in ("legendre", "lobatto"):
        jr, tr = JRule.make(kind, p + 1), TRule.make(kind, p + 1)
        assert _same(jr.points, tr.points) and _same(jr.weights, tr.weights)
        jt, tt = jtabulate(ja, jr), ttabulate(ta, tr)
        for f in dataclasses.fields(jt):
            assert _same(getattr(jt, f.name), getattr(tt, f.name)), f.name


@pytest.mark.parametrize("dim,p,nel,per", [(2, 2, 5, (False, True)), (3, 2, 4, (False,) * 3),
                                           (1, 3, 6, (True,))])
def test_factor_and_fine_mats_bit_identical(dim, p, nel, per):
    js = JSpace([JAxis.uniform(p=p, nel=nel, periodic=q) for q in per], dtype=jnp.float64)
    ts = TSpace([TAxis.uniform(p=p, nel=nel, periodic=q) for q in per], dtype=torch.float64, device="cpu")
    jf, tf = jconv._axis_factor_mats(js, jnp.float64), tconv._axis_factor_mats(ts, torch.float64)
    for d in range(dim):
        for da in range(3):
            for db in range(3):
                assert _same(jf[d][da][db], tf[d][da][db].numpy())
    jb, tb = jconv._fine_basis_mats(js, jnp.float64), tconv._fine_basis_mats(ts, torch.float64)
    for d in range(dim):
        for k in range(3):
            assert _same(jb[d][k], tb[d][k].numpy())


@pytest.mark.parametrize("dim,nel", [(2, 5), (3, 3)])
def test_space_tables_and_multiplicity(dim, nel):
    js = jpoisson.make_space(dim, p=2, nel=nel, dtype=jnp.float64)
    ts = tpoisson.make_space(dim, p=2, nel=nel, dtype=torch.float64, device="cpu")
    assert js.node_shape == ts.node_shape and js.elem_shape == ts.elem_shape
    jm, jv = js.dirichlet_mask()
    tm, tv = ts.dirichlet_mask()
    assert _same(jm, tm) and _same(jv, tv)
    mask, vals = ts.tensor("dirichlet")
    assert mask.dtype == torch.bool and vals.dtype == torch.float64
    assert _same(mask.numpy(), jm) and _same(vals.numpy(), jv)
    jasm._MULT_CACHE.pop(id(js), None)  # keyed by id(): drop a stale entry
    assert _same(jasm._node_multiplicity(js), tasm._node_multiplicity(ts).numpy())
    assert all(_same(a, b) for a, b in zip(js.axis_node_index, ts.axis_node_index))


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import petiga_tpu_torch, petiga_tpu_torch.interop\n"
        "import petiga_tpu_torch.models.poisson, petiga_tpu_torch.sparse._build\n"
        "import petiga_tpu_torch.native\n"
        "from petiga_tpu_torch import *\n"
        "for name in petiga_tpu_torch.__all__: getattr(petiga_tpu_torch, name)\n"
        "import petiga_tpu_torch.examples.poisson, petiga_tpu_torch.examples.bratu\n"
        "import petiga_tpu_torch.examples.cahnhilliard, petiga_tpu_torch.examples.elasticity\n"
        "import petiga_tpu_torch.examples.hyperelasticity\n"
        "import petiga_tpu_torch.examples.distributed\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'petiga_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------- default device, Space


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """With no ``device`` every entry point asks for the CUDA device and
    raises when there is none; it never builds on the CPU by itself."""
    import petiga_tpu_torch
    from petiga_tpu_torch import entry, interop
    from petiga_tpu_torch.sparse.spmv import StencilOperator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        petiga_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpoisson.make_space(3, nel=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TSpace([TAxis.uniform(p=1, nel=2)])
    st = tasm.stencil_of(tpoisson.make_space(2, nel=2, device="cpu"))
    data = interop.random_stencil_data(st, 0)
    for build in (lambda: StencilOperator(st),
                  lambda: interop.operator_from_stencil_data(st, data),
                  lambda: interop.operator_from_jax_planes(st, data.reshape(st.K, -1)),
                  lambda: entry.entry()):
        with pytest.raises(RuntimeError, match="CUDA device"):
            build()
    assert petiga_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert petiga_tpu_torch.default_device() == torch.device("cuda")


@pytest.mark.parametrize("kind", ["open-3d", "periodic-C0-2d"])
def test_space_index_maps_and_views(kind):
    from petiga_tpu_torch import interop

    if kind == "open-3d":
        js = JSpace([JAxis.uniform(p=2, nel=3), JAxis.uniform(p=1, nel=4),
                     JAxis.uniform(p=2, nel=2)], dof=2, dtype=jnp.float64)
    else:
        js = JSpace([JAxis.uniform(p=2, nel=5, periodic=True),
                     JAxis.uniform(p=2, nel=3, continuity=0)], dof=2, nsd=3,
                    dtype=jnp.float64)
    rng = np.random.default_rng(0)
    js.init_geometry(rng.normal(size=(js.nnodes, js.nsd)), rng.uniform(1, 2, js.nnodes))
    js.set_property(rng.normal(size=(js.nnodes, 3)))
    js.set_fix_table(rng.normal(size=(js.nnodes, 2)))
    js.set_boundary_value(1, 0, 1, 0.5).set_boundary_load(1, 1, 0, 2.0)
    js.set_boundary_form(1, 1)
    ts = interop.space_from_reference(js, device="cpu")
    assert ts.has_geometry and ts.is_rational and ts.nsd == js.nsd and ts.order == js.order
    assert (ts.nen, ts.nqp, ts.ndofs) == (js.nen, js.nqp, js.ndofs)
    assert ts.nen_shape == js.nen_shape and ts.nqp_shape == js.nqp_shape
    assert _same(ts.mapping, js.mapping) and ts.mapping.dtype == np.int32
    ids = np.array([0, js.nel - 1, js.nel // 2])
    assert _same(ts.device_emap(torch.as_tensor(ids)).numpy(), js.mapping[ids])
    assert _same(ts.element_nodes(ids), js.mapping[ids])
    assert _same(ts.tensor("mapping").numpy(), js.mapping)
    assert all(_same(a, b) for a, b in zip(ts.node_multi_index(), js.node_multi_index()))
    assert _same(ts.greville_coordinates(), js.greville_coordinates())
    assert _same(ts.flux_vector(), js.flux_vector())
    assert ts.bc_visit == js.bc_visit
    for a, b in zip(ts.dirichlet_mask(), js.dirichlet_mask()):
        assert _same(a, b)
    for key in ("geometry", "rational", "property"):
        assert _same(ts.tensor(key).numpy(), getattr(js, key))
    for key in ("tabs_value", "tabs_weight", "tabs_detJac", "tabs_point", "tabs_bnd_value"):
        assert all(_same(t.numpy(), j) for t, j in zip(ts.tensor(key), js.device(key)))
    with pytest.raises(KeyError):
        ts.tensor("nope")
    per = TSpace([TAxis.uniform(p=1, nel=2, periodic=True)], device="cpu")
    with pytest.raises(ValueError, match="periodic axis"):
        per.set_boundary_load(0, 0, 0, 1.0)
    with pytest.raises(ValueError, match="side"):
        ts.set_boundary_form(1, 2)
    cl = ts.clone(dof=1, dtype=torch.float32, nsd=ts.dim)
    assert (cl.dof, cl.dtype, cl.nsd, cl.device) == (1, torch.float32, ts.dim, ts.device)
    assert cl.rules == ts.rules and not cl.has_geometry and cl.tabs[0].nel == ts.tabs[0].nel
    # setters drop the cached tensors
    ts.set_property(np.zeros((ts.nnodes, 1)))
    assert ts.tensor("property").shape == (ts.nnodes, 1)
