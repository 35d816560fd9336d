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
    ts = TSpace([TAxis.uniform(p=p, nel=nel, periodic=q) for q in per], dtype=torch.float64)
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
    ts = tpoisson.make_space(dim, p=2, nel=nel, dtype=torch.float64)
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
