"""The conv engine on mapped geometry and rational (NURBS) weights
against the JAX package, f64 on the CPU: the cases of
``tests/test_convform.py`` (mapped 2-D with variable channels, rational
weights on the identity map, mapped and rational together, mapped 3-D)
plus symmetric storage, mapped in 2-D and mapped-rational in 3-D.

The 2-D cases hold the port's conv planes and load vector to the JAX
package's conv planes (its Pallas planes unpacked, ``conv_min=8`` on both
sides so the boundary boxes convolve too).  Every case holds them to the
port's own pointwise engine on the same space (whose mapped and rational
tabulation is held to the JAX package's in ``test_torch_assembly.py``);
the 3-D cases only so, because the JAX package's 3-D conv assembly under a
map takes 15-30 s to compile on one CPU core.  Tolerance 1e-12 relative
to the largest entry (the engines sum in different orders)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petiga_tpu.assembly.convform import assemble_coefficient_planes as jassemble
from petiga_tpu.models.poisson import make_space as jmake_space
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import convform as tconv
from petiga_tpu_torch.assembly.assemble import assemble_system_planes

TOL = 1e-12


def _curved(js, rational, weights_only=False):
    """The warp of ``tests/test_convform.py:_curved_space``."""
    X = np.asarray(js.greville_coordinates()).copy()
    X[:, 0] = X[:, 0] + 0.08 * np.sin(np.pi * X[:, 1]) * X[:, 0] * (1 - X[:, 0] + 0.5)
    X[:, 1] = X[:, 1] + 0.06 * np.sin(np.pi * X[:, 0])
    W = 1.0 + 0.4 * np.random.default_rng(7).random(js.nnodes) if rational else None
    js.init_geometry(X, W)
    if weights_only:
        js.geometry = None
    return js


def _mapped3d(js):
    G = np.asarray(js.greville_coordinates()).copy()
    G[:, 0] += 0.05 * np.sin(np.pi * G[:, 1]) * np.sin(np.pi * G[:, 2])
    js.init_geometry(G)
    return js


def _coef_mapped(lib):
    def coef(x, ctx):
        return {(1, 1): 1.0 + 0.2 * x[..., 1], (2, 2): 0.8, (0, 0): 0.5,
                (0, 1): 0.3 * x[..., 0]}
    return coef


def _coef_rational(lib):
    def coef(x, ctx):
        return {(1, 1): 1.0, (2, 2): 1.0, (0, 0): 0.3}
    return coef


def _coef_nurbs(lib):
    def coef(x, ctx):
        return {(1, 1): 1.0 + 0.1 * x[..., 0], (2, 2): 0.9, (0, 0): 0.2}
    return coef


def _coef_laplace3(lib):
    def coef(x, ctx):
        return {(i, i): 1.0 for i in range(1, 4)}
    return coef


def _f_mapped(lib):
    return lambda x, ctx: x[..., 0] * x[..., 1] + 1.0


def _f_rational(lib):
    return lambda x, ctx: x[..., 0] + 0.5


def _f_nurbs(lib):
    return lambda x, ctx: lib.sin(x[..., 0])


def _f_sines(lib):
    return lambda x, ctx: 3 * math.pi**2 * lib.prod(lib.sin(math.pi * x), -1)


# name -> (dim, nel, space constructor, coef, forcing, symmetric)
CASES = {
    "mapped2d": (2, 8, lambda s: _curved(s, False), _coef_mapped, _f_mapped, False),
    "rational_identity": (2, 7, lambda s: _curved(s, True, weights_only=True),
                          _coef_rational, _f_rational, False),
    "nurbs": (2, 7, lambda s: _curved(s, True), _coef_nurbs, _f_nurbs, False),
    "mapped3d": (3, 6, _mapped3d, _coef_laplace3, None, False),
    "mapped2d_sym": (2, 8, lambda s: _curved(s, False), _coef_rational, _f_sines, True),
    "nurbs3d_sym": (3, 5, lambda s: _curved3(s), _coef_laplace3, _f_sines, True),
}


def _curved3(js):
    G = np.asarray(js.greville_coordinates()).copy()
    G += 0.05 * np.prod(np.sin(np.pi * G), axis=1)[:, None]
    W = 1.0 + 0.3 * np.prod(np.sin(np.pi * G), axis=1)
    js.init_geometry(G, W)
    return js


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX space, port space, port conv operator, port load vector)."""
    dim, nel, build, coef, forcing, sym = CASES[name]
    js = build(jmake_space(dim, p=2, nel=nel, dtype=jnp.float64))
    ts = interop.space_from_reference(js, device="cpu")
    tf = None if forcing is None else forcing(torch)
    op, b = tconv.assemble_coefficient_planes(ts, coef(torch), None, forcing=tf,
                                              symmetric=sym, conv_min=8)
    return js, ts, op, b


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] == 2])
def test_conv_geometry_matches_reference(name):
    dim, nel, build, coef, forcing, sym = CASES[name]
    js, ts, op, b = _case(name)
    jop, jb = jassemble(js, coef(jnp), None, forcing=None if forcing is None else forcing(jnp),
                        symmetric=sym, conv_min=8, interpret=True)
    ref = interop.operator_from_jax_planes(jop.stencil, np.asarray(jop.DT), align=jop.align,
                                           symmetric=sym, device="cpu")
    assert _rel(op.DT.numpy(), ref.DT.numpy()) <= TOL
    assert _rel(b.numpy(), np.asarray(jb)) <= TOL


@pytest.mark.parametrize("name", list(CASES))
def test_conv_geometry_matches_pointwise(name):
    """The port's conv operator against its own pointwise engine on the
    same space: planes in full storage, products in symmetric storage."""
    _, _, _, coef, forcing, sym = CASES[name]
    _, ts, op, b = _case(name)
    form = tconv.coefficient_pointwise_form(coef(torch),
                                            None if forcing is None else forcing(torch))
    pw, bp = assemble_system_planes(ts, form, None)
    if sym:
        v = torch.as_tensor(np.random.default_rng(3).normal(size=(ts.nnodes, 1)))
        assert _rel(op.matvec(v).numpy(), pw.matvec(v).numpy()) <= TOL
    else:
        assert _rel(op.DT.numpy(), pw.DT.numpy()) <= TOL
    assert _rel(b.numpy(), bp.numpy()) <= TOL


def test_geometry_restrictions_raise():
    """What the reference refuses under a map, the port refuses too: the
    standalone load vector and residual, second-derivative channels and
    state fields."""
    ts = _case("mapped2d")[1]
    with pytest.raises(ValueError, match="identity map"):
        tconv.assemble_load_vector(ts, _f_mapped(torch))
    with pytest.raises(ValueError, match="identity map"):
        tconv.assemble_residual_conv(ts, lambda x, ctx: {0: 1.0})
    with pytest.raises(ValueError, match="identity map"):
        tconv.assemble_coefficient_planes(ts, lambda x, ctx: {((0, 0), 0): 1.0})
    with pytest.raises(ValueError, match="identity map"):
        tconv.assemble_coefficient_planes(ts, lambda x, ctx, fe: {(0, 0): fe["u"]},
                                          fields={"u": torch.zeros(ts.nnodes)})
