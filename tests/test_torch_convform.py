"""The port's conv engine against the JAX package's, f64 on the CPU, on
the same spaces and seeded states: variable-coefficient channels on open
and periodic axes, second-derivative channels (the biharmonic and the
Cahn–Hilliard Jacobian), state ``fields``, and the residual conv
(``assemble_residual_conv``), each through the convolution branch
(``conv_min=1``) and through the generic boxes (``conv_min`` above the
element count), in 2-D and in one 3-D case per feature.

The planes are compared with the JAX package's kernel planes read into
the port's layout (periodic halos included) at 1e-12 relative: both sum
the same products in another order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly import convform as jconv
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import bratu as jbratu
from petiga_tpu.models import cahnhilliard as jch
from petiga_tpu_torch import interop
from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.assembly import convform as tconv
from petiga_tpu_torch.models import bratu as tbratu
from petiga_tpu_torch.models import cahnhilliard as tch

F64 = jnp.float64
GEN = 10**9  # a conv_min no box reaches: every box takes the generic path


def _pair(dim, nel, per, order=None):
    js = JSpace([JAxis.uniform(p=2, nel=nel, periodic=per[d]) for d in range(dim)],
                dtype=F64, order=order)
    return js, interop.space_from_reference(js, device="cpu")


def _planes_rel(op, jop):
    ref = interop.planes_from_reference(jop, device="cpu")
    assert op.DT.shape == ref.DT.shape and op.kind == ref.kind
    return float((op.DT - ref.DT).abs().max() / ref.DT.abs().max())


def _variable(xp):
    def coef(x, ctx):
        return {(1, 1): 1.0 + 0.3 * xp.sin(2 * np.pi * x[..., 0]), (2, 2): 0.8,
                (0, 0): 0.4 + 0.1 * x[..., 1], (1, 2): 0.2 * x[..., 0], (0, 1): ctx["a"]}
    return coef


@pytest.mark.parametrize("per,conv_min", [((True, False), 1), ((True, True), 1),
                                          ((True, False), GEN)])
def test_variable_coefficients(per, conv_min):
    """Periodic and mixed axes, conv and generic routes (open axes: the
    chunked test below)."""
    js, ts = _pair(2, 6, per)
    jop, _ = jconv.assemble_coefficient_planes(js, _variable(jnp), {"a": 0.25}, apply_fix=False,
                                               interpret=True, conv_min=conv_min)
    op, _ = tconv.assemble_coefficient_planes(ts, _variable(torch), {"a": 0.25},
                                              apply_fix=False, conv_min=conv_min)
    assert _planes_rel(op, jop) <= 1e-12


def test_variable_coefficients_chunked_with_fix_and_forcing(monkeypatch):
    """Open axes with Dirichlet data: every type-combo box convolves, the
    interior one in several slowest-axis chunks; the post-fix and the
    (sum-factorized) load vector."""
    js = jbratu.make_space(2, p=2, nel=7, dtype=F64)
    ts = interop.space_from_reference(js, device="cpu")
    monkeypatch.setattr(tconv, "_CONV_CHUNK_BYTES", 4096)
    boxes, gen = tconv._boxes(ts, 1)
    assert not gen and len(tconv._conv_tasks(ts, boxes, 8 * 8)) > len(boxes)

    def force(x, ctx):
        return (jnp if not torch.is_tensor(x) else torch).cos(3 * x[..., 0]) * x[..., 1]

    jop, jb = jconv.assemble_coefficient_planes(js, _variable(jnp), {"a": 0.1},
                                                forcing=force, interpret=True, conv_min=1)
    op, b = tconv.assemble_coefficient_planes(ts, _variable(torch), {"a": 0.1},
                                              forcing=force, conv_min=1)
    assert _planes_rel(op, jop) <= 1e-12
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jb)).max())


@pytest.mark.parametrize("per,symmetric,const_outer", [
    (False, False, True), (False, False, False), (False, True, False), (True, False, True),
    (True, False, False),
])
def test_order2_biharmonic(per, symmetric, const_outer):
    """∫ Δw Δv + c w v: second-derivative channels through the
    outer-product write and the convolution, symmetric storage on open
    axes."""
    def coef(x, ctx):
        ch = {(0, 0): 0.7}
        for d in range(2):
            for e in range(2):
                ch[((d, d), (e, e))] = 1.0
        return ch

    js, ts = _pair(2, 6, (per, per))
    jop, _ = jconv.assemble_coefficient_planes(js, coef, apply_fix=False, interpret=True,
                                               conv_min=1, const_outer=const_outer,
                                               symmetric=symmetric)
    op, _ = tconv.assemble_coefficient_planes(ts, coef, apply_fix=False, conv_min=1,
                                              const_outer=const_outer, symmetric=symmetric)
    assert _planes_rel(op, jop) <= 1e-12


@pytest.mark.parametrize("dim,nel,conv_min", [(2, 5, 1), (3, 3, 1)])
def test_cahnhilliard_jacobian(dim, nel, conv_min):
    """The CH Jacobian (order-2 channels, value/gradient/Hessian fields,
    periodic C¹, the α-scheme mass channel) against the JAX package's
    conv planes and the port's AD planes.  (The generic route of this
    Jacobian is the one ``run_conv`` takes on the small meshes of
    ``test_torch_cahnhilliard.py``.)"""
    js = jch.make_space(dim, nel=nel, dtype=F64)
    ts = interop.space_from_reference(js, device="cpu")
    rng = np.random.default_rng(12)
    C = 0.5 + 0.2 * np.sin(2 * np.pi * rng.random((js.nnodes, 1)))
    ctx = {"theta": 1.5, "alpha": 3000.0, "shift": 7.3, "scale": 0.75}
    jop, _ = jconv.assemble_coefficient_planes(js, jch.jacobian_coefficients, ctx,
                                               fields={"c": (jnp.asarray(C), 2)},
                                               apply_fix=False, interpret=True,
                                               conv_min=conv_min)
    op, _ = tconv.assemble_coefficient_planes(ts, tch.jacobian_coefficients, ctx,
                                              fields={"c": (torch.as_tensor(C), 2)},
                                              apply_fix=False, conv_min=conv_min)
    assert _planes_rel(op, jop) <= 1e-12
    if dim == 2 and conv_min == 1:
        def fres(pt, ue, c):
            return (0.75 * tch.residual(pt, 0.0, torch.zeros_like(ue), 0.0, ue, c)
                    + 7.3 * pt.value(ue)[0] * pt.shape0)

        J = tasm.assemble_jacobian(ts, fres, torch.as_tensor(C), ctx, order=2)
        ad = J.fast_operator()
        assert float((op.DT - ad.DT).abs().max() / ad.DT.abs().max()) <= 1e-12


def test_field_coefficients_bratu_jacobian():
    """A state-dependent reaction channel on open axes with Dirichlet
    rows: the conv Jacobian, post-fixed, against the JAX package's and
    against the AD Jacobian; a second assembly with new field values
    reuses the cached static tables and rebuilds none."""
    js = jbratu.make_space(2, p=2, nel=6, dtype=F64)
    ts = interop.space_from_reference(js, device="cpu")
    rng = np.random.default_rng(7)
    U = rng.normal(scale=0.1, size=(js.nnodes, 1))
    U[np.asarray(js.device("dirichlet")[0])[:, 0]] = 0.0
    ctx = {"lambda": 1.5}
    jop, _ = jconv.assemble_coefficient_planes(js, jbratu.bratu_jacobian_coefficients, ctx,
                                               fields={"u": jnp.asarray(U).reshape(-1)},
                                               apply_fix=False, interpret=True, conv_min=1)
    op, _ = tconv.assemble_coefficient_planes(ts, tbratu.bratu_jacobian_coefficients, ctx,
                                              fields={"u": torch.as_tensor(U).reshape(-1)},
                                              apply_fix=False, conv_min=1)
    assert _planes_rel(op, jop) <= 1e-12
    tables = set(ts._tensor_cache)
    op2, _ = tconv.assemble_coefficient_planes(ts, tbratu.bratu_jacobian_coefficients, ctx,
                                               fields={"u": torch.as_tensor(2 * U).reshape(-1)},
                                               apply_fix=False, conv_min=1)
    assert set(ts._tensor_cache) == tables and not torch.equal(op2.DT, op.DT)
    zero = torch.zeros((ts.nnodes, 1), dtype=torch.float64)
    op, _ = tasm.dirichlet_post_fix_homogeneous(ts, op, zero)
    J = tasm.assemble_jacobian(ts, tbratu.bratu_residual, torch.as_tensor(U), ctx)
    x = torch.as_tensor(rng.normal(size=(ts.nnodes, 1)))
    y = J.matvec(x)
    assert float((op.matvec(x) - y).abs().max() / y.abs().max()) <= 1e-12


def _res_coefs(xp, dim):
    def coefs(x, ctx):
        ch = {0: xp.sin(np.pi * x[..., 0]) * ctx["a"]}
        for d in range(dim):
            ch[d + 1] = xp.cos(np.pi * x[..., d]) + 0.3 * d
            ch[(d, d)] = 0.1 + 0.05 * x[..., 0]
        return ch
    return coefs


@pytest.mark.parametrize("dim,nel,per,conv_min", [
    (1, 8, True, 1), (2, 6, False, 1), (2, 6, True, 1), (2, 6, True, GEN), (3, 3, True, 1),
])
def test_residual_conv(dim, nel, per, conv_min):
    js, ts = _pair(dim, nel, (per,) * dim, order=2)
    jctx = {"a": jnp.float64(1.3)}
    b = tconv.assemble_residual_conv(ts, _res_coefs(torch, dim),
                                     interop.state_from_reference(jctx), conv_min=conv_min)
    jb = jconv.assemble_residual_conv(js, _res_coefs(jnp, dim), jctx, conv_min=conv_min)
    jb = np.asarray(jb)
    assert np.abs(b.numpy() - jb).max() <= 1e-12 * np.abs(jb).max()


def test_residual_conv_state_fields_cahnhilliard():
    """The full CH residual (value/grad/Hessian fields) by test channels
    equals the JAX package's and the port's pointwise residual."""
    conv_min = 1
    js = jch.make_space(2, nel=6)
    ts = interop.space_from_reference(js, device="cpu")
    U = np.asarray(jch.initial_condition(js, seed=2))
    V = 0.1 * np.asarray(jch.initial_condition(js, seed=5))
    ctx = {"theta": 1.5, "alpha": 3000.0}
    jb = np.asarray(jconv.assemble_residual_conv(
        js, jch.residual_channels, ctx, conv_min=conv_min,
        fields={"c": (jnp.asarray(U).reshape(-1), 2), "ct": (jnp.asarray(V).reshape(-1), 0)}))
    Ut, Vt = torch.as_tensor(U), torch.as_tensor(V)
    b = tconv.assemble_residual_conv(ts, tch.residual_channels, ctx, conv_min=conv_min,
                                     fields={"c": (Ut.reshape(-1), 2), "ct": (Vt.reshape(-1), 0)})
    scale = np.abs(jb).max()
    assert np.abs(b.numpy() - jb).max() <= 1e-12 * scale

    def form(pt, Xe, aux_e, c):
        return tch.residual(pt, 1.0, aux_e["V0"], 0.0, Xe, c)

    bp = tasm.assemble_function(ts, form, Ut, ctx, aux={"V0": Vt})
    assert float((b - bp).abs().max()) <= 1e-12 * scale


def test_periodic_poisson_outer_and_load():
    """Constant coefficients on periodic axes: the outer-product write
    into the extended layout and the periodic load vector."""
    js, ts = _pair(2, 7, (True, False))

    def force(x, ctx):
        return (jnp if not torch.is_tensor(x) else torch).cos(2 * np.pi * x[..., 0])

    jop, jb = jconv.assemble_coefficient_planes(js, jconv.poisson_coefficients,
                                                {"c": 0.3, "k": 1.2}, forcing=force,
                                                apply_fix=False, interpret=True)
    op, b = tconv.assemble_coefficient_planes(ts, tconv.poisson_coefficients,
                                              {"c": 0.3, "k": 1.2}, forcing=force,
                                              apply_fix=False)
    assert _planes_rel(op, jop) <= 1e-12
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_conv_is_the_padded_correlation(dim):
    """The engine's per-tap GEMM convolution computes the padded
    element-tap correlation of ``torch.nn.functional.conv{1,2,3}d`` (which
    it replaces because cuDNN rounds it 20× worse in f32 on the card)."""
    rng = np.random.default_rng(dim)
    W = torch.as_tensor(rng.normal(size=(6,) + (5, 4, 3)[:dim]))
    ker = torch.as_tensor(rng.normal(size=(4, 6) + (3, 2, 3)[:dim]))
    p = (2, 1, 2)[:dim][::-1]
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d,
            torch.nn.functional.conv3d)[dim - 1]
    ref = conv(W[None], ker, padding=tuple(p[::-1]))[0]
    out = tconv._conv(W, ker, p)
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("conv_min", [1, GEN])
def test_empty_fields_call_the_three_argument_spec(conv_min):
    """``fields={}`` means a ``coef(x, ctx, fe)`` spec on every route (the
    probe, the conv boxes and the generic boxes): the Poisson planes."""
    _, ts = _pair(2, 4, (False, True))
    ref, _ = tconv.assemble_coefficient_planes(ts, tconv.poisson_coefficients, {"c": 0.5},
                                               apply_fix=False, const_outer=False,
                                               conv_min=conv_min)

    def coef3(x, ctx, fe):
        assert fe == {}
        return tconv.poisson_coefficients(x, ctx)

    op, _ = tconv.assemble_coefficient_planes(ts, coef3, {"c": 0.5}, fields={},
                                              apply_fix=False, conv_min=conv_min)
    assert torch.equal(op.DT, ref.DT)


def _elastic_like(xp):
    """dof 2 channel blocks: constant elasticity-like (2, 2) blocks on the
    gradient channels and a varying mass block (the reference's
    test_conv_dof2_blocks spec)."""
    def coef(x, ctx):
        lam, mu = 1.2, 0.7
        ch = {}
        for i in range(1, 3):
            for j in range(1, 3):
                C = np.zeros((2, 2))
                C[i - 1, j - 1] += lam
                if i == j:
                    C[0, 0] += mu
                    C[1, 1] += mu
                C[j - 1, i - 1] += mu
                ch[(i, j)] = C if xp is jnp else torch.as_tensor(C)
        m = 0.3 + x[..., 0] * 0.5
        eye = jnp.eye(2) if xp is jnp else torch.eye(2, dtype=x.dtype)
        ch[(0, 0)] = m[..., None, None] * eye
        return ch

    def forcing(x, ctx):
        return xp.stack([xp.sin(np.pi * x[..., 0]), x[..., 1] + 0.2], **(
            {"axis": -1} if xp is jnp else {"dim": -1}))

    return coef, forcing


@pytest.mark.parametrize("conv_min,const_outer", [(8, True), (1, True), (GEN, False)])
def test_conv_dof2_blocks(conv_min, const_outer):
    """dof > 1: (dof, dof) channel blocks, constant and varying, with the
    zero-pattern pruning, per-field forcing and the Dirichlet fix of one
    field, through the convolution and the generic boxes; the port's
    pointwise form of the same spec gives the same planes."""
    js = JSpace([JAxis.uniform(p=2, nel=7) for _ in range(2)], dof=2, dtype=F64)
    for d in range(2):
        for s in range(2):
            js.set_boundary_value(d, s, 0, 0.0)
    ts = interop.space_from_reference(js, device="cpu")
    jcoef, jforce = _elastic_like(jnp)
    tcoef, tforce = _elastic_like(torch)
    jop, jb = jconv.assemble_coefficient_planes(js, jcoef, forcing=jforce, interpret=True,
                                                conv_min=8)
    op, b = tconv.assemble_coefficient_planes(ts, tcoef, forcing=tforce, conv_min=conv_min,
                                              const_outer=const_outer)
    assert _planes_rel(op, jop) <= 1e-12
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-12)
    pw, pb = tasm.assemble_system_planes(ts, tconv.coefficient_pointwise_form(tcoef, tforce))
    assert float((pw.DT - op.DT).abs().max() / op.DT.abs().max()) <= 1e-12
    assert float((pb - b).abs().max()) <= 1e-12


@pytest.mark.parametrize("symmetric", [False, True])
def test_conv_dof3_poisson_vector(symmetric):
    """dof 3 with decoupled diagonal blocks (three Poissons), 3-D: the
    outer-product write of constant blocks, full and symmetric storage."""
    js, ts = _pair(3, 3, (False,) * 3)
    js, ts = js.clone(dof=3), ts.clone(dof=3)

    def coef(xp):
        eye = jnp.eye(3) if xp is jnp else torch.eye(3, dtype=torch.float64)
        return lambda x, ctx: {(i, i): eye * (0.5 + 0.5 * i) for i in range(1, 4)}

    jop, _ = jconv.assemble_coefficient_planes(js, coef(jnp), interpret=True, conv_min=8,
                                               apply_fix=False, symmetric=symmetric)
    op, _ = tconv.assemble_coefficient_planes(ts, coef(torch), apply_fix=False,
                                              symmetric=symmetric)
    assert _planes_rel(op, jop) <= 1e-12
    assert op.nplanes == (63 if symmetric else 125) * 9


def test_conv_fields_need_dof1():
    """State fields with dof ≠ 1 raise, as in the reference."""
    _, ts = _pair(2, 3, (False, False))
    ts = ts.clone(dof=2)
    u = torch.zeros(ts.nnodes, dtype=torch.float64)
    with pytest.raises(ValueError, match="dof=1"):
        tconv.assemble_coefficient_planes(
            ts, lambda x, ctx, fe: {(1, 1): np.eye(2)}, fields={"u": u})
