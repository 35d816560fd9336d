"""The port's matrix-free operator (petiga_tpu_torch.sparse.matfree)
against the JAX package's, f64 on the CPU, on the same seeded vectors.

Both apply the same sum-factorized contractions in the same order, so
matvec, diagonal and load vector agree to round-off: atol 1e-12 on values
of order 1-10.  The windowed (``zchunk``) apply must reproduce the
unchunked one at 1e-13."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.sparse.matfree import MatFreeOperator as JMatFree
from petiga_tpu_torch import interop
from petiga_tpu_torch.sparse.matfree import JacobianFreeOperator, MatFreeOperator

ATOL = 1e-12


def _space(dim, p, nel=4, periodic=False, continuity=None, dof=1, mapped=False):
    axes = [JAxis.uniform(p=p, nel=nel, periodic=(periodic and d == 0),
                          continuity=continuity) for d in range(dim)]
    js = JSpace(axes, dof=dof, dtype=jnp.float64)
    for f in range(dof):
        js.set_boundary_value(dim - 1, 0, f, 0.0)
    if mapped:
        # warped map: x = u + 0.1 sin(pi u) v, y = v (det J > 0)
        g = js.greville_coordinates()
        js.init_geometry(np.stack(
            [g[:, 0] + 0.1 * np.sin(np.pi * g[:, 0]) * g[:, 1], g[:, 1]], axis=1))
    return js, interop.space_from_reference(js, device="cpu")


CASES = {
    "2d-p1": dict(dim=2, p=1),
    "2d-p2-c0.3": dict(dim=2, p=2, c=0.3),
    "2d-p3": dict(dim=2, p=3),
    "3d-p2-c0.3": dict(dim=3, p=2, c=0.3),
    "2d-p2-periodic": dict(dim=2, p=2, c=0.3, periodic=True),
    "2d-p2-C0": dict(dim=2, p=2, c=0.3, continuity=0),
    "2d-p3-C1": dict(dim=2, p=3, continuity=1),
    "2d-p2-mapped": dict(dim=2, p=2, c=0.3, mapped=True),
    "2d-p2-dof2-coupled": dict(dim=2, p=2, dof=2,
                               C=[[0.5, 0.2], [0.2, 0.0]], Kmat=[[1.0, 0.3], [0.3, 2.0]]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matfree_matches_jax(name):
    kw = dict(CASES[name])
    coef = {k: kw.pop(k) for k in ("c", "C", "Kmat") if k in kw}
    coef.setdefault("kappa", 1.3)
    js, ts = _space(**kw)
    jop, top = JMatFree(js, **coef), MatFreeOperator(ts, **coef)
    x = np.random.default_rng(len(name)).normal(size=(js.nnodes, js.dof))
    np.testing.assert_allclose(top.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))), rtol=0, atol=ATOL)
    # flat vectors in, flat vectors out
    assert top.matvec(torch.as_tensor(x.ravel())).shape == (x.size,)
    np.testing.assert_allclose(top.scalar_diagonal().numpy(),
                               np.asarray(jop.scalar_diagonal()), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim,zchunk", [(2, None), (3, None), (3, 2)])
def test_load_vector_matches_jax(dim, zchunk):
    js, ts = _space(dim, 2, nel=4)
    jb = JMatFree(js, zchunk=zchunk).load_vector(
        lambda x: 3.0 * jnp.prod(jnp.sin(jnp.pi * x)) + x[0])
    tb = MatFreeOperator(ts, zchunk=zchunk).load_vector(
        lambda x: 3.0 * torch.prod(torch.sin(torch.pi * x), dim=-1) + x[..., 0])
    assert tb.shape == (ts.nnodes, 1)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=ATOL)


@pytest.mark.parametrize("c", [0.0, 0.3])
def test_chunked_matches_unchunked(c):
    """The windowed apply (the bounded-memory 256³ path) reproduces the
    unchunked one at 1e-13, incl. a periodic fast axis, an awkward
    ``zchunk`` (rounded down to a divisor of E_z) and reduced
    continuity."""
    for kw, zchunk, want in ((dict(dim=3, p=2, nel=6), 2, 2),
                             (dict(dim=3, p=2, nel=6, periodic=True), 4, 3),
                             (dict(dim=2, p=2, nel=6, continuity=0), 3, 3)):
        _, ts = _space(**kw)
        x = torch.as_tensor(np.random.default_rng(0).normal(size=(ts.nnodes, 1)))
        A0 = MatFreeOperator(ts, c=c, kappa=1.2)
        A1 = MatFreeOperator(ts, c=c, kappa=1.2, zchunk=zchunk)
        assert A0.zchunk is None and A1.zchunk == want
        np.testing.assert_allclose(A1.matvec(x).numpy(), A0.matvec(x).numpy(),
                                   rtol=0, atol=1e-13)


def test_matvec_is_deterministic():
    """Refinement reads residual differences of 1e-12: two applies of one
    operator to one vector are bit-identical."""
    _, ts = _space(3, 2, nel=4)
    A = MatFreeOperator(ts, c=0.3, zchunk=2)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(ts.nnodes, 1)))
    assert torch.equal(A.matvec(x), A.matvec(x))


def test_refused_spaces():
    js, ts = _space(2, 2)
    ts.init_geometry(ts.greville_coordinates(), np.full(ts.nnodes, 1.5))
    with pytest.raises(ValueError, match="rational"):
        MatFreeOperator(ts)
    _, ts = _space(2, 2, mapped=True)
    with pytest.raises(ValueError, match="identity map"):
        MatFreeOperator(ts).load_vector(lambda x: x[..., 0])
    # the Jacobian-free operator takes the mapped space: its action equals
    # the assembled AD Jacobian's there
    from petiga_tpu_torch.assembly.assemble import assemble_jacobian

    def res(pt, Ue, ctx):
        return pt.shape1 @ pt.grad(Ue)[0] + torch.exp(pt.value(Ue)[0]) * pt.shape0

    rng = np.random.default_rng(2)
    U, v = (torch.as_tensor(rng.normal(scale=0.1, size=(ts.nnodes, 1))) for _ in range(2))
    y = assemble_jacobian(ts, res, U).matvec(v)
    assert float((JacobianFreeOperator(ts, res, U).matvec(v) - y).abs().max()) <= (
        1e-12 * float(y.abs().max()))
