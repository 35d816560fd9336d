"""PetIGA binary checkpoints, probes and VTK output of the port
(``io/checkpoint.py``, ``post/probe.py``, ``post/sample.py``) against the
JAX package, f64 on the CPU.

Files are compared byte for byte: the same space (geometry, NURBS weights,
properties) or vector written by both packages gives the same file, each
package reads the other's, and ``write_vts`` of the same arrays gives the
same ``.vts``.  Probe values and derivatives are held to the reference's
at 1e-12 relative (the same tables contracted in another order)."""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.io import checkpoint as jck
from petiga_tpu.post.probe import FixedProbe as JFixedProbe
from petiga_tpu.post.probe import Probe as JProbe
from petiga_tpu.post.sample import sample_grid as jsample_grid
from petiga_tpu.post.sample import write_vts as jwrite_vts
from petiga_tpu_torch import interop
from petiga_tpu_torch.io import checkpoint as tck
from petiga_tpu_torch.post.probe import FixedProbe, Probe
from petiga_tpu_torch.post.sample import sample_grid, write_vts

F64 = torch.float64


def _nurbs_space(nels=(5, 4), degrees=(2, 3)):
    js = JSpace([JAxis.uniform(p=p, nel=n) for p, n in zip(degrees, nels)],
                dtype=jnp.float64)
    G = np.asarray(js.greville_coordinates())
    X = np.stack([G[:, 0] + 0.1 * np.sin(np.pi * G[:, 1]), 1.5 * G[:, 1]], axis=1)
    W = 1.0 + 0.2 * np.cos(3 * G[:, 0] + G[:, 1])
    js.init_geometry(X, W)
    js.set_property(np.arange(js.nnodes * 2, dtype=float).reshape(-1, 2))
    return js


@pytest.mark.parametrize("geom", ["plain", "nurbs"])
def test_space_files_identical_and_cross_read(tmp_path, geom):
    js = (JSpace([JAxis.uniform(p=2, nel=5), JAxis.uniform(p=3, nel=3, continuity=1)],
                 dtype=jnp.float64) if geom == "plain" else _nurbs_space())
    ts = interop.space_from_reference(js, device="cpu")
    jpath, tpath = tmp_path / "j.dat", tmp_path / "t.dat"
    jck.write_space(js, str(jpath))
    tck.write_space(ts, str(tpath))
    assert filecmp.cmp(jpath, tpath, shallow=False)
    back = tck.read_space(str(jpath), dtype=F64, device="cpu")
    jback = jck.read_space(str(tpath), dtype=jnp.float64)
    assert back.degrees == js.degrees and jback.node_shape == ts.node_shape
    for a, b in zip(back.axes, js.axes):
        np.testing.assert_array_equal(a.U, b.U)
    for attr in ("geometry", "rational", "property"):
        ref = getattr(js, attr)
        if ref is None:
            assert getattr(back, attr) is None
        else:
            np.testing.assert_allclose(getattr(back, attr), ref, rtol=0, atol=1e-13)
            np.testing.assert_allclose(getattr(jback, attr), ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("nel", [3, 7])
def test_vec_files_identical_odd_sizes(tmp_path, nel):
    js = JSpace([JAxis.uniform(p=2, nel=nel)] * 2, dof=3, dtype=jnp.float64)
    ts = interop.space_from_reference(js, device="cpu")
    U = np.random.default_rng(nel).normal(size=(js.nnodes, 3))
    jpath, tpath = tmp_path / "j.dat", tmp_path / "t.dat"
    jck.write_vec(js, jnp.asarray(U), str(jpath))
    tck.write_vec(ts, torch.as_tensor(U), str(tpath))
    assert filecmp.cmp(jpath, tpath, shallow=False)
    np.testing.assert_array_equal(tck.read_vec(ts, str(jpath)).numpy(), U)
    np.testing.assert_array_equal(np.asarray(jck.read_vec(js, str(tpath))), U)


def test_vec_length_mismatch(tmp_path):
    ts = interop.space_from_reference(JSpace([JAxis.uniform(p=2, nel=4)]), device="cpu")
    path = str(tmp_path / "v.dat")
    tck.write_vec(ts, torch.zeros((ts.nnodes, 1)), path)
    ts8 = interop.space_from_reference(JSpace([JAxis.uniform(p=2, nel=8)]), device="cpu")
    with pytest.raises(IOError):
        tck.read_vec(ts8, path)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300))


def test_probe_parity_through_der4():
    """Value through the 4th derivative and the mapped coordinates on a
    NURBS space (order 4 at p = 4 for der3/der4)."""
    pts = np.random.default_rng(0).random((13, 2))
    for js, order in ((_nurbs_space(), 2), (_nurbs_space((3, 3), (4, 4)), 4)):
        js.order = order
        ts = interop.space_from_reference(js, device="cpu")
        U = np.random.default_rng(1).normal(size=(js.nnodes, 1))
        jp = JProbe(js, jnp.asarray(U), order=order)
        tp = Probe(ts, torch.as_tensor(U), order=order)
        kinds = ("value", "grad", "hess") + (("der3", "der4") if order == 4 else ())
        for kind in kinds:
            assert _rel(getattr(tp, kind)(pts).numpy(), getattr(jp, kind)(pts)) <= 1e-12, kind
        assert _rel(tp.geometry(pts).numpy(), jp.geometry(pts)) <= 1e-13
        jf = JFixedProbe(js, pts, order=order)
        tf = FixedProbe(ts, pts, order=order)
        for kind in kinds:
            assert _rel(getattr(tf, kind)(torch.as_tensor(U)).numpy(),
                        getattr(jf, kind)(jnp.asarray(U))) <= 1e-12, kind
            np.testing.assert_array_equal(getattr(tf, kind)(torch.as_tensor(U)).numpy(),
                                          getattr(tp, kind)(pts).numpy())
        assert _rel(tf.geometry().numpy(), jf.geometry()) <= 1e-13


def test_probe_periodic_wrap():
    js = JSpace([JAxis.uniform(p=2, nel=8, periodic=True)], dtype=jnp.float64)
    ts = interop.space_from_reference(js, device="cpu")
    U = np.random.default_rng(1).normal(size=(js.nnodes, 1))
    tp = Probe(ts, torch.as_tensor(U))
    pts = np.array([[0.0], [1.0], [1.3], [-0.7]])
    v = tp.value(pts).numpy()
    np.testing.assert_allclose(v[0], v[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(v[2], v[3], rtol=0, atol=1e-12)
    assert _rel(v, JProbe(js, jnp.asarray(U)).value(pts)) <= 1e-12


def test_sample_grid_and_vts_identical(tmp_path):
    js = _nurbs_space()
    ts = interop.space_from_reference(js, device="cpu")
    U = np.random.default_rng(2).normal(size=(js.nnodes, 1))
    jc, jv, jshape = jsample_grid(js, jnp.asarray(U))
    tc, tv, tshape = sample_grid(ts, torch.as_tensor(U), resolution=2)
    tc2, tv2, _ = sample_grid(ts, torch.as_tensor(U))
    assert tshape != jshape and tc2.shape == jc.shape
    assert _rel(tc2, jc) <= 1e-13 and _rel(tv2, jv) <= 1e-12
    jpath, tpath = tmp_path / "j.vts", tmp_path / "t.vts"
    jwrite_vts(str(jpath), jc, jshape, {"u": jv[:, 0], "uu": np.concatenate([jv, jv], 1)})
    write_vts(str(tpath), jc, jshape, {"u": torch.tensor(jv[:, 0]),
                                       "uu": np.concatenate([jv, jv], 1)})
    assert filecmp.cmp(jpath, tpath, shallow=False)
    assert tc.shape[0] == np.prod(tshape)
