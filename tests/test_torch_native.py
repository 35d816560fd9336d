"""The port's native host setup library (``petiga_tpu_torch/native.py``,
``csrc/host/native_core.cpp``) against the JAX package's
(``petiga_tpu.native``) and the numpy routes, on the CPU: the test
builds it at first use with the host C++ compiler."""

import shutil

import numpy as np
import pytest
import torch

from petiga_tpu import native as jnative
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu_torch import native
from petiga_tpu_torch.core import bspline
from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space


@pytest.fixture(scope="module")
def lib():
    """The port's library, built at first use; skips only when this host
    has no C++ compiler at all."""
    import os

    if not any(shutil.which(c) for c in (os.environ.get("CXX"), "c++", "g++") if c):
        pytest.skip("no host C++ compiler")
    assert native.available(), native.build_error()
    assert native.build_error() is None
    return native.load()


def _numpy_ders(U, p, spans, u, nder):
    """The numpy route of ``bspline_ders`` (batches under 4096 points)."""
    return np.concatenate([
        bspline.bspline_ders(U, p, spans[i:i + 1000], u[i:i + 1000], nder)
        for i in range(0, len(u), 1000)
    ])


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_bspline_ders_matches_reference_and_numpy(lib, p):
    ax = Axis.uniform(p=p, nel=7)
    u = np.random.default_rng(0).random(5000) * 0.999
    spans = ax.find_span(u)
    out = native.bspline_ders(ax.U, p, spans, u, p)
    assert out.shape == (5000, p + 1, p + 1)
    np.testing.assert_allclose(out, jnative.bspline_ders(ax.U, p, spans, u, p), atol=1e-13)
    np.testing.assert_allclose(out, _numpy_ders(ax.U, p, spans, u, p), atol=1e-13)
    # the port's bspline_ders takes the native route at B >= 4096
    calls = native.CALLS["bspline_ders"]
    np.testing.assert_array_equal(bspline.bspline_ders(ax.U, p, spans, u, p), out)
    assert native.CALLS["bspline_ders"] == calls + 1


def test_build_mapping_equals_reference_space_mapping(lib):
    """The 20×20×11 periodic space of tests/test_native.py: the port's
    ``Space.mapping`` takes the native route and equals the JAX package's
    bit for bit."""
    axes = [(2, 20, False), (2, 20, False), (2, 11, True)]
    sp = Space([Axis.uniform(p=p, nel=n, periodic=per) for p, n, per in axes],
               dtype=torch.float64, device="cpu")
    js = JSpace([JAxis.uniform(p=p, nel=n, periodic=per) for p, n, per in axes])
    assert sp.nel >= 4096
    calls = native.CALLS["build_mapping"]
    m = sp.mapping
    assert native.CALLS["build_mapping"] == calls + 1
    assert m.dtype == np.int32
    np.testing.assert_array_equal(m, js.mapping)
    np.testing.assert_array_equal(m, sp.element_nodes(np.arange(sp.nel)))


def test_build_mapping_wraps_periodic_collocation(lib):
    """A periodic collocation axis has closure offsets of -1: the port's
    closure map wraps them into range, as the numpy route does (the
    reference's C++ ``%`` leaves them negative: ROADMAP.md, Queue 3)."""
    axes = [(2, 20, False), (3, 20, True), (2, 11, True)]
    sp = Space([Axis.uniform(p=p, nel=n, periodic=per) for p, n, per in axes],
               collocation=True, dtype=torch.float64, device="cpu")
    assert sp.nel >= 4096 and min(t.offset.min() for t in sp.tabs) < 0
    m = sp.mapping
    assert m.min() >= 0 and m.max() < sp.nnodes
    np.testing.assert_array_equal(m, sp.element_nodes(np.arange(sp.nel)))


def test_mapping_below_4096_elements_stays_numpy(lib):
    sp = Space([Axis.uniform(p=2, nel=16)] * 2, dtype=torch.float64, device="cpu")
    calls = native.CALLS["build_mapping"]
    np.testing.assert_array_equal(sp.mapping, sp.element_nodes(np.arange(sp.nel)))
    assert native.CALLS["build_mapping"] == calls


def test_byteswap_f64(lib):
    a = np.random.default_rng(1).normal(size=(100, 10))
    out = native.byteswap_f64(a)
    np.testing.assert_array_equal(out, a.astype(">f8").view(np.float64))
    np.testing.assert_array_equal(out, jnative.byteswap_f64(a))
    np.testing.assert_array_equal(native.byteswap_f64(out), a)


def test_failed_build_reports_the_compiler(monkeypatch, tmp_path):
    """A compiler that fails leaves ``available()`` False with its output
    in ``build_error()``, and ``load()`` raises with it."""
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho 'cxx: cannot build' >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert not native.available()
    assert "cannot build" in native.build_error()
    with pytest.raises(RuntimeError, match="cannot build"):
        native.load()
