"""Options, command line, ``print_info``, the flop models and the log
events of the port (``config.py``, ``utils/profiling.py``) against the JAX
package, on the CPU."""

import dataclasses
import io
import time

import numpy as np
import pytest
import torch

from petiga_tpu import config as jconfig
from petiga_tpu.assembly.assemble import stencil_of as jstencil_of
from petiga_tpu.io import checkpoint as jck
from petiga_tpu.utils import profiling as jprof
from petiga_tpu_torch import config
from petiga_tpu_torch.assembly.assemble import stencil_of
from petiga_tpu_torch.utils import profiling


def _fields(opts):
    return {k: v for k, v in dataclasses.asdict(opts).items() if k != "_frozen"}


def test_options_build_and_freeze():
    opts = config.Options(dim=2, degree=(2, 3), elements=4, dtype="float64")
    sp = opts.build_space(device="cpu")
    assert sp.dim == 2 and tuple(sp.degrees) == (2, 3)
    assert tuple(sp.elem_shape) == (4, 4)
    assert sp.dtype == torch.float64 and sp.device == torch.device("cpu")
    with pytest.raises(AttributeError):
        opts.dim = 3


def test_build_space_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.Options(dim=1, elements=2).build_space()


@pytest.mark.parametrize("argv", [
    ["--dim", "2", "-p", "3", "-N", "5", "6", "--periodic", "1", "0", "--check-error", "1e-4"],
    ["--dim", "2", "-p", "2", "-N", "7", "--rule-type", "lobatto", "--quadrature", "4",
     "--dtype", "float64"],
    ["--dim", "1", "-p", "3", "-N", "9", "--collocation", "--dtype", "float64"],
], ids=["periodic-extra", "lobatto", "collocation"])
def test_bind_cli_matches_reference(argv):
    extra = [("check-error", float, 0.0, "tolerance")]
    opts, ns = config.bind_cli(argv, extra=extra)
    jopts, jns = jconfig.bind_cli(argv, extra=extra)
    assert _fields(opts) == _fields(jopts) and vars(ns) == vars(jns)
    sp, js = opts.build_space(device="cpu"), jopts.build_space()
    assert (sp.elem_shape, sp.degrees, sp.periodic, sp.collocation) == (
        js.elem_shape, js.degrees, js.periodic, js.collocation)
    for t, jt in zip(sp.tabs, js.tabs):
        np.testing.assert_array_equal(t.point, jt.point)
        np.testing.assert_array_equal(t.value, jt.value)
    out, jout = io.StringIO(), io.StringIO()
    config.print_info(sp, file=out)
    jconfig.print_info(js, file=jout)
    assert out.getvalue() == jout.getvalue()


def test_load_reads_reference_file_and_print_info(tmp_path):
    """``--load`` (PetIGA's -iga_load) reads a NURBS geometry written by
    the JAX package; ``print_info`` with a partition grid prints the
    reference's text."""
    jsp = jconfig.Options(dim=2, degree=2, elements=(5, 4), dtype="float64").build_space()
    G = np.asarray(jsp.greville_coordinates())
    jsp.init_geometry(G * [1.0, 2.0], 1.0 + 0.1 * G[:, 0])
    path = str(tmp_path / "geo.dat")
    jck.write_space(jsp, path)
    opts, _ = config.bind_cli(["--load", path, "--dtype", "float64"])
    sp = opts.build_space(device="cpu")
    js = jconfig.bind_cli(["--load", path, "--dtype", "float64"])[0].build_space()
    np.testing.assert_array_equal(sp.geometry, js.geometry)
    np.testing.assert_array_equal(sp.rational, js.rational)
    for pgrid in (None, (2, 1)):
        out, jout = io.StringIO(), io.StringIO()
        config.print_info(sp, file=out, pgrid=pgrid)
        jconfig.print_info(js, file=jout, pgrid=pgrid)
        assert out.getvalue() == jout.getvalue()
    with pytest.raises(AttributeError):
        opts.load = None


def test_flop_models_match_reference():
    for argv in (["--dim", "3", "-p", "2", "-N", "4"], ["--dim", "2", "--dof", "3", "-p", "3"]):
        sp = config.bind_cli(argv)[0].build_space(device="cpu")
        js = jconfig.bind_cli(argv)[0].build_space()
        for name in ("system_flops", "residual_flops", "jacobian_flops"):
            assert getattr(profiling, name)(sp) == getattr(jprof, name)(js)
            assert getattr(profiling, name)(sp, Q=5) == getattr(jprof, name)(js, Q=5)
        assert profiling.spmv_flops(stencil_of(sp)) == jprof.spmv_flops(jstencil_of(js))


def test_log_view_columns():
    """Count, seconds, modeled flops and GF/s per event; ``count`` takes
    no time, ``timed`` and ``event`` time their work (the host clock
    here)."""
    profiling.reset()
    profiling.count("IGA_FormSystem", 3e9)
    profiling.count("IGA_FormSystem", 1e9)
    out = profiling.timed("KSPSolve", lambda a: a * 2, torch.ones(4), flops=2e6)
    with profiling.event("MatMult", flops=5e5):
        time.sleep(0.005)
    with profiling.annotate("SNESSolve"):
        pass
    assert out.tolist() == [2.0] * 4
    buf = io.StringIO()
    profiling.log_view(buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].split() == ["Event", "Count", "Time", "(s)", "Flops", "GF/s"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    assert list(rows) == ["IGA_FormSystem", "KSPSolve", "MatMult", "SNESSolve"]
    assert rows["IGA_FormSystem"][:3] == ["2", "0.0000", "4e+09"]
    assert rows["IGA_FormSystem"][3] == "0.00"
    assert rows["KSPSolve"][0] == "1" and float(rows["KSPSolve"][2]) == 2e6
    assert float(rows["MatMult"][1]) > 0 and float(rows["MatMult"][3]) > 0
    assert rows["SNESSolve"][:1] == ["1"]
    profiling.reset()
    assert not profiling.EVENTS
