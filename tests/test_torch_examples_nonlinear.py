"""The port's Newton examples (``petiga_tpu_torch/examples/bratu.py``,
``cahnhilliard.py``) against the JAX package's on the CPU, at the arguments
of tests/test_config.py: both return 0 and print the same results (float64
energies and extrema to 1e-10 relative, Newton counts within one;
residuals at the f64 floor are not compared)."""

from _torch_examples_compare import assert_same_results, out, port_main, reference_main  # noqa: F401


def test_bratu_matches_reference(out):
    argv = ["--dim", "2", "-p", "2", "-N", "6"]
    assert reference_main("bratu")(argv) == 0
    ref = out.readouterr().out
    assert port_main("bratu")(argv + ["--device", "cpu"]) == 0
    assert_same_results(out.readouterr().out, ref)


def test_cahnhilliard_matches_reference(tmp_path, out):
    """The reference's run (AD Jacobian) against the port's, and against
    the port's ``--conv-jacobian`` (``run_conv``); ``--vtk`` writes the
    reference's file layout."""
    argv = ["--nel", "8", "--nsteps", "1"]
    ref_vts = tmp_path / "ref.vts"
    assert reference_main("cahnhilliard")(argv + ["--vtk", str(ref_vts)]) == 0
    ref = out.readouterr().out.replace(str(ref_vts), "")
    for extra in ([], ["--conv-jacobian"]):
        vts = tmp_path / "port.vts"
        assert port_main("cahnhilliard")(argv + extra + ["--vtk", str(vts),
                                                         "--device", "cpu"]) == 0
        assert_same_results(out.readouterr().out.replace(str(vts), ""), ref)
        assert vts.stat().st_size == ref_vts.stat().st_size > 0
