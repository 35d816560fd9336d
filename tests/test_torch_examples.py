"""The port's example programs (``petiga_tpu_torch/examples/``) against the
JAX package's (``examples/``) on the CPU, at the arguments of
tests/test_config.py: both return 0 and print the same results (float64
L2/H1 errors, energies and extrema to 1e-10 relative, iteration counts
within one; residuals at the f64 floor are not compared).  Bratu and
Cahn–Hilliard are in tests/test_torch_examples_nonlinear.py, the
distributed example in tests/test_torch_examples_dist.py (each file stays
near 30 s on one core: the JAX examples' compiles are most of it)."""

import pytest

from _torch_examples_compare import assert_same_results, out, port_main, reference_main  # noqa: F401

ARGS = {
    "poisson": ["--dim", "2", "-p", "2", "-N", "8", "--dtype", "float64",
                "--check-error", "1e-3"],
    "elasticity": ["--dim", "2", "-p", "2", "-N", "8", "--dtype", "float64",
                   "--check-error", "1e-3"],
    "hyperelasticity": ["--dim", "2", "-p", "2", "-N", "4", "--dtype", "float64",
                        "--material", "neo_hookean", "--stretch", "0.1"],
}


@pytest.mark.parametrize("name", ARGS)
def test_example_matches_reference(name, out):
    assert reference_main(name)(ARGS[name]) == 0
    ref = out.readouterr().out
    assert port_main(name)(ARGS[name] + ["--device", "cpu"]) == 0
    assert_same_results(out.readouterr().out, ref)


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for the CUDA device and raises
    when there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_main("poisson")(["--dim", "1", "-N", "2"])
