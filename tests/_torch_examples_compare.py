"""Shared by the example tests: run a JAX example and its port counterpart
and compare what they print (torch-free on the JAX side)."""

import importlib
import importlib.util
import os
import pathlib
import re
import sys

import numpy as np
import pytest

from petiga_tpu_torch.examples import printed_results

# The distributed example's ranks inherit this: c10d's warnings would
# otherwise land in the middle of pytest's progress lines.
os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def reference_main(name):
    """``main`` of the JAX package's ``examples/<name>.py``, loaded by path
    (the bare module names would clash with the port's)."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def port_main(name):
    return importlib.import_module(f"petiga_tpu_torch.examples.{name}").main


def assert_same_results(port_text, ref_text, rtol=1e-10):
    """Every printed ``key=value`` equal: counts (``iters``) within one,
    other integers and flags exactly, floats to ``rtol``."""
    got, want = printed_results(port_text), printed_results(ref_text)
    assert [k for k, _ in got] == [k for k, _ in want], (port_text, ref_text)
    assert want, ref_text
    for (k, a), (_, b) in zip(got, want):
        if re.fullmatch(r"[-+]?\d+|True|False", b):
            if k == "iters":
                assert abs(int(a) - int(b)) <= 1, (k, a, b)
            else:
                assert a == b, (k, a, b)
        else:
            np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=0, err_msg=k)


class _CurrentStdout:
    """Writes to whatever ``sys.stdout`` is at the time of the write."""

    def write(self, text):
        return sys.stdout.write(text)


@pytest.fixture
def out(capsys, monkeypatch):
    """``capsys``, with the reference's ``print_info`` writing to it: its
    default stream is the ``sys.stdout`` of the module's first import."""
    from petiga_tpu import config as jconfig

    monkeypatch.setattr(jconfig.print_info, "__defaults__",
                        (_CurrentStdout(),) + jconfig.print_info.__defaults__[1:])
    return capsys
