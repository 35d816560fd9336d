#!/usr/bin/env python3
"""The JAX package's example programs at the sizes of ``chip_smoke.py``'s
``examples`` phase, for its ``EXAMPLES_REF``.

Runs each ``examples/<name>.py`` of the JAX package in this process on
the CPU, in float64 (every run here is f64: the example turns x64 on, or
its ``--dtype float64`` does), captures what it prints and prints one
JSON line per run: its arguments, its ``key=value`` results (the parse
``petiga_tpu_torch.examples.printed_results`` that ``chip_smoke.py``
applies to the port's output) and its seconds;
then the ``EXAMPLES_REF`` literal to paste into ``chip_smoke.py``.  The
distributed example runs on a 4-device CPU mesh (``XLA_FLAGS``), the grid
the port's 4 ranks take, because its multigrid preconditioner depends on
the partition.  ``{tmp}`` in an argument is a temporary directory.

The Poisson example at 128³ in f64 is not run here (the JAX package's CPU
run of 2.2 M unknowns is the slow one): ``chip_smoke.py`` holds the port's
run of it to its own f64 phase's L2 error at 128³, which that phase holds
to the h³ rate.

    JAX_PLATFORMS=cpu python3 scripts/torch_examples_reference.py [name ...]
"""

import contextlib
import importlib.util
import io
import json
import os
import pprint
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from petiga_tpu import config as jconfig  # noqa: E402
from petiga_tpu_torch.examples import printed_results  # noqa: E402

# the runs of chip_smoke.py's examples phase: (key, example, arguments)
RUNS = (
    ("bratu", "bratu", ["--dim", "2", "-N", "256"]),
    ("elasticity", "elasticity", ["--dim", "3", "-N", "48", "--dtype", "float64"]),
    ("hyperelasticity", "hyperelasticity", ["--dim", "3", "-N", "12", "--dtype", "float64"]),
    ("cahnhilliard", "cahnhilliard", ["--nel", "256", "--nsteps", "5"]),
    ("cahnhilliard_conv", "cahnhilliard", ["--nel", "256", "--nsteps", "5",
                                           "--conv-jacobian"]),
    ("distributed", "distributed", ["--dim", "3", "-p", "2", "-N", "64", "--dtype", "float64",
                                    "--pc", "mg", "--checkpoint", "{tmp}"]),
)


class _CurrentStdout:
    """Writes to whatever ``sys.stdout`` is at the time of the write (the
    reference's ``print_info`` binds the stream of its import)."""

    def write(self, text):
        return sys.stdout.write(text)


def run(example, argv):
    spec = importlib.util.spec_from_file_location(f"_example_{example}",
                                                  REPO / "examples" / f"{example}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        rc = mod.main([a.replace("{tmp}", f"{tmp}/ck") for a in argv])
    return rc, out.getvalue()


def main(argv=None):
    names = set(sys.argv[1:] if argv is None else argv)
    jconfig.print_info.__defaults__ = (_CurrentStdout(),) + jconfig.print_info.__defaults__[1:]
    ref = {}
    for key, example, args in RUNS:
        if names and key not in names:
            continue
        t0 = time.perf_counter()
        rc, text = run(example, args)
        seconds = time.perf_counter() - t0
        if rc not in (0, None):
            raise SystemExit(f"{key}: the JAX example returned {rc}:\n{text}")
        ref[key] = {"example": example, "argv": args, "results": printed_results(text)}
        print(json.dumps({"run": key, **ref[key], "seconds": seconds,
                          "devices": len(jax.devices())}), flush=True)
    body = pprint.pformat(ref, width=84, compact=True, sort_dicts=False)
    print("EXAMPLES_REF = " + body.replace("\n", "\n" + " " * 15))


if __name__ == "__main__":
    main()
