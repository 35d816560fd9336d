"""The example programs of the port, the counterparts of the JAX package's
``examples/`` (PetIGA's demos): ``poisson``, ``bratu``, ``cahnhilliard``,
``elasticity``, ``hyperelasticity`` and ``distributed``.

Each takes the reference example's command-line flags and defaults and
prints its result lines; ``main(argv) -> int`` runs it, and

    python -m petiga_tpu_torch.examples.<name> [flags]

runs it from the shell.  The port adds one flag, ``--device``: the CUDA
device by default, ``--device cpu`` to run on the CPU.
"""

import re

# (name, type, default, help) of the one flag the port adds to each example
DEVICE_FLAG = ("device", str, None, "torch device: the CUDA device by default, or 'cpu'")

# a result an example prints: key=value (``iters=54``, ``L2=4.357036e-08``,
# ``converged=True``); the residuals at the f64 floor are round-off
_RESULT = re.compile(r"([\w|()]+)=([-+0-9.eE]+|True|False)")
_FLOOR_KEYS = ("residual", "|F|")


def printed_results(text: str) -> list:
    """The ``[key, value]`` results in an example's printed output, in
    order, the f64-floor residuals left out: what the port's examples are
    held to against the reference's (``chip_smoke.py``, the tests,
    ``scripts/torch_examples_reference.py``)."""
    return [[k, v] for line in text.splitlines() for k, v in _RESULT.findall(line)
            if k not in _FLOOR_KEYS]
