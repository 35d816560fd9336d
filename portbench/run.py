"""Run one cell of the benchmark of ``petiga_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The run sets
the program up and warms it up, measures for ``--seconds``, judges what
the window produced against the plain reference, prints each number
compared beside its limit on standard error, and prints one JSON object as
the last line of standard output.  ``--trace 1`` reports the per-layer
metrics from a ``torch.profiler`` trace of the window instead of the
end-to-end ones.  Without a CUDA device, or with fewer than the cell asks
for, it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)

    # every cache of the program stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    cell = next((w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == ns.workload), None)
    if cell is None:
        print(f"no workload named {ns.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{ns.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    from portbench.harness import run_cell

    run_cell(ns.workload, ns.seed, ns.seconds, bool(ns.trace), device=torch.device("cuda", 0),
             t_start=T_START, root=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
