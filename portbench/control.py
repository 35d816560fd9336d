"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program as it runs in the benchmark, or with a control
planted (``faults.py``), for setting and checking the limits in
``cells/<workload>.json``.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seconds <s> --mode program|lower|unchanged|altered|early --seeds <n> [<n> ...] [--factor <f>]

Prints one JSON line per seed: its readings, ``correct`` and the count of
requests, then ``nvidia-smi``'s name and power limit of the card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "lower", "unchanged", "altered", "early"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--factor", type=float, default=100.0,
                    help="early: the multiple of the configured tolerance")
    ns = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import io

    import torch

    from portbench import faults
    from portbench.harness import Spec, run_cell

    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cfg = spec.config(spec.cell(ns.workload)["config"])
    kw = {"factor": ns.factor} if ns.mode == "early" else {}
    overrides = {} if ns.mode == "program" else faults.plant(ns.mode, cfg["problem"], cfg, **kw)
    for seed in ns.seeds:
        t = time.perf_counter()
        r = run_cell(ns.workload, seed, ns.seconds, False, device=torch.device("cuda", 0),
                     t_start=t, root=ROOT, overrides=overrides, out=io.StringIO())
        print(json.dumps({"workload": ns.workload, "mode": ns.mode, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"],
                          "readings": {k: v["value"] for k, v in r["checks"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
