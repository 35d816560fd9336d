"""Readings of the numbers that decide ``correct``, over many seeds: the
program as it runs in the benchmark, or with a control planted
(``faults.py``), for setting and checking the limits in
``cells/<workload>.json``.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seconds <s> --mode program|lower|unchanged|altered|exchange|early --seeds <n> [<n> ...] [--factor <f>]

Prints one JSON line per seed: its readings, ``correct``, the count of
requests, the end-to-end metrics, the peak and the seconds the run took,
then ``nvidia-smi``'s name and power limit of the cards.  Each seed is one
run as ``run.py`` makes it: a cell of one card in this process, the
control planted once; a cell of several cards in a job of its own, one
rank per card, the control planted in every rank.
"""

import argparse
import io
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
                    choices=("program", "lower", "unchanged", "altered", "exchange", "early"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--factor", type=float, default=100.0,
                    help="early: the multiple of the configured tolerance")
    ns = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import Spec, run

    chips = Spec(ROOT).cell(ns.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"control readings need {chips} CUDA device(s)", file=sys.stderr)
        return 2
    plant = None if ns.mode == "program" else (
        ns.mode, {"factor": ns.factor} if ns.mode == "early" else {})
    for seed in ns.seeds:
        t = time.perf_counter()
        r = run(ns.workload, seed, ns.seconds, False, root=ROOT, t_start=t, plant=plant,
                out=io.StringIO())
        print(json.dumps({"workload": ns.workload, "mode": ns.mode, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"],
                          "readings": {k: v["value"] for k, v in r["checks"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "peak": r["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
