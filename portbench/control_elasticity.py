"""Readings of the numbers that decide ``correct`` in the elasticity cell
over many seeds: the program as it runs in the benchmark, or with a
control planted in this process, for setting and checking the limits in
``cells/<workload>.json``.  The benchmark's own runs never run this.

    python3 portbench/control_elasticity.py --workload elast96-mg --seconds <s> --mode program|lower|unchanged|altered|early --seeds <n> [<n> ...] [--factor <f>]

The controls (:func:`plant`) patch the running program, never its files:

* ``lower``: the nearest precision below the configuration's float32:
  TF32 switched on for the program's matrix products (the assembly's and
  the load vector's contractions, the multigrid transfers), which
  ``petiga_tpu_torch`` switches off on import; the CUDA stencil kernel
  has no TF32 mode.  Only a card has TF32;
* ``unchanged``: the MG-CG solve returns the zero vector;
* ``altered``: the MG-CG solution's middle entry moved by the solution's
  largest magnitude;
* ``early``: MG-CG stopped at ``factor`` (100) times the configured
  tolerance, by the solver, while the configuration keeps its own.

Prints one JSON line per seed (its readings, ``correct``, the count of
requests, the end-to-end metrics, the peak and the seconds the run
took), then ``nvidia-smi``'s name and power limit of the card.
"""

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = ("program", "lower", "unchanged", "altered", "early")


def _patch_outer(fn=None, factor=1.0):
    """Wrap ``krylov.cg`` so that the outer MG-CG solve (the one whose
    preconditioner is the V-cycle) stops at ``factor`` times its
    tolerance and returns ``fn(x)``; other solves are left as they are."""
    from petiga_tpu_torch.solve import krylov
    from petiga_tpu_torch.solve.multigrid import MGPreconditioner

    cg = krylov.cg

    def outer_cg(A, b, *args, M=None, rtol=1e-8, **kw):
        if not isinstance(M, MGPreconditioner):
            return cg(A, b, *args, M=M, rtol=rtol, **kw)
        res = cg(A, b, *args, M=M, rtol=factor * rtol, **kw)
        return res if fn is None else res._replace(x=fn(res.x))

    krylov.cg = outer_cg


def _bump(U):
    U = U.clone()
    U.view(-1)[U.numel() // 2] += U.abs().max()
    return U


def plant(mode, cfg, factor=100.0):
    """Patch the program in this process for ``mode``; returns the config
    overrides.  Plant once a process."""
    import torch

    import petiga_tpu_torch  # noqa: F401 - its import switches TF32 off first

    if mode == "program":
        return {}
    if mode == "lower":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return {}
    if mode == "unchanged":
        _patch_outer(torch.zeros_like)
        return {}
    if mode == "altered":
        _patch_outer(_bump)
        return {}
    if mode == "early":
        _patch_outer(factor=factor)
        return {}
    raise ValueError(f"no control {mode!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="elast96-mg")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="program", choices=MODES)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--factor", type=float, default=100.0,
                    help="early: the multiple of the configured tolerance")
    ns = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import Spec, run

    spec = Spec(ROOT)
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    cfg = spec.config(spec.cell(ns.workload)["config"])
    overrides = plant(ns.mode, cfg, ns.factor)
    for seed in ns.seeds:
        t = time.perf_counter()
        r = run(ns.workload, seed, ns.seconds, False, root=ROOT, t_start=t, overrides=overrides,
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
