#!/usr/bin/env python3
"""Time the f64 ``stencil_spmv_full`` on the 512² periodic layout with the
L2 cache flushed and not (GPU).

The operator is the layout of ``chip_smoke.py``'s f64 row (2-D, p=2,
periodic, 512² elements: 25 planes on the 516² extended grid, 52.4 MB of
planes plus x and y, just above the H100's 50 MB L2), with seeded random
values (the time does not depend on them).  Each mode times ``--reps``
rounds of ``--calls`` launches:

  warm   back-to-back launches, CUDA events around the round (the way
         ``chip_smoke.kernel_row`` times its best-of and median);
  flush  before every launch a 256 MB buffer is overwritten (evicting the
         L2), CUDA events around each launch alone.

Prints one JSON line per round and a summary line with the bound
(``chip_smoke.kernel_row``'s: planes' node columns, x and y over
3.35 TB/s) and each mode's median and best.  Usage, on a machine with a
CUDA GPU, from the repository root:

    python3 scripts/torch_kernel_l2.py [--reps 5] [--calls 20]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from petiga_tpu_torch import interop  # noqa: E402
from petiga_tpu_torch.sparse import spmv  # noqa: E402
from petiga_tpu_torch.sparse.stencil import Stencil  # noqa: E402

HBM_BYTES_S = 3.35e12


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_l2: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    st = Stencil(node_shape=(512, 512), widths=(2, 2), periodic=(True, True), dof=1)
    op = interop.operator_from_stencil_data(st, interop.random_stencil_data(st, 3),
                                            device="cuda", dtype=torch.float64)
    x = torch.randn(st.nnodes, 1, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    xb = op.pack_vec(x)
    yb = torch.zeros_like(xb)
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def launch():
        spmv.stencil_spmv_full(op.DT, xb, op._shift_t, op.G, out=yb)

    isz, nn = op.DT.element_size(), st.nnodes
    bound_ms = 1e3 * (op.nplanes * nn * isz + 2 * nn * isz) / HBM_BYTES_S
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    rounds = {"warm": [], "flush": []}
    for rep in range(args.reps):
        for mode in ("warm", "flush"):
            if mode == "warm":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.calls):
                    launch()
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1) / args.calls
            else:
                per = []
                for _ in range(args.calls):
                    scrub.fill_(rep & 0xFF)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    launch()
                    e1.record()
                    e1.synchronize()
                    per.append(e0.elapsed_time(e1))
                ms = float(np.mean(per))
            rounds[mode].append(ms)
            print(json.dumps({"round": rep, "mode": mode, "ms": ms,
                              "bound_frac": bound_ms / ms}), flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
        "planes_MB": op.plane_bytes / 1e6, "bound_ms": bound_ms,
        **{f"{m}_median_ms": float(np.median(v)) for m, v in rounds.items()},
        **{f"{m}_best_ms": float(np.min(v)) for m, v in rounds.items()},
        **{f"{m}_median_bound_frac": bound_ms / float(np.median(v)) for m, v in rounds.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
