#!/usr/bin/env python3
"""Where the time of one Jacobi-CG iteration goes on the card (port).

Assembles the m128 (128³, full storage) and m256 (256³, symmetric storage)
Poisson p=2 systems with ``petiga_tpu_torch``, runs a few untimed CG
iterations, then ``ITERS`` iterations under ``torch.profiler``.  Device
busy time is the sum of the CUDA kernels' self times in
``key_averages()`` (the host-side aten rows are left out: they repeat
their kernels' time); the idle share is ``1 - busy / wall`` with wall the
host clock around the window, synchronised at both ends.  The profiler
itself lengthens the window, so the idle share is an upper bound.

    python3 scripts/torch_profile_cg.py

Prints one JSON line per mesh (the eight kernels with the most device
time), then the ``nvidia-smi`` name and power-limit line.
"""

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from petiga_tpu_torch.models import poisson  # noqa: E402

ITERS = 30


def window(op, b):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson.solve_system(op, b, rtol=0.0, maxiter=ITERS)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main():
    for shape, nel, sym in (("m128-full", 128, False), ("m256-sym", 256, True)):
        sp = poisson.make_space(3, p=2, nel=nel, dtype=torch.float32, device="cuda")
        op, b = poisson.assemble_poisson(sp, symmetric=sym)
        window(op, b)  # warm-up: cuBLAS start-up, allocator
        plain_ms = window(op, b)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms = window(op, b)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        print(json.dumps({
            "shape": shape, "iters": ITERS, "wall_ms": wall_ms,
            "wall_ms_unprofiled": plain_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top],
        }), flush=True)
        del op, b
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
