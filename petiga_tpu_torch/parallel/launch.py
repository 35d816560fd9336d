"""Start ``n`` ranks of one ``torch.distributed`` job and collect their
results — the launcher of the distributed layer (:mod:`.dist`), its dry
run (:func:`petiga_tpu_torch.entry.dryrun_multichip`), the chip smoke run
and the tests.

Each rank is a fresh interpreter (``multiprocessing`` start method
``spawn``: never ``fork``, which is unsafe once CUDA or threads exist).
It joins the process group at ``tcp://127.0.0.1:<free port>`` with the
backend the caller names and an ``init_process_group`` timeout (which
also bounds every collective), runs ``fn(*args)`` and sends back its
return value, or its traceback.  The caller waits at most ``timeout``
seconds for the whole job: on expiry, or as soon as one rank fails,
every rank is killed and :func:`launch` raises.  A hung rank thus fails
its caller instead of stalling it.

``fn`` and ``args`` are pickled: ``fn`` must be importable by name (a
module-level function), and the results should be small (numpy arrays,
numbers).  Inside ``fn`` the rank and world size are
``torch.distributed.get_rank()`` / ``get_world_size()``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Callable, Sequence

__all__ = ["launch", "free_port", "rank_device"]


def free_port() -> int:
    """A TCP port on the loopback interface that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, init_timeout, fn, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # n ranks share the host's cores
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
            timeout=timedelta(seconds=init_timeout),
        )
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, nprocs: int, args: Sequence = (), *, backend: str,
           init_timeout: float = 60.0, timeout: float = 240.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks of a fresh process group.

    ``backend``: ``"gloo"`` or ``"nccl"`` (no default: ranks that share
    one card need gloo).  ``init_timeout`` bounds the rendezvous and each
    collective; ``timeout`` the whole job.  Each rank runs torch on one
    CPU thread.  Returns the ranks' return values in rank order;
    raises ``RuntimeError`` with the first failing rank's traceback, or
    on the job timeout, after killing every rank."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, name=f"rank{r}",
                    args=(r, nprocs, port, backend, init_timeout, fn, tuple(args), results))
        for r in range(nprocs)
    ]
    for p in procs:
        p.start()
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"job timeout after {timeout:g} s ({len(out)}/{nprocs} ranks done)"
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"{dead[0].name} exited with code {dead[0].exitcode} "
                               "before reporting")
                continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, {nprocs}): {failure}")
    return [out[r] for r in range(nprocs)]


def rank_device(device=None):
    """This rank's device: ``device`` when given, else
    ``cuda:{rank % device_count}``; raises without CUDA, like every
    entry point of the port."""
    import torch
    import torch.distributed as dist

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "petiga_tpu_torch runs on a CUDA device unless told otherwise, and "
            "none is present; pass device='cpu' to run on the CPU"
        )
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())
