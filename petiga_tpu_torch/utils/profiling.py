"""Log events and profiling (port of :mod:`petiga_tpu.utils.profiling`):
the analog of PetIGA's PetscLog events (FormScalar/Vector/Matrix/System/
Function/Jacobian, KSPSolve, SNESSolve, MatMult) with analytic flop
models, and a ``-log_view``-style table.

* :func:`count` registers one occurrence of an event with its modeled
  flops.  The assembly and solve routines call it where the reference's
  do; it only adds numbers on the host, so it never waits for the card.
* :func:`annotate` is the same registration around a
  ``torch.profiler.record_function`` range while a profiler records, so
  the event shows by name in a :func:`trace`.
* :func:`event` and :func:`timed` time a bracket or a call: with
  ``torch.cuda.Event`` pairs on the card (waiting for the end event, as
  the reference blocks on its result) and with the host clock when no
  card is present.
* :class:`Spans` totals CUDA-event time per named span where a caller
  switches it on (``DistSpace.spans``, ``MGPreconditioner.spans``); off,
  the caller takes no event and no synchronise.
* :func:`trace` records a ``torch.profiler`` window and writes its
  Chrome trace.

``EVENTS`` is one table per process, like PETSc's log.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from collections import defaultdict

import torch

__all__ = [
    "annotate", "count", "event", "timed", "log_view", "reset", "trace",
    "EVENTS", "Spans",
    "system_flops", "residual_flops", "jacobian_flops", "spmv_flops",
]

EVENTS = defaultdict(lambda: {"count": 0, "time": 0.0, "flops": 0.0})


# ------------------------------------------------------------ flop models
# Analytic per-call counts, as PetIGA logs them: a bilinear form's
# quadrature loop touches (nen·dof)² fused multiply-adds per point plus
# the basis contraction.

def _nqp(space, Q):
    return Q if Q is not None else math.prod(t.value.shape[1] for t in space.tabs)


def system_flops(space, Q=None):
    n = space.nen * space.dof
    return 2.0 * space.nel * _nqp(space, Q) * (n * n + n)


def residual_flops(space, Q=None):
    n = space.nen * space.dof
    return 2.0 * space.nel * _nqp(space, Q) * n


def jacobian_flops(space, Q=None):
    # forward AD of the residual: one dual pass per element column
    return system_flops(space, Q)


def spmv_flops(stencil):
    return 2.0 * stencil.nnodes * stencil.K * stencil.dof * stencil.dof


# ------------------------------------------------------------- event layer

def count(name: str, flops: float = 0.0):
    """Register one occurrence of an event with its modeled flops."""
    rec = EVENTS[name]
    rec["count"] += 1
    rec["flops"] += flops
    return rec


@contextlib.contextmanager
def annotate(name: str, flops: float = 0.0):
    """Count the event and, while a profiler records, mark the bracket as
    a named profiler range (a range costs about 18 µs of host time on
    its own, so none is opened when nothing records it)."""
    rec = count(name, flops)
    if not torch._C._autograd._profiler_enabled():
        yield rec
        return
    with torch.profiler.record_function(name):
        yield rec


class _Clock:
    """A start mark and the seconds since it: CUDA events on the card,
    the host clock without one."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()

    def seconds(self) -> float:
        if not self.cuda:
            return time.perf_counter() - self.start
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self.start.elapsed_time(end) / 1e3


@contextlib.contextmanager
def event(name: str, flops: float = 0.0):
    """Timed event bracket: the work the bracket queued is finished and
    timed at its exit."""
    rec = EVENTS[name]
    clock = _Clock()
    with torch.profiler.record_function(name):
        yield rec
    rec["count"] += 1
    rec["time"] += clock.seconds()
    rec["flops"] += flops


def timed(name: str, fn, *args, flops: float = 0.0, **kw):
    """Call ``fn``, wait for the work it queued, and add its seconds and
    flops to ``name``.  Returns fn's result."""
    with event(name, flops):
        out = fn(*args, **kw)
    return out


class Spans:
    """Time per named span (``"halo"``, ``"vcycle"``, ...): CUDA events on
    the card, the host clock on the CPU.  The events are read only by
    :meth:`ms`, so collecting adds no synchronise to the timed work.  A
    caller holds one where timing is switched on, and None (no events at
    all) by default."""

    def __init__(self):
        self._ev: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, device: torch.device):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self._ev.setdefault(name, []).append((e0, e1))
        else:
            t0 = time.perf_counter()
            yield
            self._ev.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))

    def ms(self) -> dict:
        """Total milliseconds and count per span name (synchronises)."""
        out = {}
        for name, evs in self._ev.items():
            tot = 0.0
            for e in evs:
                if isinstance(e, tuple):
                    e[1].synchronize()
                    tot += e[0].elapsed_time(e[1])
                else:
                    tot += e
            out[name] = {"ms": tot, "n": len(evs)}
        return out


def reset():
    EVENTS.clear()


def log_view(file=None):
    """``-log_view``-style table: per event its count, seconds, modeled
    flops and GF/s (0 where no time was taken)."""
    f = file or sys.stdout
    f.write(f"{'Event':<24}{'Count':>8}{'Time (s)':>12}{'Flops':>12}{'GF/s':>10}\n")
    for name, rec in sorted(EVENTS.items()):
        gfs = rec["flops"] / rec["time"] / 1e9 if rec["time"] > 0 else 0.0
        f.write(f"{name:<24}{rec['count']:>8}{rec['time']:>12.4f}"
                f"{rec['flops']:>12.4g}{gfs:>10.2f}\n")


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` window (host, and the card when one is
    present) over the enclosed region; writes ``logdir/trace.json``
    (Chrome trace format) and yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
