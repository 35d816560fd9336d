"""Spans, counters and the device trace of one run.

A :class:`Recorder` is handed to the problem module of a cell.  Its spans are
``torch.profiler.record_function`` ranges named ``pb.<name>`` around the
calls into each layer of the program; in a traced run each span also
takes the host clock, ending in ``torch.cuda.synchronize()``.  In an
untraced run spans take no clock and synchronise nothing.

:func:`read_trace` reduces a ``torch.profiler`` trace of the window to the
device's busy time (the union of the intervals in which some operation
ran on the device), the time per device operation by name, and the idle
gaps between device operations, each named by the benchmark span and the
host operation that were open when the gap began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["Recorder", "read_trace", "WINDOW_SPAN"]

WINDOW_SPAN = "pb.window"


class Recorder:
    def __init__(self, timed: bool, device):
        self.timed = timed
        self.device = device
        self.spans = defaultdict(list)
        self.counters = defaultdict(list)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function("pb." + name):
            if not self.timed:
                yield
                return
            self.sync()
            t0 = time.perf_counter()
            yield
            self.sync()
            self.spans[name].append(time.perf_counter() - t0)

    def count(self, name, value):
        self.counters[name].append(value)


def _union(intervals):
    """Merged, sorted intervals of ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _sweep(events, times):
    """For each of the ascending ``times``, the name of the innermost of
    ``events`` (``(start, end, name)`` sorted by start, nested as the
    ranges of one thread are) open then, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _events(prof):
    """``(name, on_device, start_us, end_us, thread)`` of every event of the
    trace, read from the profiler's raw results where it has them (much
    faster than its parsed events)."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            s = e.start_ns() / 1e3
            yield (e.name(), e.device_type() == cuda, s, s + e.duration_ns() / 1e3,
                   e.start_thread_id())
        return
    for e in prof.events():
        yield (e.name, e.device_type == cuda, e.time_range.start, e.time_range.end, e.thread)


def read_trace(prof, top=10):
    """``busy_s``, ``window_s``, ``ops`` (every device operation in the
    window by name: seconds and count) and the ``breakdown`` lists of the
    device operations and idle gaps that took the most time."""
    events = list(_events(prof))
    win = [e for e in events if e[0] == WINDOW_SPAN and not e[1]]
    if not win:
        return None
    _, _, w0, w1, main = win[0]
    dev, spans, host = [], [], []
    for name, on_device, s, t, thread in events:
        if on_device:
            # the host's ranges projected onto the device's timeline are no work
            if name.startswith("pb."):
                continue
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), name))
        elif thread != main or name == WINDOW_SPAN:
            continue
        elif name.startswith("pb."):
            spans.append((s, t, name[3:]))
        else:
            host.append((s, t, name))
    ops = defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        ops[name][0] += (t - s) * 1e-6
        ops[name][1] += 1
    busy = _union([(s, t) for s, t, _ in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    outer_first = lambda ev: (ev[0], -ev[1])  # noqa: E731
    spans.sort(key=outer_first)
    host.sort(key=outer_first)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    starts = [a for a, _ in idle]
    gaps = defaultdict(float)
    for (a, b), where, op in zip(idle, _sweep(spans, starts), _sweep(host, starts)):
        where = where or "outside"
        gaps[f"{where}/{op}" if op else where] += (b - a) * 1e-6
    srt = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])  # noqa: E731
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "ops": dict(ops),
        "breakdown": {"device_ops": [[k[:160], v[0]] for k, v in
                                     sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]],
                      "idle_gaps": [[k[:160], v] for k, v in srt(gaps)[:top]]},
    }
