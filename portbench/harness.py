"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment's sizes, settings and the
  precision it is held to; its ``problem`` names the module
  ``problems/<problem>.py``, which sets the program up and runs its
  requests;
* ``traffic/<traffic>.json``: the mix's parameters, read by that module;
* ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``: one reader per metric, ``read(run)``, which
  returns a number or None when the run has nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import trace

__all__ = ["Spec", "Run", "closed_loop", "run_cell", "worst", "FORBIDDEN_MODULES"]

HERE = Path(__file__).resolve().parent
# what the process that prints the result may not hold once the window has
# closed, compared by whole top-level module names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "petiga_tpu")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / HERE.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key, name):
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key}: no entry named {name!r}")

    def cell(self, name):
        return self._named("workloads", name)

    def config(self, name):
        return json.loads((self.root / self._named("configs", name)["file"]).read_text())

    def traffic(self, name):
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell):
        return json.loads((self.dir / "cells" / f"{cell}.json").read_text())["limits"]

    def problem(self, name):
        return importlib.import_module(f"{__package__}.problems.{name}")

    def reader(self, metric):
        return _load_module(self.dir / "metrics" / f"{metric}.py", f"pb_metric_{metric}").read

    def metrics_of(self, cell, kind):
        """The ``end_to_end`` metrics the cell reports, or (``per_layer``)
        those listed for it or, without a list, those whose ``moves`` it
        reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


class Run:
    """What the metric readers read."""

    def __init__(self, rec, durations, t0, t1, setup_s, info, trace_summary):
        self.spans = rec.spans
        self.counters = rec.counters
        self.requests = durations
        self.window_s = t1 - t0
        self.setup_s = setup_s
        self.info = info
        self.trace = trace_summary


def closed_loop(request, seconds, rec):
    """Call ``request(i)`` for i = 0, 1, ... until ``seconds`` have passed;
    the request under way when they pass runs to its end and the window
    ends with it.  Returns ``(t0, t1, durations)``."""
    rec.sync()
    durations = []
    with torch.profiler.record_function(trace.WINDOW_SPAN):
        t0 = t = time.perf_counter()
        i = 0
        while True:
            with torch.profiler.record_function("pb.request"):
                request(i)
            rec.sync()
            now = time.perf_counter()
            durations.append(now - t)
            t = now
            i += 1
            if now - t0 >= seconds:
                break
    return t0, t, durations


def worst(a, b):
    """The larger of two readings, where a reading that is not a number
    is the worst of all."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


def _fmt(v):
    return "nan" if v is None else repr(float(v))


def run_cell(workload, seed, seconds, traced, *, device, t_start, root,
             overrides=None, out=sys.stdout, err=sys.stderr):
    """Run one cell once; print the checks to ``err`` and the result line
    to ``out``; return the result dict."""
    spec = Spec(root)
    cell = spec.cell(workload)
    cfg = dict(spec.config(cell["config"]), **(overrides or {}))
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    rec = trace.Recorder(traced, device)
    prob = spec.problem(cfg["problem"]).Problem(cfg, traffic, seed, device, rec)
    prob.warmup()
    rec.sync()
    setup_s = time.perf_counter() - t_start
    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t0, t1, durations = prob.window(seconds)
        t_read = time.perf_counter()
        summary = trace.read_trace(prof)
        del prof
        print(f"trace read in {time.perf_counter() - t_read:.1f} s", file=err)
    else:
        t0, t1, durations = prob.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(rec, durations, t0, t1, setup_s, prob.info(), summary)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(workload, kind):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted, failed = len(durations), prob.failed
    readings = prob.check()
    checks = {}
    for name, lim in limits.items():
        v = float(readings.get(name, math.nan))
        # a number that is not finite fails, and is written as null
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": lim}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                  for c in checks.values())
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
    if held:
        print(f"modules of the JAX package or JAX loaded in this process: {held}", file=err)
        raise SystemExit(3)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    print(f"attempted {attempted} failed {failed} correct {correct}", file=err)
    for name, c in checks.items():
        print(f"check {name} {_fmt(c['value'])} limit {_fmt(c['limit'])}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
