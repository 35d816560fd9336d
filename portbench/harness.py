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

A cell of one card runs in this process (:func:`run_cell`).  A cell of
``chips`` > 1 runs as one rank per card (:func:`run_ranks`), started by
the program's own launcher: every rank sets up, runs the same requests in
lock step (rank 0 decides when the window has closed and tells the
others) and judges its part; this process prints one result line from
rank 0's metrics and every rank's readings and peaks.
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

__all__ = ["Spec", "Run", "closed_loop", "run_cell", "run_ranks", "run", "merge_ranks", "worst",
           "FORBIDDEN_MODULES"]

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


def _ranks():
    """The world size of this process's job and this process's rank in
    it; ``(1, 0)`` outside one."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def _agreed(over, device):
    """Rank 0's ``over``, the same on every rank of a job: every rank then
    runs the same requests."""
    import torch.distributed as tdist

    flag = torch.tensor([int(over)], device=device)
    tdist.broadcast(flag, 0)
    return bool(flag.item())


def closed_loop(request, seconds, rec):
    """Call ``request(i)`` for i = 0, 1, ... until ``seconds`` have passed;
    the request under way when they pass runs to its end and the window
    ends with it.  Returns ``(t0, t1, durations)``.  In a job of several
    ranks, rank 0's clock decides after each request."""
    rec.sync()
    lockstep = _ranks()[0] > 1
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
            over = now - t0 >= seconds
            if lockstep:
                over = _agreed(over, rec.device)
            if over:
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


def _held():
    """The forbidden top-level modules this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def _refuse_held(err):
    held = _held()
    if held:
        print(f"modules of the JAX package or JAX loaded in this process: {held}", file=err)
        err.flush()
        raise SystemExit(3)


def run_part(workload, seed, seconds, traced, *, device, t_start, root, overrides=None,
             err=sys.stderr):
    """One process's share of a run: set-up, warm-up, the window and its
    check.  Returns what :func:`finish` reads: ``metrics``, ``attempted``,
    ``failed``, ``readings``, ``peak`` (the device's peak bytes),
    ``device_kind`` and, traced, ``trace`` (busy and window seconds and
    the breakdown).
    In a job of several ranks every rank runs this, traced alike (a traced
    run on four cards in which rank 0 alone ran the profiler hung in a
    halo exchange); rank 0's metrics and trace are the run's, and only
    rank 0 reads them."""
    spec = Spec(root)
    cell = spec.cell(workload)
    cfg = dict(spec.config(cell["config"]), **(overrides or {}))
    traffic = spec.traffic(cell["traffic"])
    first = _ranks()[1] == 0
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
        if first:
            t_read = time.perf_counter()
            summary = trace.read_trace(prof)
            print(f"trace read in {time.perf_counter() - t_read:.1f} s", file=err)
        del prof
    else:
        t0, t1, durations = prob.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(rec, durations, t0, t1, setup_s, prob.info(), summary)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(workload, kind) if first else ():
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if first:
        # each request's seconds, so that a slow run shows whether one
        # request stalled or every request ran slower
        print("request seconds " + " ".join(f"{d:.4f}" for d in durations), file=err)
    attempted, failed = len(durations), prob.failed
    readings = {k: float(v) for k, v in prob.check().items()}
    _refuse_held(err)
    part = {"metrics": metrics, "attempted": attempted, "failed": failed, "readings": readings,
            "peak": int(peak),
            "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if summary is not None:
        part["trace"] = {k: summary[k] for k in ("busy_s", "window_s", "breakdown")}
    return part


def merge_ranks(parts):
    """One run's share from every rank's (:func:`run_part`), rank 0 first:
    rank 0's metrics and trace; the worst of every reading; the largest
    peak, so that it is the fullest device's; the largest ``failed``.
    Ranks that ran a different number of requests make the run not
    correct (``same``)."""
    out = dict(parts[0])
    readings = {}
    for p in parts:
        for k, v in p["readings"].items():
            readings[k] = worst(readings[k], v) if k in readings else v
    out["readings"] = readings
    out["peak"] = max(p["peak"] for p in parts)
    out["failed"] = max(p["failed"] for p in parts)
    out["same"] = len({p["attempted"] for p in parts}) == 1
    return out


def finish(workload, part, *, count, device_type, root, out=sys.stdout, err=sys.stderr):
    """Judge the readings against the cell's limits, print each beside its
    limit to ``err`` and the result line to ``out``; return the result."""
    limits = Spec(root).limits(workload)
    checks = {}
    for name, lim in limits.items():
        v = float(part["readings"].get(name, math.nan))
        # a number that is not finite fails, and is written as null
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": lim}
    attempted, failed = part["attempted"], part["failed"]
    correct = failed == 0 and part.get("same", True) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    _refuse_held(err)
    dev = {"platform": "gpu" if device_type == "cuda" else device_type,
           "kind": part["device_kind"], "count": count, "memory_peak_bytes": part["peak"]}
    summary = part.get("trace")
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": part["metrics"], "device": dev}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    if not part.get("same", True):
        print("the ranks ran different numbers of requests", file=err)
    print(f"attempted {attempted} failed {failed} correct {correct}", file=err)
    for name, c in checks.items():
        print(f"check {name} {_fmt(c['value'])} limit {_fmt(c['limit'])}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def run_cell(workload, seed, seconds, traced, *, device, t_start, root,
             overrides=None, out=sys.stdout, err=sys.stderr):
    """Run one cell of one card once, in this process; print the checks to
    ``err`` and the result line to ``out``; return the result dict."""
    part = run_part(workload, seed, seconds, traced, device=device, t_start=t_start, root=root,
                    overrides=overrides, err=err)
    return finish(workload, part, count=1, device_type=device.type, root=root, out=out, err=err)


def _planted(root, workload, overrides, plant):
    """``overrides`` with the fault ``plant`` (``(mode, kwargs)`` of
    ``faults.py``), if any, planted in this process."""
    overrides = dict(overrides or {})
    if plant is not None:
        from . import faults

        spec = Spec(root)
        cfg = dict(spec.config(spec.cell(workload)["config"]), **overrides)
        mode, kw = plant
        overrides.update(faults.plant(mode, cfg["problem"], cfg, **kw))
    return overrides


def rank_main(workload, seed, seconds, traced, device_type, t_start, root, overrides, plant):
    """One rank of a run (the launcher's ``fn``): this rank's card, the
    fault ``plant`` (``(mode, kwargs)`` of ``faults.py``) if any, then
    :func:`run_part`, whose set-up counts from the parent's start (the
    host's monotonic clock is one for every process), so that starting
    the ranks and the process group is set-up.  What the rank writes to
    its standard output goes to standard error, so that the parent's
    result line is the only line of the run's output."""
    import os

    from petiga_tpu_torch.parallel.launch import rank_device

    sys.stdout.flush()
    os.dup2(2, 1)
    device = rank_device("cpu" if device_type == "cpu" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return run_part(workload, seed, seconds, traced, device=device, t_start=t_start, root=root,
                    overrides=_planted(root, workload, overrides, plant))


# the launcher's bounds for a job of several ranks: the whole job (set-up,
# window, check and, traced, rank 0's trace read), under a run's limit of
# 360 s so that a hung rank ends the run with every rank killed; and each
# collective, which must outlast the longest wait of one rank for another:
# unequal host set-up, and the other ranks waiting in the check's first
# exchange while rank 0 alone reads its trace (13-20 s at 512^3 on four
# cards)
JOB_TIMEOUT_S = 330.0
COLLECTIVE_TIMEOUT_S = 120.0


def run_ranks(workload, seed, seconds, traced, *, chips, t_start, root, device_type="cuda",
              overrides=None, plant=None, out=sys.stdout, err=sys.stderr):
    """Run a cell of ``chips`` ranks once, one per card (NCCL), or on the
    CPU over gloo.  Prints the checks and one result line; returns the
    result."""
    from petiga_tpu_torch.parallel.launch import launch

    backend = "nccl" if device_type == "cuda" else "gloo"
    ranks = launch(rank_main, chips,
                   (workload, seed, seconds, traced, device_type, t_start, str(root), overrides,
                    plant),
                   backend=backend, init_timeout=COLLECTIVE_TIMEOUT_S, timeout=JOB_TIMEOUT_S)
    return finish(workload, merge_ranks(ranks), count=chips, device_type=device_type, root=root,
                  out=out, err=err)


def run(workload, seed, seconds, traced, *, root, t_start, device_type="cuda", overrides=None,
        plant=None, out=sys.stdout, err=sys.stderr):
    """Run a cell once as its ``chips`` ask: in this process on one card,
    or one rank per card.  ``plant`` (``(mode, kwargs)``) breaks the
    program as ``faults.py`` says, in every process that runs it."""
    chips = Spec(root).cell(workload)["chips"]
    if chips > 1:
        return run_ranks(workload, seed, seconds, traced, chips=chips, t_start=t_start,
                         root=root, device_type=device_type, overrides=overrides, plant=plant,
                         out=out, err=err)
    overrides = _planted(root, workload, overrides, plant)
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    return run_cell(workload, seed, seconds, traced, device=device, t_start=t_start, root=root,
                    overrides=overrides, out=out, err=err)
