"""``run.py`` fails, and prints no result, without a CUDA device or in a
directory that holds only the benchmark."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "poisson256-rhs", "--seed",
         str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_KEYS = ["platform", "kind", "count", "memory_peak_bytes"]


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_one_card_result_line_keeps_its_keys(traced):
    """A cell of one card runs in this process and prints the keys it
    always printed, in their order."""
    import io
    import json

    import torch

    from portbench.harness import run_cell

    out = io.StringIO()
    r = run_cell("poisson256-rhs", 2**31 + 9, 0.2, traced, device=torch.device("cpu"),
                 t_start=0.0, root=ROOT, overrides={"nel": 6}, out=out, err=io.StringIO())
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == r
    want = KEYS[:-1] + (["breakdown"] if traced else []) + KEYS[-1:]
    assert list(r) == want
    assert list(r["device"]) == DEVICE_KEYS + (["busy_s", "window_s"] if traced else [])
    assert r["device"]["count"] == 1 and r["correct"]


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_a_multi_rank_run_prints_one_result_line(traced):
    """A cell of four cards, at a tiny mesh on four gloo ranks through the
    path ``run.py`` takes on the cards: one line on standard output, the
    device count of the cell, rank 0's metrics (traced: rank 0's trace,
    the only one taken), every check.  Each rank and the parent refuse to
    print a result while they hold JAX, so a line at all says none did."""
    import json

    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench.harness import run\n"
        f"run('poisson512-dist4', {2**31 + 5}, 0.3, {traced}, root=Path({str(ROOT)!r}),\n"
        "    t_start=time.perf_counter(), device_type='cpu', overrides={'nel': 6})\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    res = json.loads(lines[0])
    assert list(res) == KEYS[:-1] + (["breakdown"] if traced else []) + KEYS[-1:]
    assert res["device"]["count"] == 4 and res["correct"]
    if traced:
        assert r.stderr.count("trace read in") == 1  # rank 0 alone reads its trace
        assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]  # no device here
        assert {"space_build_s.setup", "krylov_iters.dist_solve", "halo_ms_per_iter.dist_solve",
                "allreduce_ms_per_iter.dist_solve"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"dist_solve_s", "setup_s"}
    assert set(res["checks"]) == {"planes_rel", "spmv_rel", "load_rel", "solution_rel",
                                  "residual_over_floor"}
    assert r.stderr.rstrip().splitlines()[-1].startswith("check residual_over_floor ")


def test_merge_takes_the_fullest_device_and_the_worst_rank():
    from portbench.harness import merge_ranks

    def part(peak, failed, planes, attempted=3, rank=0):
        p = {"metrics": {"solve_s": {"value": peak / 10, "unit": "s"}} if rank == 0 else {},
             "attempted": attempted, "failed": failed, "readings": {"planes_rel": planes},
             "peak": peak, "device_kind": "cpu"}
        if rank == 0:  # only rank 0 traces
            p["trace"] = {"busy_s": 1.0, "window_s": 2.0, "breakdown": {"device_ops": []}}
        return p

    m = merge_ranks([part(5, 0, 1e-9), part(7, 1, 2e-9, rank=1),
                     part(6, 0, float("nan"), rank=2)])
    assert m["peak"] == 7 and m["failed"] == 1 and m["same"]
    assert m["readings"]["planes_rel"] != m["readings"]["planes_rel"]  # not a number
    assert m["metrics"] == {"solve_s": {"value": 0.5, "unit": "s"}}  # rank 0's
    assert m["trace"] == {"busy_s": 1.0, "window_s": 2.0, "breakdown": {"device_ops": []}}
    m = merge_ranks([part(5, 0, 1e-9), part(5, 0, 3e-9, attempted=4, rank=1)])
    assert not m["same"] and m["readings"]["planes_rel"] == 3e-9
