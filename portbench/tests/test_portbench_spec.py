"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and key != "end_to_end" and key != "per_layer":
                    assert _line(e[text]), (e["name"], text)
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = Spec(ROOT)
    w = spec.cell(cell)
    cfg = spec.config(w["config"])
    assert cfg["reduced"] == spec._named("configs", w["config"])["reduced"]
    spec.traffic(w["traffic"])
    assert spec.limits(cell)
    assert spec.problem(cfg["problem"]).Problem
    for kind in ("end_to_end", "per_layer"):
        for m in spec.metrics_of(cell, kind):
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    spec = Spec(ROOT)
    e2e = {m["name"] for m in spec.metrics_of(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(cell, "per_layer")


def test_moves_reported_where_listed():
    spec = Spec(ROOT)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in {e["name"] for e in spec.metrics_of(cell, "end_to_end")}


def test_metrics_of_one_layer_share_its_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_roofline_and_mfu_names_have_percent_units():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, mix, cell and per-layer metric, each only new
    files and new entries in a copy of the benchmark, run without an edit
    to any file that was there."""
    import torch

    from portbench.harness import run_cell

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/poisson3d-p2-256.json").read_text())
    cfg.update(nel=6, storage="full")
    (root / "portbench/configs/poisson3d-p2-6.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/one_mode.json").write_text(json.dumps(
        {"forcing": {"load_factor": [1.0, 1.0],
                     "pool": [[{"amplitude": 1.0, "waves": [1, 2, 3], "phases": [0, 0, 0]}]]}}))
    (root / "portbench/cells/poisson6-one.json").write_text(json.dumps(
        {"limits": {"planes_rel": 1e-5, "solution_rel": 1e-4}}))
    (root / "portbench/metrics/solves.solve.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench["configs"].append({"name": "poisson3d-p2-6", "source": "a test",
                             "file": "portbench/configs/poisson3d-p2-6.json", "reduced": ["nel"],
                             "why": "a test"})
    bench["workloads"].append({"name": "poisson6-one", "config": "poisson3d-p2-6",
                               "traffic": "one_mode", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("poisson6-one")
    bench["per_layer"].append({"name": "solves.solve", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "service statistic",
                               "moves": "solve_s", "workloads": ["poisson6-one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for traced in (False, True):
        r = run_cell("poisson6-one", 5, 0.2, traced, device=torch.device("cpu"),
                     t_start=0.0, root=root, out=open("/dev/null", "w"),
                     err=open("/dev/null", "w"))
        assert r["correct"]
        want = {"solve_s", "setup_s"} if not traced else {"solves.solve"}
        assert want <= set(r["metrics"])


def test_four_card_cells_keep_to_their_share():
    """At most a quarter of the cells, rounded down, ask for four cards;
    one always may."""
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4), four


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] > 1])
def test_a_multi_card_cell_runs_its_configured_grid(cell):
    """A configuration of several ranks states as many ranks as its cell's
    cards, and the process grid the program's partitioner chooses."""
    from petiga_tpu_torch.parallel.partition import factor_grid

    spec = Spec(ROOT)
    w = spec.cell(cell)
    cfg = spec.config(w["config"])
    assert cfg["ranks"] == w["chips"]
    nodes = (cfg["nel"] + cfg["p"],) * cfg["dim"]
    assert list(factor_grid(cfg["ranks"], nodes)) == cfg["pgrid"]
    assert cfg["nodes"] == (cfg["nel"] + cfg["p"]) ** cfg["dim"]


def test_space_build_is_read_in_every_cell():
    """Every cell builds its space in set-up, the distributed cell its
    ``DistSpace`` with it, and counts the seconds."""
    m = next(m for m in BENCH["per_layer"] if m["name"] == "space_build_s.setup")
    assert sorted(m["workloads"]) == sorted(CELLS)
