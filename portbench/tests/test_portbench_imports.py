"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; compared by whole top-level
module names (the part before the first dot), so ``petiga_tpu_torch`` is
not taken for ``petiga_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "petiga_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_program_free_reference(path):
    names = _top_names(path)
    assert not names & JAX, (path, names & JAX)
    if "reference" in path.relative_to(BENCH).parts:
        assert "petiga_tpu_torch" not in names
        assert not {"portbench"} & names


def test_a_run_holds_no_jax_module():
    """A whole run at a tiny size, in a fresh process: what it loads, not
    only what its sources name."""
    code = (
        "import sys, io, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.harness import run_cell, FORBIDDEN_MODULES\n"
        "from pathlib import Path\n"
        "for w, nel in (('poisson256-rhs', 6), ('ch2d256-ad', 8)):\n"
        "    run_cell(w, 1, 0.1, False, device=torch.device('cpu'), t_start=0.0,\n"
        f"             root=Path({str(ROOT)!r}), overrides={{'nel': nel}},\n"
        "             out=io.StringIO(), err=io.StringIO())\n"
        "held = {m.split('.')[0] for m in sys.modules} & set(FORBIDDEN_MODULES)\n"
        "print(sorted(held))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_run_refuses_a_process_that_holds_jax(monkeypatch):
    import io
    import types

    import torch

    from portbench.harness import run_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out = io.StringIO()
    with pytest.raises(SystemExit) as e:
        run_cell("poisson256-rhs", 1, 0.1, False, device=torch.device("cpu"), t_start=0.0,
                 root=ROOT, overrides={"nel": 6}, out=out, err=io.StringIO())
    assert e.value.code != 0
    assert out.getvalue() == ""
