"""The comparison that decides ``correct`` fails what it must.

On the CPU at tiny meshes, each cell runs whole (set-up, window, check)
with the timed path broken underneath: an answer returned unchanged, an
answer altered where it is produced, and for the float64 cells the
program in float32.  On the card, the float32 cells' control (TF32
products) at the cell's own size.  ``portbench/control.py`` gives the
readings over many seeds on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = {"poisson256-rhs": 6, "ch2d256-ad": 10}


def _run(cell, mode, device="cpu", nel=None):
    """One run in a fresh process, with ``mode`` planted; ``(correct,
    readings)``."""
    code = (
        "import io, sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench import faults\n"
        "from portbench.harness import Spec, run_cell\n"
        f"root, cell, mode, nel = Path({str(ROOT)!r}), {cell!r}, {mode!r}, {nel!r}\n"
        "spec = Spec(root)\n"
        "ov = {} if nel is None else {'nel': nel}\n"
        "cfg = dict(spec.config(spec.cell(cell)['config']), **ov)\n"
        "if mode != 'program':\n"
        "    ov.update(faults.plant(mode, cfg['problem'], cfg))\n"
        f"r = run_cell(cell, 11, 0.3, False, device=torch.device({device!r}), t_start=0.0,\n"
        "             root=root, overrides=ov, out=io.StringIO(), err=io.StringIO())\n"
        "print(json.dumps([r['correct'], {k: v['value'] for k, v in r['checks'].items()}]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_program_is_correct(cell):
    correct, readings = _run(cell, "program", nel=TINY[cell])
    assert correct, readings


@pytest.mark.parametrize("mode", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, mode):
    correct, readings = _run(cell, mode, nel=TINY[cell])
    assert not correct, readings


@pytest.mark.parametrize("cell", ["ch2d256-ad"])
def test_float32_control_is_not_correct(cell):
    correct, readings = _run(cell, "lower", nel=TINY[cell])
    assert not correct, readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["poisson256-rhs"])
def test_tf32_control_is_not_correct_on_the_card(cell, cuda_device):
    correct, readings = _run(cell, "lower", device="cuda")
    assert not correct, readings
