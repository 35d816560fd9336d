"""The comparison that decides ``correct`` fails what it must.

On the CPU at tiny meshes, each cell runs whole (set-up, window, check)
with the timed path broken underneath: an answer returned unchanged, an
answer altered where it is produced, and for the float64 cells the
program in float32; a cell of several cards runs its ranks over gloo,
the fault planted in every rank, also with the halo exchange between the
ranks left out, and its TF32 control.  On the card,
the float32 cells' control (TF32 products) at the cell's own size.
``portbench/control.py`` gives the readings over many seeds on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = {"poisson256-rhs": 6, "ch2d256-ad": 10, "poisson512-dist4": 6}


def _run(cell, mode, device="cpu", nel=None):
    """One run in a fresh process, with ``mode`` planted in every process
    that runs the cell; ``(correct, readings)``."""
    code = (
        "import io, sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench.harness import run\n"
        f"root, cell, mode, nel = Path({str(ROOT)!r}), {cell!r}, {mode!r}, {nel!r}\n"
        "ov = {} if nel is None else {'nel': nel}\n"
        "plant = None if mode == 'program' else (mode, {})\n"
        f"r = run(cell, 11, 0.3, False, root=root, t_start=0.0, device_type={device!r},\n"
        "        overrides=ov, plant=plant, out=io.StringIO(), err=io.StringIO())\n"
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


@pytest.mark.parametrize("cell", ["poisson512-dist4"])
def test_exchange_left_out_is_not_correct(cell):
    """The halo exchange between the ranks left out of every product."""
    correct, readings = _run(cell, "exchange", nel=TINY[cell])
    assert not correct, readings


@pytest.mark.parametrize("cell", ["ch2d256-ad", "poisson512-dist4"])
def test_float32_control_is_not_correct(cell):
    """The lower precision: float32 for the float64 cell, the TF32
    reference in every rank for the distributed float32 cell."""
    correct, readings = _run(cell, "lower", nel=TINY[cell])
    assert not correct, readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["poisson256-rhs", "poisson512-dist4"])
def test_tf32_control_is_not_correct_on_the_card(cell, cuda_device):
    import torch

    from portbench.harness import Spec

    chips = Spec(ROOT).cell(cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    correct, readings = _run(cell, "lower", device="cuda")
    assert not correct, readings


def test_a_fault_is_planted_once_in_a_process():
    """Asked twice, as a control over several seeds of a one-card cell
    asks, ``plant`` wraps the program once: an altered answer is altered
    once, not twice."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from petiga_tpu_torch.models import poisson\n"
        "from portbench import faults\n"
        "cfg = {'dim': 3, 'nel': 6}\n"
        "faults.plant('altered', 'poisson', cfg)\n"
        "once = poisson.solve_system\n"
        "assert faults.plant('altered', 'poisson', cfg) == {}\n"
        "assert poisson.solve_system is once\n"
        "assert faults.plant('early', 'poisson', {'krylov': {'rtol': 1e-8}}, factor=1e6) == \\\n"
        "    {'krylov': {'rtol': 1e-8 * 1e6}}\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
