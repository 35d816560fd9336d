"""The elasticity cell: its plain reference against a dense quadrature
assembly, the program against the reference on the CPU at the cell's
limits, and the whole cell run judged ``correct`` as programmed and not
``correct`` with its answer broken (``control_elasticity.py``'s controls,
planted in the test's own subprocess)."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import Spec
from portbench.reference import bspline
from portbench.reference.elasticity import Elasticity

ROOT = Path(__file__).resolve().parents[2]
CELL = "elast96-mg"
LAM, MU = 1.0, 1.3  # unequal, so that a λ/μ mix-up shows
MODES = [(0, 0.7, [(2 * math.pi, 0.3), (math.pi, 1.1), (3 * math.pi, 0.2)]),
         (2, -0.4, [(0.0, math.pi / 2), (2 * math.pi, 2.0), (math.pi, 0.5)])]


def _dense(p, nel, q, lam, mu, modes):
    """The fixed stiffness ``(3 n, 3 n)`` and load ``(3 n,)`` of the
    clamped cube by an element loop over tensor-product Gauss points,
    dof index ``3·node + component``, node index axis 0 fastest."""
    x, w, B, nodes = bspline.element_tables(p, nel, q, 1)
    N = nel + p
    n = N**3
    K = np.zeros((3 * n, 3 * n))
    F = np.zeros(3 * n)
    loc = [(a0, a1, a2) for a2 in range(p + 1) for a1 in range(p + 1) for a0 in range(p + 1)]
    for e2 in range(nel):
        for e1 in range(nel):
            for e0 in range(nel):
                es = (e0, e1, e2)
                gid = [nodes[e0, a[0]] + N * nodes[e1, a[1]] + N * N * nodes[e2, a[2]]
                       for a in loc]
                for q0 in range(q):
                    for q1 in range(q):
                        for q2 in range(q):
                            qs = (q0, q1, q2)
                            wt = w[e0, q0] * w[e1, q1] * w[e2, q2]
                            val = np.array([np.prod([B[0, es[d], qs[d], a[d]] for d in range(3)])
                                            for a in loc])
                            G = np.array([[np.prod([B[1 if d == k else 0, es[d], qs[d], a[d]]
                                                    for d in range(3)]) for k in range(3)]
                                          for a in loc])
                            xs = [x[es[d], qs[d]] for d in range(3)]
                            GG = G @ G.T
                            for i in range(3):
                                for j in range(3):
                                    blk = (lam * np.outer(G[:, i], G[:, j])
                                           + mu * np.outer(G[:, j], G[:, i])
                                           + (mu * GG if i == j else 0.0))
                                    rows = [3 * g + i for g in gid]
                                    cols = [3 * g + j for g in gid]
                                    K[np.ix_(rows, cols)] += wt * blk
                            for c, amp, axes in modes:
                                f = amp * np.prod([math.sin(k * xs[d] + ph)
                                                   for d, (k, ph) in enumerate(axes)])
                                F[[3 * g + c for g in gid]] += wt * val * f
    m1 = bspline.multiplicity(p, nel)
    fixed = np.zeros(n, dtype=bool)
    mult = np.zeros(n)
    for node in range(n):
        i = (node % N, (node // N) % N, node // (N * N))
        fixed[node] = any(v in (0, N - 1) for v in i)
        mult[node] = m1[i[0]] * m1[i[1]] * m1[i[2]]
    fdof = np.repeat(fixed, 3)
    K[fdof, :] = 0.0
    K[:, fdof] = 0.0
    K[fdof, fdof] = np.repeat(mult, 3)[fdof]
    F[fdof] = 0.0
    return K, F


def test_reference_against_dense_quadrature():
    """Slot blocks, a product and a load of the reference at 3³ against a
    dense element loop: equal to float64 rounding (1e-13 of the largest
    entry)."""
    p, nel, q = 2, 3, 3
    K, F = _dense(p, nel, q, LAM, MU, MODES)
    S = Elasticity(p, nel, q, LAM, MU)
    N = S.N
    top = np.abs(K).max()
    idx = np.arange(N**3).reshape(N, N, N)
    for s in range(S.nslots):
        off = S.P.slot_offsets(s)
        for a in range(3):
            for b in range(3):
                R = S.slot_block(s, a, b, 0, N).numpy()
                want = np.zeros((N, N, N))
                for z in range(N):
                    for y in range(N):
                        for xx in range(N):
                            j = (xx + off[0], y + off[1], z + off[2])
                            if all(0 <= v < N for v in j):
                                want[z, y, xx] = K[3 * idx[z, y, xx] + a,
                                                   3 * idx[j[2], j[1], j[0]] + b]
                assert np.abs(R - want).max() <= 1e-13 * top, (s, a, b)
    xv = torch.randn((N, N, N, 3), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    y = S.apply(xv).reshape(-1).numpy()
    yd = K @ xv.reshape(-1).numpy()
    assert np.abs(y - yd).max() <= 1e-13 * np.abs(yd).max()
    b = S.load(MODES).reshape(-1).numpy()
    assert np.abs(b - F).max() <= 1e-13 * np.abs(F).max()
    u = S.solve(S.load(MODES))
    assert S.rel_residual(S.load(MODES), u) <= 1e-12


def _program_readings(nel, seed, requests):
    """The cell's problem at ``nel`` on the CPU: set-up, warm-up,
    ``requests`` solves, then its check against the reference."""
    from portbench.problems.elasticity import Problem
    from portbench.trace import Recorder

    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    cfg = dict(spec.config(cell["config"]), nel=nel)
    prob = Problem(cfg, spec.traffic(cell["traffic"]), seed, torch.device("cpu"),
                   Recorder(False, torch.device("cpu")))
    prob.warmup()
    for i in range(requests):
        prob.request(i)
    assert prob.failed == 0
    return prob.check()


# why each of the cell's limits (``cells/elast96-mg.json``) holds the
# program on the CPU too: every limit is about ten times the largest sound
# reading over the card's seeds at 96³ and these meshes
REASONS = {
    "planes_rel": "float32 sums of 27 Gauss points an entry; over the largest entry, the fixed "
                  "diagonal 27, the gap reads larger on coarse meshes (1.4e-8 at 8³, 4.0e-10 "
                  "at 96³)",
    "spmv_rel": "the kernel's float32 sums of 1125 planes (2.7e-8 to 3.1e-8 on every mesh)",
    "load_rel": "float32 sum factorisation of the body force (2.0e-7 to 3.8e-7)",
    "solution_rel": "MG-CG's rtol 1e-6 and the operator's float32 rounding (8e-7 at 8³, 1.0e-4 "
                    "at 96³)",
    "residual_over_floor": "the float32 iterate's rounding over that of the rounded exact "
                           "answer (12 to 30)",
    "residual_over_rtol": "at most 1 where MG-CG met the configuration's rtol; the limit "
                          "leaves room for the float32 norm of b, and a solve stopped at 100 "
                          "times the tolerance reads 10 or more",
}


@pytest.mark.parametrize("nel", [8, 16])
def test_program_against_reference(nel):
    """The program (f32 assembly, kernel operator, load vector, MG-CG to
    rtol 1e-6) against the float64 reference on seeded loads and a seeded
    probe, at the cell's own limits (reasons in ``REASONS``)."""
    limits = Spec(ROOT).limits(CELL)
    readings = _program_readings(nel, 2**33 + nel, 2)
    assert set(readings) == set(limits) == set(REASONS)
    for k, v in readings.items():
        assert v <= limits[k], (k, v, limits[k], REASONS[k])


def _run(mode, nel=8):
    """One run of the whole cell in a fresh process, with ``mode`` planted
    there; ``(correct, readings)``."""
    code = (
        "import io, sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench.harness import Spec, run\n"
        "from portbench.control_elasticity import plant\n"
        f"root, cell, mode, nel = Path({str(ROOT)!r}), {CELL!r}, {mode!r}, {nel!r}\n"
        "spec = Spec(root)\n"
        "ov = dict(plant(mode, spec.config(spec.cell(cell)['config'])), nel=nel)\n"
        "r = run(cell, 2**33 + 11, 0.3, False, root=root, t_start=0.0, device_type='cpu',\n"
        "        overrides=ov, out=io.StringIO(), err=io.StringIO())\n"
        "print(json.dumps([r['correct'], {k: v['value'] for k, v in r['checks'].items()}]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cell_is_correct():
    correct, readings = _run("program")
    assert correct, readings


@pytest.mark.parametrize("mode", ["unchanged", "altered", "early"])
def test_control_is_not_correct(mode):
    """The answer returned as zeros, one entry altered by the answer's
    largest magnitude, and MG-CG stopped at 100 times its tolerance.  The
    early solve fails ``residual_over_rtol`` on every mesh; at 96³ in
    float32 it is the only number it fails."""
    correct, readings = _run(mode)
    assert not correct, readings
    if mode == "early":
        limit = Spec(ROOT).limits(CELL)["residual_over_rtol"]
        assert readings["residual_over_rtol"] > limit, readings


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_the_card(cuda_device):
    """The lower precision: TF32 in the program's matrix products, at the
    cell's own size."""
    code = (
        "import io, sys, json, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from portbench.harness import Spec, run\n"
        "from portbench.control_elasticity import plant\n"
        f"root, cell = Path({str(ROOT)!r}), {CELL!r}\n"
        "spec = Spec(root)\n"
        "ov = plant('lower', spec.config(spec.cell(cell)['config']))\n"
        "r = run(cell, 2**33 + 13, 1.0, False, root=root, t_start=time.perf_counter(),\n"
        "        overrides=ov, out=io.StringIO(), err=io.StringIO())\n"
        "print(json.dumps([r['correct'], {k: v['value'] for k, v in r['checks'].items()}]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    correct, readings = json.loads(r.stdout.strip().splitlines()[-1])
    assert not correct, readings
