#!/usr/bin/env python3
"""Rehearse chip_smoke.py's later phases on the CPU at small sizes.

The phases are written for the CUDA device; this script points the
port's default device at the CPU, replaces the CUDA timing calls by host
clocks, and runs each phase at a size a CPU handles in seconds to
minutes, so control flow, shapes and checks are exercised before a chip
run.  The kernels run as their plain PyTorch versions, so no time printed
here is a device time.

    python3 scripts/torch_cpu_rehearsal.py elast f64 precond hyper ns
    python3 scripts/torch_cpu_rehearsal.py mg-band      # MG/BJ counts, 8³-32³ f32
    python3 scripts/torch_cpu_rehearsal.py ch-adapt transient
    python3 scripts/torch_cpu_rehearsal.py surface      # mapped, colloc, io_post, ...
    python3 scripts/torch_cpu_rehearsal.py front        # native, api, examples

Prints each phase's JSON lines and, last, the failed checks; exits 1 if
any failed.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import petiga_tpu_torch  # noqa: E402


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` that reads the host clock."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def _on_the_cpu():
    petiga_tpu_torch.default_device = lambda: torch.device("cpu")
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.Event = _HostEvent


def mg_band(chip_smoke, nels=(8, 16, 24, 32)):
    """MG-CG and block-Jacobi CG iteration counts of the elast96 problem
    in f32 at growing sizes (the mesh-independence band)."""
    from petiga_tpu_torch.solve.krylov import block_jacobi_preconditioner, cg

    for nel in nels:
        sp = chip_smoke.elastic_space(nel, torch.float32)
        A, b = chip_smoke.elastic_system(sp)
        op = A.fast_operator()
        hier = chip_smoke.elastic_hierarchy(sp, op)
        mg, _, _ = chip_smoke.mg_cg(sp, op, b, hier, 1e-6)
        bj = cg(op, b, M=block_jacobi_preconditioner(A), rtol=1e-6, maxiter=5000)
        chip_smoke.emit({"phase": "mg_band", "nel": nel,
                         "levels": [s.elem_shape[0] for s in hier.spaces],
                         "mg_iters": mg.iters, "bj_iters": bj.iters})


# the transient models at CPU sizes (the 1-D stepper cases run at their
# chip sizes); the Kirchhoff plate's 3 % band belongs to 32², so its
# check may fail at 8²
TRANSIENT_SMALL = {
    "shallowwater": dict(nel=8), "richards": dict(nel1=16, nel2=8), "pfc": dict(nel=8),
    "nsk": dict(nel=8), "twophase": dict(nel=32), "patternformation": dict(nel=8),
    "elasticrod": dict(nel=32), "laplace_beltrami": dict(nel=8), "kirchhoff": dict(nel=8),
    "nitsche": dict(nels=(8, 16)),
}


def transient(chip_smoke):
    for name, fn in chip_smoke.TRANSIENT:
        t0 = time.perf_counter()
        with chip_smoke.counted(name):
            out = fn(**TRANSIENT_SMALL.get(name, {}))
        chip_smoke.emit({"phase": f"transient_{name}", "host_s": time.perf_counter() - t0,
                         "launches_plain": chip_smoke.PHASE_LAUNCHES[name]["full"], **out})


# The JAX package's values at the sizes of the ``surface`` rehearsal
# (scripts/torch_geometry_reference.py at these nel; the SHA-256 values do
# not depend on the size).
SURFACE_SMALL_REF = {
    "mapped_l2": {8: 0.00020203666484600749, 16: 2.400931701074951e-05},
    "colloc_l2": {8: 0.002336609567914552, 16: 0.0005719517851971403},
    "bratu256": {"newton_iters": 4, "max_u": 0.3959599712789957},
}


def surface(chip_smoke):
    """The single-device user-surface phases at 8³ (bratu_colloc at 16²,
    the f64 L2 checks at 8³ and 16³ against the JAX package's values
    there)."""
    import tempfile

    from petiga_tpu_torch.models import poisson

    cs = chip_smoke
    cs.GEOMETRY_REF.update(SURFACE_SMALL_REF)
    with tempfile.TemporaryDirectory() as d:
        sp_map, U_map, op_map, b_map = cs.phase_mapped(8, False, d)
        cs.phase_mapped_f64(d, nels=(8, 16))
        sp_nurbs = cs.phase_mapped(8, True, d)[0]
        cs.phase_colloc(nel=8, nels_f64=(8, 16))
        cs.phase_bratu_colloc(nel=16)
        cs.phase_separable(nel=8, nel_f64=6)
        sp = poisson.make_space(3, p=2, nel=8)
        op, b = poisson.assemble_poisson(sp)
        U, _ = poisson.solve_system(op, b, rtol=1e-6)
        cs.phase_io_post(sp, U, sp_map, U_map, op_map, b_map, sp_nurbs, d)
        cs.phase_log_view(op_map)


# the JAX package's examples at CPU sizes (scripts/torch_examples_reference.py's
# parse of their output, run at these arguments)
FRONT_SMALL_REF = {'bratu': {'argv': ['--dim', '2', '-N', '8'],
               'example': 'bratu',
               'results': [['dim', '2'], ['dof', '1'], ['order', '2'], ['geometry', '0'],
                           ['rational', '0'], ['periodic', '0'], ['nnp', '10'], ['nel', '8'],
                           ['periodic', '0'], ['nnp', '10'], ['nel', '8'], ['iters', '7'],
                           ['converged', 'True'], ['max(u)', '1.322329']]},
     'cahnhilliard': {'argv': ['--nel', '8', '--nsteps', '2'],
                      'example': 'cahnhilliard',
                      'results': [['t', '1.0000e-11'], ['energy', '4.037061e-02'],
                                  ['mass', '6.432994e-05'], ['t', '2.0000e-11'],
                                  ['energy', '4.037061e-02'], ['mass', '6.433029e-05']]},
     'cahnhilliard_conv': {'argv': ['--nel', '8', '--nsteps', '2', '--conv-jacobian'],
                           'example': 'cahnhilliard',
                           'results': [['t', '1.0000e-11'], ['energy', '4.037061e-02'],
                                       ['mass', '6.432994e-05'], ['t', '2.0000e-11'],
                                       ['energy', '4.037061e-02'], ['mass', '6.433029e-05']]},
     'distributed': {'argv': ['--dim', '3', '-p', '2', '-N', '8', '--dtype', 'float64', '--pc',
                              'mg', '--checkpoint', '{tmp}'],
                     'example': 'distributed',
                     'results': [['dim', '3'], ['dof', '1'], ['order', '2'], ['geometry', '0'],
                                 ['rational', '0'], ['periodic', '0'], ['nnp', '10'], ['nel', '8'],
                                 ['periodic', '0'], ['nnp', '10'], ['nel', '8'], ['periodic', '0'],
                                 ['nnp', '10'], ['nel', '8'], ['iters', '10'],
                                 ['L2', '1.8868e-04']]},
     'elasticity': {'argv': ['--dim', '3', '-N', '4', '--dtype', 'float64'],
                    'example': 'elasticity',
                    'results': [['dim', '3'], ['dof', '3'], ['order', '2'], ['geometry', '0'],
                                ['rational', '0'], ['periodic', '0'], ['nnp', '6'], ['nel', '4'],
                                ['periodic', '0'], ['nnp', '6'], ['nel', '4'], ['periodic', '0'],
                                ['nnp', '6'], ['nel', '4'], ['iters', '14'],
                                ['L2', '1.801985e-03']]},
     'hyperelasticity': {'argv': ['--dim', '3', '-N', '3', '--dtype', 'float64'],
                         'example': 'hyperelasticity',
                         'results': [['dim', '3'], ['dof', '3'], ['order', '2'], ['geometry', '0'],
                                     ['rational', '0'], ['periodic', '0'], ['nnp', '5'],
                                     ['nel', '3'], ['periodic', '0'], ['nnp', '5'], ['nel', '3'],
                                     ['periodic', '0'], ['nnp', '5'], ['nel', '3'], ['iters', '4'],
                                     ['max|u|', '0.1000']]}}


def front(chip_smoke):
    """The front-door phases: native setup at 16³ (the native route starts
    at 4096 elements), the flat API's quickstart at 8³, and the examples at
    CPU sizes (Poisson at 8³ f64) against the JAX package's there."""
    import copy
    import tempfile

    from petiga_tpu_torch.models import poisson

    cs = chip_smoke
    cs.phase_native(nel=16, nel_setup=16, npts=1 << 13)
    cs.phase_api(nel=8)
    cs.EXAMPLES_REF = copy.deepcopy(FRONT_SMALL_REF)
    # spawned ranks do not see this process's CPU default device
    cs.EXAMPLES_REF["distributed"]["argv"] += ["--device", "cpu"]
    cs.POISSON_ARGV = ["--dim", "3", "-p", "2", "-N", "8", "--dtype", "float64"]
    sp = poisson.make_space(3, p=2, nel=8, dtype=torch.float64)
    U, _ = poisson.solve_poisson(sp, rtol=1e-12, symmetric=True)
    with tempfile.TemporaryDirectory() as d:
        cs.phase_examples(poisson.l2_error(sp, U), d)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+",
                    choices=["elast", "f64", "precond", "hyper", "ns", "mg-band", "ch-adapt",
                             "transient", "surface", "front"])
    args = ap.parse_args(argv)
    _on_the_cpu()
    import chip_smoke as cs

    for ph in args.phases:
        t0 = time.perf_counter()
        if ph == "elast":
            cs.MG_BAND = 100  # 8³ against 4³ says nothing about the band
            sp, A, op, op_sym, b, probe, Us = cs.phase_elast96(nel=8, nel_small=4)
            cs.elast96_quality(8, op, b, Us)
            cs.phase_elast_conv(sp, op, nel64=4)
        elif ph == "f64":
            cs.phase_elast_f64(nels=(8, 16))
        elif ph == "precond":
            cs.phase_precond(nel=12)
        elif ph == "hyper":
            cs.phase_hyper(nel=3, nel_big=4)
        elif ph == "ns":
            cs.phase_ns(nel_cavity=12, nel_tg=8)
        elif ph == "ch-adapt":
            cs.phase_ch_adapt(nel=8, expect={"outcome": "t_end"})
        elif ph == "transient":
            transient(cs)
        elif ph == "surface":
            surface(cs)
        elif ph == "front":
            front(cs)
        else:
            mg_band(cs)
        cs.emit({"rehearsal": ph, "host_s": time.perf_counter() - t0})
    cs.emit({"failed_checks": cs.FAILURES})
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
