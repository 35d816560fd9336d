#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``petiga_tpu_torch``).

Builds the CUDA stencil-SpMV kernels from ``petiga_tpu_torch/csrc``, holds
each against its plain PyTorch version, then drives the flagship path —
3-D Poisson, p=2 B-splines, homogeneous Dirichlet — through the port's
entry points at the sizes its users run:

  m128  128³ elements, full storage: assembly, post-fix, Jacobi-CG to
        rtol 1e-6, L2 error;
  m256  256³ elements: full and symmetric assembly, full-vs-symmetric
        matvec on a seeded probe, symmetric Jacobi-CG to rtol 1e-8, L2;
  f64   the same path in float64 at 64³, 128³ and 256³: the L2 error
        falls as h³, the rate of p=2 B-splines;
  m128_refine, m256_refine
        mixed-precision refinement of the f32 solves against the f64
        matrix-free residual (the inner Jacobi-CG launches the stencil
        kernel once per iteration), L2 error on the f64 clone, held to
        the f64 assembled solves above;
  m256_matfree
        f32 matrix-free Jacobi-CG on the m256 load vector against the
        symmetric solve, and one f64 matrix-free product against the f64
        kernel product at 128³;
  pointwise
        the generic pointwise engine: q-batched plane assembly at 128³
        and 256³ against the coefficient-form planes, and the node-major
        solve at 128³ through ``StencilMatrix.fast_operator()``;
  entry ``petiga_tpu_torch.entry.entry()``;
  ch64, ch128
        the nonlinear and transient path: Cahn-Hilliard ``run_conv`` at
        64³ and 128³ periodic C¹ p=2 in f32 (3 α-steps, dt 1e-9, Newton to
        rtol 5e-3, at most 4 iterations, the settings of the TPU's ch64
        witness), every Newton iteration a conv-assembled Jacobian (28
        channels, order-2, value/gradient/Hessian state fields), a
        conv-assembled residual and a Jacobi-BiCGStab solve through the
        periodic stencil kernel.  Checks, per step: U finite and in (0, 1),
        the Newton history reaches rtol 5e-3, the mean concentration is
        conserved to 1e-6 (f64 sums), the free energy does not rise by more
        than 1e-6 relative.  Prints per step the Newton and BiCGStab
        iterations, residual and Jacobian ms, Jacobian Mnnz/s, BiCGStab ms
        per iteration and each solve's true relative residual in f64, the
        stencil kernel's launches (read from its count at each step's end;
        step 1 includes the initial-velocity mass CG), and beside them the
        TPU's ch64 values, unchecked;
  nonlinear_f64
        the card against itself at 16³: conv Jacobians (Cahn-Hilliard
        periodic, Bratu open with its Dirichlet fix) against the AD
        Jacobians of ``assemble_jacobian`` (1e-12 in f64, 1e-5 in f32), the
        conv residual against ``assemble_function`` (1e-12), ``run_conv``
        against ``run`` after 2 steps at dt 1e-11 (2e-9),
        ``solve_bratu_conv`` against ``solve_bratu``, and Newton with the
        Jacobian-free operator and with GMRES against Newton-CG on the
        kernel operator, at λ = 6.80, rtol 1e-12 (1e-9, Newton iterations
        within one); prints a GMRES(30) restart cycle's ms beside its host
        least squares' ms;
  elast96
        the vector (dof 3) class at full size, f32: 3-D linear elasticity,
        p=2, 96³ elements (2.82 M unknowns, 1125 planes, 4.24 GB), all
        faces clamped, λ = μ = 1, the manufactured field of
        examples/elasticity.py with its body force by AD; pointwise
        assembly in element chunks, block-Jacobi CG and MG-CG
        (``MGHierarchy.build`` 96 → 48 → 24 → 12 → 6, ``mg_preconditioner``)
        to rtol 1e-6 on the kernel operator, the symmetric storage's
        product against the full one, and MG-CG at 24³.  Checks: each
        solve's true relative residual in f64 within 30× its floor (the
        f64 solution of the same f32 system, rounded to f32), MG-CG in
        fewer iterations than block-Jacobi CG and within +5 of its 24³
        count, ``full_vs_sym_matvec_rel`` ≤ 1e-5;
  elast_f64
        MG-CG in f64 at 24³ and 48³: the L2 error falls at order 3 ± 0.2;
  elast_conv
        the conv engine's (3, 3)-block planes of elasticity written as
        order-1 channels against the pointwise planes: 1e-5 of the largest
        entry in f32 at 96³, 1e-12 in f64 at 16³;
  precond
        Schwarz (rigid-body and constant coarse spaces), field split
        (additive, multiplicative), EBE and BBB on 24³ elasticity in f64
        and f32, each held to its JAX test's criterion (EBE's on that
        test's 2-D Poisson problem);
  hyper
        Neo-Hooke, St-Venant–Kirchhoff and Mooney–Rivlin at 16³ and
        Neo-Hooke at 32³ (stretch 0.1 in 4 load steps), f64, Newton–CG
        on the kernel with the AD tangent, and the small-strain limit
        against linear elasticity;
  ns    the stabilized Navier–Stokes cavity at 64² (ν = 0.1,
        Newton–BiCGStab) and two RBVMS generalized-α steps of the
        Taylor–Green vortex at 32², f64;
  ch_adapt512, ch_adapt256
        ``examples/cahnhilliard.py --adaptive`` in f64 at 512² and 256²
        periodic C¹ p=2: ``integrate_adaptive`` then
        ``integrate_adaptive_device`` at the example's settings (Newton–
        BiCGStab on the kernel, AD Jacobian), each mesh held to the JAX
        package's outcome there (``CH_ADAPT_REF``, from
        ``scripts/ch_adapt_reference.py``): at 512² the controller rejects
        the first step twice (error estimates 80.04 and 13.97) and its
        next dt falls below the floor dt_min = 1e-12, so it stops at t = 0;
        256² reaches t_end in 16 steps with 3 rejections and is held
        besides to mass, free energy and t_end.  Both hold the device run
        to the host run's stop and every Newton solve to its tolerance, and
        time each residual, Jacobian assembly and BiCGStab solve.  The f64
        row of the kernel table is timed on the 512² α-step Jacobian (25
        planes, periodic);
  transient
        the θ-method, generalized-α2 and SSP-RK3 steppers, shallow water,
        Richards (1-D and 2-D), phase-field crystal, Navier–Stokes–Korteweg,
        two-phase flow, pattern formation, the elastic rod, Laplace–Beltrami
        and the Kirchhoff plate on manifolds, Nitsche and boundary-integral
        conditions and adaptive L2 projection, each on its own counted path
        at a small size, f64, held to its JAX test's criterion;
  mapped128, nurbs128
        the ``-iga_load`` flow at full width, f32: a 128³ p=2 space with its
        Greville control points warped by ``x += 0.05 Π sin(πx_i)`` (and, in
        the NURBS variant, weights ``1 + 0.3 Π sin(πG_i)``) written by the
        port's ``write_space`` and read back through
        ``Options(load=...).build_space()``; conv planes (full, and
        symmetric without weights) against the pointwise engine's (1e-5 of
        the largest entry), full against symmetric products (1e-5),
        Jacobi-CG to rtol 1e-6 on each kernel with the true residual within
        30x its floor; in f64 at 32³ and 64³ the L2 error at order 3 ± 0.15
        and within 1e-8 of the JAX package's (``GEOMETRY_REF``, from
        ``scripts/torch_geometry_reference.py``);
  colloc
        Poisson collocation at 128³ in f32 from ``bind_cli([... "--collocation"])``,
        Jacobi-BiCGStab to rtol 1e-5 on the full kernel (125-slot
        nonsymmetric stencil), the true residual within 30x its floor (the
        f64 BiCGStab solution on the f64 kernel, rounded to f32); in f64 at
        32³ and 64³ the L2 error on a Galerkin clone within 1e-8 of the JAX
        package's, and the rate;
  bratu_colloc
        Bratu collocation, 2-D p=2 256² f64, λ = 4: Newton with the AD
        collocation Jacobian and Jacobi-BiCGStab on the f64 kernel to
        ‖F‖ < 1e-10 ‖F₀‖; max U within 1e-9 and the Newton count within one
        of the JAX package's;
  separable256
        ``assemble_separable_planes`` at 256³ against the conv planes and
        load vector (1e-6 of the largest entry; 1e-12 in f64 at 16³ with
        c = 0.4, κ = 1.3), Jacobi-CG to rtol 1e-8 on the full kernel with
        its true residual within 30x its floor; its CG count and L2 error
        printed beside m256's, unchecked;
  io_post
        PetIGA binary vectors and spaces round-trip bit for bit (the mapped
        solution read back gives the same residual through the kernel),
        the seeded 8³ NURBS files' SHA-256 equal the JAX package's,
        ``Probe``/``FixedProbe`` reproduce a linear field at 4096 points
        on the m128 and mapped spaces and the pointwise tabulation on the
        mapped solution, ``sample_grid`` + ``write_vts`` parsed back;
  log_view
        ``profiling.log_view()`` of the events these phases counted and
        timed (CUDA events), after 20 timed ``MatMult`` products of the
        mapped operator;
  dist128
        the distributed layer (``parallel.dist.DistSpace``) at full width:
        the m128 flagship, f32, over 4 ranks of one gloo job that share the
        card (``parallel.launch``; pgrid (1, 2, 2), so corner folds run),
        q-batched pointwise assembly per rank, halo folds, Jacobi-CG to
        the m128 phase's rtol through ``stencil_spmv_full`` on each rank's
        halo-extended block (overlapped: interior kernel on a side stream,
        frame correction per onion slab).  Checks: 45 ± 3 iterations, L2
        within 5 % of ``L2_REF`` m128, ``true_rel_residual`` ≤ 30× its floor
        (the ranks' f64 solve of the same system), one rank's extended-block
        product equal to its plain version (1e-5, as ``phase_kernels`` holds
        f32), the sharded checkpoint of U (pgrid (1, 2, 2)) reloaded
        serially bit for bit, every rank's halo staging "host" (gloo does
        not take device pointers in send/recv).  Prints the distance to the
        m128 phase's single-device U (two f32 CG runs, unchecked), and per
        rank ms per CG iteration split into kernel, halo exchange and
        all-reduce (CUDA events); the extended-block row of the kernel
        table (rank 0 timed while the others wait), its library call a
        CSR matvec of (local rows) × (extended columns);
  dist_f64
        the same flow in f64 at 16³ on the same ranks: within 1e-10 of the
        single-device f64 solve;
  dist_nccl1
        world size 1 on NCCL (no staging) at 32³ f64: within 1e-6 of the
        single-device solve;
  dist_dryrun
        ``entry.dryrun_multichip(4)`` on the card (gloo): its seven steps
        pass their reference assertions.  One H100 shows the distributed
        layer's correctness and per-rank kernel time, not multi-GPU
        scaling;
  native
        the native host-setup library (``petiga_tpu_torch/native.py``,
        ``csrc/host/native_core.cpp``) built by the host compiler: the 128³
        p=2 closure map equal to its numpy route, ``bspline_ders`` on 2²⁰
        points within 1e-13 of its numpy route, the native call counter;
        host seconds of both routes and of a 256³ space's set-up by each;
  api   the reference's quickstart (``petiga_tpu/__init__.py:9-22``)
        through ``from petiga_tpu_torch import ...`` at 3-D p=2 128³ f32,
        Dirichlet on every face: CG to rtol 1e-6 on the full kernel, its
        true residual within 30x its floor; ``StencilOperator.from_symmetric``
        (the symmetric kernel) against the full product, ``stencil_matvec``
        against the slot loop (1e-5), both operators' kernels against their
        plain versions, ``StencilMatrix.zeros`` on the card;
  examples
        the six example programs, each ``main(argv)`` on the card through
        its command line, launches counted per example: Poisson at 128³ in
        f64, its L2 held to the f64 phase's at its printed digits; Bratu
        256², elasticity 48³ f64, hyperelasticity 12³ f64, Cahn–Hilliard
        256² (AD and conv Jacobians, 5 steps) and the distributed example
        at 64³ f64 with its MG preconditioner over 4 gloo ranks, each held
        to the JAX package's printed results at the same arguments
        (``EXAMPLES_REF``, from ``scripts/torch_examples_reference.py``:
        floats to 1e-8 or one unit in the last printed digit, counts within
        one).  Each example's kernel calls are captured at the shapes and
        dtype the example gives them (``kernel_inputs``; in the
        distributed example on each rank, its halo-framed blocks) and held
        against the plain versions on the captured x and a seeded probe
        (1e-12 in f64).

The elasticity rows of the kernel table are timed on the 96³ operator
(dof 3: 1125 planes full, 567 symmetric); their library call is a CSR
matvec of the same scalar matrix (row node·3 + a).  The periodic row of
the kernel table is timed on the ch128 Jacobian at the final state (125 planes on the 132³ extended grid); its library call is a
CSR matvec of the same periodic matrix (columns wrapped modulo N).  Every
row's bound counts the planes' node columns, x and y: the zero halo
columns that the periodic layout streams besides are a cost of the
layout, not of the product (``planes_streamed_GB`` beside
``planes_needed_GB``).

CG iteration counts are held to the reference's recorded ones (45 and
193).  In f32 the L2 error at these sizes is set by the rounding of one
interior stencil, which every interior row shares, so it is held to the
reference's own f32 system (the JAX package's planes and load vector,
assembled on an IEEE CPU, where its planes are bit-identical to this
port's) solved on the card by ``scripts/torch_f32_reference.py``; the
TPU's recorded values are printed beside.  Kernel launch counts are reset
just before each path and read just after it (``launches`` line, per
phase); the kernels are timed beside their plain versions at the main
path's shapes and beside one library call for the same product (a CSR
``torch.sparse`` matvec of the full matrix, built on the card from the
planes at 128³ and at 256³, and of the periodic ch128 Jacobian), which
the port itself never uses.

Which checks a change of f32 summation order (in a kernel, the CG
updates or the load vector) may move: the m256 ``cg_iters`` (the same
system has read 155 to 209 iterations under different roundings of its
load vector and sums) and both ``l2_error`` checks (a few per cent).  It
should not move the rounding-independent checks: ``true_rel_residual``
(the f32 solution's residual in f64, against the floor that rounding the
f64 solution of the same system to f32 leaves), ``full_vs_sym_matvec_rel``,
the kernel-vs-plain agreement, or the f64 h³ order.

Usage, from the repository root, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Prints one JSON line per phase (and the wall seconds of each block of
phases; a rank's own lines come from its process), the ``log_view``
table, the ``nvidia-smi`` name/power-limit line,
a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, without that last line, when no CUDA device is present
or any phase fails.
"""

import contextlib
import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SOURCE = "petiga_tpu_torch/csrc/stencil_spmv.cu"
PALLAS = "petiga_tpu/sparse/pallas_spmv.py"
FAILURES = []
# CG iterations recorded by the reference (BENCH_r05.json: cg_iters).
ITERS_REF = {"m128": 45, "m256": 193}
# f32 L2 errors of the reference's own f32 system: the JAX package's planes
# and load vector, solved by this port's Jacobi-CG on an NVIDIA H100 80GB
# HBM3 (700 W) at the tolerances below, L2 by the JAX package's functional
# ("l2_jax_fn" of scripts/torch_f32_reference.py).  That system reads 207
# CG iterations at m256, outside the 193 +- 10 band this port's own system
# meets: see the module docstring on summation order.
L2_REF = {"m128": 1.1209e-5, "m256": 4.864e-5}
# The TPU's recorded L2 errors (BENCH_r05.json), which IEEE f32 does not
# reproduce: printed beside, not checked (bench.py solved with k = 1 + 2e-6
# and 1 + 1e-6; with those k this port gives 5.15e-6 and 2.05e-5).
L2_TPU = {"m128": 6.0e-6, "m256": 2.40e-6}
# true_rel_residual may exceed its f32 floor by this factor: the f32 CG's
# error in the rough modes puts it 7x (m128) and 9x (m256) above the floor
# on an H100 (PERF.md, Findings); a reordered sum moves that little, a
# wrong solution by far more
RESIDUAL_OVER_FLOOR = 30.0
# The TPU's refined L2 errors (BENCH_r05.json: refined_l2_error), floored by
# an f32 cast of the refined solution: history, printed beside, not checked.
REFINED_L2_TPU = {"m128": 7.04e-8, "m256": 5.47e-8}
# Element slabs per window of the matrix-free apply, chosen by memory: the
# f64 closures of one window are zchunk·E_y·E_x·27·8 B (226 MB at 256³).
ZCHUNK = 16
# Published peaks of one H100 SXM (NVIDIA's data sheet), for the kernels'
# bounds: device memory rate, and float32/float64 rates outside the tensor
# cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}
# kernel launches of each counted path, by phase
PHASE_LAUNCHES = {}
# wall seconds of each block of phases
PHASE_SECONDS = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(name, ok, **info):
    if not ok:
        FAILURES.append(name)
    emit({"check": name, "ok": bool(ok), **info})


@contextlib.contextmanager
def counted(phase):
    """Set the kernels' launch counts to 0 just before the path, read
    them just after, into ``PHASE_LAUNCHES[phase]``."""
    from petiga_tpu_torch.sparse import spmv

    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    yield
    PHASE_LAUNCHES[phase] = dict(spmv.LAUNCHES)


def sync_s(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def time_ms(fn, reps, warm=2):
    """Mean device milliseconds per call, by CUDA events around ``reps``
    back-to-back calls after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def scalar_nnz(sp):
    nnz = 1
    for N, p in zip(sp.node_shape, sp.degrees):
        i = np.arange(N)
        nnz *= int(np.sum(np.minimum(i + p, N - 1) - np.maximum(i - p, 0) + 1))
    return nnz


# ------------------------------------------------------------------ phases


def phase_env():
    from petiga_tpu_torch.sparse import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else None,
        "triton": importlib.util.find_spec("triton") is not None,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    })
    return smi


def phase_build():
    from petiga_tpu_torch.sparse import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0, "library": path.name,
        "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln],
    })


def _random_operator(st, sym, dtype, seed):
    """Seeded slot data (out-of-range slots zero) packed on the card."""
    from petiga_tpu_torch import interop

    data = interop.random_stencil_data(st, seed, symmetric=sym)
    return interop.operator_from_stencil_data(st, data, symmetric=sym, device="cuda",
                                              dtype=dtype)


def launch_vs_plain(kind, DT, xb, shifts, G):
    """(max |Δ|, max |Δ| / max |y|) of the ``kind`` kernel's wrapper
    against its plain version on the same packed input, both on the
    device of ``xb``."""
    from petiga_tpu_torch.sparse import spmv

    sym = kind == "sym"
    y_k = (spmv.stencil_spmv_sym if sym else spmv.stencil_spmv_full)(DT, xb, shifts, G)
    y_p = torch.zeros_like(y_k)
    plain = spmv._spmv_sym_plain if sym else spmv._spmv_full_plain
    plain(DT, xb, shifts.tolist(), G, y_p)
    err = float((y_k - y_p).abs().max())
    return err, err / float(y_p.abs().max())


def kernel_vs_plain(op, xb):
    """:func:`launch_vs_plain` of an operator's kernel on ``xb``."""
    return launch_vs_plain(op.kind, op.DT, xb, op._shift_t, op.G)


@contextlib.contextmanager
def kernel_inputs():
    """Capture, for each kernel and each planes shape the path gives it,
    copies of the inputs of its first call with a non-zero x (planes,
    packed x, shifts, guard), by wrapping the wrappers' common body
    ``spmv._apply``: the call, its launch and its count are unchanged.
    Yields the captures, by key."""
    from petiga_tpu_torch.sparse import spmv

    seen, apply = {}, spmv._apply

    def spy(kind, plain, DT, xb, shifts, G, out):
        key = (kind, tuple(DT.shape), str(DT.dtype)[6:], G)
        if key not in seen and bool(xb.any()):
            seen[key] = (kind, DT.clone(), xb.clone(), shifts.clone(), G)
        return apply(kind, plain, DT, xb, shifts, G, out)

    spmv._apply = spy
    try:
        yield seen
    finally:
        spmv._apply = apply


def captured_vs_plain(seen):
    """Each capture of :func:`kernel_inputs` through the kernel and its
    plain version: on the path's own x and on a seeded probe of its shape.
    One row per capture, its tolerance 1e-12 in f64 and 1e-5 in f32."""
    rows = []
    for (kind, shape, dtype, G), (_, DT, xb, shifts, _) in seen.items():
        g = torch.Generator(xb.device).manual_seed(5)
        probe = torch.randn(xb.shape, dtype=xb.dtype, device=xb.device, generator=g)
        errs = [launch_vs_plain(kind, DT, x, shifts, G) for x in (xb, probe)]
        rows.append({"kernel": f"stencil_spmv_{kind}", "planes": list(shape), "dtype": dtype,
                     "G": G, "max_abs_err": max(e for e, _ in errs),
                     "rel_err": max(r for _, r in errs),
                     "tol": 1e-12 if DT.dtype == torch.float64 else 1e-5})
    return rows


def example_rank(argv):
    """The distributed example's rank body (``examples/distributed._rank``)
    with its kernel inputs captured; the rank's result gains the captures
    held against the plain versions, after the rank's own launches were
    read."""
    from petiga_tpu_torch.examples import distributed

    with kernel_inputs() as seen:
        res = distributed._rank(argv)
    res["kernel_vs_plain"] = captured_vs_plain(seen)
    return res


def phase_kernels():
    from petiga_tpu_torch.sparse.stencil import Stencil

    def st(shape, p, per, dof):
        return Stencil(node_shape=shape, widths=(p,) * len(shape), periodic=per, dof=dof)

    cases = [(f"full-3d-open-nel6-dof{d}", st((8, 8, 8), 2, (False,) * 3, d), False)
             for d in (1, 2, 3, 4)]
    cases += [
        ("full-2d-periodic-nel7", st((7, 7), 2, (True, True), 1), False),
        ("full-2d-mixed-nel7-dof2", st((7, 9), 2, (True, False), 2), False),
        ("full-3d-periodic-nel6-dof4", st((8, 8, 8), 2, (True, True, False), 4), False),
        ("full-1d-p3", st((23,), 3, (False,), 1), False),
        ("full-2d-periodic-nel7-dof3", st((7, 7), 2, (True, True), 3), False),
        ("full-2d-periodic-nel7-dof2", st((7, 7), 2, (True, True), 2), False),
        ("full-1d-p1-dof2", st((17,), 1, (False,), 2), False),
        ("full-2d-open-p3-dof1", st((11, 11), 3, (False, False), 1), False),
    ]
    cases += [(f"sym-3d-open-nel6-dof{d}", st((8, 8, 8), 2, (False,) * 3, d), True)
              for d in (1, 2, 3, 4)]
    for name, stc, sym in cases:
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            op = _random_operator(stc, sym, dtype, seed=len(name))
            x = torch.as_tensor(np.random.default_rng(1).normal(size=(stc.nnodes, stc.dof)),
                                dtype=dtype, device="cuda")
            err, rel = kernel_vs_plain(op, op.pack_vec(x))
            check(f"kernel:{name}:{str(dtype)[6:]}", rel <= tol, max_abs_err=err,
                  rel_err=rel, tol=tol)


def timed_solve(poisson, op, b, rtol):
    """The main path's solve step; returns (U, iters, residual, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, res = poisson.solve_system(op, b, rtol=rtol, maxiter=2000)
    t = sync_s(t0)
    return U, res.iters, float(res.residual), t


def solve_quality(poisson, sp, op, b, U):
    """How well the f32 CG solved its own f32 system, measured in f64: the
    true relative residual ``‖b − A U‖/‖b‖`` of the f32 solution; its floor,
    the same residual of the f64 solution of that system rounded to f32
    (no f32 vector does much better); the distance of U to that f64
    solution; and the f64 solution's L2 error (the error the f32 system
    itself carries, with no f32 solver in it)."""
    from petiga_tpu_torch.sparse.spmv import StencilOperator

    make = StencilOperator.from_planes_symmetric if op.kind == "sym" else StencilOperator.from_planes
    op64 = make(op.st, op.DT.double())
    b64 = b.double()
    bb = op64.pack_vec(b64)
    bn = torch.linalg.vector_norm(bb)

    def rel_res(v):
        r = bb - op64.matvec_xb(op64.DT, op64.pack_vec(v.double()))
        return float(torch.linalg.vector_norm(r) / bn)

    U64, res = poisson.solve_system(op64, b64, rtol=1e-10, maxiter=5000)
    out = {"true_rel_residual": rel_res(U), "floor_rel_residual": rel_res(U64.float()),
           "rel_err_vs_f64_solve": float(torch.linalg.vector_norm(U.double() - U64)
                                         / torch.linalg.vector_norm(U64)),
           "f64_solve_iters": res.iters,
           "l2_error_f64_solve": poisson.l2_error(sp, U64.float(), chunk=65536)}
    del op64, U64
    return out


def cg_sync_cost(poisson, op, b, iters=50):
    """ms per CG iteration of the real solve step (its set-up taken out:
    ``iters`` iterations less none) and of the same step with no host read
    of the residual; the difference is the per-iteration sync cost."""
    def solve(n):
        return lambda: poisson.solve_system(op, b, rtol=0.0, maxiter=n)

    real = (time_ms(solve(iters), reps=3, warm=1) - time_ms(solve(0), reps=3)) / iters
    dinv = op.packed_diag_inv()
    r = op.pack_vec(b)
    x = torch.zeros_like(r)
    z = r * dinv
    p, rz = z, torch.dot(r.reshape(-1), z.reshape(-1))

    def step():
        nonlocal x, r, z, p, rz
        Ap = op.matvec_xb(op.DT, p)
        alpha = rz / torch.dot(p.reshape(-1), Ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * dinv
        rz_new = torch.dot(r.reshape(-1), z.reshape(-1))
        p = z + (rz_new / rz) * p
        rz = rz_new

    nosync = time_ms(step, iters, warm=1)
    return {"loop_ms_per_iter": real, "nosync_ms_per_iter": nosync,
            "sync_ms_per_iter": real - nosync}


def f64_forcing(x):
    """Manufactured forcing of -Δu = f, u = Π sin(π x_i), 3-D, on points
    (..., 3)."""
    return 3 * math.pi**2 * torch.prod(torch.sin(math.pi * x), dim=-1)


def phase_refine(poisson, shape, sp, op, U32):
    """Mixed-precision refinement of one f32 system: f64 clone, f64
    matrix-free residual operator, f64 load vector, f32 inner Jacobi-CG
    through the stencil kernel; L2 error of the refined solution on the
    f64 clone.  Returns the refined L2 error and the refined solution."""
    from petiga_tpu_torch.solve.refine import assemble_rhs_f64, clone_f64, refined_solve
    from petiga_tpu_torch.sparse.matfree import MatFreeOperator

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp64 = clone_f64(sp)
    A64 = MatFreeOperator(sp64, c=0.0, kappa=1.0, zchunk=ZCHUNK)
    b64 = assemble_rhs_f64(sp64, A64, f64_forcing)
    t_rhs = sync_s(t0)
    t0 = time.perf_counter()
    x64, info = refined_solve(sp, op, b64, c=0.0, kappa=1.0, A64=A64, sp64=sp64,
                              rtol=1e-11, rtol_inner=1e-6)
    t_solve = sync_s(t0)
    t_res = time_ms(lambda: A64.matvec(x64), reps=2, warm=1)
    l2 = poisson.l2_error(sp64, x64)
    hist = info["residuals"]
    guard = any(not math.isfinite(r) for r in hist)
    emit({"phase": f"{shape}_refine", "zchunk": A64.zchunk, "rhs_s": t_rhs,
          "refine_s": t_solve, "refine_passes": len(info["inner_iters"]),
          "refine_inner_iters": info["inner_iters"], "refine_residuals": hist,
          "refine_rel_residual": info["relative_residual"],
          "f64_residual_ms": t_res, "nonfinite_guard_fired": guard,
          "refined_l2_error": l2, "f32_l2_error": poisson.l2_error(sp, U32),
          "refined_l2_error_tpu": REFINED_L2_TPU[shape],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    check(f"{shape}_refine:rel_residual", info["relative_residual"] <= 1e-10,
          value=info["relative_residual"], want="<= 1e-10")
    check(f"{shape}_refine:passes", len(info["inner_iters"]) <= 6,
          value=len(info["inner_iters"]), want="<= 6")
    return l2, x64


def phase_matfree(poisson, sp, b, U_sym, U_refined, rtol):
    """f32 matrix-free Jacobi-CG on the assembled path's load vector.

    It is held to the refined f64 solution.  Its distance to the f32
    symmetric assembled solve is printed beside the TPU's but not held to
    a limit: the two f32 operators round differently, and the assembled
    one's rounding (one interior stencil shared by every row) is what
    sets that solve's own error, so the distance reads the assembled
    solve's error, ``sym_vs_refined_max_diff``, on any hardware."""
    from petiga_tpu_torch.solve.krylov import cg
    from petiga_tpu_torch.sparse.matfree import MatFreeOperator

    A = MatFreeOperator(sp, c=0.0, kappa=1.0, zchunk=ZCHUNK)
    minv = 1.0 / A.scalar_diagonal()
    t_mv = time_ms(lambda: A.matvec(b), reps=3, warm=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(A, b, M=lambda z: z * minv, rtol=rtol, maxiter=2000)
    t = sync_s(t0)
    diff = float((res.x.double() - U_refined).abs().max())
    emit({"phase": "m256_matfree", "zchunk": A.zchunk, "matfree_iters": res.iters,
          "matfree_residual": float(res.residual), "matfree_solve_s": t,
          "matfree_matvec_ms": t_mv, "matfree_vs_refined_max_diff": diff,
          "matfree_vs_sym_max_diff": float((res.x - U_sym).abs().max()),
          "sym_vs_refined_max_diff": float((U_sym.double() - U_refined).abs().max()),
          "matfree_vs_sym_max_diff_tpu": 7.9e-6})
    check("m256_matfree:vs_refined", diff <= 5e-6, value=diff, want="<= 5e-6")


def planes_rel_diff(P, Q):
    """max |P - Q| / max |Q| over two plane arrays, one plane at a time
    (no second copy of a multi-GB operator)."""
    num = max(float((P[i] - Q[i]).abs().max()) for i in range(P.shape[0]))
    return num / float(Q.abs().max())


def phase_pointwise(poisson, spaces, conv_ops, nnz):
    """The generic pointwise engine: q-batched element forms into planes
    at both sizes (timed on the second call) against the coefficient-form
    planes of the same space; then the node-major solve at 128³ through
    ``StencilMatrix.fast_operator()``.

    Returns the solve's ``(U, info)`` for :func:`pointwise_quality`,
    which runs outside the counted path."""
    from petiga_tpu_torch.assembly.assemble import assemble_system_planes

    row = {"phase": "pointwise"}
    for shape in ("m128", "m256"):
        sp = spaces[shape]
        times = []
        for _ in range(2):
            op_p = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op_p, _ = assemble_system_planes(sp, poisson.poisson_system_q,
                                             {"c": 0.0, "k": 1.0}, chunk=65536, order=1)
            times.append(sync_s(t0))
        rel = planes_rel_diff(op_p.DT, conv_ops[shape].DT)
        del op_p
        row.update({f"{shape}_assembly_pointwise_s": times[-1],
                    f"{shape}_assembly_pointwise_first_s": times[0],
                    f"{shape}_assembly_pointwise_Mnnz_s": nnz[shape] / times[-1] / 1e6,
                    f"{shape}_planes_vs_conv_rel": rel})
        check(f"pointwise:{shape}:planes_vs_conv", rel <= 1e-5, value=rel, want="<= 1e-5")
    sp = spaces["m128"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, info = poisson.solve_poisson(sp, rtol=1e-6, engine="pointwise", chunk=65536)
    t = sync_s(t0)
    row.update({"m128_solve_s": t, "m128_cg_iters": info["iters"],
                "m128_cg_residual": info["residual"],
                "m128_l2_error": poisson.l2_error(sp, U),
                "l2_error_conv_ref": L2_REF["m128"]})
    emit(row)
    check("pointwise:m128:cg_iters", abs(info["iters"] - ITERS_REF["m128"]) <= 3,
          value=info["iters"], want="45 +- 3")
    return U, info


def pointwise_quality(poisson, sp, U, info):
    """The pointwise f32 solve held to its own system, as the assembled
    path's solves are (``true_rel_residual``).  Its L2 error is printed
    by :func:`phase_pointwise`, not held to the coefficient-form band: at
    this size it is set by how the interior stencil rounds, and a
    quadrature sum rounds it otherwise than a product of 1-D integrals
    does."""
    q = solve_quality(poisson, sp, info["A"].fast_operator(), info["b"], U)
    emit({"phase": "pointwise_quality", **q})
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    check("pointwise:m128:true_rel_residual", q["true_rel_residual"] <= lim,
          value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")


def phase_entry():
    """``entry()`` on the card, counted alone.  Its CG runs to rtol 1e-5,
    so the residual it returns is held to 1e-5·‖b‖ of the same system,
    assembled once more outside the counted path."""
    from petiga_tpu_torch import entry
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models import poisson

    _, b = assemble_system(poisson.make_space(3, p=2, nel=8), poisson.poisson_system,
                           {"c": 0.0, "k": 1.0})
    lim = 1e-5 * float(torch.linalg.vector_norm(b))
    with counted("entry"):
        fn, args = entry.entry()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, res = fn(*args)
        t = sync_s(t0)
    finite = bool(torch.isfinite(x).all())
    emit({"phase": "entry", "seconds": t, "shape": list(x.shape), "device": str(x.device),
          "residual": float(res), "residual_limit": lim, "finite": finite})
    check("entry:finite", finite and x.is_cuda and float(res) <= lim, residual=float(res),
          want=f"<= 1e-5 x |b| = {lim:.3e}")


def device_csr(op, rows_per_chunk=1 << 20):
    """The matrix of a full-storage operator as a CSR ``torch.sparse``
    tensor, built on the card from the planes.

    Entry (node n, slot s, block entry (a, b)) is plane ``(s·dof + a)·dof
    + b`` at n's column of the extended grid (periodic axes carry a halo
    of p on each side).  Its row is ``n·dof + a`` and its column ``(n +
    off_s)·dof + b``, the node ``n + off_s`` taken modulo ``N_d`` on a
    periodic axis (every slot lands inside) and kept on an open axis only
    where the slot stays inside the grid (the clipped slots hold zero
    planes).  Entries whose value is zero (the Dirichlet fix and
    elasticity's sparse blocks leave explicit zeros) are dropped, so the
    library call moves no entry it could do without.  Each row's columns
    are sorted on the card.  One pass counts the rows' entries, a second
    fills them; no host pass.  Indices are int32 where the count allows.
    Returns ``(csr, nnz, index dtype)``."""
    st = op.st
    if op.kind != "full":
        raise ValueError("device_csr: full storage only")
    dev, n, N, Ne, dof = op.device, st.nnodes, st.node_shape, op.Ne, st.dof
    offs = torch.as_tensor(st.slot_offsets(), device=dev)  # (K, dim)
    rows_per_chunk = max(1, rows_per_chunk // (dof * dof))
    bidx = torch.arange(dof, device=dev)

    def chunk(r0):
        """scalar rows, their values and columns in column order, the
        keep mask"""
        rows = torch.arange(r0, min(r0 + rows_per_chunk, n), device=dev)
        rem, ext, col = rows, 0, 0
        mask = torch.ones((rows.numel(), st.K), dtype=torch.bool, device=dev)
        stride_n = stride_e = 1
        for d in range(st.dim):  # axis 0 fastest
            i = rem % N[d]
            rem = rem // N[d]
            ext = ext + (i + (Ne[d] - N[d]) // 2) * stride_e
            j = i[:, None] + offs[None, :, d]
            if st.periodic[d]:
                j = j % N[d]
            else:
                mask &= (j >= 0) & (j < N[d])
            col = col + j * stride_n
            stride_n *= N[d]
            stride_e *= Ne[d]
        R = rows.numel()
        # (node, a, slot, b): scalar row n·dof + a, column (n + off_s)·dof + b
        v = op.DT[:, ext].T.reshape(R, st.K, dof, dof).permute(0, 2, 1, 3)
        c = (col[:, None, :, None] * dof + bidx).expand(R, dof, st.K, dof)
        m = mask[:, None, :, None].expand(R, dof, st.K, dof) & (v != 0)
        v, c, m = (t.reshape(R * dof, st.K * dof) for t in (v, c, m))
        c, order = torch.sort(torch.where(m, c, n * dof), dim=1)
        srows = torch.arange(r0 * dof, r0 * dof + R * dof, device=dev)
        return srows, v.gather(1, order), c, m.gather(1, order)

    indptr = torch.zeros(n * dof + 1, dtype=torch.int64, device=dev)
    for r0 in range(0, n, rows_per_chunk):
        rows, _, _, mask = chunk(r0)
        indptr[rows + 1] = mask.sum(dim=1)
    torch.cumsum(indptr, 0, out=indptr)
    nnz = int(indptr[-1])
    itype = torch.int32 if nnz < 2**31 else torch.int64
    vals = torch.empty(nnz, dtype=op.DT.dtype, device=dev)
    cols = torch.empty(nnz, dtype=itype, device=dev)
    for r0 in range(0, n, rows_per_chunk):
        rows, v, col, mask = chunk(r0)
        lo, hi = int(indptr[rows[0]]), int(indptr[rows[-1] + 1])
        vals[lo:hi] = v[mask]
        cols[lo:hi] = col[mask].to(itype)
    csr = torch.sparse_csr_tensor(indptr.to(itype), cols, vals, size=(n * dof, n * dof),
                                  check_invariants=False)
    return csr, nnz, itype


def library_csr_ms(op, xb, shape, structural_nnz, min_frac=0.9):
    """ms of one PyTorch call for the stencil kernels' product: a CSR
    ``torch.sparse`` matvec of the same matrix (:func:`device_csr`),
    timed like the kernels.  The port never calls it.  The CSR keeps at
    least ``min_frac`` of the structural entries (the rest are the
    Dirichlet fix's and the blocks' exact zeros)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csr, nnz, itype = device_csr(op)
    t_build = sync_s(t0)
    x = op.unpack_vec(xb).reshape(-1)
    y = csr @ x
    rel = float((y - op.matvec(x)).abs().max() / y.abs().max())
    runs = [time_ms(lambda: csr @ x, reps=20) for _ in range(2)]
    emit({"phase": "library_csr", "shape": shape, "nnz": nnz,
          "structural_nnz": structural_nnz,
          "index_dtype": str(itype)[6:], "build_s": t_build, "ms_runs": runs,
          "csr_GB": nnz * (op.DT.element_size() + itype.itemsize) / 1e9,
          "rel_vs_kernel": rel,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    check(f"library_csr:{shape}:nnz", min_frac * structural_nnz <= nnz <= structural_nnz,
          value=nnz, frac=nnz / structural_nnz,
          want=f"between {min_frac:g} and 1 x {structural_nnz}")
    check(f"library_csr:{shape}:agrees", rel <= 1e-5, rel=rel)
    return min(runs)


def kernel_row(name, op, shape, replaces, xb, library_ms, x_nodes=None):
    """One row of the kernel table: the kernel against its plain version
    on ``xb``, both timed (kernel, plain, kernel, plain: 20 calls each),
    the kernel's median over 5 × 20 calls and its time per product in a
    back-to-back loop of 200, its bound and the library call's ms;
    ``launches`` is filled in at the end of the run.  ``x_nodes``: the
    entries of x the product reads per field (default the rows; a rank's
    extended block reads its halo frame too)."""
    from petiga_tpu_torch.sparse import spmv

    sym = op.kind == "sym"
    err, rel_err = kernel_vs_plain(op, xb)
    yb = torch.zeros_like(xb)
    plain = spmv._spmv_sym_plain if sym else spmv._spmv_full_plain
    shifts = op.shifts_u if sym else op.shifts
    fn = spmv.stencil_spmv_sym if sym else spmv.stencil_spmv_full
    runs = {"ms": [], "plain_ms": []}
    for _ in range(2):
        runs["ms"].append(time_ms(lambda: fn(op.DT, xb, op._shift_t, op.G, out=yb), reps=20))
        runs["plain_ms"].append(time_ms(lambda: plain(op.DT, xb, shifts, op.G, yb), reps=20))
    ms, plain_ms = min(runs["ms"]), min(runs["plain_ms"])
    # beside the best of 2 x 20: the median of 5 x 20 calls, and the time
    # per product inside one back-to-back loop of 200 products
    median_ms = float(np.median([time_ms(lambda: fn(op.DT, xb, op._shift_t, op.G, out=yb),
                                         reps=20) for _ in range(5)]))
    loop_ms = time_ms(lambda: fn(op.DT, xb, op._shift_t, op.G, out=yb), reps=200)
    # the least time the card could take: the planes' node columns and x
    # read once, y written once (a periodic layout's halo columns hold
    # zeros the product does not need), against 2 operations per stored
    # nonzero (twice that for the symmetric kernel's mirror term)
    isz, nn = op.DT.element_size(), op.st.nnodes
    need = op.nplanes * nn * isz
    gbps = need / (ms * 1e-3) / 1e9
    nbytes = need + (nn + (nn if x_nodes is None else x_nodes)) * op.dof * isz
    flops = 2 * op.nplanes * nn * (2 if sym else 1)
    t_bytes = 1e3 * nbytes / HBM_BYTES_S
    t_ops = 1e3 * flops / PEAK_FLOP_S[op.DT.dtype]
    row = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
           "launches": None, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "shape": shape, "dof": op.dof, "planes": op.nplanes,
           "median_ms": median_ms, "loop_ms": loop_ms,
           "median_bound_frac": max(t_bytes, t_ops) / median_ms,
           "loop_bound_frac": max(t_bytes, t_ops) / loop_ms,
           "rel_err": rel_err, "plane_GB_s": gbps, "plane_roofline_frac": gbps / 3350.0,
           "plane_bound_ms": 1e3 * need / HBM_BYTES_S, "planes_needed_GB": need / 1e9,
           "planes_streamed_GB": op.plane_bytes / 1e9}
    emit({"phase": "timing", **row, "ms_runs": runs["ms"], "plain_ms_runs": runs["plain_ms"]})
    check(f"timing:{name}:{shape}:agrees", rel_err <= 1e-5, rel_err=rel_err)
    return {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "shape")}


def phase_f64(poisson):
    """The path in float64 at 64³, 128³ and 256³ (symmetric storage):
    with f32 rounding out of the way the L2 error is the
    discretization's, and it falls as h³ for p=2.  At 128³ one f64
    matrix-free product is held against the f64 kernel product on a
    seeded vector.  Returns the L2 errors by nel."""
    from petiga_tpu_torch.sparse.matfree import MatFreeOperator

    l2 = {}
    for nel in (64, 128, 256):
        sp = poisson.make_space(3, p=2, nel=nel, dtype=torch.float64)
        U, info = poisson.solve_poisson(sp, rtol=1e-12, symmetric=True)
        l2[nel] = poisson.l2_error(sp, U)
        emit({"phase": f"m{nel}_f64", "cg_iters": info["iters"],
              "cg_residual": info["residual"], "l2_error": l2[nel],
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        if nel == 128:
            x = torch.as_tensor(np.random.default_rng(4).normal(size=(sp.nnodes, 1)),
                                device=sp.device)
            y_mf = MatFreeOperator(sp, c=0.0, kappa=1.0, zchunk=ZCHUNK).matvec(x)
            y_k = info["A"].matvec(x)
            rel = float((y_mf - y_k).abs().max() / y_k.abs().max())
            emit({"phase": "m128_matfree_f64", "matfree_vs_kernel_rel": rel})
            check("m128_matfree_f64:vs_kernel", rel <= 1e-12, value=rel, want="<= 1e-12")
        del U, info
    for lo, hi in ((64, 128), (128, 256)):
        order = float(np.log2(l2[lo] / l2[hi]))
        check(f"f64:l2_order:{lo}-{hi}", abs(order - 3.0) <= 0.15, value=order,
              want="3 +- 0.15")
    return l2


# The TPU's run of the same ch64 settings (artifacts/r5_checks.json,
# ch_conv_alpha_3d_64): printed beside, not checked (IEEE rounding differs).
CH_TPU = {"newton_iters_total": 3, "fnorm_final": 0.13556015491485596, "s_per_step": 0.536}
# Element chunk of the pointwise assemblies of the Cahn-Hilliard path (the
# consistent initial velocity, the statistics): order-2 tables of 2^18
# elements are about 10 GB in f32.
CH_CHUNK = 1 << 18
# The Cahn-Hilliard settings of the TPU witness (scripts/bench_ch_tpu.py):
# in f32 the residual cancels to about 2e-3 relative, hence rtol 5e-3.
CH_RUN = dict(dt=1e-9, rtol_newton=5e-3, max_newton=4)


def ch_jacobian(ch, sp, U, dt):
    """The α-step Jacobian of :func:`run_conv` at the state ``U``."""
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes
    from petiga_tpu_torch.solve.ts import AlphaStepper

    am, af, g = AlphaStepper(sp, ch.residual).coeffs()
    ctx = {"theta": 1.5, "alpha": 3000.0, "shift": am / (g * dt), "scale": af}
    op, _ = assemble_coefficient_planes(sp, ch.jacobian_coefficients, ctx,
                                        fields={"c": (U.reshape(-1), 2)}, apply_fix=False)
    return op


def phase_ch(shape, nel, nsteps):
    """The Cahn-Hilliard conv-α path (``run_conv``) at nel³ periodic C¹
    p=2 in f32 from ``initial_condition(seed=0)``, counted; checks that U
    stays finite and in (0, 1), that each step's Newton history reaches
    rtol_newton, that the mean concentration is conserved (f64 sums) and
    that the free energy does not rise.  Returns the space and the final
    U."""
    from petiga_tpu_torch.assembly.assemble import compute_scalar
    from petiga_tpu_torch.models import cahnhilliard as ch
    from petiga_tpu_torch.sparse import spmv

    sp = ch.make_space(3, nel=nel, dtype=torch.float32)
    U0 = ch.initial_condition(sp, seed=0)
    mean0 = float(U0.double().mean())
    E0 = float(compute_scalar(sp, ch.free_energy_stats, U0,
                              {"theta": 1.5, "alpha": 3000.0, "cbar": 0.63}, order=1,
                              chunk=CH_CHUNK)[0])
    cnt, marks, bounds, seen = {}, [], [], [0]

    def monitor(step, t, U, stats):
        marks.append(time.perf_counter())
        seen.append(spmv.LAUNCHES["full"])  # the count since the path began
        bounds.append((float(U.min()), float(U.max()), bool(torch.isfinite(U).all()),
                       float(U.double().mean())))

    with counted(shape):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, log = ch.run_conv(sp, U0, nsteps=nsteps, counters=cnt, chunk=CH_CHUNK,
                             monitor=monitor, **CH_RUN)
        t = sync_s(t0)
    nnz = sp.nnodes * 125
    steps = []
    for k in range(nsteps):
        lin = cnt["lin_iters"][k]
        steps.append({
            "step": k + 1, "newton_iters": cnt["newton_iters"][k], "rhist": cnt["rhist"][k],
            "residual_ms": [1e3 * x for x in cnt["residual_s"][k]],
            "jacobian_ms": [1e3 * x for x in cnt["jacobian_s"][k]],
            "jacobian_Mnnz_s": [nnz / x / 1e6 for x in cnt["jacobian_s"][k]],
            "bicgstab_iters": lin,
            "bicgstab_ms_per_iter": [1e3 * x / max(i, 1) for x, i in zip(cnt["solve_s"][k], lin)],
            "bicgstab_true_rel": cnt["lin_true_rel"][k],
            "kernel_launches": seen[k + 1] - seen[k],
            "U_min_max": bounds[k][:2], "free_energy": float(log[k][2])})
    s_steps = [b - a for a, b in zip(marks, marks[1:])]
    emit({"phase": shape, "nnodes": sp.nnodes, "nsteps": nsteps, "seconds": t,
          "first_step_s": marks[0] - t0, "s_per_step": s_steps,
          "newton_iters_total": sum(cnt["newton_iters"]), "fnorm_final": cnt["fnorm"][-1],
          "launches": PHASE_LAUNCHES[shape]["full"], "steps": steps,
          "tpu_ch64": CH_TPU, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    energies = [E0] + [float(row[2]) for row in log]
    for k in range(nsteps):
        lo, hi, finite, mean = bounds[k]
        check(f"{shape}:step{k + 1}:U_in_0_1", finite and 0.0 < lo and hi < 1.0, min=lo, max=hi)
        h = cnt["rhist"][k]
        check(f"{shape}:step{k + 1}:newton_converged", h[-1] <= CH_RUN["rtol_newton"] * h[0],
              rhist=h, want=f"<= {CH_RUN['rtol_newton']} x first")
        dev = abs(mean - mean0) / mean0
        check(f"{shape}:step{k + 1}:mass", dev <= 1e-6, rel_dev=dev, want="<= 1e-6")
        rise = (energies[k + 1] - energies[k]) / abs(energies[k])
        check(f"{shape}:step{k + 1}:energy", rise <= 1e-6, rel_rise=rise, want="<= 1e-6")
    return sp, U


def phase_nonlinear_f64(nel=16):
    """The card against itself at 16³ in f64 (and the Jacobians in f32):
    conv Jacobians against AD Jacobians, the conv residual against the
    pointwise one, ``run_conv`` against ``run``, ``solve_bratu_conv``
    against ``solve_bratu``, and Newton with the Jacobian-free operator
    against the kernel operator."""
    from petiga_tpu_torch.assembly.assemble import (
        assemble_function, assemble_jacobian, dirichlet_post_fix_homogeneous)
    from petiga_tpu_torch.assembly.convform import (
        assemble_coefficient_planes, assemble_residual_conv)
    from petiga_tpu_torch.models import bratu, cahnhilliard as ch
    from petiga_tpu_torch.solve.krylov import gmres, jacobi_preconditioner
    from petiga_tpu_torch.solve.newton import newton

    row = {"phase": "nonlinear_f64", "nel": nel}
    rng = np.random.default_rng(12)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    ctx = {"theta": 1.5, "alpha": 3000.0, "shift": 7.3, "scale": 0.75}
    lam = 6.80
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        sp = ch.make_space(3, nel=nel, dtype=dt)
        C = torch.as_tensor(0.5 + 0.2 * np.sin(2 * np.pi * rng.random((sp.nnodes, 1))),
                            dtype=dt, device=sp.device)

        def fres(pt, ue, c):
            return (0.75 * ch.residual(pt, 0.0, torch.zeros_like(ue), 0.0, ue, c)
                    + 7.3 * pt.value(ue)[0] * pt.shape0)

        op, _ = assemble_coefficient_planes(sp, ch.jacobian_coefficients, ctx,
                                            fields={"c": (C, 2)}, apply_fix=False)
        ad = assemble_jacobian(sp, fres, C, ctx, order=2).fast_operator()
        rel = planes_rel_diff(op.DT, ad.DT)
        row[f"ch_conv_vs_ad_jacobian_{name}"] = rel
        check(f"nonlinear_f64:ch_jacobian:{name}", rel <= tol[dt], value=rel, want=f"<= {tol[dt]}")
        bsp = bratu.make_space(3, p=2, nel=nel, dtype=dt)
        mask = bsp.tensor("dirichlet")[0]
        Ub = torch.as_tensor(rng.normal(scale=0.1, size=(bsp.nnodes, 1)), dtype=dt,
                             device=bsp.device).masked_fill(mask, 0.0)
        bop, _ = assemble_coefficient_planes(bsp, bratu.bratu_jacobian_coefficients,
                                             {"lambda": lam}, fields={"u": Ub.reshape(-1)},
                                             apply_fix=False)
        bop, _ = dirichlet_post_fix_homogeneous(bsp, bop, torch.zeros_like(Ub))
        bad = assemble_jacobian(bsp, bratu.bratu_residual, Ub, {"lambda": lam}).fast_operator()
        rel = planes_rel_diff(bop.DT, bad.DT)
        row[f"bratu_conv_vs_ad_jacobian_{name}"] = rel
        check(f"nonlinear_f64:bratu_jacobian:{name}", rel <= tol[dt], value=rel,
              want=f"<= {tol[dt]}")
    # the conv residual against the pointwise one (f64)
    sp = ch.make_space(3, nel=nel, dtype=torch.float64)
    U = ch.initial_condition(sp, seed=2)
    V = 0.1 * ch.initial_condition(sp, seed=5)
    c2 = {"theta": 1.5, "alpha": 3000.0}
    bc = assemble_residual_conv(sp, ch.residual_channels, c2,
                                fields={"c": (U.reshape(-1), 2), "ct": (V.reshape(-1), 0)})
    bp = assemble_function(sp, lambda pt, Xe, aux_e, c: ch.residual(pt, 1.0, aux_e["V0"], 0.0,
                                                                     Xe, c), U, c2,
                           aux={"V0": V})
    rel = float((bc - bp).abs().max() / bp.abs().max())
    row["ch_residual_conv_vs_pointwise"] = rel
    check("nonlinear_f64:ch_residual", rel <= 1e-12, value=rel, want="<= 1e-12")
    # run_conv against run, 2 steps
    U0 = ch.initial_condition(sp, seed=3)
    cnt = {}
    Ua, loga = ch.run(sp, U0, dt=1e-11, nsteps=2,
                      newton_kw=dict(rtol=1e-10, linear_solver="bicgstab", maxit=4))
    Ub, logb = ch.run_conv(sp, U0, dt=1e-11, nsteps=2, rtol_newton=1e-10, max_newton=4,
                           counters=cnt)
    diff = float((Ua - Ub).abs().max())
    row.update({"ch_run_conv_vs_run_max_diff": diff, "ch_run_conv_newton_iters": cnt["newton_iters"],
                "ch_stats_run": [[float(v) for v in r] for r in loga],
                "ch_stats_run_conv": [[float(v) for v in r] for r in logb]})
    check("nonlinear_f64:run_conv_vs_run", diff <= 2e-9, value=diff, want="<= 2e-9")
    # Bratu: the conv route and the Jacobian-free route against the AD route
    bsp = bratu.make_space(3, p=2, nel=nel, dtype=torch.float64)
    ra = bratu.solve_bratu(bsp, lam=lam, rtol=1e-12)
    Uc, info = bratu.solve_bratu_conv(bsp, lam=lam, rtol=1e-12)
    diff = float((Uc - ra.U).abs().max())
    row.update({"bratu_ad_newton_iters": ra.iters, "bratu_conv_newton_iters": info["iters"],
                "bratu_conv_cg_iters": info["cg_iters"], "bratu_conv_vs_ad_max_diff": diff})
    check("nonlinear_f64:bratu_conv_vs_ad", diff <= 1e-9 and ra.converged
          and abs(info["iters"] - ra.iters) <= 1, value=diff, iters=(info["iters"], ra.iters),
          want="<= 1e-9, iterations within one")
    U0 = torch.zeros((bsp.nnodes, 1), dtype=torch.float64, device=bsp.device)
    rf = newton(bsp, bratu.bratu_residual, U0, {"lambda": lam}, rtol=1e-12, operator="fast")
    rj = newton(bsp, bratu.bratu_residual, U0, {"lambda": lam}, rtol=1e-12, operator="jfnk")
    diff = float((rf.U - rj.U).abs().max())
    row.update({"bratu_fast_newton_iters": rf.iters, "bratu_jfnk_newton_iters": rj.iters,
                "bratu_jfnk_vs_fast_max_diff": diff})
    check("nonlinear_f64:jfnk_vs_fast", diff <= 1e-9 and rf.converged and rj.converged
          and abs(rf.iters - rj.iters) <= 1, value=diff, iters=(rj.iters, rf.iters),
          want="<= 1e-9, iterations within one")
    # GMRES(30) on the card: Newton with it against CG on the same
    # operator, and its host least squares (H to the host, LAPACK, y back
    # to the card: one sync per restart cycle) timed beside a whole cycle
    rg = newton(bsp, bratu.bratu_residual, U0, {"lambda": lam}, rtol=1e-12, operator="fast",
                linear_solver="gmres")
    diff = float((rf.U - rg.U).abs().max())
    J = assemble_jacobian(bsp, bratu.bratu_residual, rf.U, {"lambda": lam}).fast_operator()
    bv = torch.as_tensor(rng.normal(size=(bsp.nnodes, 1)), device=bsp.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(J, bv, M=jacobi_preconditioner(J), rtol=1e-10, maxiter=3000)
    t_g = sync_s(t0)
    H = torch.as_tensor(rng.normal(size=(31, 30)), device=bsp.device)
    e1 = torch.zeros((31, 1), dtype=torch.float64)
    e1[0] = 1.0

    def lsq():
        return torch.linalg.lstsq(H.cpu(), e1).solution.to(bsp.device)

    lsq()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lsq()
    t_l = sync_s(t0) / 20
    cycles = res.iters // 30
    row.update({"bratu_gmres_newton_iters": rg.iters, "bratu_gmres_vs_cg_max_diff": diff,
                "gmres_cycles": cycles, "gmres_ms_per_cycle": 1e3 * t_g / max(cycles, 1),
                "gmres_rel_residual": float(res.residual / torch.linalg.vector_norm(bv)),
                "gmres_host_lstsq_ms": 1e3 * t_l})
    check("nonlinear_f64:gmres_vs_cg", diff <= 1e-9 and rg.converged
          and abs(rf.iters - rg.iters) <= 1, value=diff, iters=(rg.iters, rf.iters),
          want="<= 1e-9, iterations within one")
    emit(row)


# ------------------------------------------ the vector (dof > 1) class

# 3-D linear elasticity, p = 2, dof 3, all faces clamped, λ = μ = 1, the
# manufactured field of examples/elasticity.py; Krylov solves to rtol 1e-6
# in f32 (1e-10 in f64)
ELAST_CTX = {"lambda": 1.0, "mu": 1.0}
ELAST_RTOL = {torch.float32: 1e-6, torch.float64: 1e-10}
# element chunk of the pointwise elasticity assembly: two z-slabs of 96²
# elements, about 0.4 GB of f32 element matrices (81² entries each)
ELAST_CHUNK = 2 * 96 * 96
# MG-CG may take this many more iterations at 96³ than at 24³
MG_BAND = 5


def elastic_exact(x):
    """u_0 = Π sin(π x_i), u_1 = Π x_i (1 − x_i), u_2 = 2 u_1 on one point
    (3,) or a batch (..., 3)."""
    rest = torch.prod(x * (1 - x), dim=-1)
    return torch.stack([torch.prod(torch.sin(math.pi * x), dim=-1), rest, 2 * rest], dim=-1)


def elastic_channels(x, ctx):
    """Elasticity as order-1 channels with (3, 3) blocks: ``C_kl[r, c] =
    λ δ_rk δ_cl + μ δ_rl δ_ck + μ δ_rc δ_kl``."""
    lam, mu = ctx["lambda"], ctx["mu"]
    ch = {}
    for k in range(3):
        for l in range(3):
            C = np.zeros((3, 3))
            C[k, l] += lam
            C[l, k] += mu
            if k == l:
                C += mu * np.eye(3)
            ch[(k + 1, l + 1)] = C
    return ch


def elastic_space(nel, dtype):
    from petiga_tpu_torch.core.axis import Axis
    from petiga_tpu_torch.core.space import Space

    sp = Space([Axis.uniform(p=2, nel=nel)] * 3, dof=3, dtype=dtype)
    for d in range(3):
        for side in range(2):
            for c in range(3):
                sp.set_boundary_value(d, side, c, 0.0)
    return sp


def elastic_system(sp, ctx=None):
    """Pointwise assembly of the manufactured problem: (A, b)."""
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models import elasticity as el

    return assemble_system(sp, el.body_force_system(elastic_exact), ctx or ELAST_CTX,
                           chunk=ELAST_CHUNK)


def compute_l2(sp, U):
    """L2 error of a displacement against the manufactured field."""
    from petiga_tpu_torch.assembly.assemble import compute_error_norm

    return compute_error_norm(sp, U, elastic_exact)


def elastic_hierarchy(sp, A_fine):
    """``MGHierarchy.build`` with the fine level's kernel operator and the
    coarse levels assembled pointwise (their planes packed for the
    kernel): the operators every V-cycle product runs on."""
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models import elasticity as el
    from petiga_tpu_torch.solve.multigrid import MGHierarchy

    def assemble(s):
        if s is sp:
            return A_fine
        return assemble_system(s, el.elasticity_system, ELAST_CTX, chunk=ELAST_CHUNK)[0]

    return MGHierarchy.build(sp, assemble, min_nel=4)


def elastic_quality(op, b, Us):
    """Each f32 solution's true relative residual ``‖b − A U‖/‖b‖`` in
    f64 against its floor: the f64 block-Jacobi CG solution of the same
    f32 system, rounded to f32."""
    from petiga_tpu_torch.solve.krylov import block_jacobi_preconditioner, cg
    from petiga_tpu_torch.sparse.spmv import StencilOperator

    op64 = StencilOperator.from_planes(op.st, op.DT.double())
    b64 = b.double()
    bn = float(torch.linalg.vector_norm(b64))

    def rel_res(v):
        return float(torch.linalg.vector_norm(b64 - op64.matvec(v.double()))) / bn

    res = cg(op64, b64, M=block_jacobi_preconditioner(op64), rtol=1e-10, maxiter=10000)
    out = {"f64_solve_iters": res.iters, "floor_rel_residual": rel_res(res.x.float())}
    out.update({f"{k}_true_rel_residual": rel_res(U) for k, U in Us.items()})
    del op64
    return out


def mg_cg(sp, op, b, hier, rtol):
    """MG-CG on the kernel operator: (result, seconds, V-cycle ms)."""
    from petiga_tpu_torch.solve.krylov import cg
    from petiga_tpu_torch.solve.multigrid import mg_preconditioner

    M = mg_preconditioner(hier)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(op, b, M=M, rtol=rtol, maxiter=1000)
    t = sync_s(t0)
    return res, t, time_ms(lambda: M(b), reps=3, warm=1)


def phase_elast96(nel=96, nel_small=24):
    """The slice at full size, f32: assembly, block-Jacobi CG and MG-CG on
    the 96³ operator, the symmetric storage's product against the full
    one, and MG-CG at 24³ for the mesh-independence check.  Returns the
    space, the node-major operator, its kernel operator, the symmetric
    kernel operator, b and the seeded probe."""
    from petiga_tpu_torch.solve.krylov import block_jacobi_preconditioner, cg
    from petiga_tpu_torch.sparse.stencil import SymmetricStencilMatrix

    rtol = ELAST_RTOL[torch.float32]
    row = {"phase": f"elast{nel}", "nel": nel}
    sp = elastic_space(nel, torch.float32)
    times = []
    for _ in range(2):  # the first call includes first-use allocations
        A = b = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A, b = elastic_system(sp)
        times.append(sync_s(t0))
    t0 = time.perf_counter()
    op = A.fast_operator()
    t_pack = sync_s(t0)
    row.update({"nnodes": sp.nnodes, "unknowns": sp.nnodes * 3, "planes": op.nplanes,
                "plane_GB": op.plane_bytes / 1e9, "assembly_s": times[-1],
                "assembly_first_s": times[0], "pack_s": t_pack})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bj = cg(op, b, M=block_jacobi_preconditioner(A), rtol=rtol, maxiter=5000)
    t_bj = sync_s(t0)
    t0 = time.perf_counter()
    hier = elastic_hierarchy(sp, op)
    t_h = sync_s(t0)
    mg, t_mg, vc_ms = mg_cg(sp, op, b, hier, rtol)
    row.update({"bj_iters": bj.iters, "bj_s": t_bj, "bj_ms_per_iter": 1e3 * t_bj / max(bj.iters, 1),
                "mg_levels": [s.elem_shape[0] for s in hier.spaces], "mg_build_s": t_h,
                "mg_iters": mg.iters, "mg_s": t_mg, "mg_ms_per_iter": 1e3 * t_mg / max(mg.iters, 1),
                "vcycle_ms": vc_ms,
                "l2_error_bj": float(compute_l2(sp, bj.x)), "l2_error_mg": float(compute_l2(sp, mg.x))})
    del hier
    # the symmetric storage's product on a seeded probe
    probe = torch.as_tensor(np.random.default_rng(8).normal(size=(sp.nnodes, 3)),
                            dtype=torch.float32, device=sp.device)
    op_sym = SymmetricStencilMatrix.from_full(A).fast_operator()
    y_full, y_sym = op.matvec(probe), op_sym.matvec(probe)
    rel = float((y_sym - y_full).abs().max() / y_full.abs().max())
    row.update({"sym_planes": op_sym.nplanes, "full_vs_sym_matvec_rel": rel})
    # MG-CG at 24³, the same problem
    sp_s = elastic_space(nel_small, torch.float32)
    A_s, b_s = elastic_system(sp_s)
    op_s = A_s.fast_operator()
    mg_s, _, _ = mg_cg(sp_s, op_s, b_s, elastic_hierarchy(sp_s, op_s), rtol)
    row.update({f"mg_iters_{nel_small}": mg_s.iters, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    del A_s, b_s, op_s
    emit(row)
    check(f"elast{nel}:full_vs_sym_matvec_rel", rel <= 1e-5, value=rel, want="<= 1e-5")
    check(f"elast{nel}:mg_fewer_iters", mg.iters < bj.iters, mg=mg.iters, bj=bj.iters)
    check(f"elast{nel}:mg_mesh_independent", mg.iters <= mg_s.iters + MG_BAND,
          value=mg.iters, at_small=mg_s.iters, want=f"<= {mg_s.iters} + {MG_BAND}")
    return sp, A, op, op_sym, b, probe, {"bj": bj.x, "mg": mg.x}


def elast96_quality(nel, op, b, Us):
    q = elastic_quality(op, b, Us)
    emit({"phase": f"elast{nel}_quality", **q})
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    for k in Us:
        v = q[f"{k}_true_rel_residual"]
        check(f"elast{nel}:{k}:true_rel_residual", v <= lim, value=v,
              want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")


def phase_elast_f64(nels=(24, 48)):
    """MG-CG in f64: the L2 error of the manufactured field falls at the
    p = 2 rate, 3 ± 0.2 (tests/test_models_vector.py:46)."""
    rtol = ELAST_RTOL[torch.float64]
    l2 = {}
    for nel in nels:
        sp = elastic_space(nel, torch.float64)
        A, b = elastic_system(sp)
        op = A.fast_operator()
        res, t, vc = mg_cg(sp, op, b, elastic_hierarchy(sp, op), rtol)
        l2[nel] = float(compute_l2(sp, res.x))
        emit({"phase": f"elast{nel}_f64", "mg_iters": res.iters, "mg_s": t, "vcycle_ms": vc,
              "cg_residual": float(res.residual), "l2_error": l2[nel]})
        del A, b, op, res
    order = float(np.log2(l2[nels[0]] / l2[nels[1]]))
    check("elast_f64:l2_order", abs(order - 3.0) <= 0.2, value=order, want="3 +- 0.2")


def phase_elast_conv(sp96, op96, nel64=16):
    """The (3, 3)-block coefficient planes of the conv engine (elasticity
    as order-1 channels, the constant blocks' outer-product write)
    against the pointwise planes: 1e-5 of the largest entry in f32 at
    96³, 1e-12 in f64 at 16³."""
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes

    n = sp96.elem_shape[0]
    row = {"phase": "elast_conv"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opc, _ = assemble_coefficient_planes(sp96, elastic_channels, ELAST_CTX)
    row[f"conv_assembly_s_{n}"] = sync_s(t0)
    rel = planes_rel_diff(opc.DT, op96.DT)
    del opc
    sp = elastic_space(nel64, torch.float64)
    A, _ = elastic_system(sp)
    opc, _ = assemble_coefficient_planes(sp, elastic_channels, ELAST_CTX)
    rel64 = planes_rel_diff(opc.DT, A.fast_operator().DT)
    row.update({f"conv_vs_pointwise_rel_f32_{n}": rel, f"conv_vs_pointwise_rel_f64_{nel64}": rel64})
    emit(row)
    check("elast_conv:f32", rel <= 1e-5, value=rel, want="<= 1e-5")
    check("elast_conv:f64", rel64 <= 1e-12, value=rel64, want="<= 1e-12")


def _ebe_blocks(sp, system, ctx):
    """Per-element Dirichlet-fixed blocks (nel, nen·dof, nen·dof)."""
    from petiga_tpu_torch.assembly.assemble import _make_element_KF

    Ke = _make_element_KF(sp, ctx, 1, True)(torch.arange(sp.nel, device=sp.device), None,
                                            system)[0]
    n = sp.nen * sp.dof
    return Ke.permute(0, 1, 3, 2, 4).reshape(sp.nel, n, n)


def phase_precond(nel=24):
    """Each preconditioner of the slice on 3-D elasticity (λ = 2, μ = 1,
    body force sin(π x)) in f64 and f32, held to the criterion of its
    JAX test: Schwarz with rigid-body coarse modes takes at most 2
    iterations more than with the constants (tests/test_schwarz.py:160-162);
    field split additive (CG) and multiplicative (BiCGStab), EBE (CG) and
    BBB (BiCGStab, fewer iterations than Jacobi-CG) each reach the
    block-Jacobi CG solution (tests/test_fieldsplit.py:53,
    tests/test_blockpc.py:70): 1e-7 absolute in f64, 1e-3 of its largest
    entry in f32.  EBE's own criterion, at most 3× the iterations of
    Jacobi-CG (tests/test_blockpc.py:53), is held on that test's problem,
    2-D Poisson at 12² in f64."""
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models import elasticity as el
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.solve.blockpc import bbb_preconditioner, ebe_preconditioner
    from petiga_tpu_torch.solve.fieldsplit import fieldsplit_preconditioner
    from petiga_tpu_torch.solve.krylov import (
        bicgstab, block_jacobi_preconditioner, cg, jacobi_preconditioner)
    from petiga_tpu_torch.solve.schwarz import schwarz_preconditioner

    ctx = {"lambda": 2.0, "mu": 1.0, "body_force": lambda x: torch.sin(math.pi * x)}
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        rtol = ELAST_RTOL[dt]
        sp = elastic_space(nel, dt)
        A, b = assemble_system(sp, el.elasticity_system, ctx, chunk=ELAST_CHUNK)
        op = A.fast_operator()
        ref = cg(op, b, M=block_jacobi_preconditioner(A), rtol=rtol, maxiter=5000)
        jac = cg(op, b, M=jacobi_preconditioner(A), rtol=rtol, maxiter=5000)
        scale = float(ref.x.abs().max())
        tol_x = 1e-7 if dt == torch.float64 else 1e-3 * scale
        row = {"phase": f"precond_{name}", "nel": nel, "bj_iters": ref.iters,
               "jacobi_iters": jac.iters}

        def run(key, solver, M_build):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M = M_build()
            t_b = sync_s(t0)
            t0 = time.perf_counter()
            res = solver(op, b, M=M, rtol=rtol, maxiter=5000)
            t_s = sync_s(t0)
            err = float((res.x - ref.x).abs().max())
            row[key] = {"iters": res.iters, "build_s": t_b, "solve_s": t_s, "max_diff": err}
            check(f"precond:{name}:{key}:solution", err <= tol_x and math.isfinite(err),
                  value=err, want=f"<= {tol_x:.3e}")
            return res

        subs = (nel // 6,) * 3  # boxes of 7 nodes a side, 9 with the overlap
        rc = run("schwarz_constants", cg, lambda: schwarz_preconditioner(
            A, subdomains=subs, overlap=1))
        rr = run("schwarz_rigid_body", cg, lambda: schwarz_preconditioner(
            A, subdomains=subs, overlap=1, coarse_modes=el.rigid_body_modes(sp)))
        check(f"precond:{name}:schwarz_rbm_iters", rr.iters <= rc.iters + 2,
              rbm=rr.iters, constants=rc.iters, want="rbm <= constants + 2")
        run("fieldsplit_additive", cg, lambda: fieldsplit_preconditioner(A, kind="additive"))
        run("fieldsplit_multiplicative", bicgstab,
            lambda: fieldsplit_preconditioner(A, kind="multiplicative"))
        # EBE on 3-D elasticity converges to the solution, but takes more
        # than 3× Jacobi-CG's iterations (4.6× at 24³ in f64 on an H100),
        # and in f32 the reference's pseudo-inverse cut-off (10·n·eps)
        # falls among the element matrices' own smallest singular values:
        # its count is printed, and the JAX test's criterion is held on
        # that test's own problem below
        run("ebe", cg, lambda: ebe_preconditioner(sp, _ebe_blocks(sp, el.elasticity_system,
                                                                   ctx)))
        rb = run("bbb", bicgstab, lambda: bbb_preconditioner(A, overlap=1))
        check(f"precond:{name}:bbb_iters", rb.iters < jac.iters, value=rb.iters,
              want=f"< {jac.iters}")
        if dt == torch.float64:
            # EBE on the JAX test's own problem (2-D Poisson, p = 2, 12²,
            # f64): at most 3× the iterations of Jacobi-CG, the solution
            # within 1e-8 of Jacobi-CG's at rtol 1e-12
            # (tests/test_blockpc.py:44-53)
            psp = poisson.make_space(2, p=2, nel=12, dtype=dt)
            pctx = {"c": 0.0, "k": 1.0}
            A, b = assemble_system(psp, poisson.poisson_system, pctx)
            op = A.fast_operator()
            pjac = cg(op, b, M=jacobi_preconditioner(A), rtol=1e-10, maxiter=5000)
            pref = cg(op, b, M=jacobi_preconditioner(A), rtol=1e-12, maxiter=5000)
            pe = cg(op, b, rtol=1e-10, maxiter=5000,
                    M=ebe_preconditioner(psp, _ebe_blocks(psp, poisson.poisson_system, pctx)))
            err = float((pe.x - pref.x).abs().max())
            row["ebe_poisson_2d"] = {"iters": pe.iters, "jacobi_iters": pjac.iters,
                                     "max_diff": err}
            check(f"precond:{name}:ebe_poisson_2d", pe.iters <= 3 * pjac.iters and err <= 1e-8,
                  iters=pe.iters, jacobi=pjac.iters, max_diff=err,
                  want=f"<= 3 x {pjac.iters}, max_diff <= 1e-8")
        row["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
        emit(row)
        del A, b, op


def phase_hyper(nel=16, nel_big=32):
    """Hyperelasticity, 3-D, f64: Neo-Hooke, St-Venant–Kirchhoff and
    Mooney–Rivlin at stretch 0.05 on 16³, Neo-Hooke at stretch 0.1 on 32³
    in 4 load steps,
    Newton–CG on the kernel with the AD tangent; each converges with the
    stretch and the clamp held, and at stretch 1e-4 Neo-Hooke is linear
    elasticity to 1e-3 relative (tests/test_models_vector.py:91)."""
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models import elasticity as el
    from petiga_tpu_torch.models import hyperelasticity as hel
    from petiga_tpu_torch.solve.krylov import block_jacobi_preconditioner, cg

    f64 = torch.float64
    # (name, nel, stretch, material, load steps): the first Newton step
    # starts from the boundary values lifted onto the last element layer,
    # a deformation gradient of about 1 + 2·stretch·nel there, so the
    # 32³ stretch of 0.1 is taken in 4 load steps (the 16³ step of 0.05
    # starts from the same gradient)
    cases = [("neo_hookean", nel, 0.05, hel.neo_hookean(1.0, 1.0), 1),
             ("st_venant", nel, 0.05, hel.st_venant(1.0, 1.0), 1),
             ("mooney_rivlin", nel, 0.05, hel.mooney_rivlin(0.5, 0.1, 1.0), 1),
             ("neo_hookean", nel_big, 0.1, hel.neo_hookean(1.0, 1.0), 4)]
    for name, n, stretch, mat, steps in cases:
        sp = hel.make_space(3, p=2, nel=n, dtype=f64, stretch=stretch)
        hist = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, res = hel.solve(sp, material=mat, rtol=1e-10, chunk=4096, continuation=steps,
                           monitor=lambda k, f, li: hist.append((f, li)))
        t = sync_s(t0)
        Ug = U.reshape(*sp.node_shape[::-1], 3)
        bc = max(float((Ug[:, :, -1, 0] - stretch).abs().max()), float(Ug[:, :, 0, :].abs().max()))
        emit({"phase": f"hyper_{name}_{n}", "stretch": stretch, "load_steps": steps,
              "newton_iters": res.iters,
              "fnorm_history": [h[0] for h in hist], "cg_iters": [h[1] for h in hist[1:]],
              "seconds": t, "boundary_err": bc, "max_u": float(U.abs().max())})
        check(f"hyper:{name}:{n}:converged", res.converged and bc <= 1e-10,
              fnorm=res.fnorm, boundary_err=bc)
    eps = 1e-4
    sp = hel.make_space(3, p=2, nel=nel, dtype=f64, stretch=eps)
    U, res = hel.solve(sp, rtol=1e-12, chunk=4096)
    sp2 = hel.make_space(3, p=2, nel=nel, dtype=f64, stretch=eps)
    A, b = assemble_system(sp2, el.elasticity_system, ELAST_CTX)
    Ul = cg(A.fast_operator(), b, M=block_jacobi_preconditioner(A), rtol=1e-12, maxiter=5000).x
    diff = float((U - Ul).abs().max()) / eps
    emit({"phase": "hyper_small_strain", "nel": nel, "newton_iters": res.iters,
          "rel_diff_vs_linear": diff})
    check("hyper:small_strain_vs_linear", res.converged and diff < 1e-3, value=diff,
          want="< 1e-3")


def phase_ns(nel_cavity=64, nel_tg=32):
    """Navier–Stokes VMS, 2-D, dof 3, f64: the lid-driven cavity at ν = 0.1
    (tests/test_models_transient.py:41-52: the lid and no-slip values,
    recirculation, fnorm < 1e-4) and two generalized-α steps of the
    Taylor–Green vortex (E1/E0 within 5 % of exp(−16π²νt), ‖∇·u‖ < 0.5)."""
    from petiga_tpu_torch.models import navierstokes as ns

    sp = ns.make_cavity_space(nel=nel_cavity, p=2)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, res = ns.solve_cavity(sp, nu=0.1, rtol=1e-5, maxit=25,
                             monitor=lambda k, f, li: hist.append((f, li)))
    t = sync_s(t0)
    Ug = U.reshape(*sp.node_shape[::-1], 3)
    lid = float((Ug[-1, 1:-1, 0] - 1.0).abs().max())
    wall = float(Ug[0, :, 0].abs().max())
    recirc = float(Ug[1:-1, :, 0].min())
    emit({"phase": f"ns_cavity_{nel_cavity}", "newton_iters": res.iters, "seconds": t,
          "fnorm_history": [h[0] for h in hist], "bicgstab_iters": [h[1] for h in hist[1:]],
          "lid_err": lid, "wall_err": wall, "min_ux": recirc})
    check("ns:cavity", res.converged and res.fnorm < 1e-4 and lid <= 1e-10 and wall <= 1e-10
          and recirc < -1e-3 and bool(torch.isfinite(U).all()),
          fnorm=res.fnorm, lid_err=lid, wall_err=wall, min_ux=recirc)
    nu, dt = 0.02, 5e-3
    sp = ns.taylor_green_space(nel=nel_tg, p=2)
    U0 = ns.taylor_green_init(sp, nu)
    lam = 8 * math.pi**2 * nu
    rate = torch.tensor([-lam, -lam, -2 * lam], dtype=U0.dtype, device=U0.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, _, tt = ns.solve_transient_vms(sp, U0, nu=nu, dt=dt, nsteps=2, V0=U0 * rate)
    t = sync_s(t0)
    E0, E1 = float(ns.kinetic_energy(sp, U0)), float(ns.kinetic_energy(sp, U))
    expect = math.exp(-16 * math.pi**2 * nu * tt)
    div = float(ns.divergence_l2(sp, U))
    emit({"phase": f"ns_taylor_green_{nel_tg}", "seconds": t, "E1_over_E0": E1 / E0,
          "expected": expect, "divergence_l2": div})
    check("ns:taylor_green", E1 < E0 and abs(E1 / E0 - expect) <= 0.05 * expect and div < 0.5
          and bool(torch.isfinite(U).all()), ratio=E1 / E0, expected=expect, div=div)


# ------------------------- the time steppers and the remaining models

# examples/cahnhilliard.py --adaptive: generalized-α (ρ∞ = 0.5) with
# Newton–BiCGStab to rtol 1e-6 on the kernel operator, the basic controller
# from dt 1e-11 to the example's t_end (nsteps·dt·100 = 5e-9) at rtol =
# atol = 1e-3, in f64 (the example enables x64: the 4th-order problem is
# stiff)
CH_CTX = {"theta": 1.5, "alpha": 3000.0, "cbar": 0.63}
CH_ADAPT = dict(dt0=1e-11, t_end=5e-9, rtol=1e-3, atol=1e-3)
CH_NEWTON = dict(rtol=1e-6, linear_solver="bicgstab", operator="fast")


# The JAX package's run of the same example at each mesh
# (scripts/ch_adapt_reference.py on the CPU of the H100 machine): its
# error estimates of the attempts from t = 0 up to the first accepted step,
# and its outcome.  512² rejects twice and its next proposal falls below
# dt_min = 1e-12 ("adaptive dt underflow at t=0.0"); 256² accepts its
# fourth attempt and reaches t_end in 16 steps with 3 rejections.  The
# estimates are held to 1e-8 relative (the port's read 7.6e-11 from them
# on the H100: the two packages' Newton iterates part at round-off, and the
# estimate divides a difference of nearly equal states by 1e-3 weights);
# dt_final to 1e-9 (4.8e-10 measured: the last step is t_end − t, which
# cancels to 1/550 of t, and the controller multiplies it by 10).
CH_ADAPT_REF = {
    512: dict(outcome="underflow", steps=0, rejections=2,
              wlte=(80.04117061580094, 13.971770468359145)),
    256: dict(outcome="t_end", steps=16, rejections=3, dt_final=9.031015970143056e-11,
              wlte=(2.923523992631488, 1.4859843540683966, 1.0310418252847697,
                    0.8590754636451763)),
}
WLTE_RTOL = 1e-8
DT_FINAL_RTOL = 1e-9


def phase_ch_adapt(nel, expect=None):
    """The adaptive Cahn–Hilliard example at nel² periodic C¹ p=2 in f64
    (262,144 unknowns at 512²): ``integrate_adaptive`` (one host read of
    the error estimate per step), then ``integrate_adaptive_device`` (the
    controller's state on the card), both from the same U0 and consistent
    V0, at the example's settings.

    ``expect`` (default ``CH_ADAPT_REF[nel]``) is the reference's outcome:
    ``"t_end"``, where any exception propagates, or ``"underflow"``, where
    the host controller must raise its dt-underflow error and the device
    loop must stop at the same place.  Checks: the outcome, the steps and
    rejections and, where given, dt_final and the error estimate of each
    attempt up to the first accepted step against the reference's; t_end for both variants where it is
    expected; every Newton solve converged; on accepted steps, the mean
    concentration conserved to 1e-6 and the free energy not rising by more
    than 1e-6 relative (f64 sums); the device run stops where the host run
    stopped, with its steps and rejections and its U within 1e-10·max|U|.

    The host variant's Newton runs with ``counters`` (seconds of each
    residual, Jacobian assembly and BiCGStab solve, the device
    synchronised at each reading) and its accepted steps run the
    free-energy monitor: ``host_s`` includes both, ``host_monitor_s`` is
    the monitor's share; the device variant runs neither.  Returns the
    space, the host run's last U and the device run's last step size."""
    from petiga_tpu_torch.assembly.assemble import compute_scalar
    from petiga_tpu_torch.models import cahnhilliard as ch
    from petiga_tpu_torch.solve.ts import (
        AlphaStepper, integrate_adaptive, integrate_adaptive_device)

    name = f"ch_adapt{nel}"
    expect = CH_ADAPT_REF[nel] if expect is None else expect
    sp = ch.make_space(dim=2, nel=nel, dtype=torch.float64)
    U0 = ch.initial_condition(sp, cbar=0.63, seed=0)
    spans = {}
    host_st = AlphaStepper(sp, ch.residual, rho_inf=0.5, ctx=CH_CTX,
                           newton_kw=dict(CH_NEWTON, counters=spans))
    dev_st = AlphaStepper(sp, ch.residual, rho_inf=0.5, ctx=CH_CTX, newton_kw=CH_NEWTON)

    def stats(U):
        s = compute_scalar(sp, ch.free_energy_stats, U, CH_CTX, order=1, chunk=CH_CHUNK)
        return float(s[0]), float(U.double().mean())

    E0, mean0 = stats(U0)
    t0 = time.perf_counter()
    V0 = host_st.initial_velocity(U0, 0.0)
    v0_s = sync_s(t0)
    v0_rhist = spans["rhist"][0]
    spans.clear()

    attempts, steps, last = [], [], {"t": 0.0, "U": U0}
    mon_s = [0.0]

    def on_attempt(t, dt, err, accepted):
        attempts.append({"t": t, "dt": dt, "wlte": err, "accepted": accepted})

    def monitor(k, t, U):
        t1 = time.perf_counter()
        E, mean = stats(U)
        mon_s[0] += time.perf_counter() - t1
        steps.append({"step": k, "t": t, "dt": t - last["t"], "free_energy": E, "mean": mean})
        last.update(t=t, U=U)

    t_end = CH_ADAPT["t_end"]
    kw = dict(V0=V0, rtol=CH_ADAPT["rtol"], atol=CH_ADAPT["atol"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if expect["outcome"] == "t_end":
        Uh, _, rh = integrate_adaptive(host_st, U0, 0.0, CH_ADAPT["dt0"], t_end, monitor=monitor,
                                       attempt_monitor=on_attempt, **kw)
        host, stop = rh._asdict(), "t_end"
    else:
        try:
            Uh, _, rh = integrate_adaptive(host_st, U0, 0.0, CH_ADAPT["dt0"], t_end,
                                           monitor=monitor, attempt_monitor=on_attempt, **kw)
            host, stop = rh._asdict(), "t_end"
        except RuntimeError as e:
            if "dt underflow" not in str(e):
                raise
            Uh, stop = last["U"], str(e)
            host = {"t": last["t"], "steps": len(steps),
                    "rejections": sum(not a["accepted"] for a in attempts)}
    t_host = sync_s(t0)
    t0 = time.perf_counter()
    Ud, _, rd = integrate_adaptive_device(dev_st, U0, 0.0, CH_ADAPT["dt0"], t_end, **kw)
    t_dev = sync_s(t0)

    # one Newton solve per attempt, in order
    for a, rh_, li, rs, js, ss in zip(attempts, spans["rhist"], spans["lin_iters"],
                                      spans["residual_s"], spans["jacobian_s"],
                                      spans["solve_s"]):
        a.update(newton_iters=len(li), fnorm=rh_, bicgstab_iters=li,
                 residual_ms=[1e3 * x for x in rs], jacobian_ms=[1e3 * x for x in js],
                 bicgstab_ms_per_iter=[1e3 * x / max(i, 1) for x, i in zip(ss, li)])
    totals = {k: sum(map(sum, spans[k])) for k in ("residual_s", "jacobian_s", "solve_s")}
    diff = float((Ud - Uh).abs().max())
    scale = float(Uh.abs().max())
    emit({"phase": name, "nel": nel, "unknowns": sp.nnodes, "dtype": "float64",
          "outcome": stop, "expected": expect, "host": host, "device": rd._asdict(),
          "host_s": t_host, "host_monitor_s": mon_s[0], "host_spans_s": totals,
          "device_s": t_dev, "v0_s": v0_s, "max_abs_V0": float(V0.abs().max()),
          "newton_solves_host": len(spans["rhist"]), "attempts": attempts,
          "device_vs_host_max_diff": diff, "free_energy_0": E0, "steps": steps,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})

    if expect["outcome"] == "t_end":
        check(f"{name}:outcome", stop == "t_end", outcome=stop, want="t_end")
    else:  # the device loop ends on the proposal below dt_min = 1e-12
        check(f"{name}:outcome", stop.startswith("adaptive dt underflow") and rd.dt_final < 1e-12,
              outcome=stop, device_dt_final=rd.dt_final, want="dt underflow in both variants")
    if "steps" in expect:
        counts = {k: host[k] for k in ("steps", "rejections")}
        ref = {k: expect[k] for k in ("steps", "rejections")}
        check(f"{name}:counts_vs_reference", counts == ref, host=counts, reference=ref)
    if "dt_final" in expect:
        got = host.get("dt_final", float("nan"))
        dev_ = abs(got - expect["dt_final"]) / expect["dt_final"]
        check(f"{name}:dt_final_vs_reference", dev_ <= DT_FINAL_RTOL, dt_final=got,
              reference=expect["dt_final"], rel_dev=dev_, want=f"<= {DT_FINAL_RTOL:g}")
    if "wlte" in expect:
        got = [a["wlte"] for a in attempts[:len(expect["wlte"])]]
        ok = len(got) == len(expect["wlte"]) and all(
            abs(g - r) <= WLTE_RTOL * r for g, r in zip(got, expect["wlte"]))
        check(f"{name}:wlte_vs_reference", ok, wlte=got, reference=list(expect["wlte"]),
              want=f"each within {WLTE_RTOL:g} relative")
    if expect["outcome"] == "t_end":
        for var, r in (("host", rh), ("device", rd)):
            check(f"{name}:{var}:t_end", abs(r.t - t_end) <= 1e-10 * t_end, t=r.t, t_end=t_end)
    for k, h in enumerate([v0_rhist] + spans["rhist"]):
        check(f"{name}:newton{k}:converged", h[-1] <= CH_NEWTON["rtol"] * h[0],
              fnorm=h, want=f"<= {CH_NEWTON['rtol']} x first")
    energies = [E0] + [s["free_energy"] for s in steps]
    for k, s in enumerate(steps):
        dev = abs(s["mean"] - mean0) / mean0
        check(f"{name}:step{k + 1}:mass", dev <= 1e-6, rel_dev=dev, want="<= 1e-6")
        rise = (energies[k + 1] - energies[k]) / abs(energies[k])
        check(f"{name}:step{k + 1}:energy", rise <= 1e-6, rel_rise=rise, want="<= 1e-6")
    same = (rd.steps, rd.rejections) == (host["steps"], host["rejections"]) and (
        abs(rd.t - host["t"]) <= 1e-10 * t_end)
    check(f"{name}:device_equals_host", same and diff <= 1e-10 * scale, device=rd._asdict(),
          host=host, max_diff=diff,
          want=f"same stop, steps and rejections, U within {1e-10 * scale:.3e}")
    return sp, Uh, rd.dt_final


def _heat_problem(nel, p):
    """The reference's 1-D heat/wave test problem (tests/test_ts.py):
    p-spline space with u = 0 at both ends, the L2 projection of
    sin(πx) on the kernel, and the exact solution's L2 error."""
    from petiga_tpu_torch.assembly.assemble import compute_error_norm
    from petiga_tpu_torch.core.axis import Axis
    from petiga_tpu_torch.core.space import Space
    from petiga_tpu_torch.models.projection import l2_project

    sp = Space([Axis.uniform(p=p, nel=nel)], dtype=torch.float64)
    sp.set_boundary_value(0, 0, 0, 0.0)
    sp.set_boundary_value(0, 1, 0, 0.0)

    def sin(x, a=1.0):
        return a * torch.sin(math.pi * x[..., :1])

    def error(U, decay):
        return float(compute_error_norm(sp, U, lambda x: decay * sin(x)))

    return sp, sin, lambda f: l2_project(sp, f), error


def heat_ifunction(pt, shift, Ve, t, Ue, ctx):
    return pt.value(Ve)[0] * pt.shape0 + pt.shape1 @ pt.grad(Ue)[0]


def tr_theta():
    """θ-method on the heat problem (nel 32, p 3, T 0.08, 4 and 8 steps):
    backward Euler at order 1 ± 0.15, the midpoint rule above 1.8
    (tests/test_ts.py:56)."""
    from petiga_tpu_torch.solve.ts import ThetaStepper, integrate

    sp, sin, project, error = _heat_problem(32, 3)
    U0 = project(sin)
    T = 0.08
    rates = {}
    for theta in (1.0, 0.5):
        e = []
        for n in (4, 8):
            st = ThetaStepper(sp, heat_ifunction, theta=theta,
                              newton_kw=dict(rtol=1e-12, operator="fast"))
            e.append(error(integrate(st, U0, 0.0, T / n, n), math.exp(-math.pi**2 * T)))
        rates[theta] = float(np.log2(e[0] / e[1]))
    check("transient:theta:orders", abs(rates[1.0] - 1) < 0.15 and rates[0.5] > 1.8,
          backward_euler=rates[1.0], midpoint=rates[0.5], want="1 +- 0.15, > 1.8")
    return {"rate_backward_euler": rates[1.0], "rate_midpoint": rates[0.5]}


def tr_alpha2():
    """Generalized-α2 on u_tt = u_xx (nel 16, p 2, ρ∞ 0.9, T 0.5, 32 and
    64 steps): order above 1.7 (tests/test_ts.py:100)."""
    from petiga_tpu_torch.solve.ts import Alpha2Stepper, integrate

    sp, sin, project, error = _heat_problem(16, 2)

    def wave(pt, sA, Ae, sV, Ve, t, Ue, ctx):
        return pt.value(Ae)[0] * pt.shape0 + pt.shape1 @ pt.grad(Ue)[0]

    U0, A0 = project(sin), project(lambda x: sin(x, -math.pi**2))
    T, e = 0.5, []
    for n in (32, 64):
        st = Alpha2Stepper(sp, wave, rho_inf=0.9, newton_kw=dict(rtol=1e-12, operator="fast"))
        U, _, _ = integrate(st, U0, 0.0, T / n, n, V0=torch.zeros_like(U0), A0=A0)
        e.append(error(U, math.cos(math.pi * T)))
    rate = float(np.log2(e[0] / e[1]))
    check("transient:alpha2:order", rate > 1.7, value=rate, errors=e, want="> 1.7")
    return {"rate": rate}


def tr_rk3():
    """SSP-RK3 on the heat problem (nel 64, p 2, dt 2e-5, 200 steps),
    every stage a consistent-mass Jacobi-CG on the kernel: L2 error below
    2e-4 (tests/test_ts.py:149)."""
    from petiga_tpu_torch.solve.ts import ExplicitStepper, integrate

    sp, sin, project, error = _heat_problem(64, 2)

    def rhs(pt, t, Ue, ctx):
        return -(pt.shape1 @ pt.grad(Ue)[0])

    dt, n = 2e-5, 200
    U = integrate(ExplicitStepper(sp, rhs, scheme="rk3"), project(sin), 0.0, dt, n)
    err = error(U, math.exp(-math.pi**2 * n * dt))
    check("transient:rk3:error", err < 2e-4, value=err, want="< 2e-4")
    return {"l2_error": err}


def tr_shallowwater(nel=64):
    """Shallow water, periodic dof 3, 4 steps of 0.005: the water volume
    to 1e-6, the hump's peak falls (tests/test_models_misc.py:12)."""
    from petiga_tpu_torch.models import shallowwater as sw

    U0, U = sw.run(sw.make_space(nel=nel), dt=0.005, nsteps=4)
    dev = abs(float(U[:, 0].mean()) - float(U0[:, 0].mean())) / float(U0[:, 0].mean())
    peak = (float(U[:, 0].max()), float(U0[:, 0].max()))
    check("transient:shallowwater", bool(torch.isfinite(U).all()) and dev <= 1e-6
          and peak[0] < peak[1], mass_rel_dev=dev, peak=peak)
    return {"mass_rel_dev": dev, "peak": peak}


def tr_richards(nel1=32, nel2=64):
    """Richards, backward Euler, 5 steps of 1e-3 from ψ = −2, in 1-D
    (nel 32) and 2-D (nel²): the ponded top at ψ ≥ −1e-6, the bottom still
    dry (ψ < −1.8), ψ within [−2.3, 0.1] (tests/test_models_misc.py:24)."""
    from petiga_tpu_torch.models import richards

    out = {}
    for dim, nel in ((1, nel1), (2, nel2)):
        sp = richards.make_space(nel=nel, dim=dim)
        _, U = richards.run(sp, dt=1e-3, nsteps=5)
        g = U.reshape(sp.node_shape[::-1])  # the last axis first
        top, bottom = float(g[-1].min()), float(g[0].max())
        lo, hi = float(U.min()), float(U.max())
        out[f"{dim}d"] = {"top_min": top, "bottom_max": bottom, "min": lo, "max": hi}
        check(f"transient:richards:{dim}d", top > -1e-6 and bottom < -1.8 and lo >= -2.3
              and hi <= 0.1, **out[f"{dim}d"])
    return out


def tr_pfc(nel=64):
    """Phase-field crystal, periodic [0, 16π]², dof 2, order 2, 2 steps of
    0.05: φ's mean to 1e-7 (tests/test_models_misc.py:36)."""
    from petiga_tpu_torch.models import phasefieldcrystal as pfc

    sp = pfc.make_space(nel=nel)
    U0 = pfc.initial_condition(sp, seed=5)
    U = pfc.run(sp, U0, dt=0.05, nsteps=2)
    dev = abs(float(U[:, 0].mean()) - float(U0[:, 0].mean())) / abs(float(U0[:, 0].mean()))
    moved = float((U - U0).abs().max())
    check("transient:pfc", bool(torch.isfinite(U).all()) and dev <= 1e-7, mass_rel_dev=dev,
          max_change=moved)
    return {"mass_rel_dev": dev, "max_change": moved}


def tr_nsk(nel=64):
    """Navier–Stokes–Korteweg, the van der Waals bubble, 2 steps of 5e-5:
    ρ within (0.05, 0.95), mass to 1e-6 (tests/test_models_misc.py:47)."""
    from petiga_tpu_torch.models import nsk

    sp = nsk.make_space(nel=nel)
    U0 = nsk.vdw_bubble_ic(sp)
    U = nsk.run(sp, U0, dt=5e-5, nsteps=2)
    rho = (float(U[:, 0].min()), float(U[:, 0].max()))
    dev = abs(float(U[:, 0].mean()) - float(U0[:, 0].mean())) / float(U0[:, 0].mean())
    check("transient:nsk", bool(torch.isfinite(U).all()) and 0.05 < rho[0] and rho[1] < 0.95
          and dev <= 1e-6, rho_min_max=rho, mass_rel_dev=dev)
    return {"rho_min_max": rho, "mass_rel_dev": dev}


def tr_twophase(nel=256):
    """Two-phase flow, 1-D p 1 dof 2, 4 steps of 0.02: hydrogen at the
    injection face, none at the fixed face (tests/test_models_misc.py:63)."""
    from petiga_tpu_torch.models import twophase

    _, U = twophase.run(twophase.make_space(nel=nel), dt=0.02, nsteps=4)
    left, right = float(U[0, 1]), float(U[-1, 1])
    check("transient:twophase", bool(torch.isfinite(U).all()) and left > 1e-4
          and abs(right) < 1e-8, left=left, right=right)
    return {"rho_lh_left": left, "rho_lh_right": right}


def tr_patternformation(nel=128):
    """Pattern formation, periodic dof 2, 2 steps of 0.005 in each
    splitting: the fields move and stay below 10
    (tests/test_models_transient.py:15)."""
    from petiga_tpu_torch.models import patternformation as pf

    sp = pf.make_space(nel=nel)
    U0 = pf.initial_condition(sp, seed=3)
    out = {}
    for implicit in (True, False):
        U = pf.run(sp, U0, dt=0.005, nsteps=2, implicit=implicit)
        out[f"implicit_{implicit}"] = (float((U - U0).abs().max()), float(U.abs().max()))
        check(f"transient:patternformation:implicit_{implicit}", bool(torch.isfinite(U).all())
              and out[f"implicit_{implicit}"][0] > 1e-8 and out[f"implicit_{implicit}"][1] < 10,
              change_and_max=out[f"implicit_{implicit}"])
    return out


def tr_elasticrod(nel=512):
    """The plucked rod, generalized-α2, 20 steps of 0.01: |u| < 1.5, the
    clamped ends at 0 (1e-12), the center below 1
    (tests/test_models_transient.py:26)."""
    from petiga_tpu_torch.models import elasticrod as rod

    U, _, _ = rod.run(rod.make_space(nel=nel), dt=0.01, nsteps=20)
    u = U.reshape(-1).cpu().numpy()
    out = {"max_abs": float(np.abs(u).max()), "ends": (float(u[0]), float(u[-1])),
           "center": float(u[len(u) // 2])}
    check("transient:elasticrod", np.isfinite(u).all() and out["max_abs"] < 1.5
          and max(map(abs, out["ends"])) <= 1e-12 and abs(out["center"]) < 1.0, **out)
    return out


def _plate_solve(sp, system, ctx, maxiter=10000):
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.solve.krylov import cg, jacobi_preconditioner

    A, b = assemble_system(sp, system, ctx)
    res = cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=1e-12, maxiter=maxiter)
    return res.x, res.iters


def tr_laplace_beltrami(nel=64):
    """The surface Laplacian on the plate tilted by 0.7 rad against the
    untilted plate, unit source, fixed edges: equal to 1e-10, maximum
    above 0.05 (tests/test_manifold.py:20)."""
    from petiga_tpu_torch.models import shell

    sols, iters = [], []
    for tilt in (None, 0.7):
        sp = shell.make_plate_space(nel=nel, p=2, tilt=tilt)
        for d in range(2):
            for s in range(2):
                sp.set_boundary_value(d, s, 0, 0.0)
        x, it = _plate_solve(sp, shell.laplace_beltrami_system, {"forcing": lambda x: 1.0})
        sols.append(x)
        iters.append(it)
    diff, top = float((sols[0] - sols[1]).abs().max()), float(sols[0].max())
    check("transient:laplace_beltrami", diff <= 1e-10 and top > 0.05, max_diff=diff, max=top)
    return {"cg_iters": iters, "max_diff": diff, "max": top}


def tr_kirchhoff(nel=32):
    """The clamped Kirchhoff plate, p 3, unit load, D = 1: w_max =
    0.00126 ± 3 % (tests/test_manifold.py:46)."""
    from petiga_tpu_torch.models import shell

    sp = shell.clamp_plate(shell.make_plate_space(nel=nel, p=3))
    w, it = _plate_solve(sp, shell.kl_shell_system, {"D": 1.0, "load": 1.0}, maxiter=20000)
    wmax = float(w.max())
    check("transient:kirchhoff", abs(wmax - 0.00126) <= 0.03 * 0.00126, w_max=wmax,
          want="0.00126 +- 3 %")
    return {"cg_iters": it, "w_max": wmax}


def _exact_sin(x):
    return torch.prod(torch.sin(math.pi * x + 0.3), dim=-1, keepdim=True)


def _forcing_sin(x):
    return 2 * math.pi**2 * torch.prod(torch.sin(math.pi * x + 0.3), dim=-1)


def tr_nitsche(nels=(64, 128)):
    """Nitsche's weak Dirichlet on -Δu = f, p 2: L2 rate 3 ± 0.25
    (tests/test_boundary_forms.py:30)."""
    from petiga_tpu_torch.assembly.assemble import compute_error_norm
    from petiga_tpu_torch.models import boundary

    errs, iters = [], []
    for nel in nels:
        sp = boundary.make_open_space(2, p=2, nel=nel)
        U, info = boundary.nitsche_poisson(sp, _exact_sin, _forcing_sin)
        errs.append(float(compute_error_norm(sp, U, _exact_sin)))
        iters.append(info["iters"])
    rate = float(np.log2(errs[0] / errs[1]))
    check("transient:nitsche:rate", abs(rate - 3) < 0.25, value=rate, errors=errs,
          want="3 +- 0.25")
    return {"cg_iters": iters, "l2_errors": errs, "rate": rate}


def tr_boundary_integral(nels=(8, 16)):
    """The natural flux by a surface integral on the x faces, strong
    values on the y faces from the projected exact solution: L2 rate
    3 ± 0.4, the finer error below 5e-4 (tests/test_boundary_forms.py:40)."""
    from petiga_tpu_torch.assembly.assemble import compute_error_norm
    from petiga_tpu_torch.models import boundary
    from petiga_tpu_torch.models.projection import l2_project

    def flux(x, n):
        gx = math.pi * torch.cos(math.pi * x[0] + 0.3) * torch.sin(math.pi * x[1] + 0.3)
        gy = torch.sin(math.pi * x[0] + 0.3) * math.pi * torch.cos(math.pi * x[1] + 0.3)
        return gx * n[0] + gy * n[1]

    errs = []
    for nel in nels:
        sp = boundary.make_open_space(2, p=2, nel=nel)
        sp.bc_visit = [[True, True], [False, False]]
        sp.set_fix_table(l2_project(sp, _exact_sin).cpu().numpy())
        sp.set_boundary_value(1, 0, 0, 0.0)
        sp.set_boundary_value(1, 1, 0, 0.0)
        U, _ = boundary.boundary_integral_poisson(sp, _forcing_sin, flux, fixed_faces=[])
        errs.append(float(compute_error_norm(sp, U, _exact_sin)))
    rate = float(np.log2(errs[0] / errs[1]))
    check("transient:boundary_integral", abs(rate - 3) < 0.4 and errs[-1] < 5e-4, rate=rate,
          errors=errs, want="3 +- 0.4, finer < 5e-4")
    return {"l2_errors": errs, "rate": rate}


def tr_adaptive():
    """Greedy adaptive L2 projection of the reference's off-center
    Gaussian, p 2, from 3 × 3 spans, 3 insertions: the error falls at
    every insertion and below 0.3 of the first, the axis-0 breaks denser
    near x = 0.85 (tests/test_models_misc.py:75)."""
    from petiga_tpu_torch.models.adaptive import adaptive_l2_projection

    def f(x):
        return torch.exp(-((x[..., 0:1] - 0.85) ** 2 / 0.03125
                           + (x[..., 1:2] - 0.45) ** 2 / 0.08))

    sp, _, hist = adaptive_l2_projection(f, dim=2, p=2, n0=3, iters=3)
    b0 = np.asarray(sp.axes[0].U)
    dense = (int(((b0 > 0.6) & (b0 < 1.0)).sum()), int(((b0 > 0.0) & (b0 < 0.4)).sum()))
    check("transient:adaptive", all(hist[i + 1] < hist[i] for i in range(len(hist) - 1))
          and hist[-1] < 0.3 * hist[0] and dense[0] > dense[1], history=hist, breaks=dense)
    return {"history": hist}


TRANSIENT = (("ts_theta", tr_theta), ("ts_alpha2", tr_alpha2), ("ts_rk3", tr_rk3),
             ("shallowwater", tr_shallowwater), ("richards", tr_richards), ("pfc", tr_pfc),
             ("nsk", tr_nsk), ("twophase", tr_twophase),
             ("patternformation", tr_patternformation), ("elasticrod", tr_elasticrod),
             ("laplace_beltrami", tr_laplace_beltrami), ("kirchhoff", tr_kirchhoff),
             ("nitsche", tr_nitsche), ("boundary_integral", tr_boundary_integral),
             ("adaptive_l2", tr_adaptive))


def phase_transient():
    """Each model of :data:`TRANSIENT` on its own counted path, f64,
    held to its JAX test's criterion; one line per model with its
    seconds."""
    for name, fn in TRANSIENT:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted(name):
            out = fn()
        emit({"phase": f"transient_{name}", "seconds": sync_s(t0),
              "launches": PHASE_LAUNCHES[name]["full"], **out})


# ------------------------------------------- the single-device user surface
# The JAX package's values for the phases below, made on the CPU in f64 by
# scripts/torch_geometry_reference.py (one case per process).
GEOMETRY_REF = {
    "mapped_l2": {32: 2.9613182011190706e-06, 64: 3.6891084036118847e-07},
    "colloc_l2": {32: 0.00014223533101202182, 64: 3.5511951825098976e-05},
    "bratu256": {"newton_iters": 4, "max_u": 0.3955277143729947},
    "space_sha256": "ef87d329147674d9f63cf513e12a0e108c0e8089a4bc9d45b45eb600be45b4a3",
    "vec_sha256": "ed0e3d12feb6632fcaae3bdbd2880c487468e3b80473b1b9d9aaf82f6e7155fc",
}
GEOMETRY_L2_RTOL = 1e-8
COEF = {"c": 0.0, "k": 1.0}


def warp(G):
    """The warp of ``scripts/torch_geometry_reference.py``: the Greville
    control points ``G`` (nnodes, 3) moved by ``0.05 Π sin(πG_i)`` along
    the first axis.  Boundary points stay on their faces, so the domain is
    the unit cube and det J ≥ 1 - 0.05π."""
    X = np.array(G, dtype=np.float64)
    X[:, 0] += 0.05 * np.prod(np.sin(np.pi * G), axis=1)
    return X


def nurbs_weights(G):
    return 1.0 + 0.3 * np.prod(np.sin(np.pi * G), axis=1)


def loaded_space(nel, dtype, nurbs, tmpdir):
    """The ``-iga_load`` flow: a p=2 space of ``nel``³ elements under :func:`warp`
    (and NURBS weights) written by the port's ``write_space``, read back
    through ``Options(load=...).build_space()``, homogeneous Dirichlet on
    every face."""
    from petiga_tpu_torch import config
    from petiga_tpu_torch.io.checkpoint import write_space
    from petiga_tpu_torch.models import poisson

    sp = poisson.make_space(3, p=2, nel=nel, dtype=dtype)
    G = sp.greville_coordinates()
    sp.init_geometry(warp(G), nurbs_weights(G) if nurbs else None)
    path = f"{tmpdir}/geometry_{nel}_{'nurbs' if nurbs else 'mapped'}.dat"
    write_space(sp, path)
    out = config.Options(load=path, dtype=str(dtype)[6:]).build_space()
    for d in range(3):
        for s in range(2):
            out.set_boundary_value(d, s, 0, 0.0)
    return out


def mapped_assemble(sp, name, symmetric=False):
    """Conv planes and load vector of the manufactured problem on a
    mapped space, timed as a log event (CUDA events)."""
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes, poisson_coefficients
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.utils import profiling

    return profiling.timed(name, assemble_coefficient_planes, sp, poisson_coefficients, COEF,
                           forcing=poisson.poisson_forcing(), symmetric=symmetric,
                           flops=profiling.system_flops(sp))


def phase_mapped(nel=128, nurbs=False, tmpdir="."):
    """``mapped128`` (and its NURBS variant): the ``-iga_load`` flow at
    full width in f32.  Conv planes (full; symmetric too without weights)
    against the pointwise engine's planes of the same form on the same
    space, Jacobi-CG to rtol 1e-6 on each kernel, each f32 solution's true
    residual against its floor.  Returns the loaded space and the full
    solve's solution, with the full operator and load vector."""
    from petiga_tpu_torch.assembly.assemble import assemble_system_planes
    from petiga_tpu_torch.assembly.convform import coefficient_pointwise_form, poisson_coefficients
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.utils import profiling

    tag = f"{'nurbs' if nurbs else 'mapped'}{nel}"
    row = {"phase": tag}
    t0 = time.perf_counter()
    sp = loaded_space(nel, torch.float32, nurbs, tmpdir)
    row["load_s"] = time.perf_counter() - t0
    op, b = mapped_assemble(sp, f"{tag}.conv_full")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op, b = mapped_assemble(sp, f"{tag}.conv_full")
    row["assembly_full_s"] = sync_s(t0)
    form = coefficient_pointwise_form(poisson_coefficients, poisson.poisson_forcing())
    t0 = time.perf_counter()
    op_pw, b_pw = profiling.timed(f"{tag}.pointwise", assemble_system_planes, sp, form, COEF,
                                  chunk=65536, order=1, flops=profiling.system_flops(sp))
    row["assembly_pointwise_s"] = sync_s(t0)
    rel = planes_rel_diff(op.DT, op_pw.DT)
    rel_b = float((b - b_pw).abs().max() / b_pw.abs().max())
    del op_pw, b_pw
    row.update({"conv_vs_pointwise_rel": rel, "load_conv_vs_pointwise_rel": rel_b})
    check(f"{tag}:conv_vs_pointwise", rel <= 1e-5 and rel_b <= 1e-5, value=rel, load=rel_b,
          want="<= 1e-5 of the largest entry")
    solves = {"full": op}
    if not nurbs:
        t0 = time.perf_counter()
        op_sym, _ = mapped_assemble(sp, f"{tag}.conv_sym", symmetric=True)
        row["assembly_sym_s"] = sync_s(t0)
        probe = torch.as_tensor(
            np.random.default_rng(0).normal(size=(sp.nnodes, 1)).astype(np.float32),
            device=sp.device)
        y_full, y_sym = op.matvec(probe), op_sym.matvec(probe)
        mrel = float((y_sym - y_full).abs().max() / y_full.abs().max())
        del y_full, y_sym, probe
        row["full_vs_sym_matvec_rel"] = mrel
        check(f"{tag}:full_vs_sym_matvec_rel", mrel <= 1e-5, value=mrel, want="<= 1e-5")
        solves["sym"] = op_sym
    U_full = None
    for kind, o in solves.items():
        U, res = profiling.timed(f"{tag}.cg_{kind}", poisson.solve_system, o, b, rtol=1e-6,
                                 maxiter=4000)
        q = solve_quality(poisson, sp, o, b, U)
        lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
        row[f"cg_{kind}"] = {"iters": res.iters, "residual": float(res.residual),
                             "l2_error": poisson.l2_error(sp, U, chunk=65536), **q}
        check(f"{tag}:{kind}:true_rel_residual", q["true_rel_residual"] <= lim,
              value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")
        if kind == "full":
            U_full = U
    emit(row)
    return sp, U_full, op, b


def phase_mapped_f64(tmpdir, nels=(32, 64)):
    """The mapped problem in f64 at 32³ and 64³ (symmetric conv planes,
    Jacobi-CG to rtol 1e-12): the L2 error falls at order 3 and equals
    the JAX package's to 1e-8."""
    from petiga_tpu_torch.models import poisson

    l2 = {}
    for nel in nels:
        sp = loaded_space(nel, torch.float64, False, tmpdir)
        op, b = mapped_assemble(sp, f"mapped{nel}_f64.conv_sym", symmetric=True)
        U, res = poisson.solve_system(op, b, rtol=1e-12, maxiter=20000)
        l2[nel] = poisson.l2_error(sp, U)
        ref = GEOMETRY_REF["mapped_l2"][nel]
        dev = abs(l2[nel] - ref) / ref
        emit({"phase": f"mapped{nel}_f64", "cg_iters": res.iters, "l2_error": l2[nel],
              "l2_error_ref": ref, "rel_dev": dev})
        check(f"mapped{nel}_f64:l2_vs_reference", dev <= GEOMETRY_L2_RTOL, value=l2[nel],
              ref=ref, rel_dev=dev, want=f"within {GEOMETRY_L2_RTOL:g}")
    order = float(np.log2(l2[nels[0]] / l2[nels[1]]) / np.log2(nels[1] / nels[0]))
    check("mapped_f64:l2_order", abs(order - 3.0) <= 0.15, value=order, want="3 +- 0.15")


def laplace_colloc(pt, ctx):
    """-Δu = f at a collocation point, ``u = Π sin(πx_i)``."""
    dim = pt.x.shape[-1]
    f = dim * math.pi**2 * torch.prod(torch.sin(math.pi * pt.x))
    lap = pt.shape2[:, 0, 0]
    for d in range(1, dim):
        lap = lap + pt.shape2[:, d, d]
    return -lap[None, :], f.reshape(1)


def colloc_space(argv):
    """A collocation space from the command line (``bind_cli``), homogeneous
    Dirichlet on every face."""
    from petiga_tpu_torch import config

    opts, _ = config.bind_cli(argv + ["--collocation"])
    sp = opts.build_space()
    for d in range(sp.dim):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def packed_bicgstab(op, b, rtol, maxiter=20000):
    """Jacobi-BiCGStab on packed vectors through the full stencil kernel;
    returns (U (nnodes, dof), result)."""
    from petiga_tpu_torch.solve.krylov import bicgstab

    dinv = op.packed_diag_inv()
    res = bicgstab(lambda v: op.matvec_xb(op.DT, v), op.pack_vec(b), M=lambda r: r * dinv,
                   rtol=rtol, maxiter=maxiter)
    return op.unpack_vec(res.x), res


def phase_colloc(nel=128, nels_f64=(32, 64)):
    """``colloc``: Poisson collocation at 128³ in f32 through ``bind_cli``,
    Jacobi-BiCGStab to rtol 1e-5 on the full kernel (125-slot nonsymmetric
    stencil), its true residual against the f64 solution of the same
    system rounded to f32; then f64 at 32³ and 64³, the L2 error on a
    Galerkin clone held to the JAX package's."""
    from petiga_tpu_torch.assembly.collocation import assemble_collocation
    from petiga_tpu_torch.core.axis import Axis
    from petiga_tpu_torch.core.space import Space
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.sparse.spmv import StencilOperator
    from petiga_tpu_torch.utils import profiling

    sp = colloc_space(["--dim", "3", "-p", "2", "-N", str(nel), "--dtype", "float32"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A, b = profiling.timed(f"colloc{nel}.assembly", assemble_collocation, sp, laplace_colloc,
                           flops=profiling.system_flops(sp))
    op = A.fast_operator()
    del A
    t_asm = sync_s(t0)
    t0 = time.perf_counter()
    U, res = profiling.timed(f"colloc{nel}.bicgstab", packed_bicgstab, op, b, 1e-5)
    t_solve = sync_s(t0)
    op64 = StencilOperator.from_planes(op.st, op.DT.double())
    b64 = b.double()
    bb = op64.pack_vec(b64)
    bn = torch.linalg.vector_norm(bb)

    def rel_res(v):
        r = bb - op64.matvec_xb(op64.DT, op64.pack_vec(v.double()))
        return float(torch.linalg.vector_norm(r) / bn)

    U64, res64 = packed_bicgstab(op64, b64, 1e-10)
    q = {"true_rel_residual": rel_res(U), "floor_rel_residual": rel_res(U64.float()),
         "f64_solve_iters": res64.iters}
    del op64, U64, bb
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    emit({"phase": f"colloc{nel}", "nnodes": sp.nnodes, "assembly_s": t_asm,
          "bicgstab_iters": res.iters, "bicgstab_residual": float(res.residual),
          "solve_s": t_solve, "ms_per_iter": 1e3 * t_solve / max(res.iters, 1), **q})
    check(f"colloc{nel}:true_rel_residual", q["true_rel_residual"] <= lim,
          value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")
    del op
    l2 = {}
    for n in nels_f64:
        spc = colloc_space(["--dim", "3", "-p", "2", "-N", str(n), "--dtype", "float64"])
        A, b = assemble_collocation(spc, laplace_colloc)
        U, res = packed_bicgstab(A.fast_operator(), b, 1e-12)
        spg = Space([Axis.uniform(p=2, nel=n) for _ in range(3)], dtype=torch.float64)
        l2[n] = poisson.l2_error(spg, U)
        ref = GEOMETRY_REF["colloc_l2"][n]
        dev = abs(l2[n] - ref) / ref
        emit({"phase": f"colloc{n}_f64", "bicgstab_iters": res.iters, "l2_error": l2[n],
              "l2_error_ref": ref, "rel_dev": dev})
        check(f"colloc{n}_f64:l2_vs_reference", dev <= GEOMETRY_L2_RTOL, value=l2[n], ref=ref,
              rel_dev=dev, want=f"within {GEOMETRY_L2_RTOL:g}")
    n0, n1 = nels_f64
    emit({"phase": "colloc_f64_rate", "rate": float(np.log2(l2[n0] / l2[n1]) / np.log2(n1 / n0)),
          "expected": "near 2 (even p)"})


def phase_bratu_colloc(nel=256):
    """``bratu_colloc``: Bratu collocation in 2-D, p=2, 256², f64, λ = 4:
    Newton from U = 0 with the AD collocation Jacobian and Jacobi-BiCGStab
    (rtol 1e-10) on the f64 kernel to ‖F‖ < 1e-10 ‖F₀‖ (the f64 residual
    stalls near 1.2e-9 at 256², in the JAX package too, so an absolute
    1e-10 is never met); max U and the Newton iterations against the JAX
    package's run."""
    from petiga_tpu_torch.assembly.collocation import (
        assemble_collocation_function, assemble_collocation_jacobian)
    from petiga_tpu_torch.models.bratu import bratu_collocation_residual
    from petiga_tpu_torch.utils import profiling

    sp = colloc_space(["--dim", "2", "-p", "2", "-N", str(nel), "--dtype", "float64"])
    ctx = {"lambda": 4.0}
    U = torch.zeros((sp.nnodes, 1), dtype=torch.float64, device=sp.device)
    its, hist, lin = 0, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        F = profiling.timed("bratu_colloc.function", assemble_collocation_function, sp,
                            bratu_collocation_residual, U, ctx,
                            flops=profiling.residual_flops(sp))
        hist.append(float(torch.linalg.vector_norm(F)))
        if hist[-1] < 1e-10 * hist[0] or its == 30:
            break
        J = profiling.timed("bratu_colloc.jacobian", assemble_collocation_jacobian, sp,
                            bratu_collocation_residual, U, ctx,
                            flops=profiling.jacobian_flops(sp))
        dU, res = packed_bicgstab(J.fast_operator(), F, 1e-10)
        lin.append(res.iters)
        U = U - dU
        its += 1
    t = sync_s(t0)
    ref = GEOMETRY_REF["bratu256"]
    max_u = float(U.max())
    emit({"phase": f"bratu_colloc{nel}", "newton_iters": its, "fnorm": hist,
          "bicgstab_iters": lin, "max_u": max_u, "seconds": t, "reference": ref})
    check("bratu_colloc:converged", hist[-1] < 1e-10 * hist[0], value=hist[-1],
          want=f"< 1e-10 x {hist[0]:g}")
    check("bratu_colloc:max_u", abs(max_u - ref["max_u"]) <= 1e-9, value=max_u,
          ref=ref["max_u"], want="within 1e-9")
    check("bratu_colloc:newton_iters", abs(its - ref["newton_iters"]) <= 1, value=its,
          ref=ref["newton_iters"], want="within one")


def phase_separable(nel=256, nel_f64=16):
    """``separable256``: ``assemble_separable_planes`` (c = 0, κ = 1, the
    m256 forcing) against ``assemble_coefficient_planes``' full planes and
    load vector (1e-6 of the largest entry), Jacobi-CG to rtol 1e-8 on the
    full kernel and its true residual against its floor; at 16³ with
    c = 0.4, κ = 1.3 in f64 to 1e-12.  Returns the solve's cg_iters and
    L2 error (printed beside m256's, unchecked)."""
    from petiga_tpu_torch.assembly.assemble import assemble_separable_planes
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes, poisson_coefficients
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.utils import profiling

    row = {"phase": f"separable{nel}"}
    for n, dtype, c, k, tol in ((nel_f64, torch.float64, 0.4, 1.3, 1e-12),
                                (nel, torch.float32, 0.0, 1.0, 1e-6)):
        sp = poisson.make_space(3, p=2, nel=n, dtype=dtype)
        fpt = poisson.poisson_forcing(c, k)
        t0 = time.perf_counter()
        op_s, b_s = profiling.timed(f"separable{n}.assembly", assemble_separable_planes, sp,
                                    c=c, kappa=k, forcing=lambda x: fpt(x, None),
                                    flops=profiling.system_flops(sp))
        t_sep = sync_s(t0)
        t0 = time.perf_counter()
        op_c, b_c = assemble_coefficient_planes(sp, poisson_coefficients, {"c": c, "k": k},
                                                forcing=fpt)
        t_conv = sync_s(t0)
        rel = planes_rel_diff(op_s.DT, op_c.DT)
        rel_b = float((b_s - b_c).abs().max() / b_c.abs().max())
        del op_c
        row[f"m{n}"] = {"assembly_separable_s": t_sep, "assembly_conv_s": t_conv,
                        "planes_rel": rel, "load_rel": rel_b}
        check(f"separable{n}:vs_conv_planes", rel <= tol and rel_b <= tol, value=rel,
              load=rel_b, want=f"<= {tol:g} of the largest entry")
    U, iters, res, t_cg = timed_solve(poisson, op_s, b_s, rtol=1e-8)
    q = solve_quality(poisson, sp, op_s, b_s, U)
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    l2 = poisson.l2_error(sp, U)
    row.update({"cg_iters": iters, "cg_residual": res, "cg_s": t_cg, "l2_error": l2, **q})
    emit(row)
    check(f"separable{nel}:true_rel_residual", q["true_rel_residual"] <= lim,
          value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")
    return iters, l2


def parse_vts(path):
    """The arrays of a ``write_vts`` file: {name: float32 array}, points
    under ``"Points"``."""
    import base64
    import re
    import struct

    text = open(path).read()
    out = {}
    for m in re.finditer(r'<DataArray type="Float32"(?: Name="([^"]+)")? '
                         r'NumberOfComponents="(\d+)" format="binary">\s*(\S+)\s*</DataArray>',
                         text):
        raw = base64.b64decode(m.group(3))
        (n,) = struct.unpack("<I", raw[:4])
        arr = np.frombuffer(raw[4:4 + n], dtype="<f4").reshape(-1, int(m.group(2)))
        out[m.group(1) or "Points"] = arr
    return out


def linear_probe_check(tag, sp, coords):
    """Probe and FixedProbe of ``U = a + b·X_a[0]`` (X_a the control
    points: on the identity map the Greville abscissae) at 4096 seeded
    points: the value ``a + b·x`` to 1e-6 relative, the gradient ``(b,
    0, 0)`` to 1e-6 of the sum of magnitudes its contraction adds (the f32
    grade of a cancelling sum), the two probes equal."""
    from petiga_tpu_torch.post.probe import FixedProbe, Probe

    a, bcoef = 0.5, 2.0
    U = torch.as_tensor(a + bcoef * coords[:, :1], dtype=sp.dtype, device=sp.device)
    pts = np.random.default_rng(6).random((4096, sp.dim))
    pr = Probe(sp, U)
    fp = FixedProbe(sp, pts)
    v, g, x = pr.value(pts), pr.grad(pts), pr.geometry(pts)
    exact = a + bcoef * x[:, :1].double()
    v_rel = float((v.double() - exact).abs().max() / exact.abs().max())
    gref = torch.zeros_like(g, dtype=torch.float64)
    gref[:, 0, 0] = bcoef
    S, emap, _ = pr._tabulate(pts)
    mag = torch.einsum("pqni,pnd->pdi", S[1].abs().double(), U.double().abs()[emap])
    g_err = float(((g.double() - gref).abs() / mag).max())
    same = bool(torch.equal(fp.value(U), v) and torch.equal(fp.grad(U), g))
    emit({"phase": f"io_post_probe_{tag}", "value_rel": v_rel, "grad_err_over_sum": g_err,
          "fixed_equals_probe": same})
    check(f"io_post:{tag}:probe_linear", v_rel <= 1e-6 and g_err <= 1e-6 and same,
          value_rel=v_rel, grad=g_err, fixed_equals_probe=same, want="<= 1e-6")


def phase_io_post(sp128, U128, sp_map, U_map, op_map, b_map, sp_nurbs, tmpdir):
    """``io_post``: PetIGA binary round trips bit for bit (the mapped
    solution read back gives the same residual through the full kernel,
    bit for bit), the seeded 8³
    NURBS files' SHA-256 against the JAX package's, probes on the m128
    space and on the mapped space, probes against the pointwise
    tabulation on the mapped solution, ``sample_grid`` and ``write_vts``
    on the mapped solution parsed back."""
    import hashlib

    from petiga_tpu_torch.assembly.tabulation import tabulate_elements
    from petiga_tpu_torch.io.checkpoint import read_space, read_vec, write_space, write_vec
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.post.probe import Probe
    from petiga_tpu_torch.post.sample import sample_grid, write_vts

    row = {"phase": "io_post"}
    for tag, sp, U in (("m128", sp128, U128), ("mapped128", sp_map, U_map)):
        path = f"{tmpdir}/{tag}_vec.dat"
        write_vec(sp, U, path)
        back = read_vec(sp, path)
        same = bool(torch.equal(back, U.reshape(sp.nnodes, 1)))
        row[f"{tag}_vec_roundtrip"] = same
        check(f"io_post:{tag}:vec_roundtrip", same)
    r0 = b_map - op_map.matvec(U_map)
    r1 = b_map - op_map.matvec(back)
    row["mapped128_readback_rel_residual"] = float(torch.linalg.vector_norm(r1)
                                                   / torch.linalg.vector_norm(b_map))
    check("io_post:mapped128:readback_residual", bool(torch.equal(r0, r1)),
          value=row["mapped128_readback_rel_residual"])
    for tag, sp in (("mapped128", sp_map), ("nurbs128", sp_nurbs)):
        path = f"{tmpdir}/{tag}_space.dat"
        write_space(sp, path)
        back = read_space(path, dtype=sp.dtype)
        geo = bool(np.array_equal(back.geometry, sp.geometry))
        geo_rel = float(np.abs(back.geometry - sp.geometry).max())
        w = (back.rational is None and sp.rational is None) or bool(
            np.array_equal(back.rational, sp.rational))
        row[f"{tag}_space_roundtrip"] = {"geometry_bitwise": geo, "geometry_max_abs": geo_rel,
                                         "weights_bitwise": w}
        # X·W / W may round by an ulp when weights are stored: bitwise for
        # the mapped space, to 2 ulp of 1 for the NURBS one
        check(f"io_post:{tag}:space_roundtrip", w and (geo if sp.rational is None
                                                        else geo_rel <= 4.5e-16),
              geometry_bitwise=geo, geometry_max_abs=geo_rel, weights_bitwise=w)
    sp8 = poisson.make_space(3, p=2, nel=8, dtype=torch.float64)
    G = sp8.greville_coordinates()
    sp8.init_geometry(warp(G), nurbs_weights(G))
    U8 = torch.as_tensor(np.random.default_rng(8).normal(size=(sp8.nnodes, 1)),
                         device=sp8.device)
    write_space(sp8, f"{tmpdir}/space8.dat")
    write_vec(sp8, U8, f"{tmpdir}/vec8.dat")
    for name in ("space", "vec"):
        with open(f"{tmpdir}/{name}8.dat", "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()
        row[f"{name}_sha256"] = h
        check(f"io_post:{name}_sha256", h == GEOMETRY_REF[f"{name}_sha256"], value=h,
              ref=GEOMETRY_REF[f"{name}_sha256"])
    linear_probe_check("m128", sp128, sp128.greville_coordinates())
    linear_probe_check("mapped128", sp_map, sp_map.geometry)
    # the mapped solution at quadrature points: probe against tabulation
    ids = torch.as_tensor(np.random.default_rng(9).choice(sp_map.nel, 64, replace=False),
                          device=sp_map.device)
    pb = tabulate_elements(sp_map, ids, order=1)
    Um = U_map.reshape(sp_map.nnodes, 1)
    v_tab = torch.einsum("bqn,bn->bq", pb.shape[0], Um[sp_map.device_emap(ids), 0])
    v_pr = Probe(sp_map, Um).value(pb.u.reshape(-1, 3).double().cpu().numpy())
    t_rel = float((v_pr[:, 0] - v_tab.reshape(-1)).abs().max() / Um.abs().max())
    row["probe_vs_tabulation_rel"] = t_rel
    check("io_post:mapped128:probe_vs_tabulation", t_rel <= 1e-6, value=t_rel,
          want="<= 1e-6 of max |U|")
    t0 = time.perf_counter()
    coords, vals, shape = sample_grid(sp_map, Um, resolution=1)
    path = f"{tmpdir}/mapped128.vts"
    write_vts(path, coords, shape, {"u": vals[:, 0]})
    back = parse_vts(path)
    xyz = np.asarray(coords, dtype=np.float32)
    ok = (back["Points"].shape == (int(np.prod(shape)), 3)
          and np.array_equal(back["Points"], xyz)
          and np.array_equal(back["u"][:, 0], np.asarray(vals[:, 0], dtype=np.float32)))
    row.update({"vts_points": int(np.prod(shape)), "vts_s": time.perf_counter() - t0})
    check("io_post:vts_parsed_back", ok, points=int(np.prod(shape)))
    emit(row)


def phase_log_view(op):
    """The log events of this slice's phases: count, CUDA-event seconds,
    modeled flops and GF/s, after 20 products of ``op`` (the mapped128
    operator) through the full kernel, each a timed ``MatMult`` event with
    PetIGA's flop model; the table printed, then as one JSON line."""
    import io

    from petiga_tpu_torch.utils import profiling

    xb = op.pack_vec(torch.ones(op.st.nnodes, 1, dtype=op.DT.dtype, device=op.device))
    for _ in range(20):
        with profiling.event("MatMult", flops=profiling.spmv_flops(op.st)):
            op.matvec_xb(op.DT, xb)
    buf = io.StringIO()
    profiling.log_view(buf)
    lines = buf.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    emit({"phase": "log_view", "events": [
        {"event": name, "count": rec["count"], "seconds": rec["time"],
         "flops": rec["flops"],
         "gflops_s": rec["flops"] / rec["time"] / 1e9 if rec["time"] > 0 else None}
        for name, rec in sorted(profiling.EVENTS.items())]})
    check("log_view:events", len(lines) > 1, events=len(lines) - 1)



# ------------------------------------------------ the distributed layer

# ranks that share the one card in the dist128/dist_f64/dist_dryrun phases
DIST_RANKS = 4


def ext_block_csr(op):
    """The product of a rank's extended-block operator (dof 1) as a CSR
    ``torch.sparse`` matrix of (local rows) × (extended columns), built on
    the card from its planes: row n, column ``ext(n) + c_s``, value plane
    s at ``ext(n)``; zero entries dropped.  Returns ``(csr, nnz)``."""
    if op.dof != 1:
        raise ValueError("ext_block_csr: dof 1 only")
    dev = op.device
    ext = torch.zeros((), dtype=torch.int64, device=dev)
    stride = 1
    for d in range(op.st.dim):  # node order: axis 0 fastest
        i = torch.arange(op.st.node_shape[d], device=dev) + op.pads[d][0]
        ext = (i * stride).reshape((-1,) + (1,) * d) + ext
        stride *= op.Ne[d]
    ext = ext.reshape(-1)
    cols, order = torch.sort(ext[:, None] + torch.as_tensor(op.shifts, device=dev)[None, :],
                             dim=1)
    vals = op.DT[:, ext].T.gather(1, order)  # (nloc, K)
    keep = vals != 0
    crow = torch.zeros(ext.numel() + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    nnz = int(crow[-1])
    csr = torch.sparse_csr_tensor(crow.to(torch.int32), cols[keep].to(torch.int32), vals[keep],
                                  size=(ext.numel(), op.next), check_invariants=False)
    return csr, nnz


def dist_quality(ds, data, b, x):
    """``true_rel_residual`` of the f32 distributed solution in f64 and its
    floor (the f64 solution of the same distributed system, rounded to
    f32), both through the ranks' f64 kernel products."""
    data64, b64 = data.double(), b.double()
    planes = ds.local_planes(data64)
    bn = math.sqrt(ds._dot(b64, b64).item())

    def rel_res(v):
        r = b64 - ds.matvec_local(data64, v.double(), DT_loc=planes)
        return math.sqrt(ds._dot(r, r).item()) / bn

    x64, it64, _ = ds.cg(data64, b64, rtol=1e-10, maxiter=5000)
    return {"true_rel_residual": rel_res(x), "floor_rel_residual": rel_res(x64.float()),
            "f64_solve_iters": it64}


def dist_ranks(tmpdir):
    """The body of each rank of the dist128 and dist_f64 phases (gloo, the
    ranks share the card).  Returns per rank its launches, CG spans and
    halo staging; rank 0 adds the solutions, checks' values and the
    extended-block kernel row."""
    import torch.distributed as tdist

    from petiga_tpu_torch.io.sharded import load_sharded, save_sharded
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.parallel.dist import DistSpace, Spans
    from petiga_tpu_torch.parallel.launch import rank_device
    from petiga_tpu_torch.sparse import spmv

    dev = rank_device(None)
    torch.cuda.set_device(dev)
    rank = tdist.get_rank()
    out = {"rank": rank, "device": str(dev)}
    # ---- dist128: the m128 flagship in f32, pgrid (1, 2, 2)
    sp = poisson.make_space(3, p=2, nel=128, dtype=torch.float32, device=dev)
    ds = DistSpace(sp, device=dev)
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    data, b = ds.assemble_system(poisson.poisson_system_q, {"c": 0.0, "k": 1.0}, order=1)
    t_asm = sync_s(t0)
    ds.spans = Spans()
    t0 = time.perf_counter()
    x, iters, res = ds.cg(data, b, rtol=1e-6, maxiter=2000)
    t_cg = sync_s(t0)
    spans = ds.spans.ms()
    ds.spans = None
    U = ds.crop_flat(x)
    out["dist128_launches"] = dict(spmv.LAUNCHES)
    out.update(pgrid=ds.pgrid, L=ds.L, halo_staging=ds.halo_staging, assembly_s=t_asm,
               cg_s=t_cg, cg_iters=iters, cg_residual=float(res),
               spans={k: {"ms_per_iter": v["ms"] / max(iters, 1), "n": v["n"]}
                      for k, v in spans.items()},
               cg_ms_per_iter=1e3 * t_cg / max(iters, 1))
    out["quality"] = dist_quality(ds, data, b, x)
    # the sharded checkpoint of U under this pgrid, reloaded serially by rank 0
    save_sharded(ds, x, tmpdir, "U128")
    if rank == 0:
        out["U"] = U.cpu().numpy()
        out["l2_error"] = poisson.l2_error(sp, U)
        out["sharded_bitwise"] = bool(np.array_equal(load_sharded(tmpdir, "U128"), out["U"]))
    # one rank's extended-block product on the kernel against its plain
    # version (on the solution's halo-exchanged block and on a seeded
    # probe) and the library call, timed on the probe while the other
    # ranks wait (the solution's A·U cancels to b, too hard a test of a
    # CSR's f32 sums)
    planes = ds.local_planes(data)
    x_ext = ds.halo_gather(x)
    if rank == 0:
        from petiga_tpu_torch.sparse.spmv import StencilOperator

        op = StencilOperator(planes.op.st, dtype=torch.float32, device=dev,
                             ext_pads=planes.op.pads)
        op._set_planes(planes.DT)
        probe = torch.randn(x_ext.shape, device=dev,
                            generator=torch.Generator("cuda").manual_seed(2))
        xb = op.pack_ext(probe)
        out["kernel_rel_err"] = max(kernel_vs_plain(op, op.pack_ext(x_ext))[1],
                                    kernel_vs_plain(op, xb)[1])
        csr, nnz = ext_block_csr(op)
        xf = probe.reshape(-1)
        y_lib = csr @ xf
        y_k = op.unpack_vec(op._kernel(op.DT, xb)).reshape(-1)
        lib_rel = float((y_lib - y_k).abs().max() / y_k.abs().max())
        lib_ms = min(time_ms(lambda: csr @ xf, reps=20) for _ in range(2))
        del csr
        out["kernel_row"] = kernel_row("stencil_spmv_full", op, "dist128_rank0",
                                       f"{PALLAS}:303", xb, lib_ms, x_nodes=op.next)
        out["library"] = {"nnz": nnz, "rel_vs_kernel": lib_rel, "ms": lib_ms}
    del data, b, x, planes, x_ext
    tdist.barrier()
    # ---- dist_f64: the same flow in f64 at nel 16
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    sp16 = poisson.make_space(3, p=2, nel=16, dtype=torch.float64, device=dev)
    ds16 = DistSpace(sp16, device=dev)
    U16, info16 = ds16.solve_system(poisson.poisson_system_q, {"c": 0.0, "k": 1.0}, order=1,
                                    rtol=1e-13)
    out["dist_f64_launches"] = dict(spmv.LAUNCHES)
    out["f64"] = {"pgrid": ds16.pgrid, "iters": info16["iters"]}
    if rank == 0:
        out["f64"]["U"] = U16.cpu().numpy()
    return out


def nccl1_rank():
    """World size 1 on NCCL at nel 32 (f64): the NCCL path, which stages
    nothing; returns the solution, launches and staging."""
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.parallel.dist import DistSpace
    from petiga_tpu_torch.parallel.launch import rank_device
    from petiga_tpu_torch.sparse import spmv

    dev = rank_device(None)
    torch.cuda.set_device(dev)
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    sp = poisson.make_space(3, p=2, nel=32, dtype=torch.float64, device=dev)
    ds = DistSpace(sp, device=dev)
    U, info = ds.solve_system(poisson.poisson_system_q, {"c": 0.0, "k": 1.0}, order=1,
                              rtol=1e-10)
    return {"U": U.cpu().numpy(), "iters": info["iters"], "backend": ds.backend,
            "halo_staging": ds.halo_staging, "pgrid": ds.pgrid,
            "launches": dict(spmv.LAUNCHES)}


def phase_dist(U_single):
    """dist128 and dist_f64 on DIST_RANKS gloo ranks that share the card,
    then dist_nccl1 on one NCCL rank; ``U_single`` is the m128 phase's
    single-device solution.  Returns the extended-block kernel row."""
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ranks = launch(dist_ranks, DIST_RANKS, (tmpdir,), backend="gloo", timeout=600.0)
    r0 = ranks[0]
    PHASE_LAUNCHES["dist128"] = {k: sum(r["dist128_launches"][k] for r in ranks)
                                 for k in ("full", "sym")}
    PHASE_LAUNCHES["dist_f64"] = {k: sum(r["dist_f64_launches"][k] for r in ranks)
                                  for k in ("full", "sym")}
    Us = U_single.reshape(-1).double().cpu().numpy()
    Ud = r0["U"].reshape(-1).astype(np.float64)
    q = r0["quality"]
    emit({"phase": "dist128", "ranks": DIST_RANKS, "backend": "gloo", "pgrid": r0["pgrid"],
          "L": r0["L"], "halo_staging": [r["halo_staging"] for r in ranks],
          "assembly_s": [r["assembly_s"] for r in ranks], "cg_iters": r0["cg_iters"],
          "cg_residual": r0["cg_residual"], "cg_s": [r["cg_s"] for r in ranks],
          "cg_ms_per_iter": [r["cg_ms_per_iter"] for r in ranks],
          "cg_spans_ms_per_iter": [r["spans"] for r in ranks],
          "l2_error": r0["l2_error"], "l2_error_ref": L2_REF["m128"], **q,
          "max_diff_vs_single_rel": float(np.max(np.abs(Ud - Us)) / np.max(np.abs(Us))),
          "library": r0["library"], "launches": PHASE_LAUNCHES["dist128"],
          "wall_s": time.perf_counter() - t0})
    check("dist128:cg_iters", abs(r0["cg_iters"] - ITERS_REF["m128"]) <= 3,
          value=r0["cg_iters"], want="45 +- 3")
    check("dist128:l2_error", abs(r0["l2_error"] - L2_REF["m128"]) <= 0.05 * L2_REF["m128"],
          value=r0["l2_error"], want=f"{L2_REF['m128']} +- 5%")
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    check("dist128:true_rel_residual", q["true_rel_residual"] <= lim,
          value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")
    check("dist128:kernel_vs_plain", r0["kernel_rel_err"] <= 1e-5,
          rel_err=r0["kernel_rel_err"], tol=1e-5)
    check("dist128:library_agrees", r0["library"]["rel_vs_kernel"] <= 1e-5,
          rel=r0["library"]["rel_vs_kernel"])
    check("dist128:sharded_bitwise", r0["sharded_bitwise"])
    check("dist128:halo_staging", all(r["halo_staging"] == "host" for r in ranks),
          value=[r["halo_staging"] for r in ranks], want="host (gloo on CUDA tensors)")

    sp16 = poisson.make_space(3, p=2, nel=16, dtype=torch.float64)
    U16, info16 = poisson.solve_poisson(sp16, rtol=1e-13)
    ref = U16.reshape(-1).cpu().numpy()
    rel = float(np.max(np.abs(r0["f64"]["U"].reshape(-1) - ref)) / np.max(np.abs(ref)))
    emit({"phase": "dist_f64", "pgrid": r0["f64"]["pgrid"], "iters": r0["f64"]["iters"],
          "single_iters": info16["iters"], "rel_vs_single": rel,
          "launches": PHASE_LAUNCHES["dist_f64"]})
    check("dist_f64:vs_single", rel <= 1e-10, value=rel, want="<= 1e-10")

    t1 = time.perf_counter()
    n1 = launch(nccl1_rank, 1, backend="nccl", timeout=300.0)[0]
    PHASE_LAUNCHES["dist_nccl1"] = n1["launches"]
    sp32 = poisson.make_space(3, p=2, nel=32, dtype=torch.float64)
    U32, _ = poisson.solve_poisson(sp32, rtol=1e-10)
    ref = U32.reshape(-1).cpu().numpy()
    rel = float(np.max(np.abs(n1["U"].reshape(-1) - ref)) / np.max(np.abs(ref)))
    emit({"phase": "dist_nccl1", "backend": n1["backend"], "pgrid": n1["pgrid"],
          "halo_staging": n1["halo_staging"], "iters": n1["iters"], "rel_vs_single": rel,
          "launches": n1["launches"], "wall_s": time.perf_counter() - t1})
    check("dist_nccl1:vs_single", rel <= 1e-6, value=rel, want="<= 1e-6")
    check("dist_nccl1:no_staging", n1["backend"] == "nccl" and n1["halo_staging"] == "device",
          backend=n1["backend"], halo_staging=n1["halo_staging"])
    return r0["kernel_row"]


def phase_dist_dryrun():
    """``dryrun_multichip(DIST_RANKS)`` on the card: its seven steps hold
    their reference assertions (a failed step raises)."""
    from petiga_tpu_torch import entry

    t0 = time.perf_counter()
    out = entry.dryrun_multichip(DIST_RANKS)
    PHASE_LAUNCHES["dist_dryrun"] = out["launches"]
    emit({"phase": "dist_dryrun", "summary": out["summary"], "device": out["device"],
          "halo_staging": out["halo_staging"], "launches_rank0": out["launches"],
          "wall_s": time.perf_counter() - t0})
    check("dist_dryrun:steps", out["summary"].startswith(f"dryrun_multichip({DIST_RANKS})")
          and "kernel-cg L2=" in out["summary"] and out["device"].startswith("cuda"),
          summary=out["summary"])


# -------------------------------- the front door: native setup, flat API, examples


@contextlib.contextmanager
def native_absent():
    """The numpy routes of the setup code: the native library reported
    absent for the duration."""
    from petiga_tpu_torch import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def phase_native(nel=128, nel_setup=256, npts=1 << 20):
    """The native host-setup library (``csrc/host/native_core.cpp``) built
    at first use on this host: ``Space.mapping`` at ``nel``³ p=2 equal to
    its numpy route, ``bspline_ders`` on ``npts`` points to 1e-13 of its
    numpy route, the native call counter showing both routes ran; host
    seconds of both routes, and of a ``nel_setup``³ space's set-up (the
    Space and its closure map) by each."""
    from petiga_tpu_torch import native
    from petiga_tpu_torch.core import bspline
    from petiga_tpu_torch.models import poisson

    t0 = time.perf_counter()
    ok = native.available()
    t_build = time.perf_counter() - t0
    check("native:available", ok, error=native.build_error())
    if not ok:
        return
    for k in native.CALLS:
        native.CALLS[k] = 0
    sp = poisson.make_space(3, p=2, nel=nel, dtype=torch.float32)
    t0 = time.perf_counter()
    m_nat = sp.mapping
    t_map = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_np = sp.element_nodes(np.arange(sp.nel)).astype(np.int32)
    t_map_np = time.perf_counter() - t0
    same = bool(np.array_equal(m_nat, m_np))
    del m_nat, m_np
    ax = sp.axes[0]
    u = np.random.default_rng(5).random(npts)
    spans = ax.find_span(u)
    t0 = time.perf_counter()
    d_nat = bspline.bspline_ders(ax.U, ax.p, spans, u, ax.p)
    t_ders = time.perf_counter() - t0
    with native_absent():
        t0 = time.perf_counter()
        d_np = bspline.bspline_ders(ax.U, ax.p, spans, u, ax.p)
        t_ders_np = time.perf_counter() - t0
    ders_err = float(np.max(np.abs(d_nat - d_np)))
    calls = dict(native.CALLS)
    setup = {}
    for route in ("native", "numpy"):
        with native_absent() if route == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            sp_big = poisson.make_space(3, p=2, nel=nel_setup, dtype=torch.float32)
            sp_big.mapping
            setup[route] = time.perf_counter() - t0
        del sp_big
    emit({"phase": "native", "build_or_load_s": t_build, "mapping_shape": [sp.nel, sp.nen],
          "mapping_native_s": t_map, "mapping_numpy_s": t_map_np,
          "bspline_ders_points": npts, "bspline_ders_native_s": t_ders,
          "bspline_ders_numpy_s": t_ders_np, "bspline_ders_max_abs_diff": ders_err,
          f"space_setup_{nel_setup}_native_s": setup["native"],
          f"space_setup_{nel_setup}_numpy_s": setup["numpy"], "calls": calls})
    check("native:mapping_equal", same, shape=[sp.nel, sp.nen])
    check("native:bspline_ders", ders_err <= 1e-13, value=ders_err, want="<= 1e-13")
    check("native:calls", calls["build_mapping"] >= 1 and calls["bspline_ders"] >= 1,
          calls=calls)


def phase_api(nel=128, chunk=65536):
    """The reference's quickstart (``petiga_tpu/__init__.py:9-22``) through
    the flat API on the card at 3-D p=2 ``nel``³, homogeneous Dirichlet on
    every face (the port's pointwise assembly takes element chunks there,
    and CG stops at the f32 path's rtol 1e-6); its symmetric storage
    through ``StencilOperator.from_symmetric``, one product through
    ``stencil_matvec``, and ``StencilMatrix.zeros``.  The solve is held to
    its own system in f64 (``true_rel_residual``); outside the counted
    path, the symmetric operator's and the quickstart operator's kernels
    against their plain versions, and ``stencil_matvec`` against the slot
    loop (1e-5, f32)."""
    from petiga_tpu_torch import (Axis, Space, StencilMatrix, StencilOperator,
                                  SymmetricStencilMatrix, assemble_system, cg, stencil_matvec)
    from petiga_tpu_torch.models import poisson

    with counted("api"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = Space([Axis.uniform(p=2, nel=nel)] * 3, dtype=torch.float32)
        for d in range(3):
            for side in range(2):
                sp.set_boundary_value(d, side, 0, 0.0)

        def laplace(pt, ctx):
            return pt.shape1 @ pt.shape1.T, pt.shape0

        A, b = assemble_system(sp, laplace, chunk=chunk)
        t_asm = sync_s(t0)
        op = A.fast_operator()
        t0 = time.perf_counter()
        x, iters, res = cg(op, b, rtol=1e-6)
        t_cg = sync_s(t0)
        op_sym = StencilOperator.from_symmetric(SymmetricStencilMatrix.from_full(A))
        probe = torch.as_tensor(np.random.default_rng(6).normal(size=(sp.nnodes, 1)),
                                dtype=torch.float32, device=sp.device)
        y_sym = op_sym @ probe
        y_sm = stencil_matvec(A, probe)
        Z = StencilMatrix.zeros(A.stencil)
        y_zero = stencil_matvec(Z, probe)
    y_full = op @ probe
    y_slot = A.matvec(probe)
    rel_sym = float((y_sym - y_full).abs().max() / y_full.abs().max())
    rel_sm = float((y_sm - y_slot).abs().max() / y_slot.abs().max())
    q = solve_quality(poisson, sp, op, b, x)
    emit({"phase": "api", "nnodes": sp.nnodes, "assembly_s": t_asm, "cg_s": t_cg,
          "cg_iters": int(iters), "cg_residual": float(res),
          "true_rel_residual": q["true_rel_residual"],
          "floor_rel_residual": q["floor_rel_residual"],
          "sym_vs_full_rel": rel_sym, "stencil_matvec_vs_slot_loop_rel": rel_sm,
          "zeros_device": str(Z.data.device), "launches": PHASE_LAUNCHES["api"]})
    check("api:finite", bool(torch.isfinite(x).all()) and tuple(x.shape) == (sp.nnodes, 1),
          shape=list(x.shape))
    lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
    check("api:true_rel_residual", q["true_rel_residual"] <= lim,
          value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")
    check("api:sym_vs_full", rel_sym <= 1e-5, value=rel_sym, want="<= 1e-5")
    check("api:stencil_matvec_vs_slot_loop", rel_sm <= 1e-5, value=rel_sm, want="<= 1e-5")
    check("api:zeros", Z.data.device == probe.device and not bool(Z.data.any())
          and not bool(y_zero.any()), device=str(Z.data.device))
    for name, o in (("sym", op_sym), ("full", op)):
        err, rel = kernel_vs_plain(o, o.pack_vec(probe))
        check(f"api:kernel_vs_plain:{name}", rel <= 1e-5, max_abs_err=err, rel_err=rel, tol=1e-5)


# The JAX package's examples on the CPU at this phase's sizes, in float64:
# each run's arguments and printed key=value results, as
# scripts/torch_examples_reference.py prints them (the distributed run on a
# 4-device CPU mesh, the port's 4 ranks' grid).
EXAMPLES_REF = {'bratu': {'example': 'bratu',
                          'argv': ['--dim', '2', '-N', '256'],
                          'results': [['dim', '2'], ['dof', '1'], ['order', '2'],
                                      ['geometry', '0'], ['rational', '0'], ['periodic', '0'],
                                      ['nnp', '258'], ['nel', '256'], ['periodic', '0'],
                                      ['nnp', '258'], ['nel', '256'], ['iters', '7'],
                                      ['converged', 'True'], ['max(u)', '1.323452']]},
                'elasticity': {'example': 'elasticity',
                               'argv': ['--dim', '3', '-N', '48', '--dtype', 'float64'],
                               'results': [['dim', '3'], ['dof', '3'], ['order', '2'],
                                           ['geometry', '0'], ['rational', '0'], ['periodic', '0'],
                                           ['nnp', '50'], ['nel', '48'], ['periodic', '0'],
                                           ['nnp', '50'], ['nel', '48'], ['periodic', '0'],
                                           ['nnp', '50'], ['nel', '48'], ['iters', '99'],
                                           ['L2', '8.275717e-07']]},
                'hyperelasticity': {'example': 'hyperelasticity',
                                    'argv': ['--dim', '3', '-N', '12', '--dtype', 'float64'],
                                    'results': [['dim', '3'], ['dof', '3'], ['order', '2'],
                                                ['geometry', '0'], ['rational', '0'],
                                                ['periodic', '0'], ['nnp', '14'], ['nel', '12'],
                                                ['periodic', '0'], ['nnp', '14'], ['nel', '12'],
                                                ['periodic', '0'], ['nnp', '14'], ['nel', '12'],
                                                ['iters', '6'], ['max|u|', '0.1000']]},
                'cahnhilliard': {'example': 'cahnhilliard',
                                 'argv': ['--nel', '256', '--nsteps', '5'],
                                 'results': [['t', '1.0000e-11'], ['energy', '4.140118e-02'],
                                             ['mass', '4.508502e-05'], ['t', '2.0000e-11'],
                                             ['energy', '4.106142e-02'], ['mass', '3.846218e-05'],
                                             ['t', '3.0000e-11'], ['energy', '4.090486e-02'],
                                             ['mass', '3.459775e-05'], ['t', '4.0000e-11'],
                                             ['energy', '4.080909e-02'], ['mass', '3.188167e-05'],
                                             ['t', '5.0000e-11'], ['energy', '4.074341e-02'],
                                             ['mass', '2.981424e-05']]},
                'cahnhilliard_conv': {'example': 'cahnhilliard',
                                      'argv': ['--nel', '256', '--nsteps', '5', '--conv-jacobian'],
                                      'results': [['t', '1.0000e-11'], ['energy', '4.140118e-02'],
                                                  ['mass', '4.508502e-05'], ['t', '2.0000e-11'],
                                                  ['energy', '4.106142e-02'],
                                                  ['mass', '3.846218e-05'], ['t', '3.0000e-11'],
                                                  ['energy', '4.090486e-02'],
                                                  ['mass', '3.459775e-05'], ['t', '4.0000e-11'],
                                                  ['energy', '4.080909e-02'],
                                                  ['mass', '3.188167e-05'], ['t', '5.0000e-11'],
                                                  ['energy', '4.074341e-02'],
                                                  ['mass', '2.981424e-05']]},
                'distributed': {'example': 'distributed',
                                'argv': ['--dim', '3', '-p', '2', '-N', '64', '--dtype', 'float64',
                                         '--pc', 'mg', '--checkpoint', '{tmp}'],
                                'results': [['dim', '3'], ['dof', '1'], ['order', '2'],
                                            ['geometry', '0'], ['rational', '0'],
                                            ['periodic', '0'], ['nnp', '66'], ['nel', '64'],
                                            ['periodic', '0'], ['nnp', '66'], ['nel', '64'],
                                            ['periodic', '0'], ['nnp', '66'], ['nel', '64'],
                                            ['iters', '9'], ['L2', '3.4880e-07']]}}

# the Poisson example at the f64 phase's 128³ (its L2 held to that phase's)
POISSON_ARGV = ["--dim", "3", "-p", "2", "-N", "128", "--dtype", "float64"]

def printed_agree(got, want, rtol=1e-8):
    """A printed float against a reference: within ``rtol``, or one unit in
    the last printed digit (two values far closer than the print can
    still round to neighbouring last digits)."""
    m = re.fullmatch(r"[-+]?\d*\.?(\d*)(?:[eE]([-+]?\d+))?", want)
    unit = 10.0 ** (int(m.group(2) or 0) - len(m.group(1)))
    return abs(float(got) - float(want)) <= max(rtol * abs(float(want)), unit * 1.000001)


def compare_results(key, got, want):
    """The port's printed results against the JAX example's: the same keys
    in order, counts (``iters``) within one, other integers and flags
    equal, floats by :func:`printed_agree`.  Returns the disagreements."""
    if [k for k, _ in got] != [k for k, _ in want]:
        return [{"keys": [k for k, _ in got], "want": [k for k, _ in want]}]
    bad = []
    for (k, a), (_, b) in zip(got, want):
        if re.fullmatch(r"[-+]?\d+|True|False", b):
            ok = abs(int(a) - int(b)) <= 1 if k == "iters" else a == b
        else:
            ok = printed_agree(a, b)
        if not ok:
            bad.append({"key": k, "port": a, "reference": b})
    return bad


def run_example(key, name, argv):
    """``petiga_tpu_torch.examples.<name>.main(argv)`` on the card, its
    kernel launches counted (the distributed example's: summed over its
    ranks) and the inputs of its kernel calls captured; returns ``(rc,
    printed text, seconds, the captures held against the plain versions)``."""
    import io

    mod = importlib.import_module(f"petiga_tpu_torch.examples.{name}")
    out = io.StringIO()
    # hand the earlier phases' cached blocks back to the card: the
    # distributed example's ranks are other processes
    gc.collect()
    torch.cuda.empty_cache()
    dist = name == "distributed"
    if dist:  # the ranks capture their own kernel inputs
        rank_body, mod._rank = mod._rank, example_rank
    try:
        with counted(f"ex_{key}"), kernel_inputs() as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = mod.main(argv)
            seconds = sync_s(t0)
    finally:
        if dist:
            mod._rank = rank_body
    if dist:
        PHASE_LAUNCHES[f"ex_{key}"] = {k: sum(r["launches"][k] for r in mod.RANKS)
                                       for k in ("full", "sym")}
        rows = [dict(row, rank=r) for r, res in enumerate(mod.RANKS)
                for row in res["kernel_vs_plain"]]
    else:
        rows = captured_vs_plain(seen)
    del seen
    return rc, out.getvalue(), seconds, rows


def phase_examples(l2_f64_128, tmpdir):
    """The six example programs through their command lines on the card:
    Poisson at 128³ in f64 (its L2 to the f64 phase's ``l2_f64_128``), the
    others at ``EXAMPLES_REF``'s arguments against the JAX package's
    printed results there (f64 L2, energies and extrema to 1e-8, counts
    within one); each returns 0 and launches the full kernel."""
    from petiga_tpu_torch.examples import printed_results

    runs = [("poisson", "poisson", POISSON_ARGV)] + [
        (key, ref["example"], [a.replace("{tmp}", f"{tmpdir}/ck_{key}") for a in ref["argv"]])
        for key, ref in EXAMPLES_REF.items()]
    for key, name, argv in runs:
        rc, text, seconds, rows = run_example(key, name, argv)
        got = printed_results(text)
        emit({"phase": f"example:{key}", "argv": argv, "rc": rc, "seconds": seconds,
              "launches": PHASE_LAUNCHES[f"ex_{key}"], "kernel_vs_plain": rows,
              "output": text.splitlines()})
        check(f"example:{key}:rc", rc == 0, value=rc)
        check(f"example:{key}:kernel_vs_plain",
              any(r["kernel"] == "stencil_spmv_full" for r in rows)
              and all(r["rel_err"] <= r["tol"] for r in rows),
              worst=max((r["rel_err"] / r["tol"] for r in rows), default=None),
              shapes=len(rows))
        if key == "poisson":
            l2 = dict(got).get("L2")
            ok = l2 is not None and printed_agree(l2, f"{l2_f64_128:.6e}")
            check("example:poisson:l2_vs_f64_phase", ok, value=l2, f64_phase=l2_f64_128,
                  want="its printed digits")
        else:
            bad = compare_results(key, got, EXAMPLES_REF[key]["results"])
            check(f"example:{key}:vs_reference", not bad, mismatches=bad)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes, poisson_coefficients
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.sparse import spmv

    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    phase_kernels()
    coef = {"c": 0.0, "k": 1.0}

    # ------------------------------------ the assembled f32 path, counted
    with counted("m128"):
        sp = poisson.make_space(3, p=2, nel=128, dtype=torch.float32)
        nnz = scalar_nnz(sp)
        t_asm = []
        for _ in range(2):  # the first run includes first-use allocations
            op128 = b128 = None
            t0 = time.perf_counter()
            op128, b128 = poisson.assemble_poisson(sp)
            t_asm.append(sync_s(t0))
        t_cg = []
        for _ in range(2):  # the first run includes cuBLAS's start-up
            x, iters, res, t = timed_solve(poisson, op128, b128, rtol=1e-6)
            t_cg.append(t)
        l2 = poisson.l2_error(sp, x)
    emit({"phase": "m128", "nnodes": sp.nnodes, "nnz": nnz, "planes": op128.nplanes,
          "assembly_s": t_asm[-1], "assembly_first_s": t_asm[0],
          "assembly_Mnnz_s": nnz / t_asm[-1] / 1e6, "cg_iters": iters,
          "cg_residual": res, "cg_s": t_cg[-1], "cg_first_s": t_cg[0],
          "cg_ms_per_iter": 1e3 * t_cg[-1] / max(iters, 1), "l2_error": l2,
          "l2_error_ref": L2_REF["m128"], "l2_error_tpu": L2_TPU["m128"]})
    check("m128:cg_iters", abs(iters - ITERS_REF["m128"]) <= 3, value=iters, want="45 +- 3")
    check("m128:l2_error", abs(l2 - L2_REF["m128"]) <= 0.05 * L2_REF["m128"], value=l2,
          want=f"{L2_REF['m128']} +- 5%")

    with counted("m256"):
        sp256 = poisson.make_space(3, p=2, nel=256, dtype=torch.float32)
        nnz256 = scalar_nnz(sp256)
        probe = torch.as_tensor(
            np.random.default_rng(0).normal(size=(sp256.nnodes, 1)).astype(np.float32),
            device="cuda")
        t0 = time.perf_counter()
        op_full, _ = assemble_coefficient_planes(sp256, poisson_coefficients, coef)
        t_full = sync_s(t0)
        y_full = op_full.matvec(probe)
        t0 = time.perf_counter()
        op_sym, b256 = poisson.assemble_poisson(sp256, symmetric=True)
        t_sym = sync_s(t0)
        y_sym = op_sym.matvec(probe)
        rel = float((y_sym - y_full).abs().max() / y_full.abs().max())
        del y_full, y_sym
        x256, iters256, res256, t_cg256 = timed_solve(poisson, op_sym, b256, rtol=1e-8)
        l2_256 = poisson.l2_error(sp256, x256)
    emit({"phase": "m256", "nnodes": sp256.nnodes, "nnz": nnz256,
          "full_planes_GB": op_full.plane_bytes / 1e9, "sym_planes_GB": op_sym.plane_bytes / 1e9,
          "assembly_full_s": t_full, "assembly_full_Mnnz_s": nnz256 / t_full / 1e6,
          "assembly_sym_s": t_sym, "assembly_sym_Mnnz_s": nnz256 / t_sym / 1e6,
          "full_vs_sym_matvec_rel": rel, "full_vs_sym_matvec_rel_ref": 1.97e-10,
          "cg_iters": iters256, "cg_residual": res256, "cg_s": t_cg256,
          "cg_ms_per_iter": 1e3 * t_cg256 / max(iters256, 1), "l2_error": l2_256,
          "l2_error_ref": L2_REF["m256"], "l2_error_tpu": L2_TPU["m256"],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    check("m256:full_vs_sym_matvec_rel", rel <= 1e-5, value=rel, want="<= 1e-5")
    check("m256:cg_iters", abs(iters256 - ITERS_REF["m256"]) <= 10, value=iters256,
          want="193 +- 10")
    check("m256:l2_error", abs(l2_256 - L2_REF["m256"]) <= 0.05 * L2_REF["m256"],
          value=l2_256, want=f"{L2_REF['m256']} +- 5%")

    # ---- the f64 half and the pointwise engine, each path counted alone
    refined = {}
    with counted("m128_refine"):
        refined["m128"], _ = phase_refine(poisson, "m128", sp, op128, x)
    with counted("m256_refine"):
        refined["m256"], x64_256 = phase_refine(poisson, "m256", sp256, op_sym, x256)
    with counted("m256_matfree"):
        phase_matfree(poisson, sp256, b256, x256, x64_256, rtol=1e-8)
    del x64_256
    with counted("pointwise"):
        U_pw, info_pw = phase_pointwise(
            poisson, {"m128": sp, "m256": sp256}, {"m128": op128, "m256": op_full},
            {"m128": nnz, "m256": nnz256})
    phase_entry()
    # ---- the nonlinear and transient path: Cahn-Hilliard conv-α, f32
    phase_ch("ch64", 64, 3)
    sp_ch, U_ch = phase_ch("ch128", 128, 3)
    with counted("nonlinear_f64"):
        phase_nonlinear_f64()
    PHASE_SECONDS["poisson_and_nonlinear"] = time.perf_counter() - t_start

    # ---- the distributed layer: ranks that share the card, one NCCL rank
    t0 = time.perf_counter()
    dist_row = phase_dist(x)
    phase_dist_dryrun()
    PHASE_SECONDS["dist"] = time.perf_counter() - t0

    # ------------------- f32 solutions against their own systems, in f64
    pointwise_quality(poisson, sp, U_pw, info_pw)
    del U_pw, info_pw
    for shape, spc, op, b, U in (("m128", sp, op128, b128, x),
                                 ("m256", sp256, op_sym, b256, x256)):
        q = solve_quality(poisson, spc, op, b, U)
        emit({"phase": f"{shape}_quality", **q})
        lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
        check(f"{shape}:true_rel_residual", q["true_rel_residual"] <= lim,
              value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")

    # the ch128 Jacobian at the final state: its assembly timed on a
    # second call, its planes the periodic row of the kernel table
    from petiga_tpu_torch.models import cahnhilliard as ch

    t_jac = []
    for _ in range(2):
        op_ch = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op_ch = ch_jacobian(ch, sp_ch, U_ch, CH_RUN["dt"])
        t_jac.append(sync_s(t0))
    nnz_ch = sp_ch.nnodes * 125
    emit({"phase": "ch128_jacobian", "assembly_s": t_jac[-1], "assembly_first_s": t_jac[0],
          "assembly_Mnnz_s": nnz_ch / t_jac[-1] / 1e6, "planes": op_ch.nplanes,
          "next": op_ch.next, "plane_GB": op_ch.plane_bytes / 1e9})
    del U_ch

    # -------- kernels beside their plain versions, bounds, library call
    kernels = []
    library_ms = {}  # by shape: the symmetric row is held to the full matrix's CSR
    structural = {"m128": nnz, "m256": nnz256, "ch128": nnz_ch}
    for name, op, shape, replaces in (
        ("stencil_spmv_full", op128, "m128", f"{PALLAS}:303"),
        ("stencil_spmv_full", op_full, "m256", f"{PALLAS}:392"),
        ("stencil_spmv_sym", op_sym, "m256", f"{PALLAS}:530"),
        ("stencil_spmv_full", op_ch, "ch128", f"{PALLAS}:303"),
    ):
        xb = op.pack_vec(probe if shape == "m256" else torch.randn(
            op.st.nnodes, 1, device="cuda", generator=torch.Generator("cuda").manual_seed(2)))
        if op.kind == "full":
            library_ms[shape] = library_csr_ms(op, xb, shape, structural[shape])
        kernels.append(kernel_row(name, op, shape, replaces, xb, library_ms[shape]))
    kernels.append(dist_row)

    # CG host-sync cost: the real loop vs the same steps with no
    # residual read
    for shape, op, b in (("m128-full", op128, b128), ("m256-sym", op_sym, b256)):
        emit({"phase": "cg_sync", "shape": shape, **cg_sync_cost(poisson, op, b)})
    del op_full, op_sym, op128, op_ch, op, xb

    # --------- f64 assembled solves; the refined solutions held to them
    l2_f64 = phase_f64(poisson)
    for shape, nel in (("m128", 128), ("m256", 256)):
        dev = abs(refined[shape] - l2_f64[nel]) / l2_f64[nel]
        check(f"{shape}_refine:l2_vs_f64_solve", dev <= 0.02, value=refined[shape],
              f64_solve=l2_f64[nel], rel_dev=dev, want="within 2 %")
    order = float(np.log2(refined["m128"] / refined["m256"]))
    check("refine:l2_order", abs(order - 3.0) <= 0.15, value=order, want="3 +- 0.15")
    PHASE_SECONDS["poisson_timing_f64"] = time.perf_counter() - t_start - sum(
        PHASE_SECONDS.values())

    # ---------------------- the vector (dof > 1) class: elasticity at 96³
    t0 = time.perf_counter()
    with counted("elast96"):
        sp_e, A_e, op_e, op_esym, b_e, probe_e, U_e = phase_elast96()
    elast96_quality(96, op_e, b_e, U_e)
    del U_e
    PHASE_SECONDS["elast96"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_elast_conv(sp_e, op_e)
    PHASE_SECONDS["elast_conv"] = time.perf_counter() - t0
    del A_e, b_e
    t0 = time.perf_counter()
    xb = op_e.pack_vec(probe_e)
    lib = library_csr_ms(op_e, xb, "elast96", scalar_nnz(sp_e) * 9, min_frac=0.75)
    kernels.append(kernel_row("stencil_spmv_full", op_e, "elast96", f"{PALLAS}:392", xb, lib))
    kernels.append(kernel_row("stencil_spmv_sym", op_esym, "elast96", f"{PALLAS}:530", xb, lib))
    del op_e, op_esym, xb
    PHASE_SECONDS["elast96_timing"] = time.perf_counter() - t0
    for name, fn in (("elast_f64", phase_elast_f64), ("precond", phase_precond),
                     ("hyper", phase_hyper), ("ns", phase_ns)):
        t0 = time.perf_counter()
        with counted(name):
            fn()
        PHASE_SECONDS[name] = time.perf_counter() - t0

    # ------------- the steppers and the remaining models; adaptive CH at 512²
    for nel in (512, 256):
        t0 = time.perf_counter()
        with counted(f"ch_adapt{nel}"):
            out = phase_ch_adapt(nel)
        if nel == 512:
            sp_a, U_a, dt_a = out
        del out
        PHASE_SECONDS[f"ch_adapt{nel}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_a = ch_jacobian(ch, sp_a, U_a, dt_a)
    xb = op_a.pack_vec(torch.randn(sp_a.nnodes, 1, dtype=torch.float64, device="cuda",
                                   generator=torch.Generator("cuda").manual_seed(3)))
    lib = library_csr_ms(op_a, xb, "ch_adapt512_f64", sp_a.nnodes * op_a.nplanes)
    kernels.append(kernel_row("stencil_spmv_full", op_a, "ch_adapt512_f64", f"{PALLAS}:303",
                              xb, lib))
    del op_a, xb, U_a
    PHASE_SECONDS["ch_adapt_timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_transient()
    PHASE_SECONDS["transient"] = time.perf_counter() - t0

    # ---- the single-device user surface: -iga_load, mapped and NURBS conv
    # assembly, collocation, separable planes, I/O and probes, log events
    from petiga_tpu_torch.utils import profiling

    profiling.reset()
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        with counted("mapped128"):
            sp_map, U_map, op_map, b_map = phase_mapped(128, False, tmpdir)
            phase_mapped_f64(tmpdir)
        PHASE_SECONDS["mapped128"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counted("nurbs128"):
            sp_nurbs = phase_mapped(128, True, tmpdir)[0]
        PHASE_SECONDS["nurbs128"] = time.perf_counter() - t0
        for name, fn in (("colloc", phase_colloc), ("bratu_colloc", phase_bratu_colloc)):
            t0 = time.perf_counter()
            with counted(name):
                fn()
            PHASE_SECONDS[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counted("separable256"):
            sep_iters, sep_l2 = phase_separable(256)
        emit({"phase": "separable256_vs_m256", "cg_iters": sep_iters, "l2_error": sep_l2,
              "m256_cg_iters": iters256, "m256_l2_error": l2_256,
              "note": "unchecked: both move with how the f32 planes round"})
        PHASE_SECONDS["separable256"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counted("io_post"):
            phase_io_post(sp, x, sp_map, U_map, op_map, b_map, sp_nurbs, tmpdir)
        PHASE_SECONDS["io_post"] = time.perf_counter() - t0
        with counted("log_view"):
            phase_log_view(op_map)
        del op_map, b_map, U_map

    # ---- the front door: native host setup, the flat API, the six examples
    for name, fn in (("native", phase_native), ("api", phase_api)):
        t0 = time.perf_counter()
        fn()
        PHASE_SECONDS[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        phase_examples(l2_f64[128], tmpdir)
    PHASE_SECONDS["examples"] = time.perf_counter() - t0
    emit({"phase": "seconds", **PHASE_SECONDS, "total": time.perf_counter() - t_start})

    emit({"phase": "launches", **PHASE_LAUNCHES})
    # each kernel is launched on every counted path
    for kind, phases in (("full", ("m128", "m256", "m128_refine", "pointwise", "entry", "ch64",
                                   "ch128", "nonlinear_f64", "elast96", "elast_f64",
                                   "precond", "hyper", "ns", "ch_adapt512",
                                   "ch_adapt256", "mapped128", "nurbs128", "colloc",
                                   "bratu_colloc", "separable256", "io_post", "log_view",
                                   "dist128", "dist_f64", "dist_dryrun", "dist_nccl1", "api",
                                   "ex_poisson")
                          + tuple(name for name, _ in TRANSIENT)
                          + tuple(f"ex_{key}" for key in EXAMPLES_REF)),
                         ("sym", ("m256", "m256_refine", "elast96", "mapped128", "api"))):
        for ph in phases:
            check(f"launches:{kind}:{ph}", PHASE_LAUNCHES[ph][kind] > 0,
                  value=PHASE_LAUNCHES[ph][kind])
    launches = {k: sum(v[k] for v in PHASE_LAUNCHES.values()) for k in ("full", "sym")}
    for row in kernels:
        row["launches"] = launches["sym" if "sym" in row["name"] else "full"]

    print(smi, flush=True)
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: failed checks: {FAILURES}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
