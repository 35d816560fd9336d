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
  entry ``petiga_tpu_torch.entry.entry()``.

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
planes at 128³ and at 256³), which the port itself never uses.

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

Prints one JSON line per phase, the ``nvidia-smi`` name/power-limit line,
a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, without that last line, when no CUDA device is present
or any phase fails.
"""

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
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


def kernel_vs_plain(op, xb):
    """(max |Δ|, max |Δ| / max |y|) of the kernel against its plain
    version on the same packed input, both on the card."""
    from petiga_tpu_torch.sparse import spmv

    sym = op.kind == "sym"
    y_k = op._kernel(op.DT, xb)
    y_p = torch.zeros_like(y_k)
    plain = spmv._spmv_sym_plain if sym else spmv._spmv_full_plain
    plain(op.DT, xb, op.shifts_u if sym else op.shifts, op.G, y_p)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    return err, err / float(y_p.abs().max())


def phase_kernels():
    from petiga_tpu_torch.sparse.stencil import Stencil

    def st(shape, p, per, dof):
        return Stencil(node_shape=shape, widths=(p,) * len(shape), periodic=per, dof=dof)

    cases = [(f"full-3d-open-nel6-dof{d}", st((8, 8, 8), 2, (False,) * 3, d), False)
             for d in (1, 2, 3)]
    cases += [
        ("full-2d-periodic-nel7", st((7, 7), 2, (True, True), 1), False),
        ("full-2d-mixed-nel7-dof2", st((7, 9), 2, (True, False), 2), False),
        ("full-1d-p3", st((23,), 3, (False,), 1), False),
    ]
    cases += [(f"sym-3d-open-nel6-dof{d}", st((8, 8, 8), 2, (False,) * 3, d), True)
              for d in (1, 2)]
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
           "f64_solve_iters": res.iters, "l2_error_f64_solve": poisson.l2_error(sp, U64.float())}
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
    """The matrix of a full-storage operator (dof 1, open axes) as a CSR
    ``torch.sparse`` tensor, built on the card from the planes.

    Entry (row n, slot s) sits in column ``n + c_s``.  It is kept where
    the slot stays inside the node grid on every axis (the clipped slots
    hold zero planes) and its value is not zero (the Dirichlet fix
    leaves explicit zeros), so the library call moves no entry it could
    do without.  Slots in order of their shift are columns in ascending
    order, so a row chunk of the transposed planes under that mask is
    already the row-major CSR payload: no sort, no host pass.  One pass
    counts the rows' entries, a second fills them.  Indices are int32
    where the count allows.  Returns ``(csr, nnz, index dtype)``."""
    st = op.st
    if op.kind != "full" or st.dof != 1 or any(st.periodic):
        raise ValueError("device_csr: full storage, dof 1, open axes only")
    dev, n, N = op.device, st.nnodes, st.node_shape
    order = np.argsort(np.asarray(op.shifts), kind="stable")
    perm = torch.as_tensor(order, device=dev)
    offs = torch.as_tensor(st.slot_offsets()[order], device=dev)  # (K, dim)
    shifts = torch.as_tensor(np.asarray(op.shifts)[order], device=dev)

    def chunk(r0):
        """rows, their slot values in column order, and the keep mask"""
        rows = torch.arange(r0, min(r0 + rows_per_chunk, n), device=dev)
        v = op.DT[:, r0:r0 + rows.numel()].index_select(0, perm).T
        mask = v != 0
        rem = rows
        for d, Nd in enumerate(N):  # axis 0 fastest
            j = (rem % Nd)[:, None] + offs[None, :, d]
            mask &= (j >= 0) & (j < Nd)
            rem = rem // Nd
        return rows, v, mask

    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    for r0 in range(0, n, rows_per_chunk):
        rows, _, mask = chunk(r0)
        indptr[rows + 1] = mask.sum(dim=1)
    torch.cumsum(indptr, 0, out=indptr)
    nnz = int(indptr[-1])
    itype = torch.int32 if nnz < 2**31 else torch.int64
    vals = torch.empty(nnz, dtype=op.DT.dtype, device=dev)
    cols = torch.empty(nnz, dtype=itype, device=dev)
    for r0 in range(0, n, rows_per_chunk):
        rows, v, mask = chunk(r0)
        lo, hi = int(indptr[r0]), int(indptr[r0 + rows.numel()])
        vals[lo:hi] = v[mask]
        cols[lo:hi] = (rows[:, None] + shifts[None, :])[mask].to(itype)
    csr = torch.sparse_csr_tensor(indptr.to(itype), cols, vals, size=(n, n),
                                  check_invariants=False)
    return csr, nnz, itype


def library_csr_ms(op, xb, shape, structural_nnz):
    """ms of one PyTorch call for the stencil kernels' product: a CSR
    ``torch.sparse`` matvec of the same matrix (:func:`device_csr`),
    timed like the kernels.  The port never calls it."""
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
    check(f"library_csr:{shape}:nnz", 0.9 * structural_nnz <= nnz <= structural_nnz,
          value=nnz, want=f"within 10 % under {structural_nnz}")
    check(f"library_csr:{shape}:agrees", rel <= 1e-5, rel=rel)
    return min(runs)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from petiga_tpu_torch.assembly.convform import assemble_coefficient_planes, poisson_coefficients
    from petiga_tpu_torch.models import poisson
    from petiga_tpu_torch.sparse import spmv

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
    emit({"phase": "launches", **PHASE_LAUNCHES})
    # each kernel is launched on the assembled path and on the new paths
    for kind, phases in (("full", ("m128", "m256", "m128_refine", "pointwise", "entry")),
                         ("sym", ("m256", "m256_refine"))):
        for ph in phases:
            check(f"launches:{kind}:{ph}", PHASE_LAUNCHES[ph][kind] > 0,
                  value=PHASE_LAUNCHES[ph][kind])
    launches = {k: sum(v[k] for v in PHASE_LAUNCHES.values()) for k in ("full", "sym")}

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

    # -------- kernels beside their plain versions, bounds, library call
    kernels = []
    library_ms = {}  # by shape: the symmetric row is held to the full matrix's CSR
    for name, op, shape, replaces in (
        ("stencil_spmv_full", op128, "m128", f"{PALLAS}:303"),
        ("stencil_spmv_full", op_full, "m256", f"{PALLAS}:392"),
        ("stencil_spmv_sym", op_sym, "m256", f"{PALLAS}:530"),
    ):
        sym = op.kind == "sym"
        xb = op.pack_vec(probe if shape == "m256" else torch.randn(
            op.st.nnodes, 1, device="cuda", generator=torch.Generator("cuda").manual_seed(2)))
        err, rel_err = kernel_vs_plain(op, xb)
        if not sym:
            library_ms[shape] = library_csr_ms(op, xb, shape,
                                               {"m128": nnz, "m256": nnz256}[shape])
        yb = torch.zeros_like(xb)
        plain = spmv._spmv_sym_plain if sym else spmv._spmv_full_plain
        shifts = op.shifts_u if sym else op.shifts
        fn = spmv.stencil_spmv_sym if sym else spmv.stencil_spmv_full
        # kernel, plain, kernel, plain: 20 timed calls each
        runs = {"ms": [], "plain_ms": []}
        for _ in range(2):
            runs["ms"].append(time_ms(lambda: fn(op.DT, xb, op._shift_t, op.G, out=yb),
                                      reps=20))
            runs["plain_ms"].append(time_ms(lambda: plain(op.DT, xb, shifts, op.G, yb),
                                            reps=20))
        ms, plain_ms = min(runs["ms"]), min(runs["plain_ms"])
        gbps = op.plane_bytes / (ms * 1e-3) / 1e9
        # the least time the card could take: planes and x read once, y
        # written once, against 2 operations per stored nonzero (twice
        # that for the symmetric kernel's mirror term)
        nbytes = op.plane_bytes + 2 * xb.numel() * xb.element_size()
        flops = 2 * op.nplanes * op.next * (2 if sym else 1)
        t_bytes = 1e3 * nbytes / HBM_BYTES_S
        t_ops = 1e3 * flops / PEAK_FLOP_S[op.DT.dtype]
        row = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
               "launches": launches["sym" if sym else "full"], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms[shape],
               "shape": shape, "rel_err": rel_err, "plane_GB_s": gbps,
               "plane_roofline_frac": gbps / 3350.0,
               "plane_bound_ms": 1e3 * op.plane_bytes / HBM_BYTES_S,
               "launches_by_phase": {ph: v["sym" if sym else "full"]
                                     for ph, v in PHASE_LAUNCHES.items()}}
        emit({"phase": "timing", **row, "ms_runs": runs["ms"],
              "plain_ms_runs": runs["plain_ms"]})
        check(f"timing:{name}:{shape}:agrees", rel_err <= 1e-5, rel_err=rel_err)
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_phase")})

    # CG host-sync cost: the real loop vs the same steps with no
    # residual read
    for shape, op, b in (("m128-full", op128, b128), ("m256-sym", op_sym, b256)):
        emit({"phase": "cg_sync", "shape": shape, **cg_sync_cost(poisson, op, b)})
    del op_full, op_sym, op128, op, xb, yb

    # --------- f64 assembled solves; the refined solutions held to them
    l2_f64 = phase_f64(poisson)
    for shape, nel in (("m128", 128), ("m256", 256)):
        dev = abs(refined[shape] - l2_f64[nel]) / l2_f64[nel]
        check(f"{shape}_refine:l2_vs_f64_solve", dev <= 0.02, value=refined[shape],
              f64_solve=l2_f64[nel], rel_dev=dev, want="within 2 %")
    order = float(np.log2(refined["m128"] / refined["m256"]))
    check("refine:l2_order", abs(order - 3.0) <= 0.15, value=order, want="3 +- 0.15")

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
