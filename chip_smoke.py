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
  f64   the same path in float64 at 64³ and 128³: the L2 error falls as
        h³, the rate of p=2 B-splines.

CG iteration counts are held to the reference's recorded ones (45 and
193).  In f32 the L2 error at these sizes is set by the rounding of one
interior stencil, which every interior row shares, so it is held to the
reference's own f32 system (the JAX package's planes and load vector,
assembled on an IEEE CPU, where its planes are bit-identical to this
port's) solved on the card by ``scripts/torch_f32_reference.py``; the
TPU's recorded values are printed beside.  Kernel launch counts are reset
just before the main path and read just after it, then the kernels are
timed beside their plain versions at the main path's shapes.

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

import importlib.util
import json
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(name, ok, **info):
    if not ok:
        FAILURES.append(name)
    emit({"check": name, "ok": bool(ok), **info})


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


def phase_f64(poisson):
    """The path in float64 at 64³ and 128³ (symmetric storage): with f32
    rounding out of the way the L2 error is the discretization's, and it
    falls as h³ for p=2."""
    l2 = {}
    for nel in (64, 128):
        sp = poisson.make_space(3, p=2, nel=nel, dtype=torch.float64, device="cuda")
        U, info = poisson.solve_poisson(sp, rtol=1e-12, symmetric=True)
        l2[nel] = poisson.l2_error(sp, U)
        emit({"phase": f"m{nel}_f64", "cg_iters": info["iters"],
              "cg_residual": info["residual"], "l2_error": l2[nel]})
        del U, info
    order = float(np.log2(l2[64] / l2[128]))
    check("f64:l2_order", abs(order - 3.0) <= 0.15, value=order, want="3 +- 0.15")


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

    # ------------------------------------------------ main path, counted
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    sp = poisson.make_space(3, p=2, nel=128, dtype=torch.float32, device="cuda")
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

    sp256 = poisson.make_space(3, p=2, nel=256, dtype=torch.float32, device="cuda")
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
    launches = dict(spmv.LAUNCHES)
    # ------------------------------------------------ end of counted path
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
    emit({"phase": "launches", **launches})
    check("launches:full", launches["full"] > 0, value=launches["full"])
    check("launches:sym", launches["sym"] > 0, value=launches["sym"])

    # ------------------- f32 solutions against their own systems, in f64
    for shape, spc, op, b, U in (("m128", sp, op128, b128, x),
                                 ("m256", sp256, op_sym, b256, x256)):
        q = solve_quality(poisson, spc, op, b, U)
        emit({"phase": f"{shape}_quality", **q})
        lim = RESIDUAL_OVER_FLOOR * q["floor_rel_residual"]
        check(f"{shape}:true_rel_residual", q["true_rel_residual"] <= lim,
              value=q["true_rel_residual"], want=f"<= {RESIDUAL_OVER_FLOOR:g} x floor {lim:.3e}")

    # ------------------------------ kernels beside their plain versions
    kernels = []
    for name, op, shape, replaces in (
        ("stencil_spmv_full", op128, "m128", f"{PALLAS}:303"),
        ("stencil_spmv_full", op_full, "m256", f"{PALLAS}:392"),
        ("stencil_spmv_sym", op_sym, "m256", f"{PALLAS}:530"),
    ):
        sym = op.kind == "sym"
        xb = op.pack_vec(probe if shape == "m256" else torch.randn(
            op.st.nnodes, 1, device="cuda", generator=torch.Generator("cuda").manual_seed(2)))
        err, rel_err = kernel_vs_plain(op, xb)
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
        row = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
               "launches": launches["sym" if sym else "full"], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "shape": shape,
               "rel_err": rel_err, "plane_GB_s": gbps,
               "plane_roofline_frac": gbps / 3350.0}
        emit({"phase": "timing", **row, "ms_runs": runs["ms"],
              "plain_ms_runs": runs["plain_ms"]})
        check(f"timing:{name}:{shape}:agrees", rel_err <= 1e-5, rel_err=rel_err)
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces",
                                            "launches", "max_abs_err", "ms", "plain_ms")}
                       | {"shape": shape})

    # CG host-sync cost: the real loop vs the same steps with no
    # residual read
    for shape, op, b in (("m128-full", op128, b128), ("m256-sym", op_sym, b256)):
        emit({"phase": "cg_sync", "shape": shape, **cg_sync_cost(poisson, op, b)})
    del op_full, op_sym, op128
    phase_f64(poisson)

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
