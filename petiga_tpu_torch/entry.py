"""Entry points of the port (the counterpart of the JAX package's
``__graft_entry__``).

``entry()`` — a single-device forward step on the flagship configuration
(3-D Poisson, p=2, 8³ elements): assemble the stencil operator with the
pointwise engine, then a fixed number of Jacobi-preconditioned CG
iterations through the stencil kernel.

``dryrun_multichip(n)`` — one pass over the distributed surface on ``n``
ranks of a ``torch.distributed`` job (:mod:`.parallel.launch`), each rank
a block of the spatial domain decomposition, with point-to-point halo
exchange and all-reduce reductions: distributed assembly + halo CG
(linear), Newton (nonlinear), GMRES with the two-level Schwarz
preconditioner, a boundary-form (Nitsche) assembly + solve, one
distributed generalized-α step, a sharded checkpoint round trip with
repartitioning, and a kernel CG — every distributed product runs the
stencil kernel on the rank's halo-extended block.
"""

from __future__ import annotations

import math
import shutil
import tempfile

import numpy as np
import torch

from .assembly.assemble import assemble_system
from .models.poisson import make_space, poisson_system
from .solve.krylov import cg, jacobi_preconditioner

__all__ = ["entry", "dryrun_multichip"]


def _build(nel: int = 8, dtype=torch.float32, device=None):
    sp = make_space(3, p=2, nel=nel, dtype=dtype, device=device)

    def step(src_scale):
        A, b = assemble_system(sp, poisson_system, {"c": 0.0, "k": 1.0})
        b = b * src_scale
        res = cg(A.fast_operator(), b, M=jacobi_preconditioner(A), rtol=1e-5,
                 maxiter=30)
        return res.x, res.residual

    return sp, step


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(src_scale) -> (x, residual)``
    assembles the f32 system at 8³ elements, scales the load by
    ``src_scale`` and runs at most 30 Jacobi-CG iterations to rtol 1e-5.
    ``device=None`` is the CUDA device."""
    sp, step = _build(nel=8, device=device)
    return step, (torch.ones((), dtype=sp.dtype, device=sp.device),)


def _require(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(n_devices, device):
    """One rank of :func:`dryrun_multichip`: the seven steps of the
    reference's dry run (``__graft_entry__.dryrun_multichip``)."""
    import torch.distributed as dist

    from .io.sharded import load_sharded, save_sharded
    from .models.boundary import make_open_space
    from .models.bratu import bratu_ifunction, bratu_residual
    from .models.poisson import l2_error
    from .parallel.dist import DistAlphaStepper, DistSpace
    from .parallel.launch import rank_device
    from .solve.schwarz import schwarz_local_preconditioner
    from .sparse import spmv

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0
    dt = torch.float32
    rank = dist.get_rank()

    # 1. linear path: distributed assembly + overlapped-halo CG
    sp = make_space(3, p=2, nel=8, dtype=dt, device=dev)
    ds = DistSpace(sp, device=dev)
    U, info = ds.solve_system(poisson_system, {"c": 0.0, "k": 1.0}, rtol=1e-5, maxiter=200)
    err = l2_error(sp, U)
    _require(math.isfinite(err) and err < 0.1, f"poisson L2 {err}")

    # 2. nonlinear path: residual + AD Jacobian + halo CG per Newton step
    sp2 = make_space(3, p=2, nel=8, dtype=dt, device=dev)
    ds2 = DistSpace(sp2, device=dev)
    _, binfo = ds2.newton(bratu_residual, torch.zeros((sp2.nnodes, 1), dtype=dt, device=dev),
                          {"lambda": 3.0}, rtol=1e-3, maxit=3)
    _require(math.isfinite(binfo["fnorm"]), f"bratu |F| {binfo['fnorm']}")

    # 3. GMRES + two-level Schwarz preconditioner
    sp3 = make_space(2, p=2, nel=6, dtype=dt, device=dev)
    ds3 = DistSpace(sp3, device=dev)
    A3, b3 = ds3.assemble_system(poisson_system, {"c": 0.0, "k": 1.0})
    pc = schwarz_local_preconditioner(subdomains=(1, 1))
    x3, it3, _ = ds3.gmres(A3, b3, rtol=1e-5, restart=10, pc=pc)
    err3 = l2_error(sp3, ds3.crop_flat(x3))
    _require(math.isfinite(err3) and err3 < 0.1, f"gmres+schwarz L2 {err3}")

    # 4. boundary-form assembly + solve (Nitsche weak Dirichlet)
    spb = make_open_space(2, p=2, nel=8, dtype=dt, device=dev)
    alpha = 5.0 * 3 * max(spb.elem_shape)

    def interior(pt, ctx):
        f = 2 * math.pi**2 * torch.prod(torch.sin(math.pi * pt.x))
        return pt.shape1 @ pt.shape1.T, f * pt.shape0

    def bnd(pt, ctx):
        dn = pt.shape1 @ pt.normal
        K = (-torch.outer(pt.shape0, dn) - torch.outer(dn, pt.shape0)
             + alpha * torch.outer(pt.shape0, pt.shape0))
        return K, torch.zeros_like(pt.shape0)

    dsb = DistSpace(spb, device=dev)
    Ab, bb = dsb.assemble_system(interior, boundary=bnd, apply_fix=False)
    xb, _, _ = dsb.cg(Ab, bb, rtol=1e-6)
    errb = l2_error(spb, dsb.crop_flat(xb))
    _require(math.isfinite(errb) and errb < 0.1, f"nitsche L2 {errb}")

    # 5. one distributed generalized-α step (transient surface)
    spt = make_space(2, p=2, nel=6, dtype=dt, device=dev)
    stepper = DistAlphaStepper(DistSpace(spt, device=dev), bratu_ifunction, rho_inf=0.5,
                               ctx={"lambda": 1.0}, newton_kw={"rtol": 1e-6, "maxit": 5})
    U0 = torch.zeros((spt.nnodes, 1), dtype=dt, device=dev)
    U1, _, _ = stepper.step(U0, torch.zeros_like(U0), 0.0, 1e-2)
    _require(bool(torch.isfinite(U1).all()), "alpha step not finite")

    # 6. sharded checkpoint round trip with repartitioning
    box = [tempfile.mkdtemp(prefix="petiga_tpu_torch_dryrun_") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    tmp = box[0]
    half = max(1, n_devices // 2)
    sub = dist.new_group(list(range(half)))  # every rank takes part in new_group
    try:
        Uflat = U.reshape(sp.nnodes, 1)
        save_sharded(ds, ds.pad_grid(Uflat), tmp, "U")
        flat = load_sharded(tmp, "U")
        _require(np.allclose(flat, Uflat.cpu().numpy(), atol=1e-6), "sharded serial reload")
        if rank < half:  # reload onto a DIFFERENT partition
            ds_alt = DistSpace(make_space(3, p=2, nel=8, dtype=dt, device=dev), device=dev,
                               group=sub)
            Ualt = load_sharded(tmp, "U", ds=ds_alt)
            _require(np.allclose(ds_alt.crop_flat(Ualt).cpu().numpy(), Uflat.cpu().numpy(),
                                 atol=1e-6), "sharded repartitioned reload")
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)

    # 7. the kernel CG on a p=1 space (the layout every rank's products use)
    spk = make_space(2, p=1, nel=6, dtype=dt, device=dev)
    dsk = DistSpace(spk, device=dev)
    Ak, bk = dsk.assemble_system(poisson_system, {"c": 0.0, "k": 1.0})
    xk, _, _ = dsk.cg(Ak, bk, rtol=1e-5, maxiter=60)
    errk = l2_error(spk, dsk.crop_flat(xk))
    _require(math.isfinite(errk) and errk < 0.1, f"kernel-cg L2 {errk}")

    summary = (
        f"dryrun_multichip({n_devices}): pgrid={ds.pgrid} "
        f"poisson L2={err:.3e} iters={info['iters']} | "
        f"bratu newton iters={binfo['iters']} |F|={binfo['fnorm']:.2e} | "
        f"gmres+schwarz iters={int(it3)} L2={err3:.3e} | "
        f"nitsche L2={errb:.3e} | alpha-step |U1|={float(U1.abs().max()):.3e} | "
        f"sharded-io ok (repartitioned) | kernel-cg L2={errk:.3e} | "
        f"halo_staging={ds.halo_staging}"
    )
    return {"summary": summary, "launches": dict(spmv.LAUNCHES),
            "halo_staging": ds.halo_staging, "device": str(dev)}


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """One pass over the distributed surface on ``n_devices`` ranks (see
    the module docstring); prints the reference's one-line summary
    (with the ranks' halo staging appended) and returns rank 0's
    ``{"summary", "launches", "halo_staging", "device"}``.

    ``device=None`` puts rank r on ``cuda:{r % device_count}`` and raises
    without CUDA; ``device="cpu"`` runs every rank on the CPU.
    ``backend=None`` is NCCL when every rank has a card of its own, gloo
    otherwise (ranks that share a card, or the CPU)."""
    from .parallel.launch import launch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "petiga_tpu_torch runs on a CUDA device unless told otherwise, and "
            "none is present; pass device='cpu' to run on the CPU"
        )
    if backend is None:
        own_cards = (device is None or torch.device(device).type == "cuda") and \
            n_devices <= torch.cuda.device_count()
        backend = "nccl" if own_cards else "gloo"
    out = launch(_dryrun_rank, n_devices, (n_devices, None if device is None else str(device)),
                 backend=backend, timeout=600.0)
    print(out[0]["summary"], flush=True)
    return out[0]
