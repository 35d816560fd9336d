"""Rank bodies of the distributed parity tests (``tests/test_torch_dist*.py``,
``tests/test_torch_io_sharded.py``).

The test files start their gloo ranks once, through
:func:`petiga_tpu_torch.parallel.launch.launch`, and run one of the
functions below in them; every rank runs every case (the collectives
need them all), rank 0 returns the cases' results as numpy arrays and
numbers, and the test process holds them to the JAX package.  This module
imports torch and the port only — never jax — so that each rank starts
in a few seconds.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space
from petiga_tpu_torch.models.poisson import make_space, poisson_system
from petiga_tpu_torch.parallel.dist import DistAlphaStepper, DistSpace, DistThetaStepper

# The ranks the test files launch inherit this: c10d's warnings would
# otherwise land in the middle of pytest's progress lines.  A rank's error
# still reaches the test, as the traceback the launcher raises.
os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")

F64 = torch.float64
CPU = "cpu"
POISSON = {"c": 0.0, "k": 1.0}
ELAST3 = {"lambda": 1.0, "mu": 1.0,
          "body_force": lambda x: torch.stack([0.0 * x[0], 0.0 * x[0], -1.0 + 0.0 * x[0]])}


def np_(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def periodic_space(nel, both=True, dof=1):
    axes = [Axis.uniform(p=2, nel=nel, periodic=True),
            Axis.uniform(p=2, nel=nel, periodic=both)]
    sp = Space(axes, dof=dof, dtype=F64, device=CPU)
    if not both:
        sp.set_boundary_value(1, 0, 0, 0.0)
        sp.set_boundary_value(1, 1, 0, 0.0)
    return sp


def adv_system(pt, ctx):
    beta = torch.tensor([1.0, 0.5], dtype=pt.shape1.dtype)
    K = pt.shape1 @ pt.shape1.T * ctx["eps"] + torch.outer(pt.shape0, pt.shape1 @ beta)
    return K, pt.shape0


def exact(x):
    return torch.stack([torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])], -1)


def forcing(x):
    return 2 * math.pi**2 * torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])


def nitsche_forms(sp):
    alpha = 5.0 * (max(sp.degrees) + 1) * max(sp.elem_shape)

    def interior(pt, ctx):
        return pt.shape1 @ pt.shape1.T, forcing(pt.x) * pt.shape0

    def bnd(pt, ctx):
        g = exact(pt.x)[0]
        dn = pt.shape1 @ pt.normal
        K = (-torch.outer(pt.shape0, dn) - torch.outer(dn, pt.shape0)
             + alpha * torch.outer(pt.shape0, pt.shape0))
        return K, -dn * g + alpha * pt.shape0 * g

    return interior, bnd


def nl_residual(pt, Ue, ctx):
    u = pt.value(Ue)[0]
    gu = pt.grad(Ue)[0]
    return pt.shape1 @ gu + pt.shape0 * (u * u - forcing(pt.x))


def nl_bnd_residual(pt, Ue, ctx):
    u = pt.value(Ue)[0]
    g = exact(pt.x)[0]
    dn = pt.shape1 @ pt.normal
    gun = pt.grad(Ue)[0] @ pt.normal
    return -pt.shape0 * gun - dn * (u - g) + 40.0 * pt.shape0 * (u - g)


def energy(pt, Ue, ctx):
    u = pt.value(Ue)[0]
    gu = pt.grad(Ue)[0]
    return torch.stack([0.5 * (gu @ gu), 0.25 * u**4])


def laplace_colloc(pt, ctx):
    f = pt.dim * math.pi**2 * torch.prod(torch.sin(math.pi * pt.x))
    lapN = torch.diagonal(pt.shape2, dim1=-2, dim2=-1).sum(-1)
    return -lapN[None, :], f.reshape(1)


def colloc_space(nel):
    sp = Space([Axis.uniform(p=2, nel=nel) for _ in range(2)], collocation=True, dtype=F64,
               device=CPU)
    for d in range(2):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)
    return sp


def rng_vec(seed, n, c=1, scale=1.0):
    return torch.as_tensor(np.random.default_rng(seed).normal(scale=scale, size=(n, c)))


def _host_tables(ds):
    e0, cnt, ebox, off0 = ds._box_setup()
    faces = {f"{d}{s}": tuple(np.asarray(a) for a in ds._partition_face_elements(d, s))
             for d in range(ds.space.dim) for s in range(2)}
    return {"pgrid": ds.pgrid, "L": ds.L, "Np": ds.Np, "elem_ids": ds.elem_ids,
            "elem_valid": ds.elem_valid, "emax": ds.emax, "faces": faces,
            "box": (e0, cnt, ebox, off0),
            "points": tuple(np.asarray(a) for a in ds._partition_points())}


def _padded(ds, blk):
    """A rank's block gathered into the padded global grid (numpy)."""
    lead = tuple(ds.L[::-1])
    return np_(ds.gather_grid(blk.reshape(lead + (-1,))))


# ----------------------------------------------------------------- dist cases


def dist_cases():
    """The cases of tests/test_torch_dist.py, run on every rank; rank 0
    returns ``{case: result}``."""
    out = {}

    # host setup (the element, face and point partitions)
    sp = make_space(2, p=2, nel=9, dtype=F64, device=CPU)
    out["host:(2,2)"] = _host_tables(DistSpace(sp, (2, 2), device=CPU))
    out["host:(4,1)"] = _host_tables(DistSpace(sp, (4, 1), device=CPU))
    out["host:periodic(2,2)"] = _host_tables(DistSpace(periodic_space(8), (2, 2), device=CPU))
    out["host:default"] = DistSpace(make_space(3, p=2, nel=8, dtype=F64, device=CPU),
                                    device=CPU).pgrid

    # one small case in full against the JAX DistSpace: 2-D nel 6, (2, 2)
    ds = DistSpace(make_space(2, p=2, nel=6, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(poisson_system, POISSON)
    x, k, res = ds.cg(A, b, rtol=1e-12)
    out["full:nel6"] = {"A": _padded(ds, A), "b": _padded(ds, b), "x": _padded(ds, x), "k": k}

    # assembly and the matvec (overlap and not), open and periodic
    ctx = {"c": 0.3, "k": 1.0}
    for name, spc, pg in (("open(2,2)", make_space(2, p=2, nel=9, dtype=F64, device=CPU), (2, 2)),
                          ("periodic(4,1)", periodic_space(8), (4, 1)),
                          ("periodic(2,2)", periodic_space(8), (2, 2)),
                          ("mixed(1,4)", periodic_space(8, both=False), (1, 4))):
        ds = DistSpace(spc, pg, device=CPU)
        A, b = ds.assemble_system(poisson_system, ctx)
        xv = rng_vec(5, spc.nnodes)
        ys = [np_(ds.crop_flat(ds.matvec_local(A, ds.pad_grid(xv), overlap=ov)))
              for ov in (True, False)]
        K = ds.st.K
        out[f"matvec:{name}"] = {
            "A": np_(ds.crop_flat(A.reshape(tuple(ds.L[::-1]) + (K,)))),
            "b": np_(ds.crop_flat(b)), "y_overlap": ys[0], "y_plain": ys[1],
            "framed": ds.local_planes(A).frames is not None}

    # Krylov: CG, BiCGStab, GMRES (two process grids)
    ds = DistSpace(make_space(2, p=2, nel=9, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(poisson_system, POISSON)
    x, k, _ = ds.cg(A, b, rtol=1e-12)
    out["cg"] = {"x": np_(ds.crop_flat(x)), "k": k}
    for pg in ((2, 2), (4, 1)):
        ds = DistSpace(make_space(2, p=2, nel=8, dtype=F64, device=CPU), pg, device=CPU)
        A, b = ds.assemble_system(adv_system, {"eps": 0.1})
        if pg == (2, 2):
            x, k, _ = ds.bicgstab(A, b, rtol=1e-12)
            out["bicgstab"] = {"x": np_(ds.crop_flat(x)), "k": k}
        x, k, _ = ds.gmres(A, b, rtol=1e-12, restart=20)
        out[f"gmres:{pg}"] = {"x": np_(ds.crop_flat(x)), "k": k}

    # point-block Jacobi at dof 3: 3-D elasticity
    from petiga_tpu_torch.models.elasticity import elasticity_system
    from petiga_tpu_torch.models.elasticity import make_space as make_el

    ds = DistSpace(make_el(3, p=2, nel=3, dtype=F64, device=CPU), (1, 2, 2), device=CPU)
    A, b = ds.assemble_system(elasticity_system, ELAST3)
    x_pb, k_pb, _ = ds.cg(A, b, rtol=1e-12, pc="pbjacobi")
    _, k_j, _ = ds.cg(A, b, rtol=1e-12, pc="jacobi")
    out["pbjacobi"] = {"x": np_(ds.crop_flat(x_pb)), "k": k_pb, "k_jacobi": k_j}

    # Nitsche boundary forms (system), two process grids
    from petiga_tpu_torch.models.boundary import make_open_space

    for pg in ((2, 2), (4, 1)):
        ds = DistSpace(make_open_space(2, p=2, nel=9, dtype=F64, device=CPU), pg, device=CPU)
        interior, bnd = nitsche_forms(ds.space)
        A, b = ds.assemble_system(interior, boundary=bnd, apply_fix=False)
        x, k, _ = ds.cg(A, b, rtol=1e-12)
        K = ds.st.K
        out[f"nitsche:{pg}"] = {"A": np_(ds.crop_flat(A.reshape(tuple(ds.L[::-1]) + (K,)))),
                                "b": np_(ds.crop_flat(b)), "x": np_(ds.crop_flat(x)), "k": k}

    # nonlinear residual + boundary form: F and J
    ds = DistSpace(make_open_space(2, p=2, nel=7, dtype=F64, device=CPU), (2, 2), device=CPU)
    U = rng_vec(3, ds.space.nnodes, scale=0.1)
    F = ds.assemble_function(nl_residual, U, boundary=nl_bnd_residual)
    J = ds.assemble_jacobian(nl_residual, U, boundary=nl_bnd_residual)
    K = ds.st.K
    out["boundary"] = {"F": np_(ds.crop_flat(F)),
                       "J": np_(ds.crop_flat(J.reshape(tuple(ds.L[::-1]) + (K,))))}

    # Bratu: the residual and Newton
    from petiga_tpu_torch.models.bratu import bratu_ifunction, bratu_residual
    from petiga_tpu_torch.models.bratu import make_space as make_bratu

    ds = DistSpace(make_bratu(2, p=2, nel=9, dtype=F64, device=CPU), (4, 1), device=CPU)
    U = rng_vec(7, ds.space.nnodes, scale=0.1)
    out["function"] = np_(ds.crop_flat(ds.assemble_function(bratu_residual, U,
                                                             {"lambda": 2.0})))
    ds = DistSpace(make_bratu(2, p=2, nel=8, dtype=F64, device=CPU), (2, 2), device=CPU)
    Un, info = ds.newton(bratu_residual, torch.zeros((ds.space.nnodes, 1), dtype=F64),
                         {"lambda": 5.0}, rtol=1e-10)
    out["bratu_newton"] = {"U": np_(Un), "iters": info["iters"]}

    # the θ and α steps
    ds = DistSpace(make_bratu(2, p=2, nel=6, dtype=F64, device=CPU), (2, 2), device=CPU)
    st = DistThetaStepper(ds, bratu_ifunction, theta=0.5, ctx={"lambda": 1.0},
                          newton_kw={"rtol": 1e-12, "linear_rtol": 1e-12})
    U1, _ = st.step(torch.zeros((ds.space.nnodes, 1), dtype=F64), 0.0, 5e-3)
    out["theta"] = np_(U1)
    ds = DistSpace(make_bratu(2, p=2, nel=7, dtype=F64, device=CPU), (2, 2), device=CPU)
    sa = DistAlphaStepper(ds, bratu_ifunction, rho_inf=0.5, ctx={"lambda": 1.0},
                          newton_kw={"rtol": 1e-12, "linear_rtol": 1e-12})
    U0 = torch.zeros((ds.space.nnodes, 1), dtype=F64)
    U1, V1, _ = sa.step(U0, torch.zeros_like(U0), 0.0, 1e-2)
    U2, V2, _ = sa.step(U1, V1, 1e-2, 1e-2)
    out["alpha"] = {"U": np_(U2), "V": np_(V2)}

    # functionals
    ds = DistSpace(make_space(2, p=2, nel=9, dtype=F64, device=CPU), (2, 2), device=CPU)
    U = rng_vec(11, ds.space.nnodes)
    out["scalar"] = {"energy": np_(ds.compute_scalar(energy, U)),
                     "l2": float(ds.compute_error_norm(U, exact, k=0))}

    # collocation
    ds = DistSpace(colloc_space(8), (2, 2), device=CPU)
    A, F = ds.assemble_collocation(laplace_colloc)
    U, info = ds.solve_collocation(laplace_colloc, rtol=1e-12, solver="bicgstab", maxiter=3000)
    K = ds.st.K
    out["collocation"] = {"A": np_(ds.crop_flat(A.reshape(tuple(ds.L[::-1]) + (K,)))),
                          "F": np_(ds.crop_flat(F)), "U": np_(U), "iters": info["iters"]}
    return out if dist.get_rank() == 0 else None


def hang():
    """A rank body that never returns (the launcher's timeout test)."""
    import time

    while True:
        time.sleep(1.0)


def fail():
    """A rank body that raises on rank 1 (the launcher's failure report)."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")


# ------------------------------------------------------------- precond cases


def precond_cases():
    """The cases of tests/test_torch_dist_precond.py; rank 0 returns
    ``{case: result}``."""
    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models.elasticity import elasticity_system, rigid_body_modes
    from petiga_tpu_torch.models.elasticity import make_space as make_el
    from petiga_tpu_torch.solve.fieldsplit import fieldsplit_local_preconditioner
    from petiga_tpu_torch.solve.multigrid import mg_local_preconditioner
    from petiga_tpu_torch.solve.schwarz import schwarz_local_preconditioner

    out = {}

    def run(name, ds, A, b, solver, pc, **kw):
        x, k, _ = getattr(ds, solver)(A, b, pc=pc, **kw)
        out[name] = {"x": np_(ds.crop_flat(x)), "k": k}

    # Schwarz: one box per rank + constants coarse; periodic; RAS; rigid-body coarse
    ds = DistSpace(make_space(2, p=2, nel=16, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(poisson_system, POISSON)
    run("schwarz", ds, A, b, "cg", schwarz_local_preconditioner(subdomains=(1, 1)),
        rtol=1e-12)
    ds = DistSpace(periodic_space(12), (2, 2), device=CPU)
    A, b = ds.assemble_system(poisson_system, {"c": 1.0, "k": 1.0})
    run("schwarz_periodic", ds, A, b, "cg", schwarz_local_preconditioner(subdomains=(2, 2)),
        rtol=1e-12)
    ds = DistSpace(make_space(2, p=2, nel=10, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(adv_system, {"eps": 0.2})
    run("schwarz_ras", ds, A, b, "bicgstab",
        schwarz_local_preconditioner(subdomains=(2, 2), restricted=True, coarse=False),
        rtol=1e-12)
    ectx = {"lambda": 2.0, "mu": 1.0, "body_force": lambda x: torch.sin(math.pi * x)}
    ds = DistSpace(make_el(2, p=2, nel=14, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(elasticity_system, ectx)
    run("schwarz_rbm", ds, A, b, "cg",
        schwarz_local_preconditioner(subdomains=(2, 2),
                                     coarse_modes=rigid_body_modes(ds.space)), rtol=1e-12)

    # multigrid: two levels, open and periodic
    for name, spc, ctx in (("mg", make_space(2, p=2, nel=16, dtype=F64, device=CPU), POISSON),
                           ("mg_periodic", periodic_space(12), {"c": 1.0, "k": 1.0})):
        ds = DistSpace(spc, (2, 2), device=CPU)
        A, b = ds.assemble_system(poisson_system, ctx)

        def asm(s, ctx=ctx):
            return assemble_system(s, poisson_system, ctx)[0]

        run(name, ds, A, b, "cg", mg_local_preconditioner(asm, levels=2), rtol=1e-12)

    # field split on 2-D elasticity
    ectx = {"lambda": 1.0, "mu": 1.0,
            "body_force": lambda x: torch.stack([0.5 + 0.0 * x[0], -1.0 + 0.0 * x[0]])}
    ds = DistSpace(make_el(2, p=2, nel=6, dtype=F64, device=CPU), (2, 2), device=CPU)
    A, b = ds.assemble_system(elasticity_system, ectx)
    run("fieldsplit_additive", ds, A, b, "cg",
        fieldsplit_local_preconditioner(kind="additive", inner="jacobi"), rtol=1e-12)
    run("fieldsplit_inner_cg", ds, A, b, "gmres",
        fieldsplit_local_preconditioner(inner="cg", inner_iters=5), rtol=1e-13, restart=20,
        maxiter=1000)
    run("fieldsplit_multiplicative", ds, A, b, "bicgstab",
        fieldsplit_local_preconditioner(kind="multiplicative", inner="jacobi"), rtol=1e-12)
    # unequal groups at dof 3: the coupling blocks are rectangular
    ds = DistSpace(make_el(3, p=2, nel=3, dtype=F64, device=CPU), (1, 2, 2), device=CPU)
    A, b = ds.assemble_system(elasticity_system, ELAST3)
    run("fieldsplit_groups", ds, A, b, "bicgstab",
        fieldsplit_local_preconditioner(groups=[(0, 1), (2,)], kind="multiplicative"),
        rtol=1e-12)
    return out if dist.get_rank() == 0 else None


# ------------------------------------------------------------------ io cases


def io_cases(tmpdir, jax_dir):
    """tests/test_torch_io_sharded.py: write under pgrid (2, 2), reload
    serially and onto (4, 1) and onto a 2-rank subgroup; read the
    checkpoint the JAX package wrote (``jax_dir``, pgrid (2, 2)) onto
    (1, 4)."""
    from petiga_tpu_torch.io.sharded import load_sharded, save_sharded

    rank = dist.get_rank()
    sp2 = Space([Axis.uniform(p=2, nel=7) for _ in range(2)], dof=2, dtype=F64, device=CPU)
    U = torch.as_tensor(np.random.default_rng(2).normal(size=(sp2.nnodes, 2)))
    ds = DistSpace(sp2, (2, 2), device=CPU)
    save_sharded(ds, ds.pad_grid(U), tmpdir, "U")
    out = {"serial": load_sharded(tmpdir, "U")}
    ds41 = DistSpace(sp2, (4, 1), device=CPU)
    out["repartitioned"] = np_(ds41.crop_flat(load_sharded(tmpdir, "U", ds=ds41)))
    sub = dist.new_group([0, 1])
    if rank < 2:
        ds2 = DistSpace(sp2, (1, 2), device=CPU, group=sub)
        out["subgroup"] = np_(ds2.crop_flat(load_sharded(tmpdir, "U", ds=ds2)))
    ds14 = DistSpace(sp2, (1, 4), device=CPU)
    out["from_jax"] = np_(ds14.crop_flat(load_sharded(jax_dir, "U", ds=ds14)))
    try:
        load_sharded(tmpdir, "U", ds=DistSpace(
            Space([Axis.uniform(p=2, nel=6) for _ in range(2)], dof=2, dtype=F64, device=CPU),
            (2, 2), device=CPU))
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    dist.barrier()
    return out if rank == 0 else None
