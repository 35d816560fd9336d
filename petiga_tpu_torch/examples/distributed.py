"""Distributed Poisson over ranks of one ``torch.distributed`` job — the
``mpiexec -n N ./Poisson -iga_...`` workflow (PetIGA demo/Poisson.c under
MPI; petigapart.c picks the process grid) driven through ``DistSpace``;
port of the JAX package's examples/distributed.py.

    python -m petiga_tpu_torch.examples.distributed --dim 2 -p 2 -N 16 \\
        --solver gmres --pc schwarz --checkpoint /tmp/ckpt

Solver: cg | bicgstab | gmres.  PC: jacobi | pbjacobi | schwarz | mg |
fieldsplit — the distributed analogs of -ksp_type/-pc_type.  With
``--checkpoint`` the solution is written as a per-rank sharded checkpoint
(``io/sharded.py``) and read back.

The port spawns ``--nranks`` ranks (default 4) through
``parallel/launch.py`` on ``--backend`` (default gloo: ranks that share one
card need it; NCCL takes one card per rank).  Rank r runs on
``cuda:{r % device_count}``, or on the CPU with ``--device cpu``.  Rank 0's
results are printed by this process.
"""

import io
import sys

from petiga_tpu_torch.config import bind_cli, print_info
from petiga_tpu_torch.examples import DEVICE_FLAG


def _cli(argv):
    return bind_cli(
        argv,
        extra=[
            ("solver", str, "cg", "cg | bicgstab | gmres"),
            ("pc", str, "jacobi",
             "jacobi | pbjacobi | schwarz | mg | fieldsplit"),
            ("checkpoint", str, "", "directory for a sharded checkpoint"),
            ("check-error", float, 0.0, "fail if L2 error exceeds this"),
            ("nranks", int, 4, "ranks of the job"),
            ("backend", str, "gloo", "gloo | nccl"),
            DEVICE_FLAG,
        ],
    )


def _rank(argv):
    """One rank: build, assemble and solve its block.  Returns the rank's
    kernel launches; rank 0 adds the lines to print and the L2 error."""
    import numpy as np

    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models.poisson import l2_error, poisson_system
    from petiga_tpu_torch.parallel.dist import DistSpace
    from petiga_tpu_torch.parallel.launch import rank_device
    from petiga_tpu_torch.sparse import spmv

    opts, ns = _cli(argv)
    device = rank_device(ns.device)
    space = opts.build_space(device=device)
    for d in range(space.dim):
        for s in range(2):
            space.set_boundary_value(d, s, 0, 0.0)
    out = io.StringIO()
    print_info(space, file=out)

    ds = DistSpace(space, device=device)
    print(f"device mesh: {ds.pgrid} over {ds.world} ranks ({ds.backend}, "
          f"{device.type})", file=out)

    pc = ns.pc
    if pc == "schwarz":
        from petiga_tpu_torch.solve.schwarz import schwarz_local_preconditioner

        pc = schwarz_local_preconditioner(subdomains=(1,) * space.dim)
    elif pc == "mg":
        from petiga_tpu_torch.solve.multigrid import mg_local_preconditioner

        def asm(s):
            A, _ = assemble_system(s, poisson_system, {"c": 0.0, "k": 1.0})
            return A

        pc = mg_local_preconditioner(asm, levels=2)
    elif pc == "fieldsplit":
        from petiga_tpu_torch.solve.fieldsplit import fieldsplit_local_preconditioner

        pc = fieldsplit_local_preconditioner()

    U, info = ds.solve_system(
        poisson_system, {"c": 0.0, "k": 1.0},
        rtol=1e-10, solver=ns.solver, pc=pc,
    )
    err = float(l2_error(space, U)) if ds.rank == 0 else None
    if ds.rank == 0:
        print(f"{ns.solver}({ns.pc}): iters={info['iters']} "
              f"residual={info['residual']:.3e} L2={err:.4e}", file=out)

    if ns.checkpoint:
        from petiga_tpu_torch.io.sharded import load_sharded, save_sharded

        save_sharded(ds, U, ns.checkpoint, "U")  # ends at a barrier
        if ds.rank == 0:
            back = load_sharded(ns.checkpoint, "U")
            if not np.array_equal(back, U.cpu().numpy()):
                raise RuntimeError(f"sharded checkpoint round trip differs: {ns.checkpoint}")
            print(f"sharded checkpoint round trip ok: {ns.checkpoint}", file=out)
    res = {"launches": dict(spmv.LAUNCHES)}
    if ds.rank == 0:
        res.update(text=out.getvalue(), err=err)
    return res


# the ranks' results of this process's last main(), by rank: each rank's
# kernel launches ("launches"); rank 0's adds its printed text and L2 error
RANKS = []


def main(argv=None):
    """Run the job; its ranks' results stay in :data:`RANKS`."""
    global RANKS
    from petiga_tpu_torch.parallel.launch import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    _, ns = _cli(argv)  # parse errors stop here, before any rank starts
    RANKS = ranks = launch(_rank, ns.nranks, (argv,), backend=ns.backend)
    text, err = ranks[0]["text"], ranks[0]["err"]
    print(text, end="")
    if ns.check_error and err > ns.check_error:
        raise SystemExit(f"L2 error {err} exceeds {ns.check_error}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
