"""The port's distributed preconditioners — ``schwarz_local_preconditioner``,
``mg_local_preconditioner`` and ``fieldsplit_local_preconditioner`` — on
four gloo ranks, each against its serial JAX counterpart with matching
subdomains or levels, f64 on the CPU.

The ranks start once for the file (``tests/_torch_dist_cases.py``
``precond_cases``) and run in the background while each test builds its
JAX side.  The serial counterparts:

* Schwarz: ``schwarz_preconditioner`` over the union of the ranks' boxes
  (pgrid (2, 2) × ``subdomains`` per rank = the serial box grid, the
  meshes chosen so the box boundaries coincide): constants coarse, a
  periodic mesh, RAS with BiCGStab, the rigid-body coarse space;
* multigrid: the same two-level method written with the JAX package's
  pieces — weighted Jacobi on the fine operator, the knot-insertion
  restriction (``prolongation_1d``), a Jacobi-CG coarse solve to rtol
  1e-8, prolongation, Jacobi again — open and periodic;
* field split: ``fieldsplit_preconditioner`` with Jacobi inner solves
  (additive with CG, multiplicative with BiCGStab) and with a fixed
  5-step Jacobi-CG inner solve (with GMRES); unequal field groups at
  dof 3 against the port's serial field split.

Tolerances: solutions 1e-10 relative, Krylov iteration counts within
one (GMRES: restart cycles within one).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax.numpy as jnp
import pytest

import _torch_dist_cases as cases
from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import elasticity as jel
from petiga_tpu.models import poisson as jpois
from petiga_tpu.solve import fieldsplit as jfs
from petiga_tpu.solve import krylov as jkry
from petiga_tpu.solve import multigrid as jmg
from petiga_tpu.solve import schwarz as jsch
from petiga_tpu_torch.parallel.launch import launch

F64 = jnp.float64
POISSON = {"c": 0.0, "k": 1.0}


@pytest.fixture(scope="module")
def ranks():
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch, cases.precond_cases, 4, backend="gloo", init_timeout=60.0,
                      timeout=240.0)
    yield fut
    pool.shutdown(wait=True)


def _check(ranks, case, x_ref, k_ref, per=1):
    t = ranks.result()[0][case]
    x_ref = np.asarray(x_ref).reshape(t["x"].shape)
    rel = float(np.max(np.abs(t["x"] - x_ref)) / np.max(np.abs(x_ref)))
    assert rel <= 1e-10, rel
    assert abs(int(t["k"]) // per - int(k_ref) // per) <= 1, (t["k"], int(k_ref))


def _periodic(nel):
    return JSpace([JAxis.uniform(p=2, nel=nel, periodic=True) for _ in range(2)], dtype=F64)


def _adv(pt, ctx):
    beta = jnp.asarray([1.0, 0.5])
    return pt.shape1 @ pt.shape1.T * 0.2 + jnp.outer(pt.shape0, pt.shape1 @ beta), pt.shape0


# ------------------------------------------------------------------ Schwarz


def test_schwarz_constants_coarse(ranks):
    sp = jpois.make_space(2, p=2, nel=16, dtype=F64)
    A, b = jasm.assemble_system(sp, jpois.poisson_system, POISSON)
    ref = jkry.cg(A, b, M=jsch.schwarz_preconditioner(A, subdomains=(2, 2)), rtol=1e-12)
    _check(ranks, "schwarz", ref.x, ref.iters)


def test_schwarz_periodic(ranks):
    sp = _periodic(12)
    A, b = jasm.assemble_system(sp, jpois.poisson_system, {"c": 1.0, "k": 1.0})
    ref = jkry.cg(A, b, M=jsch.schwarz_preconditioner(A, subdomains=(4, 4)), rtol=1e-12)
    _check(ranks, "schwarz_periodic", ref.x, ref.iters)


def test_schwarz_ras_bicgstab(ranks):
    sp = jpois.make_space(2, p=2, nel=10, dtype=F64)
    A, b = jasm.assemble_system(sp, _adv)
    M = jsch.schwarz_preconditioner(A, subdomains=(4, 4), restricted=True, coarse=False)
    ref = jkry.bicgstab(A, b, M=M, rtol=1e-12)
    _check(ranks, "schwarz_ras", ref.x, ref.iters)


def test_schwarz_rigid_body_coarse(ranks):
    sp = jel.make_space(2, p=2, nel=14, dtype=F64)
    ctx = {"lambda": 2.0, "mu": 1.0, "body_force": lambda x: jnp.sin(jnp.pi * x)}
    A, b = jasm.assemble_system(sp, jel.elasticity_system, ctx)
    M = jsch.schwarz_preconditioner(A, subdomains=(4, 4), coarse_modes=jel.rigid_body_modes(sp))
    ref = jkry.cg(A, b, M=M, rtol=1e-12)
    _check(ranks, "schwarz_rbm", ref.x, ref.iters)


# ---------------------------------------------------------------- multigrid


def _two_level(sp_f, sp_c, ctx, nsmooth=2, omega=0.6):
    """The distributed two-level method, serial, from the JAX package's
    pieces."""
    A, b = jasm.assemble_system(sp_f, jpois.poisson_system, ctx)
    Ac, _ = jasm.assemble_system(sp_c, jpois.poisson_system, ctx)
    d = A.scalar_diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)
    Ps = [jnp.asarray(jmg.prolongation_1d(sp_c.axes[k], sp_f.axes[k])) for k in range(2)]
    Mc = jkry.jacobi_preconditioner(Ac)

    def transfer(mats, x, shape):
        g = x.reshape(tuple(shape[::-1]))
        for k in range(2):
            g = jnp.moveaxis(jnp.tensordot(mats[k], g, axes=([1], [1 - k])), 0, 1 - k)
        return g.reshape(-1, 1)

    def smooth(x, r):
        for _ in range(nsmooth):
            x = x + omega * dinv * (r - A.matvec(x))
        return x

    def M(r):
        x = smooth(jnp.zeros_like(r), r)
        rc = transfer([P.T for P in Ps], r - A.matvec(x), sp_f.node_shape)
        xc = jkry.cg(Ac, rc, M=Mc, rtol=1e-8, maxiter=200).x
        return smooth(x + transfer(Ps, xc, sp_c.node_shape), r)

    return jkry.cg(A, b, M=M, rtol=1e-12)


def test_mg_two_levels(ranks):
    ref = _two_level(jpois.make_space(2, p=2, nel=16, dtype=F64),
                     jpois.make_space(2, p=2, nel=8, dtype=F64), POISSON)
    _check(ranks, "mg", ref.x, ref.iters)


def test_mg_periodic(ranks):
    ref = _two_level(_periodic(12), _periodic(6), {"c": 1.0, "k": 1.0})
    _check(ranks, "mg_periodic", ref.x, ref.iters)


# --------------------------------------------------------------- field split


def _elastic():
    sp = jel.make_space(2, p=2, nel=6, dtype=F64)
    ctx = {"lambda": 1.0, "mu": 1.0, "body_force": lambda x: jnp.asarray([0.5, -1.0])}
    return jasm.assemble_system(sp, jel.elasticity_system, ctx)


def _inner_cg(sub, iters=5):
    """The distributed inner solve: a fixed ``iters``-step Jacobi-PCG."""
    d = sub.scalar_diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)

    def M(r):
        x = jnp.zeros_like(r)
        z = r * dinv
        p, rz, rr = z, jnp.sum(r * z), r
        for _ in range(iters):
            Ap = sub.matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = rr * dinv
            rznew = jnp.sum(rr * z)
            p = z + jnp.where(rz > 0, rznew / jnp.where(rz == 0, 1.0, rz), 0.0) * p
            rz = rznew
        return x

    return M


def test_fieldsplit_additive_cg(ranks):
    A, b = _elastic()
    ref = jkry.cg(A, b, M=jfs.fieldsplit_preconditioner(A, kind="additive"), rtol=1e-12)
    _check(ranks, "fieldsplit_additive", ref.x, ref.iters)


def test_fieldsplit_inner_cg_gmres(ranks):
    A, b = _elastic()
    M = jfs.fieldsplit_preconditioner(A, inner=_inner_cg)
    ref = jkry.gmres(A, b, M=M, rtol=1e-13, restart=20)
    _check(ranks, "fieldsplit_inner_cg", ref.x, ref.iters, per=20)


def test_fieldsplit_multiplicative_bicgstab(ranks):
    A, b = _elastic()
    M = jfs.fieldsplit_preconditioner(A, kind="multiplicative")
    ref = jkry.bicgstab(A, b, M=M, rtol=1e-12)
    _check(ranks, "fieldsplit_multiplicative", ref.x, ref.iters)


def test_fieldsplit_unequal_groups(ranks):
    """Groups (0, 1) and (2,) at dof 3 (rectangular coupling blocks,
    zero-padded to square ones for the kernel): held to the port's serial
    field split (itself held to the JAX package's in
    tests/test_torch_precond.py), which costs no JAX compile here."""
    import torch

    from petiga_tpu_torch.assembly.assemble import assemble_system
    from petiga_tpu_torch.models.elasticity import elasticity_system
    from petiga_tpu_torch.models.elasticity import make_space as make_el
    from petiga_tpu_torch.solve import fieldsplit as tfs
    from petiga_tpu_torch.solve import krylov as tkry

    A, b = assemble_system(make_el(3, p=2, nel=3, dtype=torch.float64, device="cpu"),
                           elasticity_system, cases.ELAST3)
    M = tfs.fieldsplit_preconditioner(A, groups=[(0, 1), (2,)], kind="multiplicative")
    ref = tkry.bicgstab(A, b, M=M, rtol=1e-12)
    _check(ranks, "fieldsplit_groups", ref.x.numpy(), ref.iters)
