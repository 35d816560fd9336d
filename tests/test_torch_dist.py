"""The port's distributed layer (``petiga_tpu_torch.parallel``) against the
JAX package, f64 on the CPU, on four gloo ranks.

The ranks start once for the whole file (``tests/_torch_dist_cases.py``:
every case runs in them, rank 0 hands back numpy results) and each case
is one test here:

* host setup — pgrid, ``L``, ``Np`` and the element, face, box and point
  partitions — against the JAX ``DistSpace`` itself;
* one small case in full against the JAX ``DistSpace``: 2-D nel 6, pgrid
  (2, 2), the padded ``A_data``/``b`` blocks and the CG solution;
* everything else against the JAX serial functions (the JAX package's
  own tests show its distributed path equals its serial path): assembly
  and the matvec, with and without overlap, open, periodic (one, two and
  four blocks on an axis) and mixed; CG, BiCGStab, GMRES; point-block
  Jacobi at dof 3; Nitsche boundary forms; Bratu's residual and Newton; the θ and α steps; functionals;
  collocation;
* a nonlinear boundary residual and its Jacobian against the port's
  serial assembly;
* the dry run, a single rank without a process group, the device rule
  and the launcher's job timeout and failure report.

Tolerances: 1e-12 of the largest entry for assembled data and products
(the same sums in another order), 1e-10 relative for solutions, Krylov
and Newton iteration counts within one.  Every launch has a 60 s
rendezvous/collective timeout and a job timeout that kills the ranks.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_dist_cases as cases
from petiga_tpu.assembly import assemble as jasm
from petiga_tpu.assembly import collocation as jcol
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.models import boundary as jbnd
from petiga_tpu.models import bratu as jbratu
from petiga_tpu.models import elasticity as jel
from petiga_tpu.models import poisson as jpois
from petiga_tpu.parallel.dist import DistSpace as JDistSpace
from petiga_tpu.solve import krylov as jkry
from petiga_tpu.solve import ts as jts
from petiga_tpu_torch.parallel.launch import launch

F64 = jnp.float64
POISSON = {"c": 0.0, "k": 1.0}


@pytest.fixture(scope="module")
def ranks():
    """Every case of the file, run once on four gloo ranks in the
    background while the tests compute their JAX side; ``get(ranks)``
    waits for rank 0's results."""
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch, cases.dist_cases, 4, backend="gloo", init_timeout=60.0,
                      timeout=240.0)
    yield fut
    pool.shutdown(wait=True)


def get(ranks):
    return ranks.result()[0]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _same_iters(k, k_ref):
    assert abs(int(k) - int(k_ref)) <= 1, (k, k_ref)


# ---------------------------------------------------------- JAX-side forms


def j_periodic(nel, both=True):
    sp = JSpace([JAxis.uniform(p=2, nel=nel, periodic=True),
                 JAxis.uniform(p=2, nel=nel, periodic=both)], dtype=F64)
    if not both:
        sp.set_boundary_value(1, 0, 0, 0.0)
        sp.set_boundary_value(1, 1, 0, 0.0)
    return sp


def j_adv(pt, ctx):
    beta = jnp.asarray([1.0, 0.5])
    K = pt.shape1 @ pt.shape1.T * ctx["eps"] + jnp.outer(pt.shape0, pt.shape1 @ beta)
    return K, pt.shape0


def j_exact(x):
    return jnp.asarray([jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])])


def j_forcing(x):
    return 2 * jnp.pi**2 * jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])


def j_nitsche(sp):
    alpha = 5.0 * (max(sp.degrees) + 1) * max(sp.elem_shape)

    def interior(pt, ctx):
        return pt.shape1 @ pt.shape1.T, j_forcing(pt.x) * pt.shape0

    def bnd(pt, ctx):
        g = j_exact(pt.x)[0]
        dn = pt.shape1 @ pt.normal
        K = (-jnp.outer(pt.shape0, dn) - jnp.outer(dn, pt.shape0)
             + alpha * jnp.outer(pt.shape0, pt.shape0))
        return K, -dn * g + alpha * pt.shape0 * g

    return interior, bnd


def _rng(seed, n, scale=1.0):
    return np.random.default_rng(seed).normal(scale=scale, size=(n, 1))


def _serial_cg(A, b, rtol=1e-12, M=None):
    return jkry.cg(A, b, M=jkry.jacobi_preconditioner(A) if M is None else M, rtol=rtol)


# ----------------------------------------- against the JAX DistSpace


def test_small_case_matches_jax_distspace(ranks):
    """2-D nel 6 over (2, 2): the padded global blocks and the CG
    solution of the JAX DistSpace."""
    sp = jpois.make_space(2, p=2, nel=6, dtype=F64)
    jds = JDistSpace(sp, devices=jax.devices()[:4], pgrid=(2, 2))
    data, b = jds.assemble_system(jpois.poisson_system, POISSON)
    x, k, _ = jds.cg(data, b, rtol=1e-12)
    res = get(ranks)
    t = res["full:nel6"]
    A = np.asarray(data).reshape(t["A"].shape)
    assert _rel(t["A"], A) <= 1e-12
    assert _rel(t["b"], np.asarray(b)) <= 1e-12
    assert _rel(t["x"], np.asarray(x)) <= 1e-10
    _same_iters(t["k"], k)


# ------------------------------------------------------------- host setup


@pytest.mark.parametrize("case,space,pgrid", [
    ("host:(2,2)", "open", (2, 2)),
    ("host:(4,1)", "open", (4, 1)),
    ("host:periodic(2,2)", "periodic", (2, 2)),
])
def test_host_setup_matches_jax_distspace(ranks, case, space, pgrid):
    sp = jpois.make_space(2, p=2, nel=9, dtype=F64) if space == "open" else j_periodic(8)
    jds = JDistSpace(sp, devices=jax.devices()[:4], pgrid=pgrid)
    res = get(ranks)
    t = res[case]
    assert tuple(t["pgrid"]) == tuple(jds.pgrid)
    assert tuple(t["L"]) == tuple(jds.L) and tuple(t["Np"]) == tuple(jds.Np)
    assert t["emax"] == jds.emax
    np.testing.assert_array_equal(t["elem_ids"], jds.elem_ids)
    np.testing.assert_array_equal(t["elem_valid"], jds.elem_valid)
    for d in range(2):
        for s in range(2):
            ids, valid = jds._partition_face_elements(d, s)
            np.testing.assert_array_equal(t["faces"][f"{d}{s}"][0], np.asarray(ids))
            np.testing.assert_array_equal(t["faces"][f"{d}{s}"][1], np.asarray(valid))
    e0, cnt, ebox, off0 = jds._box_setup()
    np.testing.assert_array_equal(t["box"][0], np.asarray(e0))
    np.testing.assert_array_equal(t["box"][1], np.asarray(cnt))
    assert tuple(t["box"][2]) == tuple(ebox) and tuple(t["box"][3]) == tuple(off0)
    ids, valid = jds._partition_points()
    np.testing.assert_array_equal(t["points"][0], np.asarray(ids))
    np.testing.assert_array_equal(t["points"][1], np.asarray(valid))


def test_default_pgrid(ranks):
    from petiga_tpu.parallel.partition import factor_grid

    res = get(ranks)
    assert tuple(res["host:default"]) == factor_grid(4, (10, 10, 10))


# --------------------------------------------------- assembly and matvec


@pytest.mark.parametrize("name,pgrid", [("open(2,2)", (2, 2)), ("periodic(4,1)", (4, 1)),
                                        ("periodic(2,2)", (2, 2)), ("mixed(1,4)", (1, 4))])
def test_assembly_and_matvec_match_serial(ranks, name, pgrid):
    sp = {"open(2,2)": lambda: jpois.make_space(2, p=2, nel=9, dtype=F64),
          "periodic(4,1)": lambda: j_periodic(8),
          "periodic(2,2)": lambda: j_periodic(8),
          "mixed(1,4)": lambda: j_periodic(8, both=False)}[name]()
    A, b = jasm.assemble_system(sp, jpois.poisson_system, {"c": 0.3, "k": 1.0})
    res = get(ranks)
    t = res[f"matvec:{name}"]
    assert _rel(t["A"], np.asarray(A.data).reshape(t["A"].shape)) <= 1e-12
    assert _rel(t["b"], np.asarray(b)) <= 1e-12
    y = np.asarray(A.matvec(jnp.asarray(_rng(5, sp.nnodes))))
    assert _rel(t["y_overlap"], y) <= 1e-12
    assert _rel(t["y_plain"], y) <= 1e-12
    # the overlapped path splits blocks at least 2p wide on every axis
    assert t["framed"] == (name in ("open(2,2)", "periodic(2,2)"))


# ----------------------------------------------------------------- Krylov


def test_cg_matches_serial(ranks):
    sp = jpois.make_space(2, p=2, nel=9, dtype=F64)
    A, b = jasm.assemble_system(sp, jpois.poisson_system, POISSON)
    ref = _serial_cg(A, b)
    res = get(ranks)
    assert _rel(res["cg"]["x"], ref.x) <= 1e-10
    _same_iters(res["cg"]["k"], ref.iters)


@pytest.mark.parametrize("case", ["bicgstab", "gmres:(2, 2)", "gmres:(4, 1)"])
def test_nonsymmetric_solvers_match_serial(ranks, case):
    sp = jpois.make_space(2, p=2, nel=8, dtype=F64)
    A, b = jasm.assemble_system(sp, j_adv, {"eps": 0.1})
    M = jkry.jacobi_preconditioner(A)
    if case == "bicgstab":
        ref = jkry.bicgstab(A, b, M=M, rtol=1e-12)
    else:
        ref = jkry.gmres(A, b, M=M, rtol=1e-12, restart=20)
    res = get(ranks)
    assert _rel(res[case]["x"], ref.x) <= 1e-10
    _same_iters(res[case]["k"] // (20 if case != "bicgstab" else 1),
                int(ref.iters) // (20 if case != "bicgstab" else 1))


def test_pbjacobi_dof3_matches_serial(ranks):
    sp = jel.make_space(3, p=2, nel=3, dtype=F64)
    ctx = {"lambda": 1.0, "mu": 1.0, "body_force": lambda x: jnp.asarray([0.0, 0.0, -1.0])}
    A, b = jasm.assemble_system(sp, jel.elasticity_system, ctx)
    ref = _serial_cg(A, b, M=jkry.block_jacobi_preconditioner(A))
    res = get(ranks)
    t = res["pbjacobi"]
    assert _rel(t["x"], np.asarray(ref.x).reshape(t["x"].shape)) <= 1e-10
    _same_iters(t["k"], ref.iters)
    _same_iters(t["k_jacobi"], _serial_cg(A, b).iters)


# --------------------------------------------------------- boundary forms


@pytest.mark.parametrize("pgrid", [(2, 2), (4, 1)])
def test_nitsche_matches_serial(ranks, pgrid):
    sp = jbnd.make_open_space(2, p=2, nel=9, dtype=F64)
    interior, bnd = j_nitsche(sp)
    A, b = jasm.assemble_system(sp, interior, boundary=bnd, apply_fix=False)
    ref = _serial_cg(A, b)
    res = get(ranks)
    t = res[f"nitsche:{pgrid}"]
    assert _rel(t["A"], np.asarray(A.data).reshape(t["A"].shape)) <= 1e-12
    assert _rel(t["b"], np.asarray(b)) <= 1e-12
    assert _rel(t["x"], ref.x) <= 1e-10
    _same_iters(t["k"], ref.iters)


def test_boundary_function_jacobian_match_serial(ranks):
    """A nonlinear residual with a boundary form: held to the port's own
    serial assembly (itself held to the JAX package's in
    tests/test_torch_nonlinear.py), which costs no JAX compile here."""
    from petiga_tpu_torch.assembly import assemble as tasm
    from petiga_tpu_torch.models.boundary import make_open_space

    sp = make_open_space(2, p=2, nel=7, dtype=torch.float64, device="cpu")
    U = cases.rng_vec(3, sp.nnodes, scale=0.1)
    F = tasm.assemble_function(sp, cases.nl_residual, U, boundary=cases.nl_bnd_residual)
    J = tasm.assemble_jacobian(sp, cases.nl_residual, U, boundary=cases.nl_bnd_residual)
    res = get(ranks)
    t = res["boundary"]
    assert _rel(t["F"], F.numpy()) <= 1e-12
    assert _rel(t["J"], J.data.numpy().reshape(t["J"].shape)) <= 1e-12


# ---------------------------------------------------------------- Bratu


def test_function_matches_serial(ranks):
    sp = jbratu.make_space(2, p=2, nel=9, dtype=F64)
    F = jasm.assemble_function(sp, jbratu.bratu_residual, jnp.asarray(_rng(7, sp.nnodes, 0.1)),
                               {"lambda": 2.0})
    res = get(ranks)
    assert _rel(res["function"], np.asarray(F)) <= 1e-12


def test_bratu_newton_matches_serial(ranks):
    sp = jbratu.make_space(2, p=2, nel=8, dtype=F64)
    ref = jbratu.solve_bratu(sp, lam=5.0, rtol=1e-10)
    res = get(ranks)
    assert _rel(res["bratu_newton"]["U"], np.asarray(ref.U)) <= 1e-10
    _same_iters(res["bratu_newton"]["iters"], ref.iters)


def test_theta_step_matches_serial(ranks):
    sp = jbratu.make_space(2, p=2, nel=6, dtype=F64)
    ser = jts.ThetaStepper(sp, jbratu.bratu_ifunction, theta=0.5, ctx={"lambda": 1.0},
                           newton_kw={"rtol": 1e-12})
    U1, _ = ser.step(jnp.zeros((sp.nnodes, 1), F64), 0.0, 5e-3)
    res = get(ranks)
    assert _rel(res["theta"], np.asarray(U1)) <= 1e-10


def test_alpha_steps_match_serial(ranks):
    sp = jbratu.make_space(2, p=2, nel=7, dtype=F64)
    ser = jts.AlphaStepper(sp, jbratu.bratu_ifunction, rho_inf=0.5, ctx={"lambda": 1.0},
                           newton_kw={"rtol": 1e-12})
    U0 = jnp.zeros((sp.nnodes, 1), F64)
    U1, V1, _ = ser.step(U0, jnp.zeros_like(U0), 0.0, 1e-2)
    U2, V2, _ = ser.step(U1, V1, 1e-2, 1e-2)
    res = get(ranks)
    assert _rel(res["alpha"]["U"], np.asarray(U2)) <= 1e-10
    assert _rel(res["alpha"]["V"], np.asarray(V2)) <= 1e-10


# ----------------------------------------------- functionals, collocation


def test_functionals_match_serial(ranks):
    sp = jpois.make_space(2, p=2, nel=9, dtype=F64)
    U = jnp.asarray(_rng(11, sp.nnodes))

    def energy(pt, Ue, ctx):
        u = pt.value(Ue)[0]
        gu = pt.grad(Ue)[0]
        return jnp.asarray([0.5 * (gu @ gu), 0.25 * u**4])

    ref = np.asarray(jasm.compute_scalar(sp, energy, U))
    res = get(ranks)
    np.testing.assert_allclose(res["scalar"]["energy"], ref, rtol=1e-12)
    err = float(jasm.compute_error_norm(sp, U, j_exact, k=0))
    assert abs(res["scalar"]["l2"] - err) <= 1e-12 * err


def test_collocation_matches_serial(ranks):
    sp = JSpace([JAxis.uniform(p=2, nel=8) for _ in range(2)], collocation=True, dtype=F64)
    for d in range(2):
        for s in range(2):
            sp.set_boundary_value(d, s, 0, 0.0)

    def laplace(pt, ctx):
        f = pt.dim * jnp.pi**2 * jnp.prod(jnp.sin(jnp.pi * pt.x))
        return -jnp.trace(pt.shape2, axis1=-2, axis2=-1)[None, :], jnp.asarray([f])

    A, F = jcol.assemble_collocation(sp, laplace)
    ref = jkry.bicgstab(A, F, M=jkry.jacobi_preconditioner(A), rtol=1e-12, maxiter=3000)
    res = get(ranks)
    t = res["collocation"]
    assert _rel(t["A"], np.asarray(A.data).reshape(t["A"].shape)) <= 1e-12
    assert _rel(t["F"], np.asarray(F)) <= 1e-12
    assert _rel(t["U"], np.asarray(ref.x)) <= 1e-10
    _same_iters(t["iters"], ref.iters)


# --------------------------------------- dry run, one rank, device, hangs


def test_dryrun_multichip_cpu(capsys):
    from petiga_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", backend="gloo")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == out["summary"]
    assert line.startswith("dryrun_multichip(4): pgrid=(1, 2, 2) ")
    for part in ("poisson L2=", "bratu newton iters=", "gmres+schwarz iters=", "nitsche L2=",
                 "alpha-step |U1|=", "sharded-io ok (repartitioned)", "kernel-cg L2=",
                 "halo_staging=device"):
        assert part in line


def test_single_rank_without_group_matches_serial():
    """pgrid (1, 1) with no process group: periodic self-wraps are local
    copies; the overlapped matvec and CG equal the serial ones."""
    from petiga_tpu_torch.parallel.dist import DistSpace

    tsp = cases.periodic_space(8, both=False)
    ds = DistSpace(tsp, device="cpu")
    assert ds.world == 1 and ds.pgrid == (1, 1) and ds.halo_staging == "device"
    A, b = ds.assemble_system(cases.poisson_system, {"c": 0.3, "k": 1.0})
    x, k, _ = ds.cg(A, b, rtol=1e-12)
    xv = cases.rng_vec(5, tsp.nnodes)
    y = ds.crop_flat(ds.matvec_local(A, ds.pad_grid(xv))).numpy()
    sp = j_periodic(8, both=False)
    jA, jb = jasm.assemble_system(sp, jpois.poisson_system, {"c": 0.3, "k": 1.0})
    assert _rel(y, np.asarray(jA.matvec(jnp.asarray(xv.numpy())))) <= 1e-12
    ref = _serial_cg(jA, jb)
    assert _rel(ds.crop_flat(x).numpy(), ref.x) <= 1e-10
    _same_iters(k, ref.iters)


def test_device_none_needs_cuda():
    from petiga_tpu_torch.parallel.dist import DistSpace

    sp = cases.periodic_space(8)
    if torch.cuda.is_available():
        with pytest.raises(ValueError):  # the space lives on the CPU
            DistSpace(sp)
    else:
        with pytest.raises(RuntimeError):
            DistSpace(sp)


def test_hung_rank_fails_by_timeout():
    with pytest.raises(RuntimeError, match="job timeout"):
        launch(cases.hang, 2, backend="gloo", init_timeout=30.0, timeout=4.0)


def test_failing_rank_reaches_the_report():
    """The launcher's failure report: a rank's own error reaches the
    caller, traceback and all."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed:.*ValueError: rank 1 fails"):
        launch(cases.fail, 2, backend="gloo", init_timeout=30.0, timeout=60.0)
