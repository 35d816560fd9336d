"""The port's Poisson slice as a whole (petiga_tpu_torch.models.poisson)
against the JAX package, f64 on the CPU: plane assembly (full and
symmetric storage) -> Dirichlet post-fix -> Jacobi-CG -> L2 error.

The JAX side assembles with ``conv_min=1`` (its forcing-convolution load
route) and, in 2-D full storage, with the default ``conv_min`` (its
generic-box load route).  It solves each mesh once, in symmetric storage
(its Pallas solves recompile per call on the CPU, seconds each); the
port's full and symmetric solves are both held to that solution, since
the two storages hold one matrix (checked through matvec at 1e-12).
Tolerances: b, operator and l2 are round-off apart (rel 1e-12, 1e-12,
1e-10); x at rel 1e-10 with an identical CG iteration count."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.assembly.convform import assemble_coefficient_planes as jassemble
from petiga_tpu.assembly.convform import poisson_coefficients as jcoef
from petiga_tpu.models import poisson as jpoisson
from petiga_tpu.solve.krylov import cg as jcg
from petiga_tpu_torch.assembly import convform as tconv
from petiga_tpu_torch.models import poisson as tpoisson

RTOL_SOLVE = 1e-10

# (dim, nel, symmetric, JAX conv_min)
CASES = [(3, 6, False, 1), (3, 6, True, 1), (2, 8, False, 2048), (2, 8, True, 1)]
IDS = [f"{d}d-nel{n}-{'sym' if s else 'full'}-convmin{c}" for d, n, s, c in CASES]


@functools.lru_cache(maxsize=None)
def _jax_system(dim, nel, sym, conv_min):
    jsp = jpoisson.make_space(dim, p=2, nel=nel, dtype=jnp.float64)
    jop, jb = jassemble(jsp, jcoef, {"c": 0.0, "k": 1.0},
                        forcing=jpoisson.poisson_forcing(0.0, 1.0),
                        symmetric=sym, conv_min=conv_min)
    return jsp, jop, jb


@functools.lru_cache(maxsize=None)
def _jax_solution(dim, nel):
    jsp, jop, jb = _jax_system(dim, nel, True, 1)
    dinv = jpoisson._jacobi_inv(jop)
    jres = jcg(jop, jb, M=lambda r: r * dinv, rtol=RTOL_SOLVE)
    l2 = float(jpoisson.compute_error_norm(jsp, jres.x, jpoisson.exact_solution, k=0))
    return int(jres.iters), np.asarray(jres.x), l2


@functools.lru_cache(maxsize=None)
def _run(dim, nel, sym, conv_min):
    jsp, jop, jb = _jax_system(dim, nel, sym, conv_min)
    vs = np.random.default_rng(nel).normal(size=(3, jsp.nnodes, 1))
    iters, x, l2 = _jax_solution(dim, nel)
    ref = {
        "b": np.asarray(jb),
        "Av": [np.asarray(jop.matvec(jnp.asarray(v))) for v in vs],
        "iters": iters,
        "x": x,
        "l2": l2,
    }
    tsp = tpoisson.make_space(dim, p=2, nel=nel, dtype=torch.float64, device="cpu")
    U, info = tpoisson.solve_poisson(tsp, rtol=RTOL_SOLVE, symmetric=sym)
    op = info["A"]
    port = {
        "kind": op.kind,
        "b": info["b"].numpy(),
        "Av": [op.matvec(torch.as_tensor(v)).numpy() for v in vs],
        "iters": info["iters"],
        "x": U.numpy(),
        "l2": tpoisson.l2_error(tsp, U),
    }
    return ref, port


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_assembled_system_matches(case):
    ref, port = _run(*case)
    assert port["kind"] == ("sym" if case[2] else "full")
    assert port["b"].shape == ref["b"].shape
    assert _rel(port["b"], ref["b"]) <= 1e-12
    for y, y_ref in zip(port["Av"], ref["Av"]):
        assert _rel(y, y_ref) <= 1e-12


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cg_solution_matches(case):
    ref, port = _run(*case)
    assert port["iters"] == ref["iters"]
    assert _rel(port["x"], ref["x"]) <= 1e-10


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_l2_error_matches(case):
    ref, port = _run(*case)
    assert abs(port["l2"] - ref["l2"]) <= 1e-10 * ref["l2"]
    assert 0 < port["l2"] < 1e-3


@pytest.mark.parametrize("sym", [False, True], ids=["full", "sym"])
def test_reaction_diffusion_system_matches(sym):
    """The value channel ``c u v`` beside the diffusion channels."""
    ctx = {"c": 2.5, "k": 0.7}
    jsp = jpoisson.make_space(2, p=2, nel=5, dtype=jnp.float64)
    jop, jb = jassemble(jsp, jcoef, ctx, forcing=jpoisson.poisson_forcing(2.5, 0.7),
                        symmetric=sym, conv_min=1)
    tsp = tpoisson.make_space(2, p=2, nel=5, dtype=torch.float64, device="cpu")
    op, b = tconv.assemble_coefficient_planes(tsp, tconv.poisson_coefficients, ctx,
                                              forcing=tpoisson.poisson_forcing(2.5, 0.7),
                                              symmetric=sym)
    v = np.random.default_rng(0).normal(size=(tsp.nnodes, 1))
    assert _rel(op.matvec(torch.as_tensor(v)).numpy(), np.asarray(jop.matvec(jnp.asarray(v)))) <= 1e-12
    assert _rel(b.numpy(), np.asarray(jb)) <= 1e-12


def test_unported_routes_raise():
    """The conv engine's former waiting routes: mapped geometry (8.6) now
    assembles the reference's planes and load vector (a stretched and
    sheared map of the Poisson space, 1e-12); dof > 1 blocks (8.7) take
    (dof, dof) channel blocks, so scalar channels on a dof = 2 space
    raise."""
    jsp = jpoisson.make_space(2, p=2, nel=4, dtype=jnp.float64)
    G = np.asarray(jsp.greville_coordinates())
    jsp.init_geometry(np.stack([1.5 * G[:, 0] + 0.2 * G[:, 1] ** 2, G[:, 1]], axis=1))
    jop, jb = jassemble(jsp, jcoef, {"c": 0.0, "k": 1.0},
                        forcing=jpoisson.poisson_forcing(0.0, 1.0))
    sp = tpoisson.make_space(2, p=2, nel=4, dtype=torch.float64, device="cpu")
    sp.init_geometry(np.array(jsp.geometry))
    op, b = tconv.assemble_coefficient_planes(sp, tconv.poisson_coefficients,
                                              forcing=tpoisson.poisson_forcing(0.0, 1.0))
    v = np.random.default_rng(0).normal(size=(sp.nnodes, 1))
    assert _rel(op.matvec(torch.as_tensor(v)).numpy(), np.asarray(jop.matvec(jnp.asarray(v)))) <= 1e-12
    assert _rel(b.numpy(), np.asarray(jb)) <= 1e-12
    sp2 = tpoisson.make_space(2, p=2, nel=4, dtype=torch.float64, device="cpu").clone(dof=2)
    with pytest.raises(ValueError, match="blocks"):
        tconv.assemble_coefficient_planes(sp2, tconv.poisson_coefficients)


@pytest.mark.parametrize("dim,nel,sym", [(3, 6, False), (3, 5, True), (2, 7, False)])
def test_f32_planes_bit_identical(dim, nel, sym, monkeypatch):
    """f32 planes round exactly as the reference's: the interior rows share
    one stencil, so a different rounding is one systematic perturbation of
    every row, which the f32 solve's L2 error reflects."""
    from petiga_tpu_torch import interop

    jsp = jpoisson.make_space(dim, p=2, nel=nel, dtype=jnp.float32)
    jop, _ = jassemble(jsp, jcoef, {"c": 0.0, "k": 1.0}, symmetric=sym, apply_fix=False)
    tsp = tpoisson.make_space(dim, p=2, nel=nel, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(tconv, "_CHUNK_BYTES", 4096)  # several z-chunks
    op, _ = tconv.assemble_coefficient_planes(tsp, tconv.poisson_coefficients,
                                              {"c": 0.0, "k": 1.0}, symmetric=sym,
                                              apply_fix=False)
    ref = interop.operator_from_jax_planes(jop.stencil, np.asarray(jop.DT), align=jop.align,
                                           symmetric=sym, device="cpu")
    assert op.DT.dtype == torch.float32 and torch.equal(op.DT, ref.DT)


# ------------------------------------------------ pointwise engine, entry


@pytest.mark.parametrize("dim,nel,continuity", [(2, 6, None), (2, 4, 0)])
def test_pointwise_engine_matches_jax(dim, nel, continuity):
    """``solve_poisson(engine="pointwise")``: node-major assembly, then
    Jacobi-CG through ``StencilMatrix.fast_operator()``.  U at 1e-9
    relative, iteration counts within 1 (the two CG loops round their
    dots differently).  Reduced continuity is not conv-eligible, so
    ``engine="auto"`` takes the pointwise path there on both sides."""
    jsp = jpoisson.make_space(dim, p=2, nel=nel, continuity=continuity, dtype=jnp.float64)
    tsp = tpoisson.make_space(dim, p=2, nel=nel, continuity=continuity,
                              dtype=torch.float64, device="cpu")
    engine = "pointwise" if continuity is None else "auto"
    jU, jinfo = jpoisson.solve_poisson(jsp, c=0.3, rtol=1e-11, chunk=8, engine=engine)
    tU, tinfo = tpoisson.solve_poisson(tsp, c=0.3, rtol=1e-11, chunk=8, engine=engine)
    assert tinfo["engine"] == jinfo["engine"] == "pointwise"
    assert abs(tinfo["iters"] - jinfo["iters"]) <= 1
    assert tpoisson.l2_error(tsp, tU) == pytest.approx(jpoisson.l2_error(jsp, jU), rel=1e-8)
    jU = np.asarray(jU)
    assert np.abs(tU.numpy() - jU).max() <= 1e-9 * np.abs(jU).max()
    np.testing.assert_allclose(tinfo["A"].data.numpy(), np.asarray(jinfo["A"].data),
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="engine"):
        tpoisson.solve_poisson(tsp, engine="fft")


def test_entry_matches_jax():
    """``entry()``'s step (assemble_system + at most 30 Jacobi-CG
    iterations at rtol 1e-5) on a 4³ f64 mesh against the JAX package's,
    and the real f32 8³ entry point on the CPU; ``dryrun_multichip``
    without a device runs on the card or raises (its CPU run is
    tests/test_torch_dist.py::test_dryrun_multichip_cpu)."""
    import __graft_entry__ as jentry
    from petiga_tpu_torch import entry as tentry

    _, _, jstep = jentry._build(nel=4, dtype=jnp.float64)
    jx, jres = jstep(jnp.asarray(1.5))
    _, tstep = tentry._build(nel=4, dtype=torch.float64, device="cpu")
    tx, tres = tstep(torch.tensor(1.5, dtype=torch.float64))
    jx = np.asarray(jx)
    assert np.abs(tx.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    assert float(tres) == pytest.approx(float(jres), rel=1e-6)

    fn, args = tentry.entry(device="cpu")
    x, res = fn(*args)
    assert x.shape == (10**3, 1) and x.dtype == torch.float32
    assert bool(torch.isfinite(x).all()) and float(res) < 1e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tentry.dryrun_multichip(4)
