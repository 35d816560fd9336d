"""The multigrid V-cycle's tracing (``solve/multigrid.MGPreconditioner``):
PCMG's log events, the counters and the optional CUDA-event spans, and
its coarse solve without host reads (``budget_cg``), on the CPU at 8³
elasticity (dof 3, every face clamped) over three levels (8 → 4 → 2,
``min_nel=2``).  This file imports neither jax nor petiga_tpu; its
card-only test runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mg_tracing.py"""

import pytest
import torch

from petiga_tpu_torch.assembly.assemble import assemble_system
from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space
from petiga_tpu_torch.models import elasticity as el
from petiga_tpu_torch.solve import krylov, multigrid
from petiga_tpu_torch.solve.multigrid import MGHierarchy, mg_preconditioner
from petiga_tpu_torch.sparse.stencil import StencilMatrix
from petiga_tpu_torch.utils import profiling
from petiga_tpu_torch.utils.profiling import Spans

CTX = {"lambda": 1.0, "mu": 1.0}


def _space(nel, device="cpu"):
    sp = Space([Axis.uniform(p=2, nel=nel)] * 3, dof=3, dtype=torch.float32, device=device)
    for d in range(3):
        for s in range(2):
            for c in range(3):
                sp.set_boundary_value(d, s, c, 0.0)
    return sp


@pytest.fixture(scope="module")
def system():
    sp = _space(8)
    A, _ = assemble_system(sp, el.elasticity_system, CTX)
    op = A.fast_operator()
    hier = MGHierarchy.build(
        sp, lambda s: op if s is sp else assemble_system(s, el.elasticity_system, CTX)[0],
        min_nel=2)
    assert [s.elem_shape[0] for s in hier.spaces] == [2, 4, 8]
    g = torch.Generator().manual_seed(3)
    b = torch.rand((sp.nnodes, 3), generator=g, dtype=torch.float32) - 0.5
    b = b * (~sp.tensor("dirichlet")[0]).float()
    return op, hier, b


@pytest.mark.parametrize("nsmooth", [1, 2])
def test_counters_match_a_hand_count(system, nsmooth, monkeypatch):
    """One V-cycle per application of ``M``; on each level above the
    coarsest ``2·nsmooth + 1`` products a cycle (smoothing down and up and
    one residual); on the coarsest the budget's products and its initial
    residual, and as coarse iterations those ``krylov.cg`` takes on the
    same right-hand side; the log events as many times."""
    op, hier, b = system
    M = mg_preconditioner(hier, nsmooth=nsmooth, coarse_iters=7)
    by_hand = []
    budget = multigrid.budget_cg

    def counting(A, rhs, Mc, rtol, maxiter):
        by_hand.append(krylov.cg(A, rhs, M=Mc, rtol=rtol, maxiter=maxiter).iters)
        return budget(A, rhs, Mc, rtol, maxiter)

    monkeypatch.setattr(multigrid, "budget_cg", counting)
    profiling.reset()
    res = krylov.cg(op, b, M=M, rtol=1e-6, maxiter=100)
    n = res.iters + 1  # z = M r before the loop and once an iteration
    counts = M.counts
    assert counts["vcycles"] == n and len(by_hand) == n
    assert counts["coarse_iters"] == sum(by_hand) and 0 < sum(by_hand) <= 7 * n
    assert counts["products"] == [8 * n] + [(2 * nsmooth + 1) * n] * 2
    ev = profiling.EVENTS
    assert ev["PCMG_VCycle"]["count"] == n and ev["MGCoarse"]["count"] == n
    for lvl in (1, 2):
        assert ev[f"MGSmooth Level {lvl}"]["count"] == 2 * n
        assert ev[f"MGResid Level {lvl}"]["count"] == n
        assert ev[f"MGInterp Level {lvl}"]["count"] == 2 * n
    assert "MGSmooth Level 0" not in ev


@pytest.mark.parametrize("case", ["f32_budget", "f64_converges", "zero_rhs"])
def test_budget_cg_is_cg_bit_for_bit(system, case):
    """The coarse solve without host reads gives ``krylov.cg``'s answer and
    iteration count exactly: where the budget ends it (float32), where the
    tolerance does first (float64), and on a zero right-hand side."""
    op, hier, b = system
    A = hier.operators[0]
    if case == "f64_converges":
        A = StencilMatrix(A.stencil, A.data.double())
    Ak = A.fast_operator()
    Mc = krylov.jacobi_preconditioner(A)
    g = torch.Generator().manual_seed(5)
    rhs = torch.rand((A.stencil.nnodes, 3), generator=g, dtype=A.data.dtype)
    if case == "zero_rhs":
        rhs = torch.zeros_like(rhs)
    budget = 200 if case == "f64_converges" else 9
    ref = krylov.cg(Ak, rhs, M=Mc, rtol=multigrid.COARSE_RTOL, maxiter=budget)
    x, iters = multigrid.budget_cg(Ak, rhs, Mc, multigrid.COARSE_RTOL, budget)
    assert int(iters) == ref.iters
    assert ref.iters == {"f32_budget": budget, "zero_rhs": 0}.get(case, ref.iters)
    assert case != "f64_converges" or ref.iters < budget
    assert torch.equal(x, ref.x)


@pytest.mark.cuda
def test_coarse_graph_replays_the_eager_solve():
    """On the card the coarse solve is a CUDA graph captured at its first
    call: each replay, on a new right-hand side, equals the eager solve
    bit for bit, adds the eager solve's iterations to the coarse count
    and its stencil launches (the budget's and the initial residual's)
    to ``spmv.LAUNCHES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the stencil kernel")
    from petiga_tpu_torch.sparse import spmv

    sp = _space(8, device="cuda")
    A, _ = assemble_system(sp, el.elasticity_system, CTX)
    hier = MGHierarchy.build(sp, lambda s: assemble_system(s, el.elasticity_system, CTX)[0],
                             min_nel=2)
    M = mg_preconditioner(hier)
    g = torch.Generator(device="cuda").manual_seed(6)
    for _ in range(3):
        rhs = torch.rand((hier.spaces[0].nnodes, 3), generator=g, device="cuda")
        first = M._graph is None
        count, launches = M.counts["coarse_iters"], spmv.LAUNCHES["full"]
        x = M._coarse_solve(rhs)
        # the first call's warm-up solve launches too, off the graph
        made = spmv.LAUNCHES["full"] - launches - (M.coarse_iters + 1) * first
        got = M.counts["coarse_iters"] - count
        launches = spmv.LAUNCHES["full"]
        xe, ie = multigrid.budget_cg(M.fastops[0], rhs, M.coarse_M, multigrid.COARSE_RTOL,
                                     M.coarse_iters)
        assert spmv.LAUNCHES["full"] - launches == made == M.coarse_iters + 1
        assert torch.equal(x, xe) and got == int(ie) <= M.coarse_iters
    assert M._graph is not None


def test_timing_off_takes_no_event_or_synchronise(system, monkeypatch):
    """Off by default: a V-cycle creates no CUDA event and synchronises
    nothing; on, the CPU's host clock times each cycle and coarse solve."""
    op, hier, b = system

    def refuse(*a, **kw):
        raise AssertionError("a CUDA event or synchronise with timing off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    M = mg_preconditioner(hier)
    assert M.spans is None
    M(b)
    M.spans = Spans()
    M(b)
    M(b)
    ms = M.spans.ms()
    assert ms["vcycle"]["n"] == 2 and ms["coarse"]["n"] == 2
    assert ms["vcycle"]["ms"] >= ms["coarse"]["ms"] > 0


def test_spans_on_the_card_take_two_events_and_wait_only_when_read(monkeypatch):
    """On a CUDA device a span records a pair of events and waits for
    none; :meth:`Spans.ms` waits for each end event and sums the pairs."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            log.append("new")

        def record(self):
            log.append("record")

        def synchronize(self):
            log.append("wait")

        def elapsed_time(self, other):
            return 1.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    spans = Spans()
    for _ in range(3):
        with spans("vcycle", torch.device("cuda", 0)):
            pass
    assert log == ["new", "new", "record", "record"] * 3
    assert spans.ms() == {"vcycle": {"ms": 4.5, "n": 3}}
    assert log.count("wait") == 3


def test_tracing_leaves_the_solution_unchanged(system):
    """The same MG-CG solve, bit for bit, with the spans off and on; one
    V-cycle the same under the profiler, whose trace names PCMG's
    events."""
    op, hier, b = system
    plain = krylov.cg(op, b, M=mg_preconditioner(hier), rtol=1e-6, maxiter=100)
    M = mg_preconditioner(hier)
    M.spans = Spans()
    timed = krylov.cg(op, b, M=M, rtol=1e-6, maxiter=100)
    assert timed.iters == plain.iters and torch.equal(timed.x, plain.x)
    M = mg_preconditioner(hier, coarse_iters=2)
    want = M(b)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = M(b)
    assert torch.equal(got, want)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"PCMG_VCycle", "MGCoarse", "MGSmooth Level 2", "MGResid Level 1",
            "MGInterp Level 2"} <= names
