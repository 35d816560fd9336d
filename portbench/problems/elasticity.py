"""The elasticity cell: PetIGA's ``demo/Elasticity3D.c`` solved with CG
and the geometric multigrid preconditioner (PetIGA's ``-pc_type mg``),
through ``petiga_tpu_torch``'s flat API: a dof-3 ``Space`` clamped on
every face, ``assemble_system`` with ``models.elasticity.elasticity_system``
and its kernel operator (``fast_operator()``), ``MGHierarchy.build`` with
the coarse levels assembled the same way, ``mg_preconditioner`` and
``cg``.

Each request is one load case solved to the configuration's tolerance,
closed loop: the body force's load vector and its Dirichlet fix, then
MG-CG.  The traffic's parameters:

* ``forcing``: ``pool``, a list of load cases, each a list of modes
  ``{"component": c, "amplitude": a, "waves": [k_d], "phases": [φ_d]}`` of
  ``f = Σ_m a_m e_{c_m} Π_d sin(π k_md x_d + φ_md)``; each cycle through
  the pool takes a new order drawn from the seed, and every request
  scales its case by a load factor drawn uniformly from ``load_factor``.

In a traced run the preconditioner's CUDA-event spans are switched on
for each request, and its spans and counters (V-cycles, coarse CG
iterations, stencil products per level) are read into the recorder after
it.  A program whose preconditioner has no counters gives none.

A sample of requests drawn from the seed, and the last one, is judged by
the plain reference once the window has closed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..harness import closed_loop, worst
from ..reference.elasticity import Elasticity
from ..roofline import stencil_bound_s
from .poisson import SAMPLE, SAMPLE_RANGE, _Draws, _sines

# what a request adds to the fine level's products outside the V-cycles:
# the Dirichlet fix's lift (one product) and CG's initial residual
FIX_PRODUCTS, CG_START_PRODUCTS = 1, 1


class _Loads(_Draws):
    """The load cases of one seed, request by request: each a list of
    ``(component, amplitude, [(ω_d, φ_d)])``."""

    def _draw(self, i):
        f = self.t["forcing"]
        lf = self.rng.uniform(*f["load_factor"])
        return [(m["component"], lf * m["amplitude"],
                 [(math.pi * k, ph) for k, ph in zip(m["waves"], m["phases"])])
                for m in self._pick("forcing", f["pool"], i)]


def forcing_fn(modes):
    """The body force as the program takes it: ``(..., 3)`` at points
    ``(..., 3)``."""
    def forcing(x, ctx):
        f = torch.zeros(x.shape[:-1] + (3,), dtype=x.dtype, device=x.device)
        for c, a, axes in modes:
            f[..., c] += a * _sines(x, axes)
        return f
    return forcing


def _clamped_space(cfg, device):
    from petiga_tpu_torch.core.axis import Axis
    from petiga_tpu_torch.core.space import Space

    sp = Space([Axis.uniform(p=cfg["p"], nel=cfg["nel"])] * 3, dof=3,
               dtype=getattr(torch, cfg["dtype"]), device=device)
    for d in range(3):
        for side in range(2):
            for c in range(3):
                sp.set_boundary_value(d, side, c, 0.0)
    return sp


class Problem:
    def __init__(self, cfg, traffic, seed, device, rec):
        from petiga_tpu_torch.assembly.assemble import assemble_system
        from petiga_tpu_torch.models.elasticity import elasticity_system
        from petiga_tpu_torch.solve.multigrid import MGHierarchy, mg_preconditioner

        self.cfg, self.rec, self.device = cfg, rec, device
        self.rtol, self.maxiter = cfg["krylov"]["rtol"], cfg["krylov"]["maxiter"]
        self.draws = _Loads(traffic, np.random.default_rng(seed))
        srng = np.random.default_rng([seed, 1])
        self.sample = {int(i) for i in srng.choice(SAMPLE_RANGE, SAMPLE, replace=False)}
        self.probe_seed = int(srng.integers(2**62))
        self.failed = 0
        self.kept = {}
        t0 = time.perf_counter()
        with rec.span("space"):
            self.sp = sp = _clamped_space(cfg, device)
        rec.count("space_build_s", time.perf_counter() - t0)
        ctx = {"lambda": cfg["lambda"], "mu": cfg["mu"]}
        mg = cfg["mg"]
        with rec.span("assembly"):
            A, _ = assemble_system(sp, elasticity_system, ctx)
            self.op = A.fast_operator()
            del A
            hier = MGHierarchy.build(
                sp, lambda s: self.op if s is sp else assemble_system(s, elasticity_system, ctx)[0],
                min_nel=mg["min_nel"])
            self.M = mg_preconditioner(hier, nsmooth=mg["nsmooth"], omega=mg["omega"],
                                       coarse_iters=mg["coarse_iters"])
        op = self.op
        self.levels = [s.elem_shape[0] for s in hier.spaces]
        self.level_bound_s = [stencil_bound_s(op.nplanes, s.nnodes, op.dof,
                                              op.DT.element_size(), False)
                              for s in hier.spaces]
        # warm-up inputs of their own, so that every run's window starts
        # at request 0
        self.warm = _Loads(traffic, np.random.default_rng([seed, 2]))

    def _solve(self, modes):
        from petiga_tpu_torch.assembly import assemble, convform
        from petiga_tpu_torch.solve import krylov

        rec, M = self.rec, self.M
        with rec.span("assembly"):
            b = convform.assemble_load_vector(self.sp, forcing_fn(modes))
            self.op, b = assemble.dirichlet_post_fix_homogeneous(self.sp, self.op, b)
        before = getattr(M, "counts", None) if rec.timed else None
        if before is not None:
            from petiga_tpu_torch.utils.profiling import Spans

            M.spans = Spans()
        with rec.span("krylov"):
            res = krylov.cg(self.op, b, M=M, rtol=self.rtol, maxiter=self.maxiter)
        rec.count("krylov_iters", res.iters)
        if before is not None:
            after = M.counts
            ms = M.spans.ms()
            M.spans = None
            rec.count("mg_vcycles", after["vcycles"] - before["vcycles"])
            rec.count("mg_coarse_iters", after["coarse_iters"] - before["coarse_iters"])
            rec.count("mg_products", [a - b for a, b in zip(after["products"],
                                                            before["products"])])
            rec.count("mg_vcycle_ms", ms.get("vcycle", {}).get("ms", 0.0))
            rec.count("mg_coarse_ms", ms.get("coarse", {}).get("ms", 0.0))
            rec.count("fine_products_outside_mg", FIX_PRODUCTS + CG_START_PRODUCTS + res.iters)
        return b, res

    def warmup(self):
        self._solve(self.warm.request(0))
        self.rec.spans.clear()
        for k in list(self.rec.counters):
            if k != "space_build_s":
                del self.rec.counters[k]

    def request(self, i):
        b, res = self._solve(self.draws.request(i))
        if res.iters >= self.maxiter:
            self.failed += 1
        if i in self.sample:
            # on the host, so that the device's peak is the program's
            self.kept[i] = (b.cpu(), res.x.cpu(), res.residual.cpu())
        self.kept["last"] = (i, b, res.x, res.residual)

    def window(self, seconds):
        return closed_loop(self.request, seconds, self.rec)

    def info(self):
        return {"kernel": "stencil_spmv_full", "levels": self.levels,
                "level_bound_s": self.level_bound_s}

    # ------------------------------------------------------------- check

    def check(self):
        """The numbers that decide ``correct``, against the plain
        reference in float64, as the Poisson cells define them:

        * ``planes_rel``: all stored planes of the fine operator (every
          slot and component pair), largest entry gap over the largest
          entry;
        * ``spmv_rel``: its product through the kernel with a seeded
          vector, relative 2-norm gap;
        * ``load_rel``: each kept request's Dirichlet-fixed load vector,
          largest entry gap over the largest entry (worst request);
        * ``solution_rel``: each kept solution's relative 2-norm gap to
          the reference's own float64 solution ``U*`` (worst request);
        * ``residual_over_floor``: each kept solution's ``‖b - K U‖`` in
          the reference's system over that of ``U*`` rounded to the
          program's precision (worst request);
        * ``residual_over_rtol``: each kept solve's final residual as
          MG-CG reports it, over ``‖b‖`` and over the configuration's
          rtol (worst request): at most 1 where the solve met its
          tolerance.  In float32 at 96³ the two readings before it do not
          tell a solve stopped at 100 times its tolerance from a sound
          one, since the operator's rounding sets them."""
        cfg, dev = self.cfg, self.device
        N = cfg["nel"] + cfg["p"]
        grid = (N, N, N, 3)
        last_i, *last = self.kept.pop("last")
        kept = dict(self.kept)
        kept[last_i] = tuple(last)
        self.kept = None
        self.M = None
        S = Elasticity(cfg["p"], cfg["nel"], cfg["quadrature"], cfg["lambda"], cfg["mu"],
                       device=dev)
        out = {}
        op = self.op
        gap = top = 0.0
        for s in range(S.nslots):
            for a in range(3):
                for c in range(3):
                    R = S.slot_block(s, a, c, 0, N)
                    P = op.DT[(s * 3 + a) * 3 + c].reshape(grid[:3]).double()
                    gap = worst(gap, float((P - R).abs().max()))
                    top = max(top, float(R.abs().max()))
                    del R, P
        out["planes_rel"] = gap / top
        g = torch.Generator(device=dev).manual_seed(self.probe_seed)
        x = torch.rand(grid, generator=g, device=dev, dtype=op.DT.dtype) - 0.5
        y = op.matvec(x.reshape(-1, 3)).reshape(grid).double()
        yr = S.apply(x.double())
        out["spmv_rel"] = float(torch.linalg.vector_norm(y - yr) / torch.linalg.vector_norm(yr))
        del x, y, yr
        self.op = None
        load, sol, over, met = 0.0, 0.0, 0.0, 0.0
        for i in sorted(kept):
            b, U, rnorm = (v.to(dev) for v in kept[i])
            met = worst(met, float(rnorm) / float(torch.linalg.vector_norm(b.double()))
                        / self.rtol)
            br = S.load(self.draws.request(i))
            load = worst(load, float((b.reshape(grid).double() - br).abs().max()
                                     / br.abs().max()))
            Ur = S.solve(br)
            U = U.reshape(grid).double()
            sol = worst(sol, float(torch.linalg.vector_norm(U - Ur) / torch.linalg.vector_norm(Ur)))
            floor = S.rel_residual(br, Ur.to(getattr(torch, cfg["dtype"])).double())
            over = worst(over, S.rel_residual(br, U) / floor)
            del Ur, U
        out["load_rel"] = load
        out["solution_rel"] = sol
        out["residual_over_floor"] = over
        out["residual_over_rtol"] = met
        return out
