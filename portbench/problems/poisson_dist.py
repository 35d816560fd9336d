"""The distributed Poisson cells: PetIGA's Poisson demo under ``mpiexec
-n <ranks>``, one rank per card, through ``petiga_tpu_torch``'s
distributed layer (``parallel/dist.DistSpace``): each rank assembles its
block of the full-storage planes once in set-up, and every request is a
Jacobi-CG solve on the ranks' blocks, the halo exchanged between cards
around the stencil kernel and every dot all-reduced.

Each request is one solve to the configuration's tolerance, closed loop,
in lock step over the ranks.  The traffic is the one of
``problems/poisson.py`` (``forcing``: ``pool`` and ``load_factor``), drawn
the same way from the seed: request ``i`` takes forcing ``k`` of the pool
at load factor ``λ_i``, and its load vector is ``λ_i`` times forcing
``k``'s, assembled in set-up (exact by linearity; CG's tolerance is
relative, so every ``λ`` is the same work).  A per-request coefficient is
not taken: the operator is assembled once.

Every rank counts ``space_build_s`` (the space and its ``DistSpace``,
the host's element partition with it), records the ``krylov`` span and
counts ``krylov_iters``, and rank 0's are read; in a traced run every
rank collects the program's own spans (``DistSpace.spans``) over the
window, and rank 0's totals are the counters ``halo_ms`` and
``allreduce_ms``.  A sample of requests drawn
from the seed, and the last one, is gathered and judged by the plain
reference once the window has closed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..harness import closed_loop, worst
from ..reference import poisson as ref
from ..roofline import stencil_bound_s
from .poisson import SAMPLE, SAMPLE_RANGE, _Draws, forcing_fn

__all__ = ["Problem", "poisson_form", "block_range"]


def _modes(entry, scale):
    """A pool entry's forcing modes ``[(a, [(ω_d, φ_d)])]`` at ``scale``."""
    return [(scale * m["amplitude"],
             [(math.pi * k, ph) for k, ph in zip(m["waves"], m["phases"])]) for m in entry]


def block_range(ds, N):
    """This rank's block in whole-grid rows, cut to the ``N`` real nodes
    of each axis, and the same rows within the block (padded rows hold
    nothing): ``(real, cut)`` slices in grid order."""
    real = tuple(slice(s.start, min(s.stop, N)) for s in ds.block_slices())
    return real, tuple(slice(0, max(0, r.stop - r.start)) for r in real)


class _Loads(_Draws):
    """Per request ``(modes, k, λ)``: the forcing modes at the drawn load
    factor, the pool index and the factor; the seed's draws are those of
    ``problems/poisson.py``."""

    def _draw(self, i):
        f = self.t["forcing"]
        n = len(f["pool"])
        lf = float(self.rng.uniform(*f["load_factor"]))
        k = int(self._order("forcing", n, i // n)[i % n])
        return _modes(f["pool"][k], lf), k, lf


def poisson_form(modes):
    """The Galerkin form of ``-Δu = f`` at an element's quadrature points
    (the program's quadrature-batched form interface): ``K_ab = Σ_q w
    ∇N_a·∇N_b``, ``F_a = Σ_q w f N_a``; ``.modes`` carries the forcing for a
    control that stands in for the program."""
    forcing = forcing_fn(modes)

    def form(pt, w, ctx):
        N0, N1 = pt.shape0, pt.shape1  # (Q, nen), (Q, nen, dim)
        K = torch.einsum("q,qai,qbi->ab", w, N1, N1)
        F = torch.einsum("q,qa->a", w * forcing(pt.x, ctx), N0)
        return K, F

    form.qbatched = True
    form.modes = modes
    return form


class Problem:
    def __init__(self, cfg, traffic, seed, device, rec):
        from petiga_tpu_torch.models import poisson
        from petiga_tpu_torch.parallel.dist import DistSpace

        if "coefficient" in traffic:
            raise ValueError("the distributed Poisson cells assemble their operator once: "
                             "no per-request coefficient")
        if cfg["storage"] != "full" or cfg["krylov"]["preconditioner"] != "jacobi":
            raise ValueError("the distributed layer stores full planes; Jacobi-CG")
        self.cfg, self.rec, self.device = cfg, rec, device
        self.dim = cfg["dim"]
        self.rtol, self.maxiter = cfg["krylov"]["rtol"], cfg["krylov"]["maxiter"]
        self.draws = _Loads(traffic, np.random.default_rng(seed))
        srng = np.random.default_rng([seed, 1])
        self.sample = {int(i) for i in srng.choice(SAMPLE_RANGE, SAMPLE, replace=False)}
        self.probe_seed = int(srng.integers(2**62))
        self.failed = 0
        self.kept = {}
        t0 = time.perf_counter()
        with rec.span("space"):
            sp = poisson.make_space(self.dim, p=cfg["p"], nel=cfg["nel"],
                                    dtype=getattr(torch, cfg["dtype"]), device=device)
            self.ds = DistSpace(sp, pgrid=cfg["pgrid"], device=device)
        rec.count("space_build_s", time.perf_counter() - t0)
        if self.ds.world != cfg["ranks"]:
            raise ValueError(f"{cfg['ranks']} ranks configured, {self.ds.world} running")
        self.rank = self.ds.rank
        pool = traffic["forcing"]["pool"]
        with rec.span("assembly"):
            self.A, b0 = self.ds.assemble_system(poisson_form(_modes(pool[0], 1.0)))
            self.b0 = [b0] + [self.ds.assemble_system(poisson_form(_modes(e, 1.0)))[1]
                              for e in pool[1:]]
        # warm-up inputs of their own, so that every run's window starts
        # at request 0
        self.warm = _Loads(traffic, np.random.default_rng([seed, 2]))

    def _solve(self, k, lf):
        b = self.b0[k] * lf
        with self.rec.span("krylov"):
            x, iters, _ = self.ds.cg(self.A, b, rtol=self.rtol, maxiter=self.maxiter,
                                     jacobi=True)
        self.rec.count("krylov_iters", int(iters))
        return b, x, int(iters)

    def warmup(self):
        _, k, lf = self.warm.request(0)
        self._solve(k, lf)
        self.rec.spans.clear()
        del self.rec.counters["krylov_iters"]

    def request(self, i):
        _, k, lf = self.draws.request(i)
        b, x, iters = self._solve(k, lf)
        if iters >= self.maxiter:
            self.failed += 1
        if i in self.sample:
            # on the host, so that the device's peak is the program's
            self.kept[i] = (b.cpu(), x.cpu())
        self.kept["last"] = (i, b, x)

    def window(self, seconds):
        from petiga_tpu_torch.parallel.dist import Spans

        if self.rec.timed:
            self.ds.spans = Spans()
        out = closed_loop(self.request, seconds, self.rec)
        if self.ds.spans is not None:
            ms = self.ds.spans.ms()
            self.ds.spans = None
            for name in ("halo", "allreduce"):
                if name in ms:
                    self.rec.count(f"{name}_ms", ms[name]["ms"])
        return out

    def info(self):
        """The least time of one distributed product: the rank's block of
        rows through the planes once, ``x`` read and ``y`` written once
        (the frame slabs the program corrects are its own extra work)."""
        rows = int(np.prod(self.ds.L))
        return {"kernel": "stencil_spmv_full",
                "bound_s": stencil_bound_s(self.ds.st.K, rows, 1,
                                           self.A.element_size(), False)}

    # ------------------------------------------------------------- check

    def check(self):
        """The numbers of ``problems/poisson.py``'s check, against the plain
        reference in float64: ``planes_rel`` by every rank on its own block
        (the worst rank counts); ``spmv_rel`` of the distributed product of
        a seeded vector, and ``load_rel``, ``solution_rel`` and
        ``residual_over_floor`` of the kept requests, gathered from the
        ranks and judged by rank 0 once every rank has handed in its
        part and freed the program's state."""
        cfg, dev, dim, ds = self.cfg, self.device, self.dim, self.ds
        N = cfg["nel"] + cfg["p"]
        grid = (N,) * dim
        S = ref.System(dim, cfg["p"], cfg["nel"], cfg["quadrature"], device=dev)
        real, cut = block_range(ds, N)
        gap = top = 0.0
        if all(r.stop > r.start for r in real):
            for s in range(S.nslots):
                R = S.slot_block(s, real[0].start, real[0].stop)[(slice(None),) + real[1:]]
                P = self.A[cut + (s, 0, 0)].double()
                gap = worst(gap, float((P - R).abs().max()))
                top = max(top, float(R.abs().max()))
                del R, P
        out = {"planes_rel": gap / top if top > 0 else 0.0}

        # the collective part: every rank, in the same order
        x = torch.rand(grid, generator=torch.Generator().manual_seed(self.probe_seed),
                       dtype=self.A.dtype) - 0.5
        x = x.to(dev)
        y = ds.crop_flat(ds.matvec_local(self.A, ds.pad_grid(x.reshape(-1, 1))))
        last_i, b_last, U_last = self.kept.pop("last")
        kept = dict(self.kept)
        kept[last_i] = (b_last, U_last)
        self.kept = None
        got = {}
        for i in sorted(kept):
            b, U = (ds.crop_flat(v.to(dev)) for v in kept[i])
            if self.rank == 0:
                got[i] = (b.cpu(), U.cpu())
            del b, U
        self.A = self.b0 = self.ds = ds = kept = None
        if self.rank != 0:
            return out

        yr = S.apply(x.double())
        y = y.reshape(grid).double()
        out["spmv_rel"] = float(torch.linalg.vector_norm(y - yr) / torch.linalg.vector_norm(yr))
        del x, y, yr
        load, sol, over = 0.0, 0.0, 0.0
        for i in sorted(got):
            b, U = (v.to(dev) for v in got[i])
            modes = self.draws.request(i)[0]
            br = S.load(modes)
            load = worst(load, float((b.reshape(grid).double() - br).abs().max()
                                     / br.abs().max()))
            Ur = S.solve(br)
            U = U.reshape(grid).double()
            sol = worst(sol, float(torch.linalg.vector_norm(U - Ur) / torch.linalg.vector_norm(Ur)))
            floor = S.rel_residual(br, Ur.to(getattr(torch, cfg["dtype"])).double())
            over = worst(over, S.rel_residual(br, U) / floor)
            del Ur, U, b, br
        out["load_rel"] = load
        out["solution_rel"] = sol
        out["residual_over_floor"] = over
        return out
