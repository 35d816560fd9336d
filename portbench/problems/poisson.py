"""The Poisson cells: PetIGA's Poisson demo on a uniform open
mesh with homogeneous Dirichlet values on every face, through
``petiga_tpu_torch``'s conv assembly and Jacobi-CG on the stencil kernel.

Each request is one solve to the configuration's tolerance, closed loop.
The traffic's parameters:

* ``forcing``: ``pool``, a list of forcings, each a list of modes
  ``{"amplitude": a, "waves": [k_d], "phases": [φ_d]}`` of
  ``f = Σ_m a_m Π_d sin(π k_md x_d + φ_md)``; each cycle through the pool
  takes a new order drawn from the seed, and every request scales its
  forcing by a load factor drawn uniformly from ``load_factor``;
* ``coefficient`` (optional): ``pool`` of ``{"amp": a, "waves": [m_d],
  "phases": [φ_d]}``, taken as the forcings are: each request then
  assembles the operator of ``k(x) = 1 + a Π_d sin(2π m_d x_d + φ_d)``
  anew; without it the operator ``k = 1`` is assembled once, in set-up,
  and each request assembles only its load vector.

A sample of requests drawn from the seed, and the last one, is judged by
the plain reference once the window has closed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..harness import closed_loop, worst
from ..reference import poisson as ref
from ..roofline import stencil_bound_s

# requests whose answers are kept for the check: the last one and this
# many drawn from the seed among the first SAMPLE_RANGE
SAMPLE, SAMPLE_RANGE = 3, 32


class _Draws:
    """The request parameters of one seed, request by request."""

    def __init__(self, traffic, rng):
        self.t = traffic
        self.rng = rng
        self.orders = {}
        self.cache = {}

    def _order(self, key, n, cycle):
        if (key, cycle) not in self.orders:
            self.orders[(key, cycle)] = self.rng.permutation(n)
        return self.orders[(key, cycle)]

    def _pick(self, key, pool, i):
        n = len(pool)
        return pool[self._order(key, n, i // n)[i % n]]

    def request(self, i):
        """``(modes, coef)``: forcing modes ``[(a, [(ω_d, φ_d)])]`` and the
        coefficient ``(amp, [(ω_d, φ_d)])`` or None."""
        if i in self.cache:
            return self.cache[i]
        for j in range(len(self.cache), i + 1):
            self.cache[j] = self._draw(j)
        return self.cache[i]

    def _draw(self, i):
        f = self.t["forcing"]
        lf = self.rng.uniform(*f["load_factor"])
        modes = [(lf * m["amplitude"],
                  [(math.pi * k, ph) for k, ph in zip(m["waves"], m["phases"])])
                 for m in self._pick("forcing", f["pool"], i)]
        coef = None
        c = self.t.get("coefficient")
        if c is not None:
            e = self._pick("coefficient", c["pool"], i)
            coef = (e["amp"], [(2 * math.pi * m, ph) for m, ph in zip(e["waves"], e["phases"])])
        return modes, coef


def _sines(x, axes):
    v = None
    for d, (w, ph) in enumerate(axes):
        s = torch.sin(w * x[..., d] + ph)
        v = s if v is None else v * s
    return v


def forcing_fn(modes):
    """The forcing as the program takes it; ``.modes`` carries the
    parameters for a control that stands in for the program."""
    def forcing(x, ctx):
        f = None
        for a, axes in modes:
            t = a * _sines(x, axes)
            f = t if f is None else f + t
        return f
    forcing.modes = modes
    return forcing


def coefficient_fn(coef, dim):
    """The coefficient channels as the program takes them; ``.params`` as
    ``.modes`` above."""
    amp, axes = coef

    def coefficient(x, ctx):
        k = 1.0 + amp * _sines(x, axes)
        return {(i, i): k for i in range(1, dim + 1)}
    coefficient.params = coef
    return coefficient


class Problem:
    def __init__(self, cfg, traffic, seed, device, rec):
        from petiga_tpu_torch.models import poisson

        self.cfg, self.rec, self.device = cfg, rec, device
        self.dim = cfg["dim"]
        self.sym = cfg["storage"] == "symmetric"
        self.rtol, self.maxiter = cfg["krylov"]["rtol"], cfg["krylov"]["maxiter"]
        self.draws = _Draws(traffic, np.random.default_rng(seed))
        srng = np.random.default_rng([seed, 1])
        self.sample = {int(i) for i in srng.choice(SAMPLE_RANGE, SAMPLE, replace=False)}
        self.probe_seed = int(srng.integers(2**62))
        self.per_request = "coefficient" in traffic
        self.failed = 0
        self.kept = {}
        t0 = time.perf_counter()
        with rec.span("space"):
            self.sp = poisson.make_space(self.dim, p=cfg["p"], nel=cfg["nel"],
                                         dtype=getattr(torch, cfg["dtype"]), device=device)
        rec.count("space_build_s", time.perf_counter() - t0)
        self.op = None
        if not self.per_request:
            with rec.span("assembly"):
                self.op = self._assemble(None)
        # warm-up inputs of their own, so that every run's window starts
        # at request 0
        self.warm = _Draws(traffic, np.random.default_rng([seed, 2]))

    def _assemble(self, coef, forcing=None):
        from petiga_tpu_torch.assembly import convform

        if coef is None:
            op, b = convform.assemble_coefficient_planes(
                self.sp, convform.poisson_coefficients, {"c": 0.0, "k": 1.0},
                forcing=forcing, symmetric=self.sym)
        else:
            op, b = convform.assemble_coefficient_planes(
                self.sp, coefficient_fn(coef, self.dim), None, forcing=forcing,
                symmetric=self.sym)
        return op if forcing is None else (op, b)

    def _solve(self, modes, coef):
        from petiga_tpu_torch.assembly import assemble, convform
        from petiga_tpu_torch.models import poisson

        rec = self.rec
        with rec.span("assembly"):
            if self.per_request:
                self.op = None  # the old planes go before the new ones come
                self.op, b = self._assemble(coef, forcing_fn(modes))
            else:
                b = convform.assemble_load_vector(self.sp, forcing_fn(modes))
                self.op, b = assemble.dirichlet_post_fix_homogeneous(self.sp, self.op, b)
        with rec.span("krylov"):
            U, res = poisson.solve_system(self.op, b, rtol=self.rtol, maxiter=self.maxiter)
        rec.count("krylov_iters", res.iters)
        return b, U, res.iters

    def warmup(self):
        self._solve(*self.warm.request(0))
        self.rec.spans.clear()
        del self.rec.counters["krylov_iters"]

    def request(self, i):
        modes, coef = self.draws.request(i)
        b, U, iters = self._solve(modes, coef)
        if iters >= self.maxiter:
            self.failed += 1
        if i in self.sample:
            # on the host, so that the device's peak is the program's
            self.kept[i] = (b.cpu(), U.cpu())
        self.kept["last"] = (i, b, U)

    def window(self, seconds):
        return closed_loop(self.request, seconds, self.rec)

    def info(self):
        op = self.op
        sym = op.kind == "sym"
        kernel = "stencil_spmv_sym" if sym else "stencil_spmv_full"
        return {"kernel": kernel,
                "bound_s": stencil_bound_s(op.nplanes, op.st.nnodes, op.dof,
                                           op.DT.element_size(), sym)}

    # ------------------------------------------------------------- check

    def check(self):
        """The numbers that decide ``correct``, against the plain
        reference in float64:

        * ``planes_rel``: the stored planes of the last request's
          operator, largest entry gap over the largest entry;
        * ``spmv_rel``: that operator's product through the kernel with a
          seeded vector, relative 2-norm gap;
        * ``load_rel``: each kept request's Dirichlet-fixed load vector,
          largest entry gap over the largest entry (worst request);
        * ``solution_rel``: each kept solution's relative 2-norm gap to
          the reference's own float64 solution ``U*`` of its own system
          (worst request);
        * ``residual_over_floor``: each kept solution's ``‖b - A U‖`` in
          the reference's system over that of ``U*`` rounded to the
          program's precision, the least a vector of that precision does
          (worst request): the rough modes a solve leaves show here."""
        cfg, dev, dim = self.cfg, self.device, self.dim
        N = cfg["nel"] + cfg["p"]
        grid = (N,) * dim
        last_i, b_last, U_last = self.kept.pop("last")
        kept = dict(self.kept)
        kept[last_i] = (b_last, U_last)
        self.kept = None
        systems = {}

        def system(coef):
            key = repr(coef)
            if key not in systems:
                systems.clear()
                systems[key] = ref.System(dim, cfg["p"], cfg["nel"], cfg["quadrature"],
                                          coef=coef, device=dev)
            return systems[key]

        out = {}
        S = system(self.draws.request(last_i)[1])
        op = self.op
        slots = range(S.diag_slot, S.nslots) if op.kind == "sym" else range(S.nslots)
        gap = top = 0.0
        for k, s in enumerate(slots):
            R = S.slot_block(s, 0, N)
            P = op.DT[k].reshape(grid).double()
            gap = worst(gap, float((P - R).abs().max()))
            top = max(top, float(R.abs().max()))
            del R, P
        out["planes_rel"] = gap / top
        g = torch.Generator(device=dev).manual_seed(self.probe_seed)
        x = torch.rand(grid, generator=g, device=dev, dtype=op.DT.dtype) - 0.5
        y = op.matvec(x.reshape(-1, 1)).reshape(grid).double()
        yr = S.apply(x.double())
        out["spmv_rel"] = float(torch.linalg.vector_norm(y - yr) / torch.linalg.vector_norm(yr))
        del x, y, yr
        self.op = None
        load, sol, over = 0.0, 0.0, 0.0
        for i in sorted(kept):
            b, U = (v.to(dev) for v in kept[i])
            modes, coef = self.draws.request(i)
            S = system(coef)
            br = S.load(modes)
            gap = float((b.reshape(grid).double() - br).abs().max() / br.abs().max())
            load = worst(load, gap)
            Ur = S.solve(br)
            U = U.reshape(grid).double()
            gap = torch.linalg.vector_norm(U - Ur)
            sol = worst(sol, float(gap / torch.linalg.vector_norm(Ur)))
            floor = S.rel_residual(br, Ur.to(getattr(torch, cfg["dtype"])).double())
            over = worst(over, S.rel_residual(br, U) / floor)
            del Ur, U
        out["load_rel"] = load
        out["solution_rel"] = sol
        out["residual_over_floor"] = over
        return out
