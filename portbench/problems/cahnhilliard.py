"""The Cahn–Hilliard cells: PetIGA's ``demo/CahnHilliard2D.c``
as ``petiga_tpu_torch/examples/cahnhilliard.py`` runs it, fixed-dt
generalized-α steps from a seeded random state, each step Newton to the
configuration's tolerance with Jacobi-BiCGStab on the stencil kernel.

Each request is one α-step, closed loop.  The traffic's ``jacobian``
chooses the route:

* ``"ad"``: ``solve/ts.AlphaStepper.step``, the stepper of
  ``models.cahnhilliard.run``, whose Newton assembles the Jacobian of the
  pointwise residual by forward-mode AD (``operator="fast"``: the solves
  run on the kernel);
* ``"conv"``: ``models.cahnhilliard.run_conv``, Jacobian and residual
  conv-assembled.  Its step loop is internal, so the window is one call
  stopped from its monitor once the seconds have passed; the window opens
  at the monitor of the call's first step, which leaves that call's
  initial-velocity solve out of it.

The initial state is ``cbar + noise (r - 1/2)`` with ``r`` a uniform
field drawn on the device from ``--seed``.  Set-up advances it through the
traffic's ``start_steps`` by ``run_conv`` (the transient in which Newton
needs more iterations than later), then runs ``warmup_steps`` steps of the
cell's own route.  Every step's end state is copied to the host, so that the
device's peak is the program's, and judged by the plain reference once
the window has closed: how far it reduces the reference's stage residual
from the step's start.
"""

from __future__ import annotations

import time

import torch

from ..harness import closed_loop
from ..harness import worst as worst_
from ..reference.cahnhilliard import CahnHilliard
from ..trace import WINDOW_SPAN


class _Closed(Exception):
    """Raised from ``run_conv``'s monitor when the window's time is up."""


class Problem:
    def __init__(self, cfg, traffic, seed, device, rec):
        from petiga_tpu_torch.models import cahnhilliard as ch
        from petiga_tpu_torch.solve.ts import AlphaStepper

        self.ch, self.cfg, self.rec, self.device = ch, cfg, rec, device
        self.route = traffic["jacobian"]
        self.warmup_steps = traffic["warmup_steps"]
        self.failed = 0
        self.dt = cfg["dt"]
        self.ctx = {"theta": cfg["theta"], "alpha": cfg["alpha"], "cbar": cfg["cbar"]}
        nw = cfg["newton"]
        t0 = time.perf_counter()
        with rec.span("space"):
            self.sp = ch.make_space(dim=cfg["dim"], nel=cfg["nel"],
                                    dtype=getattr(torch, cfg["dtype"]), device=device)
        rec.count("space_build_s", time.perf_counter() - t0)
        n = cfg["nel"]
        g = torch.Generator(device=device).manual_seed(seed)
        U0 = torch.rand((n * n, 1), generator=g, device=device, dtype=torch.float64)
        U0 = (cfg["cbar"] + cfg["noise"] * (U0 - 0.5)).to(self.sp.dtype)
        # the states of each run of steps on the host: (start, [end of each step])
        self.segments = [(U0.cpu(), [])]
        self.U = U0
        self.t = 0.0
        if traffic.get("start_steps", 0):
            # the start of the measured run: the field advanced through the
            # first, transient steps by the conv route, each judged as well
            ends = self.segments[-1][1]
            with rec.span("start_steps"):
                self.U, _ = self._run_conv(self.U, traffic["start_steps"],
                                           lambda step, t, U, s: ends.append(U.cpu()))
            self.segments.append((ends[-1], []))
        self.counters = {} if rec.timed else None
        if self.route == "ad":
            self.newton_kw = dict(rtol=nw["rtol"], linear_solver=nw["linear_solver"],
                                  operator=nw["operator"])
            self.stepper = AlphaStepper(self.sp, ch.residual, rho_inf=cfg["rho_inf"],
                                        ctx=self.ctx, newton_kw=self.newton_kw)
            with rec.span("initial_velocity"):
                self.V = self.stepper.initial_velocity(self.U, 0.0)
        elif self.route != "conv":
            raise ValueError(f"unknown jacobian route {self.route!r}")

    # ---------------------------------------------------------- AD route

    def _ad_step(self, i):
        rec = self.rec
        with rec.span("step"):
            self.U, self.V, (iters, _, ok) = self.stepper.step(self.U, self.V, self.t, self.dt)
        self.t += self.dt
        self.segments[-1][1].append(self.U.cpu())
        rec.count("newton_iters", iters)
        if not ok:
            self.failed += 1

    # -------------------------------------------------------- conv route

    def _run_conv(self, U0, nsteps, monitor, counters=None):
        cfg = self.cfg
        return self.ch.run_conv(
            self.sp, U0, theta=cfg["theta"], alpha=cfg["alpha"], cbar=cfg["cbar"], dt=self.dt,
            nsteps=nsteps, rho_inf=cfg["rho_inf"], rtol_newton=cfg["newton"]["rtol"],
            monitor=monitor, counters=counters)

    def _conv_window(self, seconds):
        rec = self.rec
        self.segments.append((self.segments[-1][1][-1], []))
        ends = self.segments[-1][1]
        marks = []
        win = torch.profiler.record_function(WINDOW_SPAN)

        def monitor(step, t, U, stats):
            marks.append(time.perf_counter())  # the statistics have synchronised
            ends.append(U.cpu())
            if step == 1:
                win.__enter__()
            elif marks[-1] - marks[0] >= seconds:
                raise _Closed

        try:
            self._run_conv(self.U, 1 << 30, monitor, self.counters)
        except _Closed:
            pass
        finally:
            win.__exit__(None, None, None)
        if self.counters is not None:
            # the call's first step lies before the window
            for key, vals in self.counters.items():
                del vals[0]
            for key in ("newton_iters", "jacobian_s", "solve_s", "lin_iters"):
                for v in self.counters.get(key, []):
                    rec.count(key, v)
        return marks[0], marks[-1], [b - a for a, b in zip(marks, marks[1:])]

    # -------------------------------------------------------------- API

    def warmup(self):
        if self.route == "ad":
            for _ in range(self.warmup_steps):
                self._ad_step(-1)
            if self.counters is not None:
                self.newton_kw["counters"] = self.counters
        else:
            ends = self.segments[-1][1]
            self.U, _ = self._run_conv(self.U, self.warmup_steps,
                                       lambda step, t, U, s: ends.append(U.cpu()))
        self.rec.spans.clear()
        self.rec.counters.pop("newton_iters", None)
        self.failed = 0

    def window(self, seconds):
        if self.route == "conv":
            return self._conv_window(seconds)
        out = closed_loop(self._ad_step, seconds, self.rec)
        if self.counters is not None:
            for key in ("jacobian_s", "solve_s", "lin_iters"):
                for v in self.counters.get(key, []):
                    self.rec.count(key, v)
        return out

    def info(self):
        return {}

    def check(self):
        """``newton_rel``: the worst, over every step taken, of the
        reference's stage residual at the step's end state over that at
        its start, each run of steps starting from the reference's own
        consistent initial velocity and following the velocity update of
        the α scheme from the program's states."""
        cfg = self.cfg
        R = CahnHilliard(cfg["nel"], p=cfg["p"], q=cfg["quadrature"], theta=cfg["theta"],
                         alpha=cfg["alpha"], rho_inf=cfg["rho_inf"], dt=self.dt,
                         device=self.device)
        n = cfg["nel"]
        self.stepper = self.V = self.U = None
        worst = 0.0
        for U0, ends in self.segments:
            U = U0.reshape(n, n).to(self.device, torch.float64)
            V = R.initial_velocity(U)
            for X in ends:
                X = X.reshape(n, n).to(self.device, torch.float64)
                worst = worst_(worst, R.newton_reduction(X, U, V))
                V = R.velocity(X, U, V)
                U = X
        return {"newton_rel": worst}
