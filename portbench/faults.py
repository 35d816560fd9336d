"""Faults planted in the program, and the lower precision, for the
controls that the limits of ``correct`` are set against.

Each entry of :data:`MODES` patches the installed program for the rest of
the process and returns config overrides:

* ``lower``: the nearest precision below the configuration's.  For a
  float32 configuration, TF32: the plain reference computed in TF32
  (``reference/tf32.py``) put in the program's place, planes, load
  vector and solve (on a distributed Poisson cell: each rank's block of
  the planes and load vector, and the solve and the product on the whole
  grid gathered on every rank, each rank keeping its block); the
  program's own TF32 switch reaches only its matrix products, not its
  solver.  For a float64 configuration, float32, through the program's
  own path (a float32 space);
* ``unchanged``: the timed path returns its state unchanged: a Poisson
  solve returns the zero vector (every rank's block of it); an α-step
  returns its start state;
* ``exchange``: on a distributed cell, the forward halo exchange between
  ranks left out: each rank's product sees zeros where its neighbours'
  nodes are (the assembly's reverse fold still runs);
* ``early``: the solver stopped at ``factor`` (100) times the configured
  tolerance (Krylov for a linear configuration, Newton for a nonlinear
  one), through the configuration the program is run with;
* ``altered``: one entry of each answer altered where it is produced: a
  Poisson solution by its largest magnitude; an α-step's end state by
  the same, or, where the step's loop is internal to the program
  (``run_conv``), every Newton correction by 0.01 at a few entries there.

The program itself is never edited: these patch module attributes in the
running process only, so a cell of several ranks plants them in every
rank (``harness.run``'s ``plant``).
"""

from __future__ import annotations

import json

import torch

__all__ = ["MODES", "plant"]


def _tf32_reference(problem, cfg):
    """Put the reference in TF32 in the place of the Poisson program."""
    if problem != "poisson":
        raise ValueError(f"no TF32 reference for problem {problem!r}")
    from petiga_tpu_torch.assembly import assemble, convform
    from petiga_tpu_torch.models import poisson

    from .reference import tf32
    from .reference.poisson import System

    dim, p, nel, q = cfg["dim"], cfg["p"], cfg["nel"], cfg["quadrature"]
    plain = {}

    def system(space, coef=None):
        if coef is not None:
            return System(dim, p, nel, q, coef=coef, device=space.device)
        if space.device not in plain:
            plain[space.device] = System(dim, p, nel, q, device=space.device)
        return plain[space.device]

    def assemble_coefficient_planes(space, coef, ctx=None, *, forcing=None, symmetric=False,
                                    **kw):
        op = tf32.Operator(System(dim, p, nel, q, coef=getattr(coef, "params", None),
                                  device=space.device), symmetric)
        if forcing is None:
            return op, torch.zeros((op.st.nnodes, 1), dtype=torch.float32, device=space.device)
        return op, tf32.load(system(space), forcing.modes)

    def assemble_load_vector(space, forcing, ctx=None):
        return tf32.load(system(space), forcing.modes)

    def dirichlet_post_fix_homogeneous(space, op, b):
        return op, b  # the reference's load vectors are fixed already

    def solve_system(op, b, *, rtol=1e-10, maxiter=10000):
        res = tf32.cg(op, b, rtol, maxiter)
        return res.x, res

    convform.assemble_coefficient_planes = assemble_coefficient_planes
    convform.assemble_load_vector = assemble_load_vector
    assemble.dirichlet_post_fix_homogeneous = dirichlet_post_fix_homogeneous
    poisson.solve_system = solve_system
    return {}


def _tf32_dist_reference(cfg):
    """Put the reference in TF32 in the place of the distributed Poisson
    program (``DistSpace``'s assembly, CG and product)."""
    from petiga_tpu_torch.parallel.dist import DistSpace

    from .problems.poisson_dist import block_range
    from .reference import tf32
    from .reference.poisson import System

    dim, p, nel, q = cfg["dim"], cfg["p"], cfg["nel"], cfg["quadrature"]
    N = nel + p
    ops = {}

    def operator(ds):
        if ds.device not in ops:
            ops[ds.device] = tf32.Operator(System(dim, p, nel, q, device=ds.device), False,
                                           planes=False)
        return ops[ds.device]

    def block(ds, v):
        """A vector of the whole grid -> this rank's block."""
        return ds.pad_grid(v.reshape(-1, 1))

    def assemble_system(self, form, ctx=None, **kw):
        S = operator(self).S
        real, cut = block_range(self, N)
        data = torch.zeros(tuple(self.L[::-1]) + (S.nslots, 1, 1), dtype=torch.float32,
                           device=self.device)
        for s in range(S.nslots):
            R = S.slot_block(s, real[0].start, real[0].stop)[(slice(None),) + real[1:]]
            data[cut + (s, 0, 0)] = tf32.tf32(R.float())
        return data, block(self, tf32.load(S, form.modes))

    def cg(self, data, b, *, rtol=1e-8, maxiter=10000, **kw):
        res = tf32.cg(operator(self), self.crop_flat(b), rtol, maxiter)
        return block(self, res.x), res.iters, res.residual

    def matvec_local(self, data, x, *args, **kw):
        return block(self, operator(self).matvec(self.crop_flat(x)))

    DistSpace.assemble_system = assemble_system
    DistSpace.cg = cg
    DistSpace.matvec_local = matvec_local
    return {}


def _lower(problem, cfg):
    if cfg["dtype"] == "float32" and problem == "poisson_dist":
        return _tf32_dist_reference(cfg)
    if cfg["dtype"] == "float32":
        return _tf32_reference(problem, cfg)
    if cfg["dtype"] == "float64":
        return {"dtype": "float32"}
    raise ValueError(f"no lower precision for {cfg['dtype']}")


def _bump(U, by=None, width=1):
    """``U`` with ``width`` entries from its middle one on moved by ``by``,
    or by the largest magnitude in ``U``."""
    U = U.clone()
    m = U.numel() // 2
    U.view(-1)[m:m + width] += U.abs().max() if by is None else by
    return U


def _patch_answers(problem, cfg, fn):
    if problem == "poisson":
        from petiga_tpu_torch.models import poisson

        solve = poisson.solve_system

        def solve_system(op, b, **kw):
            U, res = solve(op, b, **kw)
            return fn(U), res

        poisson.solve_system = solve_system
    elif problem == "poisson_dist":
        from petiga_tpu_torch.parallel.dist import DistSpace

        cg = DistSpace.cg

        def dist_cg(self, data, b, **kw):
            x, iters, res = cg(self, data, b, **kw)
            return fn(x), iters, res

        DistSpace.cg = dist_cg
    elif problem == "cahnhilliard":
        from petiga_tpu_torch.solve import krylov, ts

        step = ts.AlphaStepper.step

        def alpha_step(self, U, V, t, dt):
            U1, V1, info = step(self, U, V, t, dt)
            return fn(U1, U), V1, info

        ts.AlphaStepper.step = alpha_step
        bicgstab = krylov.bicgstab

        def bicgstab_(A, b, **kw):
            res = bicgstab(A, b, **kw)
            return res._replace(x=fn(res.x + 0, None, correction=True))

        krylov.bicgstab = bicgstab_
    else:
        raise ValueError(f"no faults for problem {problem!r}")
    return {}


def _unchanged(problem, cfg):
    if problem.startswith("poisson"):
        return _patch_answers(problem, cfg, torch.zeros_like)

    def fn(U1, U0, correction=False):
        return torch.zeros_like(U1) if correction else U0.reshape(U1.shape)
    return _patch_answers(problem, cfg, fn)


def _altered(problem, cfg):
    if problem.startswith("poisson"):
        return _patch_answers(problem, cfg, _bump)

    def fn(U1, U0, correction=False):
        # a packed correction's middle may be a periodic halo copy, which
        # the program drops: a stretch of 8 entries reaches the nodes too
        return _bump(U1, 0.01, 8) if correction else _bump(U1)
    return _patch_answers(problem, cfg, fn)


def _no_exchange(problem, cfg):
    if problem != "poisson_dist":
        raise ValueError(f"no exchange between ranks in problem {problem!r}")
    from petiga_tpu_torch.parallel.dist import DistSpace

    def gather(self, x_loc, launch=None):
        if launch is not None:
            launch()
        dim, p = self.space.dim, self.widths
        pad = []
        for g in range(dim - 1, -1, -1):  # torch pads the last grid axis first
            pad += [p[dim - 1 - g]] * 2
        return torch.nn.functional.pad(x_loc, [0, 0] + pad)

    DistSpace._gather = gather
    return {}


def _early(problem, cfg, factor=100.0):
    key = "krylov" if "krylov" in cfg else "newton"
    return {key: dict(cfg[key], rtol=factor * cfg[key]["rtol"])}


MODES = {"lower": _lower, "unchanged": _unchanged, "altered": _altered, "exchange": _no_exchange,
         "early": _early}


_PLANTED: dict = {}


def plant(mode, problem, cfg, **kw):
    """Patch the program for ``mode``, once in a process however often it
    is asked (a patch wraps what it finds); returns the config
    overrides."""
    key = json.dumps([mode, problem, cfg, kw], sort_keys=True)
    if key not in _PLANTED:
        _PLANTED[key] = MODES[mode](problem, cfg, **kw)
    return dict(_PLANTED[key])
