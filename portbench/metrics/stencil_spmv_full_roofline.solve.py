"""Share of its roofline that ``stencil_spmv_full`` reaches in the
window's solves: the least time of every product they made, summed (the
byte bound of ``roofline.py`` for each level's planes, as the problem's
``info`` gives it, times that level's products), over the device seconds
of the kernels whose names hold ``stencil_spmv_full`` in the profiler
trace.  Products per level are the program's V-cycle counters
(``MGPreconditioner.counts``); the fine level adds those outside the
V-cycles (CG's, the Dirichlet fix's lift), which the problem counts."""

KERNEL = "stencil_spmv_full"


def read(run):
    if run.trace is None or run.info.get("kernel") != KERNEL:
        return None
    bounds = run.info.get("level_bound_s")
    per_level = run.counters.get("mg_products")
    outside = run.counters.get("fine_products_outside_mg")
    if not bounds or not per_level or not outside:
        return None
    need = sum(b * sum(p[lvl] for p in per_level) for lvl, b in enumerate(bounds))
    need += bounds[-1] * sum(outside)
    secs = sum(s for name, (s, _) in run.trace["ops"].items() if KERNEL in name)
    if secs <= 0:
        return None
    return 100.0 * need / secs
