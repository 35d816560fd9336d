"""Share of its roofline that ``stencil_spmv_full`` reaches in the
products of the window's CG solves: the least time one product of the
operator can take (``roofline.py``, from the planes' shape, as the
problem's ``info`` gives it) over the kernel's device time per product in
the profiler trace.  A CG solve of ``k`` iterations makes ``k + 1``
products, each one or more launches of the kernel (a distributed product
launches it on its block and on each frame slab, all counted)."""

KERNEL = "stencil_spmv_full"


def read(run):
    if run.trace is None or run.info.get("kernel") != KERNEL:
        return None
    n = run.counters.get("krylov_iters")
    if not n:
        return None
    secs = sum(s for name, (s, _) in run.trace["ops"].items() if KERNEL in name)
    if secs <= 0:
        return None
    return 100.0 * run.info["bound_s"] * sum(k + 1 for k in n) / secs
