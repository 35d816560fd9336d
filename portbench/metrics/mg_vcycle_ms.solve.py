"""Milliseconds per multigrid V-cycle: the program's CUDA-event span
around each cycle (``MGPreconditioner.spans`` ``vcycle``), summed over
the window's solves, over their V-cycles; traced run."""


def read(run):
    t = run.counters.get("mg_vcycle_ms")
    n = run.counters.get("mg_vcycles")
    if not t or not n or sum(n) == 0:
        return None
    return sum(t) / sum(n)
