"""Milliseconds per V-cycle in the coarsest level's CG: the program's
CUDA-event span around each coarse solve (``MGPreconditioner.spans``
``coarse``), summed over the window's solves, over their V-cycles;
traced run."""


def read(run):
    t = run.counters.get("mg_coarse_ms")
    n = run.counters.get("mg_vcycles")
    if not t or not n or sum(n) == 0:
        return None
    return sum(t) / sum(n)
