"""Milliseconds per CG iteration: the host clock around each solve's
``cg`` (ending in a synchronise) over its iterations; traced run."""


def read(run):
    t = run.spans.get("krylov")
    n = run.counters.get("krylov_iters")
    if not t or not n or sum(n) == 0:
        return None
    return 1e3 * sum(t) / sum(n)
