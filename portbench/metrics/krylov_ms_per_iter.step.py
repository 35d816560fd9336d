"""Milliseconds per BiCGStab iteration: the counters' solve seconds
(each ending in a synchronise) over the BiCGStab iterations; traced run."""


def read(run):
    t = run.counters.get("solve_s")
    n = run.counters.get("lin_iters")
    if not t or not n:
        return None
    its = sum(sum(x) for x in n)
    return 1e3 * sum(sum(x) for x in t) / its if its else None
