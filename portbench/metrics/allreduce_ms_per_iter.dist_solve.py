"""Milliseconds per CG iteration in the all-reduces of the distributed
layer's dots: rank 0's ``DistSpace.spans`` ``allreduce`` total over the
window (CUDA events around each all-reduce) over the window's CG
iterations; traced run."""


def read(run):
    t = run.counters.get("allreduce_ms")
    n = run.counters.get("krylov_iters")
    if not t or not n or sum(n) == 0:
        return None
    return sum(t) / sum(n)
