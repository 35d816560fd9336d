"""Milliseconds per CG iteration in the halo exchange of the distributed
layer: rank 0's ``DistSpace.spans`` ``halo`` total over the window (CUDA
events around posting and completing each exchange, so the time the
stream waited for its neighbours) over the window's CG iterations;
traced run."""


def read(run):
    t = run.counters.get("halo_ms")
    n = run.counters.get("krylov_iters")
    if not t or not n or sum(n) == 0:
        return None
    return sum(t) / sum(n)
