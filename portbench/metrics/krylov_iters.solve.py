"""Mean CG iterations per solve (``KrylovResult.iters``)."""


def read(run):
    v = run.counters.get("krylov_iters")
    return sum(v) / len(v) if v else None
