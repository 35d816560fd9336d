"""Mean Newton iterations per α-step."""


def read(run):
    v = run.counters.get("newton_iters")
    return sum(v) / len(v) if v else None
