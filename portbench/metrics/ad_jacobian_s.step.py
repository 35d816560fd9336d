"""Seconds per step in the pointwise AD Jacobian assembly
(``assemble.assemble_jacobian``): Newton's ``jacobian_s`` counters, each
ending in a synchronise; traced run."""


def read(run):
    v = run.counters.get("jacobian_s")
    if not v:
        return None
    return sum(sum(x) for x in v) / len(run.requests)
