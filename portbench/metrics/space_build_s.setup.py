"""Seconds to build the ``Space`` and its tables in set-up, host clock."""


def read(run):
    v = run.counters.get("space_build_s")
    return v[0] if v else None
