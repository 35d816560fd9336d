"""Seconds per solve: the whole window over the solves completed in it,
host clock; the window ends with the solve under way when its time is up."""


def read(run):
    return run.window_s / len(run.requests)
