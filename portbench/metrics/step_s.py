"""Seconds per α-step: the whole window over the steps completed in it,
host clock; the window ends with the step under way when its time is up."""


def read(run):
    return run.window_s / len(run.requests)
