"""Seconds per solve of a cell of several cards: the whole window over the
solves completed in it, rank 0's host clock; the window ends with the
solve under way when its time is up."""


def read(run):
    return run.window_s / len(run.requests)
