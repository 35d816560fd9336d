"""90th percentile of the seconds per solve in the traced window."""

import statistics


def read(run):
    if len(run.requests) < 2:
        return None
    return statistics.quantiles(run.requests, n=10)[8]
