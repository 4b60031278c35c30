"""Rows per batch the check batcher dispatched over the measured window."""

from portbench.readers import batcher_delta


def read(run):
    d = batcher_delta(run.window)
    if d is None or d[0] <= 0:
        return None
    return d[1] / d[0]
