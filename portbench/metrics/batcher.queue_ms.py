"""Check batcher queue wait per request: the program's attribution stage
queue, over the profiled sub-window."""

from portbench.readers import attribution_ms


def read(run):
    return attribution_ms(run.window, ("queue",))
