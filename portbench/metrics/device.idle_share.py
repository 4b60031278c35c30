"""The share of the profiled sub-window in which no operation ran on the
device: 1 - (union of device operation intervals / sub-window)."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
