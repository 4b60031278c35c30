"""REST plane time per request (a single check, or a whole batch): the
program's attribution stages admission, serialize and reply, over the
profiled sub-window."""

from portbench.readers import attribution_ms


def read(run):
    return attribution_ms(run.window, ("admission", "serialize", "reply"))
