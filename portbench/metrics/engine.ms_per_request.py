"""Check engine time per request (a single check, or a whole batch): the
program's attribution stages encode, launch, kernel and decode, over the
profiled sub-window. The stage kernel holds the whole engine call, host
work and waits for the interpreter lock with the device's."""

from portbench.readers import attribution_ms


def read(run):
    return attribution_ms(run.window, ("encode", "launch", "kernel", "decode"))
