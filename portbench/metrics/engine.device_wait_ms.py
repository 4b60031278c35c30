"""Time a request's thread spent blocked on the card, per request: the
program's attribution stage kernel over the profiled sub-window, where
every host<->device synchronisation of the check path is timed at its
site (keto_tpu_torch/telemetry/devstats.py DEVSTATS.wait). None where the
program's attribution snapshot has no device_waits: there kernel holds
host work as well."""

from portbench.readers import attribution_ms


def read(run):
    if not run.window or any("device_waits" not in (c.get("attribution") or {})
                             for c in run.window):
        return None
    return attribution_ms(run.window, ("kernel",))
