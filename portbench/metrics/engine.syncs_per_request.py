"""Host<->device synchronisations per request: the program's count of
timed sync sites (the attribution snapshot's device_waits, summed over
sites) over the requests it folded in between the profiled sub-window's
edges. None where the snapshot has no device_waits."""


def _syncs(snap: dict) -> int:
    return sum(w["count"] for w in snap["device_waits"].values())


def read(run):
    if not run.window:
        return None
    a, b = (c.get("attribution") or {} for c in run.window)
    if "device_waits" not in a or "device_waits" not in b:
        return None
    n = b["requests"] - a["requests"]
    if n <= 0:
        return None
    return (_syncs(b) - _syncs(a)) / n
