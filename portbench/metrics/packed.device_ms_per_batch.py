"""Device operation time per batch request in the profiled sub-window: the
sum of every device operation, over the requests the program's
attribution ledger counted between the sub-window's edges (in the cells
that report it, each request is one engine batch; the check batcher's
pipeline counts no /check/batch request)."""

from portbench.readers import subwindow


def read(run):
    t = subwindow(run)
    if t is None or t["busy_s"] <= 0:
        return None
    a, b = (c.get("attribution") for c in t["counters"])
    if not a or not b or b["requests"] <= a["requests"]:
        return None
    return 1e3 * sum(v[1] for v in t["kernels"].values()) / (b["requests"] - a["requests"])
