"""B2's share of its roofline: the least time one pass needs (the bytes of
portbench/roofline.py over the data-sheet bandwidth) over the mean time of
the kernel named packed_propagate_kernel in the profiled sub-window."""

from portbench.readers import subwindow
from portbench.roofline import b2_bound_s

KERNEL = "packed_propagate"


def read(run):
    t = subwindow(run)
    if t is None or run.roofline is None:
        return None
    hits = [v for name, v in t["kernels"].items() if KERNEL in name]
    count = sum(v[0] for v in hits)
    if not count:
        return None
    r = run.roofline
    bound = b2_bound_s(r["n_nodes"], r["n_edges"], r["distinct_sources"], r["rows"])
    return 100.0 * bound / (sum(v[1] for v in hits) / count)
