"""p95 over every request sent in the window (a POST /check/batch in the
cells that report it), from its send to the last byte of its reply; one
with no valid answer counts at the deadline."""

from portbench.readers import p95_ms


def read(run):
    if not run.requests:
        return None
    return p95_ms([(r["recv"] if len(r["allowed"]) == r["rows"] else run.deadline) - r["send"]
                   for r in run.requests])
