"""Checks answered over the window, per second of the window: the rows of
every request whose valid answer came back inside the window."""


def read(run):
    n = sum(r["rows"] for r in run.requests
            if len(r["allowed"]) == r["rows"] and run.t0 <= r["recv"] <= run.end)
    return n / run.seconds if n else None
