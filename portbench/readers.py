"""What the metric readers (``metrics/<name>.py``) share: each reader is a
file of its own with ``read(run) -> float | None``, and returns None where
its run has nothing for it to read."""

from __future__ import annotations

import numpy as np


def p95_ms(values) -> float | None:
    v = np.asarray(values, dtype=float)
    return float(np.percentile(v, 95) * 1e3) if len(v) else None


def attribution_ms(counters: tuple, stages: tuple) -> float | None:
    """Milliseconds per request in ``stages`` of the program's attribution
    ledger, between two counter readings."""
    before, after = counters
    a, b = before.get("attribution"), after.get("attribution")
    if not a or not b:
        return None
    n = b["requests"] - a["requests"]
    if n <= 0:
        return None

    def sec(snap, s):
        return snap["stages"].get(s, {}).get("seconds", 0.0)

    return 1e3 * sum(sec(b, s) - sec(a, s) for s in stages) / n


def batcher_delta(counters: tuple) -> tuple[float, float] | None:
    """(batches, rows) the check batcher dispatched between two readings."""
    before, after = counters
    a, b = before.get("pipeline"), after.get("pipeline")
    if not a or not b:
        return None
    batches = b["batches"] - a["batches"]
    rows = b["mean_batch"] * b["batches"] - a["mean_batch"] * a["batches"]
    return float(batches), float(rows)


def subwindow(run) -> dict | None:
    t = run.trace
    return t if t and t.get("window_s", 0) > 0 else None


def idle_share(run) -> float | None:
    t = subwindow(run)
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
