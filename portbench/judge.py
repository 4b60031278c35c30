"""How ``correct`` is decided: the answers the timed path gave, against the
plain reference (``reference/``), once the window has closed.

Every request of the window is a record of its loop (``loops/``), whose
rows the loop draws again from the seed. A sample of the answered rows,
drawn from the seed, is checked against the reference; every request
that got no valid answer counts.

Numbers compared, each with its limit (an exact comparison: 0):
- ``wrong_answers``: judged answers that disagree with the reference;
- ``unanswered``: requests sent in the window that got no valid answer
  (no reply, or an error status) by the close plus the grace.
"""

from __future__ import annotations

from itertools import groupby

import numpy as np

LIMITS = {"wrong_answers": 0, "unanswered": 0}


def judge_run(ref, depth: int, rng: np.random.Generator, k: int, requests: list,
              rows_of) -> tuple[dict, int, int, int]:
    """Judges up to ``k`` answered rows of ``requests``, drawn without
    replacement; ``rows_of(record)`` gives a request's (starts, targets).
    Returns the counts compared, and how many requests were attempted and
    failed, and how many rows were judged."""
    good = [r for r in requests if len(r["allowed"]) == r["rows"]]
    failed = len(requests) - len(good)
    counts = {"wrong_answers": 0, "unanswered": failed}
    good.sort(key=lambda r: (r["client"], r["i"]))
    ends = np.cumsum([r["rows"] for r in good], dtype=np.int64)
    total = int(ends[-1]) if len(ends) else 0
    picks = np.sort(rng.choice(total, size=min(k, total), replace=False)) if total else np.zeros(0, np.int64)
    at = np.searchsorted(ends, picks, side="right")
    judged = 0
    for ri, group in groupby(zip(at.tolist(), picks.tolist()), key=lambda p: p[0]):
        rec = good[ri]
        s, t = rows_of(rec)
        first = int(ends[ri]) - rec["rows"]
        for _, x in group:
            r = x - first
            judged += 1
            if ref.check(int(s[r]), int(t[r]), depth) != bool(rec["allowed"][r]):
                counts["wrong_answers"] += 1
    return counts, len(requests), failed, judged


def verdict(counts: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the numbers compared."""
    compared = {k: {"value": int(v), "limit": LIMITS[k]} for k, v in counts.items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared
