"""The leader's cluster membership table (counterpart of
``keto_tpu/cluster/membership.py``).

Followers POST their heartbeat payload to the leader's write plane
(``/cluster/heartbeat``); the leader upserts each here, keyed by
``instance_id``. Liveness is receive-side only: a member is alive while its
last heartbeat is younger than ``member_timeout_s``. There is no leave or
join protocol: a member that stops beating ages out of the alive set, and
its row stays so ``/cluster/status`` shows it down rather than dropping it.
Each heartbeat carries the member's ``read_url`` and ``write_url``, which is
how the federation scraper finds what to scrape.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ClusterMembership:
    def __init__(self, member_timeout_s: float = 10.0, clock: Callable[[], float] = time.time):
        self.member_timeout_s = float(member_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        # instance_id -> last heartbeat payload (+ received_at stamp)
        self._members: dict[str, dict] = {}

    def upsert(self, payload: dict) -> dict:
        """Record a heartbeat and return the stored row. A payload without
        an ``instance_id`` is a ValueError: the id is the key and the
        metrics label, and there is no sane fallback."""
        instance_id = str(payload.get("instance_id") or "").strip()
        if not instance_id:
            raise ValueError("heartbeat payload missing instance_id")
        row = dict(payload)
        row["instance_id"] = instance_id
        row["received_at"] = self._clock()
        with self._lock:
            prev = self._members.get(instance_id)
            row["heartbeats"] = (prev.get("heartbeats", 0) + 1) if prev else 1
            row["first_seen"] = (
                prev.get("first_seen", row["received_at"]) if prev else row["received_at"]
            )
            self._members[instance_id] = row
        return row

    def get(self, instance_id: str) -> Optional[dict]:
        with self._lock:
            row = self._members.get(instance_id)
        return dict(row) if row else None

    def members(self) -> list[dict]:
        """Every known member, alive or not, oldest-joined first, with the
        computed ``age_s`` and ``alive`` fields."""
        now = self._clock()
        with self._lock:
            rows = [dict(r) for r in self._members.values()]
        rows.sort(key=lambda r: (r.get("first_seen", 0.0), r["instance_id"]))
        for r in rows:
            r["age_s"] = round(max(0.0, now - r.get("received_at", now)), 3)
            r["alive"] = r["age_s"] <= self.member_timeout_s
        return rows

    def alive(self) -> list[dict]:
        return [r for r in self.members() if r["alive"]]

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)
