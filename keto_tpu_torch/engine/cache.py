"""Check-result cache: version-stamped LRU over single-check answers
(counterpart of ``keto_tpu/engine/cache.py``).

Hot single checks (the same user hitting the same object) skip the engine
entirely.

Correctness: entries are stamped with the engine's ANSWERING version
(ClosureCheckEngine.answering_version) — the version the next check would
be computed at. Under strong freshness that is the store version (so a
write instantly invalidates, even though the serving state still names the
old version until the rebuild runs); under bounded freshness it is the
serving snapshot's version, and asking for it also kicks the background
rebuild so cache hits cannot starve the freshness machinery. Do NOT stamp
with served_version: it lags writes under strong freshness and would keep
returning pre-write answers. Batch paths use the bulk entry points
(``get_many``/``put_many``): one lock acquisition per batch, so a hot
repeated payload costs dict probes, not engine dispatches.

The same class backs the pipeline's encoded-request cache (keys are
(start, target, depth) id triples instead of request tuples) — pass
``name`` so the two caches keep distinct hit/miss counters
(``keto_<name>_cache_hits_total`` and ``..._misses_total`` when a metrics
registry is given).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional


class CheckResultCache:
    def __init__(self, capacity: int = 65536, metrics=None, name: str = "check"):
        self.capacity = capacity
        self.name = name
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, bool] = OrderedDict()
        self._version: Optional[int] = None
        # probe tallies (the smoke run's hit share and the tests read them)
        self.hits = 0
        self.misses = 0
        if metrics is not None:
            self._m_hits = metrics.counter(
                f"keto_{name}_cache_hits_total", f"{name} cache hits"
            )
            self._m_misses = metrics.counter(
                f"keto_{name}_cache_misses_total", f"{name} cache misses"
            )
        else:
            self._m_hits = self._m_misses = None

    def get(self, version: int, key: Hashable) -> Optional[bool]:
        with self._lock:
            if version != self._version:
                # data moved: every cached answer is potentially stale
                self._entries.clear()
                self._version = version
                hit = None
            else:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
            if hit is None:
                self.misses += 1
            else:
                self.hits += 1
        m = self._m_misses if hit is None else self._m_hits
        if m is not None:
            m.inc()
        return hit

    def put(self, version: int, key: Hashable, value: bool) -> None:
        with self._lock:
            if version != self._version:
                return  # computed against a version we no longer cache
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def get_many(self, version: int, keys) -> list:
        """Batched get: one lock acquisition for the whole batch. Returns a
        list aligned with `keys`; None where missing."""
        out = [None] * len(keys)
        hits = 0
        with self._lock:
            if version != self._version:
                self._entries.clear()
                self._version = version
            else:
                entries = self._entries
                get = entries.get
                move = entries.move_to_end
                for i, k in enumerate(keys):
                    v = get(k)
                    if v is not None:
                        out[i] = v
                        move(k)
                        hits += 1
            self.hits += hits
            self.misses += len(keys) - hits
        if self._m_hits is not None:
            if hits:
                self._m_hits.inc(hits)
            if hits < len(keys):
                self._m_misses.inc(len(keys) - hits)
        return out

    def put_many(self, version: int, keys, values) -> None:
        """Batched put: one lock acquisition; same version contract as put."""
        with self._lock:
            if version != self._version:
                return
            entries = self._entries
            for k, v in zip(keys, values):
                entries[k] = v
                entries.move_to_end(k)
            while len(entries) > self.capacity:
                entries.popitem(last=False)

    def clear(self) -> None:
        """Drop every entry AND the version stamp: a wrong answer may be
        cached under an unchanged version, so a version bump alone would
        never evict it."""
        with self._lock:
            self._entries.clear()
            self._version = None

    def resize(self, capacity: int) -> None:
        """Apply a new capacity: shrinking trims LRU entries immediately
        instead of waiting for the next put."""
        capacity = max(0, int(capacity))
        with self._lock:
            self.capacity = capacity
            while len(self._entries) > capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
