"""The follower's heartbeater (counterpart of ``keto_tpu/cluster/heartbeat.py``).

A daemon thread POSTs the node's self-describing payload (role, instance
id, snapshot version, backend, breaker and quarantine state, HBM in flight,
SLO burn, advertised URLs) to the leader's write plane at
``/cluster/heartbeat`` every ``interval_s``, on the upstream URL the WAL
tail already uses: a follower that can replicate can heartbeat.

Failures are swallowed and counted: the heartbeater never takes a serving
node down because the leader is restarting. ``status()`` shows the beat and
error counts and the last error.

The heartbeat's reply is the fleet's control channel: the leader embeds
``directives`` (a fleet-wide QoS scale, tightened while the aggregate SLO
burn alert fires) and ``on_directives`` applies them here, so degradation
reaches every member at heartbeat cadence with no other RPC.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, Optional


class ClusterHeartbeater:
    def __init__(
        self,
        upstream: str,
        payload_fn: Callable[[], dict],
        interval_s: float = 1.0,
        timeout_s: float = 5.0,
        logger=None,
        post_fn=None,  # injectable for tests: post_fn(url, payload_dict)
        on_directives=None,  # on_directives(dict) applies a leader's order
    ):
        self.upstream = upstream.rstrip("/")
        self.url = f"{self.upstream}/cluster/heartbeat"
        self._payload_fn = payload_fn
        self.interval_s = max(0.01, float(interval_s))
        self.timeout_s = float(timeout_s)
        self._logger = logger
        self._post_fn = post_fn or self._post
        self._on_directives = on_directives
        self.last_directives = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self.last_beat_t: Optional[float] = None

    def _post(self, url: str, payload: dict):
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode("utf-8"),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            body = resp.read()
        try:
            return json.loads(body.decode("utf-8"))
        except Exception:
            return None

    def beat_once(self) -> bool:
        """One heartbeat attempt; True on success. The loop calls it, and so
        do the tests."""
        try:
            payload = self._payload_fn()
            reply = self._post_fn(self.url, payload)
        except Exception as e:
            self.errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            if self._logger is not None and self.errors in (1, 10, 100):
                try:
                    self._logger.warning(
                        "cluster_heartbeat_error", upstream=self.upstream,
                        errors=self.errors, error=self.last_error,
                    )
                except Exception:
                    pass
            return False
        self.beats += 1
        self.last_beat_t = time.time()
        if isinstance(reply, dict):
            directives = reply.get("directives")
            if isinstance(directives, dict):
                self.last_directives = directives
                if self._on_directives is not None:
                    try:
                        self._on_directives(directives)
                    except Exception as e:
                        self.last_error = f"directive apply failed: {type(e).__name__}: {e}"
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            self.beat_once()
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="keto-cluster-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout_s + self.interval_s)
            self._thread = None

    def status(self) -> dict:
        return {
            "upstream": self.upstream,
            "interval_s": self.interval_s,
            "beats": self.beats,
            "errors": self.errors,
            "last_error": self.last_error,
            "last_beat_t": self.last_beat_t,
            "last_directives": self.last_directives,
            "running": self._thread is not None,
        }
