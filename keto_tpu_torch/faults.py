"""Deterministic fault injection (counterpart of ``keto_tpu/faults.py``).

Named fault sites sit on the production failure-handling seams: the check
batcher's stage loops, the device engine's launch, the list path's reverse
gathers, the sharded tier's launch, the replica pool's delta broadcast,
the supervisor's backend probe, the WAL's append, the checkpoint writer,
the follower's replay and the election. Each is armed per process through :data:`FAULTS` or the
``KETO_FAULTS`` environment knob, and the recovery paths that guard those
seams (the batcher's watchdog, the device breaker in
``engine/fallback.py``, the device supervisor in ``driver/registry.py``,
the replica supervisor and resync in ``driver/replicas.py``, the scrubber
in ``engine/scrub.py``) are driven through them, deterministically, in the
tests and on the card.

Armed sites fire a bounded number of times (never at random: a flaky
fault is a flaky test), then disarm themselves. An unarmed site costs one
dict lookup under a lock; nothing fires one per request.

Fail-stop sites (:meth:`FaultRegistry.fire` / :meth:`~FaultRegistry.should_fire`):

============================  =================================================
site                          effect when armed
============================  =================================================
``replica.crash``             a forked read replica ``os._exit``\\ s while
                              applying its next delta frame
                              (driver/replicas.py)
``delta.drop``                the parent skips one delta frame for one serving
                              replica, a version gap the resync handshake must
                              fill (driver/replicas.py)
``batcher.dispatcher_die``    the serial dispatcher, or the pipeline's launch
                              thread, raises and dies at the top of its loop;
                              the watchdog restarts it (engine/batcher.py)
``batcher.encode_die``        a pipeline encode worker dies holding its batch
                              (engine/batcher.py)
``batcher.decode_die``        the pipeline decode thread dies holding its batch
                              (engine/batcher.py)
``device.compile_error``      ``DeviceCheckEngine.launch_encoded`` raises as a
                              failed kernel build would (engine/device.py)
``device.batch_nan``          the launch returns non-boolean garbage for the
                              batch, as a numerically sick card would
                              (engine/device.py)
``device.oom``                the launch raises as a CUDA out-of-memory
                              would; the breaker bisects the batch
                              (engine/device.py, engine/fallback.py)
``device.compile_fail``       the launch raises as a launch refused for one
                              shape would; the shape goes to quarantine
                              without tripping the breaker (engine/device.py)
``device.lost``               the launch raises as a lost device would; the
                              device supervisor re-probes and re-inits
                              (engine/device.py, driver/registry.py)
``backend.probe_hang``        the supervisor's backend probe counts as a child
                              killed at its timeout (driver/registry.py)
``shard.launch_fail``         a sharded serving-tier launch raises before the
                              mesh dispatch; the breaker answers the batch
                              from the host oracle and probes the mesh path
                              again (parallel/serving.py, engine/fallback.py)
``list.gather_fail``          a list query's reverse gather raises; the list
                              breaker answers from the live-store oracle
                              (engine/listing.py)
``scrub.device_bitflip``      one element of the serving closure matrix is
                              poisoned in place; the scrubber must detect and
                              repair it (engine/closure.py)
``wal.torn_write``            a WAL append writes half its frame to disk, then
                              "the process dies": replay truncates the
                              unacked torn tail (store/wal.py)
``wal.corrupt_crc``           a WAL append lands framed with a flipped CRC;
                              replay refuses the record (store/wal.py)
``wal.crash_after_append``    a WAL append completes durably, then the process
                              dies before acking: recovery may surface the
                              durable-but-unacked write (store/wal.py)
``wal.enospc``                a WAL append raises ENOSPC before any byte
                              lands; the write is never acked and the durable
                              wrapper fail-stops (store/wal.py)
``wal.bitrot``                one byte of a sealed WAL segment flips on disk;
                              the scrubber's rescan flags it and checkpoints
                              past the damage (store/wal.py, fired from
                              engine/scrub.py)
``checkpoint.crash_mid_write`` the checkpoint writer dies with a half-written
                              tmp file before the atomic rename; readers keep
                              the previous checkpoint (graph/checkpoint.py)
``election.split_heartbeat``  a follower loses one leader-liveness observation
                              and campaigns early; the lease CAS must reject
                              it, never mint a second term
                              (cluster/election.py)
``replica.promote_fail``      a winning candidate's promotion raises; the
                              lease is released and the election re-run
                              (cluster/election.py)
``replica.skip_delta``        a follower applies a delta's version but drops
                              its tuples: silent divergence with zero lag,
                              which only the anti-entropy digest sees
                              (replication/follower.py)
============================  =================================================

Slowness sites (:meth:`FaultRegistry.arm_slow`, consumed with
:meth:`FaultRegistry.maybe_sleep`) delay ``sleep=ms`` or block until
disarmed (``stuck``) instead of raising:

============================  =================================================
``batcher.dispatch_slow``     the serial dispatcher, before a batch
``batcher.encode_slow``       a pipeline encode worker, before encoding
``batcher.launch_slow``       the pipeline launch thread, before the launch
``batcher.decode_slow``       the pipeline decode thread, before decoding
``batcher.reconfigure_stall`` a live ``reconfigure()`` in its drain window
``device.slow``               the device engine inside the launch
``delta.slow``                the parent before broadcasting a delta frame
``replica.slow``              a gRPC Check before it answers (api/services.py)
``shard.launch_slow``         a sharded serving-tier launch, before the mesh
                              dispatch: a straggling shard
                              (parallel/serving.py)
``election.lease_stall``      a lease acquire or renew, before its critical
                              section (cluster/election.py)
============================  =================================================

``client.unavailable`` keeps its name only, so that a ``KETO_FAULTS`` string
written for the reference parses the same: no module calls it, here or in
the reference, whose client never fires it either.

``KETO_FAULTS`` syntax: comma-separated entries, each one of

- ``site`` — fail-stop, fire once
- ``site:count`` — fail-stop, fire ``count`` times
- ``site:sleep=ms`` — slowness, delay ``ms`` milliseconds once
- ``site:sleep=ms:count`` — slowness, delay ``count`` times
- ``site:stuck`` — slowness, block until the site is disarmed/reset

e.g. ``KETO_FAULTS="delta.drop,device.batch_nan:3,device.slow:sleep=250:2"``.
Parsed once at import; tests arm programmatically instead.

Fork semantics: the registry is plain process memory, so forked replicas
inherit the armed state at fork time and decrement their own copies. The
replica pool ships its *current* snapshot with every respawn command, so a
fault disarmed in the parent does not come back in a respawned child.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

#: upper bound on a single ``stuck`` block: even an un-reset registry can't
#: wedge a process (watchdogs fire long before this; CI budgets survive it)
STUCK_CAP_S = 120.0


class FaultInjected(RuntimeError):
    """Raised by an armed :meth:`FaultRegistry.fire` site. Deliberately a
    plain RuntimeError subclass: production recovery paths must treat it
    exactly like the organic failure it stands in for."""

    def __init__(self, site: str):
        super().__init__(f"injected fault: {site}")
        self.site = site


class FaultRegistry:
    """Thread-safe map of site -> remaining fire count."""

    def __init__(self, env: Optional[dict] = None):
        self._lock = threading.Lock()
        self._armed: dict[str, int] = {}
        # site -> [times remaining, sleep_s, stuck]; slowness is a separate
        # map so fail-stop consumers (should_fire/fire) never race a slow
        # arming for the same name
        self._slow: dict[str, list] = {}
        self._fired: dict[str, int] = {}
        # epoch event: sleepers wait on the event captured at sleep start;
        # disarm/reset swap in a fresh one and set the old, so every
        # in-flight sleep (and every ``stuck`` block) wakes immediately
        self._wake = threading.Event()
        if env is not None:
            self.load_env(env)

    # -- arming ---------------------------------------------------------------

    def arm(self, site: str, times: int = 1) -> None:
        if times <= 0:
            raise ValueError(f"times must be positive, got {times}")
        with self._lock:
            self._armed[site] = self._armed.get(site, 0) + times

    def arm_slow(
        self,
        site: str,
        sleep_ms: Optional[float] = None,
        stuck: bool = False,
        times: int = 1,
    ) -> None:
        """Arm a slowness site: each of the next ``times`` consultations of
        :meth:`maybe_sleep` delays ``sleep_ms`` milliseconds, or — with
        ``stuck`` — blocks until the site is disarmed/reset (capped at
        :data:`STUCK_CAP_S`)."""
        if times <= 0:
            raise ValueError(f"times must be positive, got {times}")
        if not stuck and sleep_ms is None:
            raise ValueError("arm_slow needs sleep_ms or stuck=True")
        sleep_s = 0.0 if sleep_ms is None else float(sleep_ms) / 1000.0
        with self._lock:
            self._slow[site] = [times, sleep_s, bool(stuck)]

    def disarm(self, site: str) -> None:
        with self._lock:
            self._armed.pop(site, None)
            self._slow.pop(site, None)
            wake, self._wake = self._wake, threading.Event()
        wake.set()

    def reset(self) -> None:
        """Disarm everything and zero fire counts (test teardown); wakes
        every in-flight sleep/stuck block."""
        with self._lock:
            self._armed.clear()
            self._slow.clear()
            self._fired.clear()
            wake, self._wake = self._wake, threading.Event()
        wake.set()

    def load_env(self, env: Optional[dict] = None) -> None:
        """Arm from ``KETO_FAULTS`` (see the module docstring syntax)."""
        raw = (env if env is not None else os.environ).get("KETO_FAULTS", "")
        for entry in raw.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0].strip()
            mods = [p.strip() for p in parts[1:]]
            if not mods:
                self.arm(site)
            elif mods[0] == "stuck":
                self.arm_slow(site, stuck=True)
            elif mods[0].startswith("sleep="):
                ms = float(mods[0][len("sleep=") :])
                times = int(mods[1]) if len(mods) > 1 else 1
                self.arm_slow(site, sleep_ms=ms, times=times)
            else:
                self.arm(site, int(mods[0]))

    # -- introspection --------------------------------------------------------

    def armed(self, site: str) -> int:
        with self._lock:
            return self._armed.get(site, 0)

    def slow_armed(self, site: str) -> int:
        with self._lock:
            spec = self._slow.get(site)
            return spec[0] if spec else 0

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def snapshot(self) -> dict:
        """The armed state, for shipping across a process boundary
        (replica respawn commands carry this). Fail-stop sites map to a
        remaining count; slowness sites to a param dict — :meth:`load`
        accepts both shapes."""
        with self._lock:
            snap: dict = dict(self._armed)
            for site, (times, sleep_s, stuck) in self._slow.items():
                snap[site] = {
                    "times": times,
                    "sleep_ms": sleep_s * 1000.0,
                    "stuck": stuck,
                }
            return snap

    def load(self, armed: dict) -> None:
        """Replace the armed state wholesale (the receiving end of
        :meth:`snapshot`)."""
        with self._lock:
            self._armed = {
                k: int(v)
                for k, v in armed.items()
                if not isinstance(v, dict) and int(v) > 0
            }
            self._slow = {
                k: [
                    int(v["times"]),
                    float(v["sleep_ms"]) / 1000.0,
                    bool(v.get("stuck", False)),
                ]
                for k, v in armed.items()
                if isinstance(v, dict) and int(v["times"]) > 0
            }

    # -- firing ---------------------------------------------------------------

    def should_fire(self, site: str) -> bool:
        """Consume one armed count for ``site``; the caller applies the
        fault itself (drop a frame, corrupt a result)."""
        with self._lock:
            remaining = self._armed.get(site, 0)
            if remaining <= 0:
                return False
            if remaining == 1:
                del self._armed[site]
            else:
                self._armed[site] = remaining - 1
            self._fired[site] = self._fired.get(site, 0) + 1
            return True

    def fire(self, site: str) -> None:
        """Raise :class:`FaultInjected` if ``site`` is armed."""
        if self.should_fire(site):
            raise FaultInjected(site)

    def maybe_sleep(self, site: str) -> float:
        """Consume one slowness arming for ``site`` and block accordingly:
        ``sleep_ms`` waits that long, ``stuck`` waits until disarm/reset
        (capped at :data:`STUCK_CAP_S`). Either wait ends early when the
        registry is disarmed/reset. Returns the seconds this call was
        configured to stall (0.0 when unarmed) — the cost of an unarmed
        site is one dict lookup under the lock."""
        with self._lock:
            spec = self._slow.get(site)
            if spec is None:
                return 0.0
            spec[0] -= 1
            if spec[0] <= 0:
                del self._slow[site]
            _, sleep_s, stuck = spec
            self._fired[site] = self._fired.get(site, 0) + 1
            wake = self._wake
        delay = STUCK_CAP_S if stuck else sleep_s
        wake.wait(delay)
        return delay


#: The process-wide registry every production fault site consults.
FAULTS = FaultRegistry(env=os.environ)
