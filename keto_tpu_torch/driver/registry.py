"""Service registry (counterpart of ``keto_tpu/driver/registry.py``,
trimmed): lazily built, memoized providers for the namespace manager, the
store, the snapshot manager, the check engine and the check batcher (with
its result caches, per-namespace qos and the overload plane), the
id-native encoded front, the expand and list engines, the snaptokens, and
the two planes that ``start_all`` brings up. Each plane's public port
answers REST and, when ``grpc`` and ``google.protobuf`` import, gRPC too;
without them the planes serve REST alone, ``start_all`` logs one line
saying why, and ``grpc_enabled`` stays False.

``Registry(config, device=None)`` runs its engines on the CUDA card unless
the caller passes ``device="cpu"``; without CUDA it raises.

The multi-device tiers (``parallel/``), dispatched as the reference does:
``engine.mode: sharded`` builds ``ShardedCheckEngine`` on ``engine.mesh.*``;
``engine.sharding.enabled`` (in any mode but ``host``) builds
``ShardedServingEngine`` on ``engine.sharding.*`` when the mesh has at least
two devices, and otherwise logs "engine.sharding enabled but mesh has one
device; serving single-chip" and falls through to the engine of
``engine.mode``. The mesh's devices are every CUDA device
(``torch.cuda.device_count()``), or on a CPU registry the one CPU; the
``mesh_devices`` argument names them instead (the tests' ``[cpu] * 8``,
the port's counterpart of the reference's ``XLA_FLAGS`` virtual devices; a
device may repeat).

The store is the DSN's (``store()``): ``memory``, ``columnar``, or a SQL
database (``sqlite://``, ``postgres://``, ``cockroach://``, ``mysql://``;
``persistence/``). With ``store.wal.dir`` set, the memory and columnar
stores are wrapped in the durable write plane (``store/durable.py``: the
WAL, checkpoints, boot recovery); ``start_all`` seeds the snapshot CSR from
the recovered checkpoint and ``stop_all`` cuts a final checkpoint.

``serve.read.workers`` N > 1 serves the read port from N processes: after
the warmup ``start_all`` forks N - 1 read replicas (``driver/replicas.py``)
that share the read port through ``SO_REUSEPORT``, then binds its own
planes. A SQL store's state is the database, so it spawns N - 1 fresh
worker interpreters instead (``driver/spawn_workers.py``). A forked child
must not touch CUDA, so with ``engine.query_mode: auto`` the closure engine
is built in host query mode; any other engine (a device query mode, the
frontier engines, the host oracle) serves from one process when the store
is process-private, and ``start_all`` logs one line saying so.

The device-aware planes wrap every device engine as the reference's
defaults do: ``checker()`` puts the circuit breaker
(``engine/fallback.py``, ``engine.fallback``) between the batcher and the
engine, with the host oracle behind it and the ``DeviceSupervisor`` below
(``engine.failover.*``) on its lost-device hook; the batcher and the closure
engine's background rebuild share one ``HbmAdmission``
(``engine.memory.*``); ``scrubber()`` builds the integrity scrubber
(``scrub.*``), started by ``start_all`` after any replica fork; and the read
port serves ``/debug`` (``api/debug.py``, ``debug.*``). The breaker drives
readiness: REST ``/health/ready`` and, with gRPC, the health service.

Config and the public port: ``start_all`` applies ``log.level`` and
``log.format`` (``telemetry/logging.py``), serves each plane's port with TLS
when ``serve.<plane>.tls.{cert,key}.path`` are set (``_ssl_context``, ALPN
``h2`` and ``http/1.1``) and CORS from ``serve.<plane>.cors``, and, with a
config file, starts the config watcher (``_start_config_watcher``): a
changed file reloads (``Config.reload``); a reload of ``log`` re-applies
it, an edited hot engine knob reaches its live component through
``_hot_knob_appliers`` (the batcher's ``reconfigure``, the encoded cache's
``resize``, HBM admission's ``set_budget_frac``, the expand and list page
size, the sharded tier's escalation budget), ``scrub.enabled`` or
``autotune.enabled`` turned on starts the scrubber or the autotuner, and
``overload.enabled`` is read per decision (a live kill switch).
``serve.read.max_freshness_wait_s`` is read per wait; a reload of
``tracing`` reconfigures the live tracer (``Tracer.reconfigure``).

The online autotuner (``autotuner()``, ``engine/autotune.py``,
``autotune.*``) moves the knobs of its table (``encode_workers``,
``pipeline_depth``, ``encoded_cache_size``, ``hbm_budget_frac``,
``escalation_budget`` on the sharded tier, ``expand_page_size`` when
paging is on, and the advertised ``hedge_delay_ms``) through
``_apply_hot_knob``: ``Config.set_hot``, then the same appliers. It reads
the attribution ledger and the SLO, freezes on the breaker and on HBM
pressure, and serves ``/debug/autotune``; ``start_all`` starts its thread
after any fork when ``autotune.enabled`` is on, and ``stop_all`` stops it
before the batcher closes.

Telemetry (``telemetry/``), as the reference wires it: ``metrics()`` is the
one ``MetricsRegistry`` every component reports into (with the store
gauges, the recovery families, ``DEVSTATS.bind`` and the WAL's
append-error counter), served at ``GET /metrics`` on both planes;
``tracer()`` (``tracing.*``), ``flight()``, ``slo()``, ``attribution()``
and ``check_telemetry()`` (``telemetry.*``) make the per-request seam the
REST read API and the gRPC servicers open around each check; ``profiler()``
is the sampling profiler behind ``/debug/pprof``, whose thread ``start_all``
starts after any fork and only with ``telemetry.profiler.enabled``.

``serve.read.wire_workers`` W > 1 (while ``serve.read.encoded`` is on)
makes the pool max(N, W) processes whose encoded routes funnel into this
process's one batcher over a shared-memory ring (``engine/shmring.py``):
each forked child's encoded front ships its batches to ``_ring_handler``
here, and answers every other route from its own engine. As in the
reference, ``auto`` turns to host query mode for ``serve.read.workers``
alone, so wire workers need ``engine.query_mode: host`` (or workers > 1);
otherwise ``start_all`` serves single-process with the same one line.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Optional

import torch

from .. import __version__
from ..api.daemon import PlaneServer
from ..api.rest import build_read_router, build_write_router
from ..engine.batcher import CheckBatcher, DirectChecker
from ..engine.cache import CheckResultCache
from ..engine.check import CheckEngine
from ..faults import FAULTS
from ..graph.snapshot import SnapshotManager
from ..store.columnar import ColumnarTupleStore
from ..store.memory import InMemoryTupleStore
from ..utils.errors import ErrMalformedInput
from ..utils.kernels import resolve_device
from .config import Config

_GRPC_SIZE_KEYS = (
    "serve.read.grpc-max-message-size",
    "serve.write.grpc-max-message-size",
)

_log = logging.getLogger("keto_tpu_torch")

_CONFIG_POLL_S = 1.0  # the config watcher's mtime poll

# how long start_all waits for transient threads (a closure rebuild, the
# overlay's groupings warm) to end before forking read replicas, and how
# long one unchanged offender may persist before it gives up early
_FORK_QUIESCE_S = 180.0
_FORK_STABLE_S = 2.0


class DeviceSupervisor:
    """Device-loss recovery and runtime backend failover (counterpart of
    ``keto_tpu/driver/registry.py DeviceSupervisor``).

    The breaker (engine/fallback.py) classifies a lost-device launch error,
    forces its circuit open (a real error's batches fail typed meanwhile;
    an injected one's are answered by the host oracle) and calls
    :meth:`notify_device_lost`. This supervisor then runs the recovery loop
    on a daemon thread:

    1. probe the home backend (``cuda``) in a fresh child process under
       ``probe_timeout_s``: ``python -c "import torch; print(
       torch.cuda.device_count())"``, spawned, never forked, so a wedged
       driver hangs the child and the timeout kills it
       (``backend.probe_hang`` drills exactly that);
    2. on probe success: drop every device-resident artifact
       (``engine.reset_residency()``), re-warm the kernels, and collapse
       the breaker's open window so the next batch is the half-open probe;
    3. on probe failure: fail over to the CPU and keep re-probing the home
       backend with exponential backoff; when it answers, swap home again.

    The CPU failover is the port's own host residency, not a default
    device: the reference repoints JAX's default device, but the port's
    engines carry an explicit device, and a plain-kernel build on the host
    CPU would take minutes at scale. So the swap puts the closure engine in
    host query mode (``set_host_queries(True)``), whose re-init builds D
    with the numpy semiring builder and answers with no device work;
    homecoming restores the placement it had and rebuilds on the card.
    Answers do not change. An engine without a host residency (the
    frontier engines) cannot fail over: it waits for the card.

    Readiness stays NOT_SERVING from the loss until the homecoming: while
    a recovery runs and for as long as ``backend`` is not the home
    platform (:meth:`serving_ok`; ``on_change`` re-syncs the registry's
    health at each transition). A host residency answers, but a balancer
    must not take this process for a healthy card.

    A sticky CUDA error (an illegal address, a device-side assert) poisons
    this process's context while a fresh child still sees a healthy card:
    the probe succeeds and the re-init fails. The loop then backs off and
    retries, and each attempt lands in the timeline as ``reinit_failed``.

    Every transition logs and lands in the failover timeline that
    ``/debug/device`` serves.
    """

    _TIMELINE_CAP = 64
    _PROBE_CODE = "import torch; print(torch.cuda.device_count())"

    def __init__(
        self,
        engine,
        warm_batch: int = 1,
        enabled: bool = True,
        probe_mode: str = "child",  # child | inproc
        probe_timeout_s: float = 10.0,
        probe_interval_s: float = 0.5,
        max_backoff_s: float = 30.0,
        allow_cpu_failover: bool = True,
        home_platform: str = "cuda",
        clock=time.monotonic,
        on_change=None,
        metrics=None,
        flight=None,
    ):
        self.engine = engine
        self._flight = flight
        self._m_failovers = self._m_recovery = None
        if metrics is not None:
            from ..telemetry.metrics import device_failover_metrics

            self._m_failovers, self._m_recovery = device_failover_metrics(metrics)
        self._on_change = on_change
        self._recovering = False
        self.warm_batch = max(1, int(warm_batch))
        self.enabled = bool(enabled)
        self.probe_mode = probe_mode
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe_interval_s = max(0.05, float(probe_interval_s))
        self.max_backoff_s = max(self.probe_interval_s, float(max_backoff_s))
        self.allow_cpu_failover = bool(allow_cpu_failover)
        self._clock = clock
        self._breaker = None
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._timeline: list[dict] = []
        self._last_recovery_s: Optional[float] = None
        self._failovers = 0
        self.home_platform = home_platform
        self.backend = home_platform  # the current serving backend
        # the engine's query placement before a CPU failover, restored on
        # homecoming
        self._home_host: Optional[bool] = None

    def bind_breaker(self, breaker) -> None:
        """Late-bound: the registry builds the breaker after the supervisor
        (the breaker's constructor takes the notify callback)."""
        self._breaker = breaker

    # -- event intake ----------------------------------------------------------

    def notify_device_lost(self, err) -> None:
        """Called by the breaker when a launch failed with a lost device.
        Idempotent while a recovery is already running."""
        if not self.enabled:
            return
        with self._lock:
            if self._recovering:
                return  # recovery already in flight
            self._recovering = True
            self._failovers += 1
            self._worker = threading.Thread(
                target=self._recover,
                args=(str(err), self._clock()),
                name="device-supervisor",
                daemon=True,
            )
            worker = self._worker
        if self._m_failovers is not None:
            self._m_failovers.inc()
        self._event("device_lost", error=str(err))
        _log.warning("device lost (%s); recovering", err)
        self._changed()
        worker.start()

    def stop(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=5)

    # -- recovery loop ---------------------------------------------------------

    def _recover(self, error: str, t_lost: float) -> None:
        try:
            self._recover_loop(t_lost)
        finally:
            with self._lock:
                self._recovering = False
            self._changed()

    def _recover_loop(self, t_lost: float) -> None:
        backoff = self.probe_interval_s
        swapped = failed_over = False
        while not self._stop.is_set():
            ok, detail = self._probe_backend(self.home_platform)
            self._event("probe", backend=self.home_platform, ok=ok, detail=detail)
            if ok:
                if self._reinit(self.home_platform, homecoming=swapped):
                    self.backend = self.home_platform
                    recovery_s = self._clock() - t_lost
                    self._last_recovery_s = recovery_s
                    if self._m_recovery is not None:
                        self._m_recovery.observe(recovery_s)
                    self._event(
                        "recovered",
                        backend=self.home_platform,
                        recovery_s=round(recovery_s, 3),
                    )
                    _log.info(
                        "device recovered; serving on %s after %.3fs",
                        self.home_platform, recovery_s,
                    )
                    return
            elif (
                self.allow_cpu_failover
                and not failed_over
                and self.home_platform != "cpu"
            ):
                # the home backend is gone for now: serve from host memory
                # instead of failing every batch
                if not swapped and self._swap_to("cpu"):
                    # the backend moves before the re-init's forced probe
                    # can close the breaker: readiness never sees a window
                    # where the host residency passes for the card
                    self.backend = "cpu"
                    swapped = True
                if swapped and self._reinit("cpu"):
                    failed_over = True
                    self._event("failover", backend="cpu")
                    _log.warning(
                        "home backend %s unavailable; serving from a host "
                        "residency", self.home_platform,
                    )
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, self.max_backoff_s)

    def _probe_backend(self, platform: str) -> tuple[bool, str]:
        """Is ``platform`` usable? By default in a fresh child process: a
        wedged driver hangs the CHILD, the timeout kills it, and the verdict
        is an ordinary failure. The CPU is always usable."""
        if FAULTS.should_fire("backend.probe_hang"):
            # stands in for the child blocking past its timeout and being
            # killed — deterministic, no real child to wedge
            return False, "probe hung; child killed (injected)"
        if platform != "cuda":
            return True, "host"
        if self.probe_mode == "inproc":
            try:
                import torch

                n = torch.cuda.device_count()
                return n > 0, f"{n} devices"
            except Exception as e:
                return False, str(e)[-200:]
        import subprocess
        import sys

        try:
            out = subprocess.run(
                [sys.executable, "-c", self._PROBE_CODE],
                capture_output=True,
                text=True,
                timeout=self.probe_timeout_s,
            )
        except subprocess.TimeoutExpired:
            return False, f"probe child killed after {self.probe_timeout_s}s"
        except OSError as e:
            return False, str(e)[-200:]
        if out.returncode != 0:
            return False, (out.stderr or "").strip()[-200:] or f"rc={out.returncode}"
        try:
            return int(out.stdout.strip()) > 0, out.stdout.strip() + " devices"
        except ValueError:
            return False, f"unparseable probe output {out.stdout!r}"

    def _swap_to(self, platform: str) -> bool:
        """Move the engine's residency to host memory (``cpu``) or back to
        the placement it had (home)."""
        place = getattr(self.engine, "set_host_queries", None)
        if place is None or getattr(self.engine, "builder", None) != "semiring":
            # no host residency to fail over to (a frontier engine), or one
            # whose host build runs on the device (the matmul builder)
            self._event(
                "swap_failed", backend=platform,
                error="the engine has no host residency",
            )
            return False
        try:
            if platform == "cpu":
                if self._home_host is None:
                    self._home_host = self.engine.host_queries()
                place(True)
            else:
                place(bool(self._home_host))
            return True
        except Exception as e:
            self._event("swap_failed", backend=platform, error=str(e)[-200:])
            return False

    def _reinit(self, platform: str, homecoming: bool = False) -> bool:
        """Teardown + re-init on ``platform``: restore the home placement
        when coming back from a failover, drop and rebuild the residency,
        re-warm the kernels, then collapse the breaker's open window so the
        next batch is the half-open probe."""
        try:
            if homecoming and not self._swap_to(platform):
                return False
            reset = getattr(self.engine, "reset_residency", None)
            if reset is not None:
                reset()
            warmup = getattr(self.engine, "warmup", None)
            if warmup is not None:
                warmup(self.warm_batch)
            breaker = self._breaker
            if breaker is not None:
                breaker.force_probe()
            return True
        except Exception as e:
            self._event("reinit_failed", backend=platform, error=str(e)[-200:])
            _log.warning("device re-init on %s failed: %s", platform, e)
            return False

    def reset_residency(self) -> bool:
        """Public quarantine + re-upload seam (the scrubber's device repair):
        tear down the residency and re-warm on the CURRENT backend — no
        probing, no failover bookkeeping."""
        t0 = time.perf_counter()
        ok = self._reinit(self.backend)
        self._event(
            "scrub_reset_residency", backend=self.backend, ok=ok,
            seconds=round(time.perf_counter() - t0, 6),
        )
        return ok

    # -- introspection ---------------------------------------------------------

    def serving_ok(self) -> bool:
        """Readiness from the supervisor's side: no recovery running, and
        serving on the home platform."""
        with self._lock:
            return not self._recovering and self.backend == self.home_platform

    def _changed(self) -> None:
        cb = self._on_change
        if cb is not None:
            cb()

    def _event(self, event: str, **fields) -> None:
        entry = {"t": time.time(), "event": event, **fields}
        with self._lock:
            self._timeline.append(entry)
            del self._timeline[: -self._TIMELINE_CAP]
        if self._flight is not None:
            try:
                self._flight.record(kind="device_failover", **entry)
            except Exception:
                pass

    def status(self) -> dict:
        with self._lock:
            timeline = list(self._timeline)
            recovering = self._recovering
        return {
            "enabled": self.enabled,
            "backend": self.backend,
            "home_platform": self.home_platform,
            "recovering": recovering,
            "failovers": self._failovers,
            "last_recovery_s": self._last_recovery_s,
            "timeline": timeline,
        }


class _Readiness:
    """The health object the device breaker drives: it moves the registry's
    readiness (REST ``/health/ready``) and, when the gRPC plane is up, its
    health service, as the reference's ``HealthServicer`` does both."""

    def __init__(self, registry: "Registry"):
        self._registry = registry

    def set_serving(self, serving: bool) -> None:
        self._registry._breaker_ok = bool(serving)
        self._registry._sync_health()


class Registry:
    def __init__(self, config: Optional[Config] = None, device=None, mesh_devices=None):
        self.config = config if config is not None else Config()
        self.device = resolve_device(device)
        # the devices a sharded tier's mesh spans; None = mesh_devices()'s
        # default
        self._mesh_devices = list(mesh_devices) if mesh_devices is not None else None
        self.version = __version__
        self._lock = threading.RLock()  # providers are built once
        self._namespace_manager = None
        self._store = None
        self._snapshots: Optional[SnapshotManager] = None
        self._check_engine = None
        self._checker = None
        self._qos = None
        self._overload = None
        self._encoded_front = None
        self._expand_engine = None
        self._list_engine = None
        self._read_plane: Optional[PlaneServer] = None
        self._write_plane: Optional[PlaneServer] = None
        # the read-replica pool and the fixed (read, gRPC) ports every pool
        # process binds with SO_REUSEPORT; None / (0, 0) when single-process
        self._replica_pool = None
        self._shared_read_ports: tuple[int, int] = (0, 0)
        # the wire workers' shared-memory ring (engine/shmring.py) and its
        # parent-side consumer, set when serve.read.wire_workers > 1 forked;
        # the ring client is set in a forked wire worker only
        self._wire_ring = None
        self._wire_ring_client = None
        self._ring_server = None
        self._ring_parent_front = None
        self._serving = False  # readiness: flips only after bring-up
        # whether start_all seeded the snapshot CSR from a checkpoint
        self.csr_primed = False
        # the device-aware planes: the breaker at the checker seam, the
        # supervisor on its lost-device hook, the memory admission, the
        # scrubber and the /debug context; the breaker clears _breaker_ok
        # while its circuit is open
        self._engine_breaker = None
        self._device_supervisor = None
        self._hbm_admission = None
        self._scrubber = None
        # the online autotuner (engine/autotune.py): built by autotuner(),
        # its thread started by start_all after any fork, or by a reload
        # that turns autotune.enabled on
        self._autotuner = None
        # the reply-stage virtual knob: the hedge delay this server
        # advertises (/debug/autotune; clients adopt it with
        # HedgePolicy.advertise). It starts at the client's cold default,
        # so an untuned server recommends nothing aggressive
        self._hedge_advertised_ms = 1000.0
        self._debug_context = None
        self._breaker_ok = True
        self._readiness = _Readiness(self)
        # the gRPC plane: its builders module once probed (None when grpc or
        # google.protobuf do not import), why it is off, and the health
        # service both planes share
        self._grpc_probed = False
        self._grpc_api = None
        self.grpc_off_reason = ""
        self._health = None
        self._config_watcher: Optional[threading.Thread] = None
        self._config_watch_stop = threading.Event()
        # telemetry (telemetry/): each built on first use
        self._logger = None
        self._tracer = None
        self._metrics = None
        self._flight = None
        self._slo = None
        self._attribution = None
        self._profiler = None
        self._check_telemetry = None
        # the fleet (replication/, cluster/, telemetry/federation.py): the
        # leader's replication source, the follower's replicator, the
        # membership and federation on the leader, the heartbeater on a
        # follower, the election and the feed a promoted follower serves
        self._replication_source = None
        self._replicator = None
        self._cluster_membership = None
        self._cluster_heartbeater = None
        self._federation = None
        self._election = None
        self._promoted_source = None
        self._cluster_instance_id = ""
        self._bound_read_port = 0
        self._bound_write_port = 0
        # a follower's bootstrap: the checkpoint seed's bytes and seconds,
        # and start_all's warmup (the encode and the closure build) after it;
        # and its last promotion's report and seconds
        self.follower_boot: dict = {}
        self.last_promotion: dict = {}

    # -- telemetry providers ---------------------------------------------------

    def logger(self):
        """The package's structured ``server`` logger (``log.*`` applies to
        it at start_all)."""
        if self._logger is None:
            from ..telemetry.logging import get_logger

            self._logger = get_logger("server")
        return self._logger

    def tracer(self):
        """The span tracer (``tracing.provider``: "" keeps spans in the
        in-process ring, "log" also logs each at debug, "otlp" also ships
        them to ``tracing.otlp.endpoint``)."""
        with self._lock:
            if self._tracer is None:
                from ..telemetry.tracing import Tracer

                self._tracer = Tracer(logger=self.logger(), **self._tracing_config())
            return self._tracer

    def _tracing_config(self) -> dict:
        cfg = self.config
        return {
            "provider": str(cfg.get("tracing.provider", default="") or ""),
            "otlp_endpoint": str(cfg.get("tracing.otlp.endpoint", default="") or ""),
            "service_name": str(
                cfg.get("tracing.otlp.service_name", default="keto-tpu") or "keto-tpu"
            ),
        }

    def metrics(self):
        """The metrics registry every component reports into, with the
        store's gauges, the durable store's recovery families and the
        device collector (``DEVSTATS.bind``, which repoints at the newest
        registry) registered here."""
        with self._lock:
            if self._metrics is None:
                from ..telemetry.devstats import DEVSTATS
                from ..telemetry.metrics import MetricsRegistry, recovery_metrics

                m = MetricsRegistry()
                store = self.store()
                m.gauge(
                    "keto_store_version",
                    "monotonic store write version (the snaptoken)",
                    fn=lambda: store.version,
                )
                m.gauge(
                    "keto_store_tuples",
                    "live relation tuples in the store",
                    fn=lambda: len(store),
                )
                m.gauge(
                    "keto_check_staleness_versions",
                    "store versions the check engine lags behind (bounded "
                    "freshness rebuilds in progress)",
                    fn=self._staleness,
                )
                if hasattr(store, "recovery"):
                    replayed, seconds, _age, gap = recovery_metrics(
                        m, checkpoint_age_fn=store.checkpoint_age_s
                    )
                    rep = store.recovery
                    replayed.inc(rep.replayed_deltas)
                    seconds.set(rep.duration_s)
                    gap.set(1.0 if rep.gap else 0.0)
                    # registered here, not in _wrap_durable (the reference's
                    # place): the store is built before the metrics
                    append_errors = m.counter(
                        "keto_wal_append_errors_total",
                        "WAL append failures (the write was NOT acked and the "
                        "durable wrapper fail-stopped), by errno",
                        labelnames=("errno",),
                    )
                    log_error = store.append_error_cb

                    def _append_error(err):
                        append_errors.labels(
                            errno=str(err) if err is not None else "none"
                        ).inc()
                        if log_error is not None:
                            log_error(err)

                    store.append_error_cb = _append_error
                DEVSTATS.bind(m, graph_panel_fn=self.graph_panel, platform=self.device.type)
                self._metrics = m
            return self._metrics

    def _staleness(self) -> int:
        served = getattr(self._check_engine, "served_version", None)
        if served is None:
            return 0
        return max(0, self.store().version - served())

    def flight(self):
        """The request flight recorder (``telemetry.flight.*``); with a dump
        directory the fatal-path dump (faulthandler and a ring flush) is
        armed too."""
        with self._lock:
            if self._flight is None:
                from ..telemetry.flight import FlightRecorder

                cfg = self.config
                self._flight = FlightRecorder(
                    capacity=int(cfg.get("telemetry.flight.capacity")),
                    dump_dir=str(cfg.get("telemetry.flight.dir") or ""),
                    flush_interval_s=float(cfg.get("telemetry.flight.flush_interval_s")),
                )
                if self._flight.dump_dir:
                    self._flight.install_fatal_dump()
            return self._flight

    def slo(self):
        """The check SLO's burn-rate tracker (``telemetry.slo.*``)."""
        with self._lock:
            if self._slo is None:
                from ..telemetry.slo import SLOTracker

                cfg = self.config
                self._slo = SLOTracker(
                    metrics=self.metrics(),
                    logger=self.logger(),
                    objective=float(cfg.get("telemetry.slo.objective")),
                    latency_target_s=float(cfg.get("telemetry.slo.latency_target_ms")) / 1e3,
                    fast_window_s=float(cfg.get("telemetry.slo.fast_window_s")),
                    slow_window_s=float(cfg.get("telemetry.slo.slow_window_s")),
                    alert_burn_rate=float(cfg.get("telemetry.slo.alert_burn_rate")),
                    alert_cooldown_s=float(cfg.get("telemetry.slo.alert_cooldown_s")),
                )
            return self._slo

    def attribution(self):
        """The wall-clock attribution aggregate: every finished check folds
        its stage ledger in (``keto_time_attribution_seconds_total`` and
        ``/debug/attribution``)."""
        with self._lock:
            if self._attribution is None:
                from ..telemetry.attribution import AttributionLedger

                enabled = bool(self.config.get("telemetry.attribution.enabled"))
                self._attribution = AttributionLedger(
                    metrics=self.metrics() if enabled else None
                )
            return self._attribution

    def profiler(self):
        """The sampling profiler behind ``/debug/pprof``. Its thread starts
        in start_all, after any replica fork, and only with
        ``telemetry.profiler.enabled``."""
        with self._lock:
            if self._profiler is None:
                from ..telemetry.profiler import SamplingProfiler

                self._profiler = SamplingProfiler(
                    hz=float(self.config.get("telemetry.profiler.hz")),
                    max_stacks=int(self.config.get("telemetry.profiler.max_stacks")),
                )
            return self._profiler

    def check_telemetry(self):
        """The per-request seam (span, exemplar, SLO, flight record,
        attribution ledger) the REST read API and the gRPC servicers open
        around each check."""
        with self._lock:
            if self._check_telemetry is None:
                from ..telemetry.flight import CheckTelemetry

                self._check_telemetry = CheckTelemetry(
                    metrics=self.metrics(),
                    tracer=self.tracer(),
                    flight=self.flight(),
                    slo=self.slo(),
                    slow_s=float(self.config.get("telemetry.flight.slow_ms")) / 1e3,
                    stages_fn=self._stage_percentiles,
                    attribution=self.attribution(),
                    role=self.replication_role(),
                )
            return self._check_telemetry

    def _stage_percentiles(self):
        """Per-stage p50/p95 from the pipeline histogram: the stage timings
        a flight record carries."""
        m = self._metrics
        h = m.get("keto_pipeline_stage_seconds") if m is not None else None
        if h is None:
            return None
        out = {}
        for labels, child in h._series():
            if child.count == 0:
                continue
            out[labels.get("stage", "?")] = {
                "p50_ms": round(child.percentile(0.50) * 1000, 3),
                "p95_ms": round(child.percentile(0.95) * 1000, 3),
                "count": child.count,
            }
        return out or None

    def _build_phases(self):
        """The last closure build's phase seconds (``last_build_phases``):
        ``/debug/attribution``'s view of the one-off build cost."""
        return getattr(self._check_engine, "last_build_phases", None)

    # -- providers -------------------------------------------------------------

    def namespace_manager(self):
        with self._lock:
            if self._namespace_manager is None:
                self._namespace_manager = self.config.namespace_manager()
            return self._namespace_manager

    def store(self):
        """The tuple store the DSN names, as the reference's dispatch does:
        ``memory``, ``columnar``, ``sqlite://<path>``, ``postgres://`` (and
        ``postgresql://``), ``cockroach://`` and ``mysql://`` (or
        ``mysql+fake://``, the in-tree shim). The memory and columnar stores
        are wrapped in the durable write plane when ``store.wal.dir`` is
        set (``_wrap_durable``)."""
        with self._lock:
            if self._store is None:
                self._store = self._wrap_durable(self._open_store(self.config.dsn()))
            return self._store

    def _open_store(self, dsn: str):
        nsm = self.namespace_manager()
        if dsn in ("memory", "sqlite://:memory:", ""):
            return InMemoryTupleStore(namespace_manager=nsm)
        if dsn == "columnar":
            return ColumnarTupleStore(namespace_manager=nsm)
        from ..persistence.dialect import dialect_for_dsn

        try:
            dialect, native = dialect_for_dsn(dsn)
        except ValueError:
            raise ErrMalformedInput(
                f"unsupported DSN {dsn!r}: keto_tpu_torch supports 'memory', "
                "'columnar', 'sqlite://<path>', 'postgres://...', "
                "'cockroach://...' and 'mysql://...'"
            ) from None
        from ..persistence.sqlstore import SQLTupleStore

        # a missing driver (mysql without pymysql, postgres behind a server
        # that refuses the session) is a configuration error
        try:
            return SQLTupleStore(dialect, native, namespace_manager=nsm)
        except RuntimeError as e:
            raise ErrMalformedInput(str(e)) from e

    def _wrap_durable(self, store):
        """The durable write plane (store/durable.py: WAL append before ack,
        atomic checkpoints, boot recovery) over the memory and columnar
        stores when ``store.wal.dir`` is set. A SQL store is durable
        already: the knob is logged and ignored, as the reference does. A
        replication follower skips the wrap: its durability is the leader's
        WAL, and replicated deltas apply through the plain store's
        ``apply_replicated_delta``."""
        wal_dir = str(self.config.get("store.wal.dir") or "")
        if self.replication_role() == "follower":
            if wal_dir:
                self.logger().warn(
                    "store.wal.dir is set but this node is a replication "
                    "follower; the leader's WAL is the durability "
                    "authority — ignoring the local WAL config",
                )
            return store
        if not wal_dir:
            return store
        if not getattr(store, "process_private", False):
            _log.warning(
                "store.wal.dir is set but the DSN %r is SQL-backed; the "
                "database is already durable, ignoring the WAL config",
                self.config.dsn(),
            )
            return store
        from ..store.durable import DurableTupleStore
        from ..store.wal import WalError

        cfg = self.config
        try:
            durable = DurableTupleStore(
                store,
                wal_dir,
                checkpoint_dir=str(cfg.get("checkpoint.dir") or "") or None,
                sync=str(cfg.get("store.wal.sync")),
                sync_interval_ms=float(cfg.get("store.wal.sync-interval-ms")),
                segment_bytes=int(cfg.get("store.wal.segment-bytes")),
                checkpoint_interval_versions=int(cfg.get("checkpoint.interval-versions")),
                checkpoint_interval_s=float(cfg.get("checkpoint.interval-s")),
                checkpoint_keep=int(cfg.get("checkpoint.keep")),
            )
        except WalError as e:
            raise ErrMalformedInput(str(e)) from e
        durable.append_error_cb = lambda err: _log.error(
            "WAL append failed (errno %s): the write was not acked and the "
            "durable store fail-stopped", err,
        )
        rep = durable.recovery
        (_log.error if rep.gap else _log.info)(
            "store recovery complete%s: checkpoint version %d, %d deltas "
            "replayed, final version %d, %.3fs (checkpoint %.3fs, replay "
            "%.3fs), torn tail %d bytes%s",
            " WITH A WAL GAP, serving possibly-stale state" if rep.gap else "",
            rep.checkpoint_version, rep.replayed_deltas, rep.final_version,
            rep.duration_s, rep.checkpoint_s, rep.replay_s, rep.torn_tail_bytes,
            (": " + "; ".join(rep.notes)) if rep.notes else "",
        )
        return durable

    def snapshots(self) -> SnapshotManager:
        with self._lock:
            if self._snapshots is None:
                self._snapshots = SnapshotManager(self.store())
            return self._snapshots

    def check_engine(self):
        with self._lock:
            if self._check_engine is None:
                self._check_engine = self._build_check_engine()
            return self._check_engine

    def mesh_devices(self) -> list:
        """The devices a sharded tier's mesh spans: the ``mesh_devices``
        the registry was given, else every CUDA device on a CUDA registry,
        else this registry's one device."""
        if self._mesh_devices is not None:
            return list(self._mesh_devices)
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [self.device]

    def _build_check_engine(self):
        cfg = self.config
        max_depth = cfg.read_api_max_depth()
        mode = cfg.engine_mode()
        if bool(cfg.get("engine.sharding.enabled")) and mode != "host":
            # the sharded serving tier: live check traffic through the
            # node-striped mesh closure engine. A one-device mesh falls
            # through to the single-device engines below: sharding with no
            # stripes to spread is pure overhead
            devices = self.mesh_devices()
            if len(devices) >= 2:
                from ..parallel import ShardedServingEngine, make_mesh

                return ShardedServingEngine(
                    self.snapshots(),
                    mesh=make_mesh(
                        devices,
                        data=int(cfg.get("engine.sharding.data")),
                        edge=int(cfg.get("engine.sharding.edge")) or None,
                    ),
                    max_depth=max_depth,
                    edge_chunk=int(cfg.get("engine.sharding.edge_chunk")),
                    escalation_budget=float(cfg.get("engine.sharding.escalation_budget")),
                    hbm=self.hbm_admission(),
                    metrics=self.metrics(),
                    logger=self.logger(),
                )
            self.logger().info(
                "engine.sharding enabled but mesh has one device; serving single-chip",
                devices=len(devices),
            )
        if mode == "sharded":
            from ..parallel import ShardedCheckEngine, make_mesh

            return ShardedCheckEngine(
                self.snapshots(),
                mesh=make_mesh(
                    self.mesh_devices(),
                    data=int(cfg.get("engine.mesh.data")),
                    edge=int(cfg.get("engine.mesh.edge")) or None,
                ),
                max_depth=max_depth,
            )
        if mode == "host":
            return CheckEngine(self.store(), max_depth=max_depth)
        if mode in ("closure", "auto"):
            query_mode = str(cfg.get("engine.query_mode"))
            if query_mode == "auto" and int(cfg.get("serve.read.workers")) > 1:
                # the replica pool forks children that must never touch
                # CUDA: the host copy of D is the only residency they can
                # serve from
                query_mode = "host"
            from ..engine.closure import ClosureCheckEngine

            return ClosureCheckEngine(
                self.snapshots(),
                max_depth=max_depth,
                interior_limit=int(cfg.get("engine.interior_limit")),
                query_mode=query_mode,
                builder=str(cfg.get("engine.closure_builder")),
                block_workers=int(cfg.get("engine.closure_block_workers")),
                freshness=str(cfg.get("engine.freshness")),
                strong_freshness_edges=int(cfg.get("engine.strong_freshness_edges")),
                rebuild_debounce_s=float(cfg.get("engine.rebuild_debounce_ms")) / 1e3,
                rebuild_gate=(
                    hbm.wait_for_headroom
                    if (hbm := self.hbm_admission()) is not None
                    else None
                ),
                device=self.device,
                tracer=self.tracer(),
                metrics=self.metrics(),
            )
        from ..engine.device import DeviceCheckEngine

        # 'device' -> size-based choice; 'dense'/'scatter'/'packed' force it
        return DeviceCheckEngine(
            self.snapshots(),
            max_depth=max_depth,
            mode=mode if mode in ("dense", "scatter", "packed") else "auto",
            dense_threshold=int(cfg.get("engine.dense_threshold")),
            device=self.device,
        )

    def checker(self):
        """The check entry point handlers use: batched on the device
        engines, direct on the host oracle."""
        with self._lock:
            if self._checker is None:
                engine = self.check_engine()
                max_batch = int(self.config.get("engine.max_batch"))
                if isinstance(engine, CheckEngine):
                    self._checker = DirectChecker(engine, max_batch=max_batch)
                else:
                    cfg = self.config
                    cache_size = int(cfg.get("engine.cache_size"))
                    if bool(cfg.get("engine.fallback")):
                        # the breaker wraps the engine at THIS seam only: the
                        # rest of the registry (the fork, host_queries, the
                        # versions) keeps seeing the raw engine
                        engine = self._wrap_breaker(engine)
                    self._checker = CheckBatcher(
                        engine,
                        max_batch=max_batch,
                        window_s=float(cfg.get("engine.batch_window_us")) / 1e6,
                        max_queue=int(cfg.get("engine.max_queue")),
                        max_freshness_wait_s=self._freshness_cap_s,
                        cache=(
                            CheckResultCache(cache_size, self.metrics())
                            if cache_size > 0 else None
                        ),
                        version_fn=self._answering_version,
                        pipeline_depth=int(cfg.get("engine.pipeline_depth")),
                        encode_workers=int(cfg.get("engine.encode_workers")),
                        encoded_cache_size=int(cfg.get("engine.encoded_cache_size")),
                        qos=self.qos(),
                        overload=self.overload(),
                        hbm=self.hbm_admission(),
                        metrics=self.metrics(),
                        tracer=self.tracer(),
                    )
            return self._checker

    def _freshness_cap_s(self) -> float:
        """The live freshness-wait cap, handed as a callable to the batcher
        and the servers: serve.read.max_freshness_wait_s is hot-reloadable."""
        return float(self.config.get("serve.read.max_freshness_wait_s"))

    def _hot_knob_appliers(self) -> dict:
        """Key -> the callable that installs a new value of a registered hot
        engine knob (config.HOT_ENGINE_KEYS) on the live component. Shared
        by the autotuner's knob table and the config watcher's reload, so a
        reloaded file and a tuner move mean the same write. Rebuilt per
        call, so components built late are picked up; a key whose component
        does not exist in this serving mode is absent
        (engine.sharding.escalation_budget off the sharded tier)."""
        out: dict = {}
        batcher = self._checker
        if isinstance(batcher, CheckBatcher):
            out["engine.pipeline_depth"] = lambda v: batcher.reconfigure(
                pipeline_depth=int(v)
            )
            out["engine.encode_workers"] = lambda v: batcher.reconfigure(
                encode_workers=int(v)
            )
            if batcher.encoded_cache is not None:
                out["engine.encoded_cache_size"] = (
                    lambda v: batcher.encoded_cache.resize(int(v))
                )
        hbm = self._hbm_admission
        if hbm is not None:
            out["engine.memory.hbm_budget_frac"] = lambda v: hbm.set_budget_frac(float(v))
        engine = self._check_engine
        if engine is not None and hasattr(engine, "escalation_budget"):
            out["engine.sharding.escalation_budget"] = lambda v: setattr(
                engine, "escalation_budget", float(v)
            )

        def _apply_page_size(v):
            for e in (self._expand_engine, self._list_engine):
                if e is not None and hasattr(e, "default_page_size"):
                    e.default_page_size = int(v)

        out["engine.expand_page_size"] = _apply_page_size
        return out

    def _apply_hot_knob(self, key: str, value) -> None:
        """The autotuner's write path for a config-backed knob: the config's
        validated override first (so /debug/config and a restart agree with
        the live component), then the component's seam."""
        self.config.set_hot(key, value)
        fn = self._hot_knob_appliers().get(key)
        if fn is not None:
            fn(value)

    def autotuner(self):
        """The online autotuner (engine/autotune.py) over this registry's
        knob table. Building it builds the checker first, so the batcher,
        breaker and admission seams exist; its thread starts only in
        start_all (after any fork) or on a reload that turns
        autotune.enabled on."""
        with self._lock:
            if self._autotuner is None:
                self.checker()
                self._autotuner = self._build_autotuner()
            return self._autotuner

    def _build_autotuner(self):
        from ..engine.autotune import AutoTuner, Knob

        cfg = self.config
        overrides = cfg.get("autotune.knobs") or {}

        def build(name: str, **kw) -> Knob:
            o = overrides.get(name) if isinstance(overrides, dict) else None
            if isinstance(o, dict):
                # the operator's pin or bounds: autotune.knobs.<name>.
                # {enabled,min,max,step}
                for key, arg in (("min", "lo"), ("max", "hi"), ("step", "step")):
                    if key in o:
                        kw[arg] = o[key]
                if "enabled" in o:
                    kw["enabled"] = bool(o["enabled"])
            return Knob(name, **kw)

        def hot(key: str, cast):
            return lambda v: self._apply_hot_knob(key, cast(v))

        knobs = []
        batcher = self._checker
        if isinstance(batcher, CheckBatcher):
            knobs.append(build(
                "encode_workers", stage="queue", lo=1, hi=8, step=1,
                read=lambda: batcher.encode_workers,
                apply=hot("engine.encode_workers", int),
                key="engine.encode_workers",
            ))
            knobs.append(build(
                "pipeline_depth", stage="launch", lo=1, hi=8, step=1,
                read=lambda: batcher.pipeline_depth,
                apply=hot("engine.pipeline_depth", int),
                key="engine.pipeline_depth",
            ))
            if batcher.encoded_cache is not None:
                knobs.append(build(
                    "encoded_cache_size", stage="encode", lo=1024, hi=1 << 20,
                    step=65536,
                    read=lambda: batcher.encoded_cache.capacity,
                    apply=hot("engine.encoded_cache_size", int),
                    key="engine.encoded_cache_size",
                ))
        hbm = self._hbm_admission
        if hbm is not None:
            knobs.append(build(
                "hbm_budget_frac", stage="kernel", lo=0.1, hi=0.95, step=0.05,
                integer=False,
                read=lambda: hbm.budget_frac,
                apply=hot("engine.memory.hbm_budget_frac", lambda v: round(float(v), 4)),
                key="engine.memory.hbm_budget_frac",
            ))
        engine = self._check_engine
        if engine is not None and hasattr(engine, "escalation_budget"):
            knobs.append(build(
                "escalation_budget", stage="kernel", lo=0.01, hi=0.5, step=0.02,
                integer=False,
                read=lambda: engine.escalation_budget,
                apply=hot("engine.sharding.escalation_budget", lambda v: round(float(v), 4)),
                key="engine.sharding.escalation_budget",
            ))
        expand = self._expand_engine
        if expand is not None and getattr(expand, "default_page_size", 0):
            # paging off (size 0) stays off: turning it on would change the
            # shape of responses, which a tuner must not do
            knobs.append(build(
                "expand_page_size", stage="serialize", lo=256, hi=8192, step=256,
                higher_helps=False,
                read=lambda: expand.default_page_size,
                apply=hot("engine.expand_page_size", int),
                key="engine.expand_page_size",
            ))

        def advertise_hedge(v):
            self._hedge_advertised_ms = float(v)

        knobs.append(build(
            "hedge_delay_ms", stage="reply", lo=1, hi=1000, step=10,
            higher_helps=False,
            read=lambda: self._hedge_advertised_ms,
            apply=advertise_hedge,
        ))

        def breaker_guard():
            breaker = self._engine_breaker
            if breaker is None:
                return None
            try:
                return "breaker_open" if breaker.breaker_snapshot()["open"] else None
            except Exception:
                return None

        def hbm_guard():
            h = self._hbm_admission
            if h is None:
                return None
            try:
                snap = h.snapshot()
            except Exception:
                return None
            if snap.get("headroom_bytes", 1) <= 0 and snap.get("inflight_bytes", 0) > 0:
                return "hbm_pressure"
            return None

        return AutoTuner(
            knobs,
            attribution=self.attribution(),
            slo=self.slo(),
            metrics=self.metrics(),
            flight=self.flight(),
            logger=self.logger(),
            interval_s=float(cfg.get("autotune.interval_s")),
            min_requests=int(cfg.get("autotune.min_requests")),
            revert_threshold=float(cfg.get("autotune.revert_threshold")),
            freeze_burn_rate=float(cfg.get("autotune.freeze_burn_rate")),
            backoff_ticks=int(cfg.get("autotune.backoff_ticks")),
            history=int(cfg.get("autotune.history")),
            enabled_fn=lambda: bool(cfg.get("autotune.enabled")),
            guards=(breaker_guard, hbm_guard),
        )

    def _wrap_breaker(self, engine):
        from ..engine.fallback import DeviceFallbackEngine

        cfg = self.config
        max_depth = cfg.read_api_max_depth()
        supervisor = self.device_supervisor()
        breaker = self._engine_breaker = DeviceFallbackEngine(
            engine,
            fallback_factory=lambda: CheckEngine(self.store(), max_depth=max_depth),
            failure_threshold=int(cfg.get("engine.fallback_threshold")),
            cooldown_s=float(cfg.get("engine.fallback_cooldown_ms")) / 1e3,
            health=self._readiness,
            on_device_lost=(
                supervisor.notify_device_lost if supervisor is not None else None
            ),
            metrics=self.metrics(),
        )
        if supervisor is not None:
            # recovery ends with a forced half-open probe on this breaker
            supervisor.bind_breaker(breaker)
        return breaker

    def hbm_admission(self):
        """The device-memory budget shared by the batcher (chunk admission,
        per-batch reserve/release) and the closure engine (rebuild gate).
        None when engine.memory.admission is off or the engine is the host
        oracle (no device memory to budget)."""
        with self._lock:
            if self._hbm_admission is None:
                if not bool(self.config.get("engine.memory.admission")):
                    return None
                if self.config.engine_mode() == "host":
                    return None
                from ..engine.hbm import HbmAdmission

                self._hbm_admission = HbmAdmission(
                    budget_frac=float(self.config.get("engine.memory.hbm_budget_frac")),
                    bytes_per_row=int(self.config.get("engine.memory.bytes_per_row")),
                    metrics=self.metrics(),
                )
            return self._hbm_admission

    def device_supervisor(self):
        """Device-loss recovery (``DeviceSupervisor``) on the breaker's
        lost-device hook. None when engine.failover.enabled is off or the
        engine is the host oracle (nothing to fail over)."""
        with self._lock:
            if self._device_supervisor is None:
                cfg = self.config
                if not bool(cfg.get("engine.failover.enabled")):
                    return None
                engine = self.check_engine()
                if isinstance(engine, CheckEngine):
                    return None
                self._device_supervisor = DeviceSupervisor(
                    engine,
                    warm_batch=int(cfg.get("engine.max_batch")),
                    probe_mode=str(cfg.get("engine.failover.probe_mode")),
                    probe_timeout_s=float(cfg.get("engine.failover.probe_timeout_s")),
                    probe_interval_s=float(cfg.get("engine.failover.probe_interval_s")),
                    max_backoff_s=float(cfg.get("engine.failover.max_backoff_s")),
                    allow_cpu_failover=bool(cfg.get("engine.failover.allow_cpu")),
                    home_platform=self.device.type,
                    on_change=self._sync_health,
                    metrics=self.metrics(),
                    flight=self.flight(),
                )
            return self._device_supervisor

    def scrubber(self):
        """The integrity scrubber (engine/scrub.py), wired to the serving
        engine's residency, the batcher's live-check tap and its result
        caches. Built lazily (building it builds the checker); its thread
        starts in start_all, after any replica fork."""
        with self._lock:
            if self._scrubber is not None:
                return self._scrubber
            from ..engine.scrub import ScrubDaemon

            cfg = self.config
            self.checker()  # engine + batcher + breaker exist after this

            def _engine():
                return self._check_engine

            def _oracle():
                fb = getattr(self._check_engine, "fallback_engine", None)
                return fb() if fb is not None else None

            def _repair():
                # the ladder's re-upload rung: the supervisor re-warms and
                # re-probes the breaker; without one, the bare reset
                sup = self._device_supervisor
                if sup is not None:
                    sup.reset_residency()
                    return
                reset = getattr(self._check_engine, "reset_residency", None)
                if reset is not None:
                    reset()

            def _flush_caches():
                b = self._checker
                for c in (getattr(b, "cache", None), getattr(b, "encoded_cache", None)):
                    if c is not None:
                        c.clear()

            def _breaker_guard():
                b = self._engine_breaker
                if b is not None and b.breaker_snapshot()["open"]:
                    return "breaker_open"
                return None

            def _hbm_guard():
                h = self._hbm_admission
                if h is None:
                    return None
                snap = h.snapshot()
                headroom = snap["headroom_bytes"]
                if headroom is not None and headroom <= 0 and snap["inflight_bytes"] > 0:
                    return "hbm_pressure"
                return None

            self._scrubber = ScrubDaemon(
                engine_fn=_engine,
                oracle_fn=_oracle,
                repair_fn=_repair,
                cache_flush_fn=_flush_caches,
                version_fn=self._answering_version,
                interval_s=float(cfg.get("scrub.interval_s")),
                sample_rows=int(cfg.get("scrub.sample_rows")),
                reservoir=int(cfg.get("scrub.reservoir")),
                replay_per_cycle=int(cfg.get("scrub.replay_per_cycle")),
                store_fn=lambda: self._store,
                replicator_fn=lambda: self._replicator,
                digest_chunk_size=int(cfg.get("scrub.digest_chunk_size")),
                wal_segments_per_cycle=int(cfg.get("scrub.wal_segments_per_cycle")),
                max_repairs_per_cycle=int(cfg.get("scrub.max_repairs_per_cycle")),
                history=int(cfg.get("scrub.history")),
                enabled_fn=lambda: bool(cfg.get("scrub.enabled")),
                guards=(_breaker_guard, _hbm_guard),
                slo=self.slo(),
                freeze_burn_rate=float(cfg.get("scrub.freeze_burn_rate")),
                metrics=self.metrics(),
                flight=self.flight(),
            )
            if isinstance(self._checker, CheckBatcher):
                # tap answered live batches into the replay reservoir
                self._checker.scrub_observer = self._scrubber.observe_batch
            return self._scrubber

    def debug_context(self):
        """Everything /debug needs (api/debug.py), gated by debug.*."""
        with self._lock:
            if self._debug_context is None:
                from ..api.debug import DebugContext

                self.metrics()  # binds DEVSTATS and its graph panel
                cfg = self.config
                self._debug_context = DebugContext(
                    config=cfg,
                    enabled=bool(cfg.get("debug.enabled")),
                    token=str(cfg.get("debug.token") or ""),
                    profile_max_s=float(cfg.get("debug.profile_max_s")),
                    flight=self.flight(),
                    tracer=self.tracer(),
                    slo=self.slo(),
                    check_telemetry=self.check_telemetry(),
                    attribution=self.attribution(),
                    profiler=self.profiler(),
                    build_phases_fn=self._build_phases,
                    device_status_fn=self._device_status,
                    # getters, not instances: /debug observes a plane and
                    # never constructs one
                    autotune_fn=lambda: self._autotuner,
                    scrub_fn=lambda: self._scrubber,
                    overload_fn=lambda: self._overload,
                    cluster=self.federation(),
                    instance_id=(
                        self.cluster_instance_id() if self.cluster_enabled() else ""
                    ),
                )
            return self._debug_context

    def _device_status(self) -> dict:
        """/debug/device: the serving backend, breaker and quarantine
        state, the failover timeline, the HBM budget. Reads only components
        already built — asking for status never constructs an engine."""
        out: dict = {"backend": None, "supervisor": None}
        sup = self._device_supervisor
        if sup is not None:
            status = sup.status()
            out["supervisor"] = status
            out["backend"] = status.get("backend")
        if out["backend"] is None:
            out["backend"] = self.device.type
        breaker = self._engine_breaker
        if breaker is not None:
            out["breaker"] = breaker.breaker_snapshot()
            out["quarantine"] = breaker.quarantine_snapshot()
        hbm = self._hbm_admission
        if hbm is not None:
            out["hbm"] = hbm.snapshot()
        rep = getattr(self._store, "recovery", None)
        if rep is not None:
            out["recovery"] = {
                "checkpoint_version": rep.checkpoint_version,
                "replayed_deltas": rep.replayed_deltas,
                "skipped_records": rep.skipped_records,
                "final_version": rep.final_version,
                "gap": rep.gap,
                "torn_tail_bytes": rep.torn_tail_bytes,
                "duration_s": rep.duration_s,
                "checkpoint_s": rep.checkpoint_s,
                "replay_s": rep.replay_s,
                "notes": list(rep.notes),
                "csr_primed": self.csr_primed,
            }
        return out

    def graph_panel(self) -> dict:
        """The graph's shape for /debug/graph: tuples, snapshot version,
        CSR nnz, vocab size. Reads only materialized state: sampling never
        forces a snapshot encode or a closure build."""
        out: dict = {}
        store = self._store
        if store is not None:
            out["tuples"] = len(store)
            out["store_version"] = store.version
        mgr = self._snapshots
        snap = mgr._snap if mgr is not None else None
        if snap is not None:
            out["snapshot_version"] = snap.version
            out["csr_nnz"] = snap.num_edges
            out["vocab_size"] = len(snap.vocab)
            out["padded_nodes"] = snap.padded_nodes
            out["padded_edges"] = snap.padded_edges
            out["csr_derived"] = snap._csr is not None
        engine = self._check_engine
        if engine is not None:
            out["engine"] = type(engine).__name__
            built = getattr(engine, "closure_built_at", None)
            if built:
                out["closure_age_s"] = round(time.time() - built, 1)
        return out

    def qos(self):
        """Per-namespace token-bucket admission (engine/qos.py), handed to
        the CheckBatcher's entry points; None unless qos.enabled."""
        with self._lock:
            if self._qos is None and bool(self.config.get("qos.enabled")):
                from ..engine.qos import NamespaceQos

                self._qos = NamespaceQos(
                    rate=float(self.config.get("qos.rate")),
                    burst=float(self.config.get("qos.burst")),
                    overrides=dict(self.config.get("qos.overrides") or {}),
                    metrics=self.metrics(),
                )
            return self._qos

    def overload(self):
        """The overload-control plane (engine/overload.py): the AIMD limit
        and CoDel discipline at the batcher's admission, the criticality
        brownout ladder and the accepts/requests throttle. None unless
        overload.enabled; the controller re-reads overload.enabled per
        decision, so turning it off in a reloaded file makes it admit
        everything (a live kill switch)."""
        with self._lock:
            if self._overload is None and bool(self.config.get("overload.enabled")):
                from ..engine.overload import (
                    AdaptiveLimiter,
                    AdaptiveThrottle,
                    BrownoutController,
                    OverloadController,
                )

                cfg = self.config
                max_queue = int(cfg.get("engine.max_queue"))
                if max_queue <= 0:
                    # the batcher's own backstop default
                    max_queue = 8 * int(cfg.get("engine.max_batch"))
                limiter = AdaptiveLimiter(
                    initial=max_queue,
                    min_limit=int(cfg.get("overload.min_limit")),
                    max_limit=max_queue,
                    additive=float(cfg.get("overload.additive")),
                    decrease=float(cfg.get("overload.decrease")),
                    target_delay_s=float(cfg.get("overload.target_delay_ms")) / 1e3,
                    interval_s=float(cfg.get("overload.interval_ms")) / 1e3,
                    tolerance=float(cfg.get("overload.tolerance")),
                )
                brownout = BrownoutController(
                    hysteresis_s=float(cfg.get("overload.hysteresis_ms")) / 1e3,
                    min_dwell_s=float(cfg.get("overload.dwell_ms")) / 1e3,
                    history=int(cfg.get("overload.history")),
                    flight=self.flight(),
                    logger=self.logger(),
                )
                throttle = AdaptiveThrottle(
                    window_s=float(cfg.get("overload.throttle_window_s")),
                    k=float(cfg.get("overload.throttle_k")),
                )
                self._overload = OverloadController(
                    max_queue=max_queue,
                    limiter=limiter,
                    brownout=brownout,
                    throttle=throttle,
                    enabled_fn=lambda: bool(self.config.get("overload.enabled")),
                    metrics=self.metrics(),
                )
            return self._overload

    def default_criticality(self) -> str:
        """The criticality class of requests that carry no header or
        metadata (overload.default_criticality)."""
        return str(self.config.get("overload.default_criticality"))

    def encoded_front(self):
        """The id-native check tier (api/encoded.py): the epoch gate, the id
        clamp and the qos bucketing in front of ``check_batch_encoded``.
        None when serve.read.encoded is off or the checker has no encoded
        path (the host oracle's DirectChecker); the encoded and vocab
        routes are then not registered. In a forked wire worker the backend
        is the ring to the parent's batcher instead of the local one."""
        with self._lock:
            if self._encoded_front is None:
                if not bool(self.config.get("serve.read.encoded")):
                    return None
                checker = self.checker()
                if self._wire_ring_client is not None:
                    from ..engine.shmring import RingBackend

                    backend = RingBackend(self._wire_ring_client)
                elif hasattr(checker, "check_batch_encoded"):
                    backend = checker
                else:
                    return None
                from ..api.encoded import EncodedCheckFront

                self._encoded_front = EncodedCheckFront(self.snapshots(), backend)
            return self._encoded_front

    def _ring_handler(self, frame: bytes) -> bytes:
        """The parent side of the wire ring: one encoded frame from a worker
        process -> the single batcher -> a response frame. The worker ran
        the strict epoch gate; this side clamps the ids again against its
        own snapshot (which may have grown) and debits qos once, here,
        where the one set of buckets lives."""
        from ..api import wirecodec
        from ..api.encoded import EncodedCheckFront

        front = self._ring_parent_front
        if front is None:
            front = self._ring_parent_front = EncodedCheckFront(
                self.snapshots(), self.checker(), validate=False
            )
        req = wirecodec.decode_check_request(frame)
        allowed = front.check(req, timeout=self._freshness_cap_s())
        return wirecodec.encode_check_response(allowed, self.read_snaptoken())

    def expand_engine(self):
        """Expand over the snapshot's CSR for every engine mode but
        ``host``, which reads the store (as the reference does)."""
        with self._lock:
            if self._expand_engine is None:
                max_depth = self.config.read_api_max_depth()
                page_size = int(self.config.get("engine.expand_page_size"))
                if self.config.engine_mode() == "host":
                    from ..engine.expand import ExpandEngine

                    self._expand_engine = ExpandEngine(
                        self.store(), max_depth=max_depth,
                        default_page_size=page_size,
                    )
                else:
                    from ..engine.device import SnapshotExpandEngine

                    self._expand_engine = SnapshotExpandEngine(
                        self.snapshots(), max_depth=max_depth,
                        default_page_size=page_size,
                    )
            return self._expand_engine

    def list_engine(self):
        """Reverse-index list serving over the closure engine's residency;
        None when serve.read.list is off or the check engine has no reverse
        residency (the host oracle, DeviceCheckEngine), and then the list
        routes are not registered. engine.reverse_index false keeps the
        routes and pins them to the exact oracle."""
        with self._lock:
            if self._list_engine is None:
                if not bool(self.config.get("serve.read.list")):
                    return None
                engine = self.check_engine()
                if not hasattr(engine, "reverse_artifacts"):
                    return None
                engine.reverse_enabled = bool(self.config.get("engine.reverse_index"))
                hbm = self.hbm_admission()
                if hbm is not None:
                    # a device D^T is resident bytes the admission charges
                    engine.reverse_residency_cb = hbm.set_reverse_residency
                from ..engine.listing import ListEngine

                self._list_engine = ListEngine(
                    engine,
                    default_page_size=int(self.config.get("engine.expand_page_size")),
                    breaker_threshold=int(self.config.get("engine.fallback_threshold")),
                    breaker_cooldown_s=float(
                        self.config.get("engine.fallback_cooldown_ms")
                    ) / 1e3,
                )
            return self._list_engine

    # -- replication (replication/) ---------------------------------------------

    def replication_role(self) -> str:
        """"" (standalone), "leader" or "follower"."""
        return str(self.config.get("replication.role") or "")

    def replication_source(self):
        """The leader's WAL and checkpoint shipping, whose routes the write
        plane registers. None off a leader."""
        with self._lock:
            if self._replication_source is None and self.replication_role() == "leader":
                store = self.store()
                if not hasattr(store, "wal"):
                    raise ErrMalformedInput(
                        "replication.role=leader requires a durable store "
                        "(set store.wal.dir on a memory/columnar DSN)"
                    )
                from ..replication.leader import ReplicationSource

                self._replication_source = ReplicationSource(
                    store,
                    poll_interval_s=float(self.config.get("replication.poll_interval_ms"))
                    / 1e3,
                )
            return self._replication_source

    def replicator(self):
        """The follower's replication client: checkpoint bootstrap and WAL
        tail replay into the local store. None off a follower."""
        with self._lock:
            if self._replicator is None and self.replication_role() == "follower":
                upstream = str(self.config.get("replication.upstream") or "")
                if not upstream:
                    raise ErrMalformedInput(
                        "replication.role=follower requires "
                        "replication.upstream (the leader's write-plane URL)"
                    )
                scratch = str(self.config.get("replication.dir") or "")
                if not scratch:
                    import tempfile

                    scratch = tempfile.mkdtemp(prefix="keto-follower-")
                from ..replication.follower import FollowerReplicator

                self._replicator = FollowerReplicator(
                    self.store(),
                    upstream,
                    scratch_dir=scratch,
                    poll_interval_s=float(self.config.get("replication.poll_interval_ms"))
                    / 1e3,
                    max_records=int(self.config.get("replication.max_records_per_poll")),
                )
                self._replicator.bind_metrics(self.metrics())
                self._replicator.on_reseed = self._after_reseed
            return self._replicator

    def _after_reseed(self) -> None:
        """A reseed replaced the follower's store wholesale and its version
        may have moved back: rebuild the residency from the store and drop
        cached answers, as the scrubber's repair does (the same version
        numbers now name other contents)."""
        engine = self._check_engine
        if engine is None:
            return  # not serving yet: the warmup builds from the seed
        sup = self._device_supervisor
        if sup is not None:
            sup.reset_residency()
        else:
            reset = getattr(engine, "reset_residency", None)
            if reset is not None:
                reset()
        b = self._checker
        for c in (getattr(b, "cache", None), getattr(b, "encoded_cache", None)):
            if c is not None:
                c.clear()

    def version_waiter(self):
        """The follower's snaptoken gate (``wait_for_version``) for both read
        planes; None on a leader or a standalone node, where the store is
        authoritative and the engine's own freshness wait suffices. The gate
        runs before the batcher and is not clamped: the engine's wait clamps
        its target to the local store version (right locally, stale on a
        follower mid-replay)."""
        rep = self.replicator()
        return rep.wait_for_version if rep is not None else None

    # -- the cluster plane (cluster/, telemetry/federation.py) -------------------

    def cluster_enabled(self) -> bool:
        return bool(self.config.get("cluster.enabled"))

    def cluster_instance_id(self) -> str:
        """This node's stable identity: the membership key and the
        ``instance`` label of every federated series. Defaults to
        ``<role>-<random>``: a test boots several nodes of one role in one
        process, and colliding ids would merge their rows."""
        if not self._cluster_instance_id:
            iid = str(self.config.get("cluster.instance_id") or "")
            if not iid:
                import uuid

                iid = f"{self.replication_role() or 'leader'}-{uuid.uuid4().hex[:6]}"
            self._cluster_instance_id = iid
        return self._cluster_instance_id

    def _cluster_url(self, plane: str) -> str:
        """How other members reach this node's ``plane``:
        cluster.advertise_url / advertise_write_url when set, else the
        loopback URL of the bound port (right for one host; a fleet on
        several hosts must advertise)."""
        key = "cluster.advertise_url" if plane == "read" else "cluster.advertise_write_url"
        url = str(self.config.get(key) or "")
        if url:
            return url.rstrip("/")
        if plane == "read":
            host = self.config.read_api_host()
            port = self._bound_read_port or self.config.read_api_port()
        else:
            host = self.config.write_api_host()
            port = self._bound_write_port or self.config.write_api_port()
        if host in ("", "0.0.0.0", "::"):
            host = "127.0.0.1"
        return f"http://{host}:{port}"

    def _cluster_self_payload(self) -> dict:
        """The heartbeat body: what the fleet view wants to know of this
        node without scraping it. Reads only components already built."""
        store = self.store()
        payload: dict = {
            "instance_id": self.cluster_instance_id(),
            "role": self.replication_role() or "leader",
            "version": store.version,
            "read_url": self._cluster_url("read"),
            "write_url": self._cluster_url("write"),
            "t": time.time(),
        }
        try:
            payload["served_version"] = self._served_version()
        except Exception:
            pass
        device = self._device_status()
        payload["backend"] = device.get("backend")
        sup = device.get("supervisor")
        if sup:
            payload["supervisor"] = {
                "recovering": sup.get("recovering"),
                "failovers": sup.get("failovers"),
            }
        if device.get("breaker") is not None:
            payload["breaker"] = device["breaker"]
        if device.get("quarantine") is not None:
            payload["quarantine_size"] = len(device["quarantine"])
        if device.get("hbm") is not None:
            payload["hbm"] = {
                "inflight_bytes": device["hbm"].get("inflight_bytes"),
                "inflight_batches": device["hbm"].get("inflight_batches"),
            }
        if self._slo is not None:
            snap = self._slo.snapshot()
            payload["slo"] = {
                "fast": snap.get("fast"),
                "slow": snap.get("slow"),
                "budget_remaining": snap.get("budget_remaining"),
            }
        rep = self._replicator
        if rep is not None:
            lag = rep.lag()
            payload["lag_versions"] = lag.get("lag_versions")
            payload["staleness_seconds"] = lag.get("staleness_seconds")
        em = self._election
        if em is not None:
            # a promoted follower advertises itself as the leader, so routers
            # and the fleet view follow it
            payload["role"] = em.role
            payload["election"] = {
                "priority": em.priority,
                "position": store.version,
                "term": em.term,
            }
        elif self.election_enabled():
            payload["election"] = {
                "priority": int(self.config.get("cluster.election.priority")),
                "position": store.version,
            }
        return payload

    def cluster_membership(self):
        """The heartbeat table of a leader (and of a standalone node, which
        federates itself). None on a follower or with cluster.enabled off."""
        with self._lock:
            if (
                self._cluster_membership is None
                and self.cluster_enabled()
                and self.replication_role() in ("", "leader")
            ):
                from ..cluster import ClusterMembership

                self._cluster_membership = ClusterMembership(
                    member_timeout_s=float(self.config.get("cluster.member_timeout_s")),
                )
            return self._cluster_membership

    def federation(self):
        """The leader's federation scraper: membership, then each member's
        /metrics and /replication/status, into instance-labelled
        keto_cluster_* series and the /cluster/status rollup. None wherever
        cluster_membership() is None."""
        membership = self.cluster_membership()
        with self._lock:
            if self._federation is None and membership is not None:
                from ..telemetry.federation import DEFAULT_THRESHOLDS, FederationScraper

                thresholds = {
                    key: self.config.get(f"cluster.health.{key}", default=default)
                    for key, default in DEFAULT_THRESHOLDS.items()
                }
                self._federation = FederationScraper(
                    membership,
                    self.metrics(),
                    scrape_interval_s=float(self.config.get("cluster.scrape_interval_ms"))
                    / 1e3,
                    thresholds=thresholds,
                    objective=float(self.config.get("telemetry.slo.objective")),
                    self_payload_fn=self._cluster_self_payload,
                    election_status_fn=(
                        (lambda: self.election().status())
                        if self.election_enabled()
                        else None
                    ),
                    qos=self.qos(),
                    logger=self.logger(),
                )
            return self._federation

    def cluster_heartbeater(self):
        """The follower's push side: beats this node's payload to the
        leader's write plane (the replication upstream). None off a follower
        or with cluster.enabled off."""
        with self._lock:
            if (
                self._cluster_heartbeater is None
                and self.cluster_enabled()
                and self.replication_role() == "follower"
            ):
                upstream = str(self.config.get("replication.upstream") or "")
                if upstream:
                    from ..cluster import ClusterHeartbeater

                    self._cluster_heartbeater = ClusterHeartbeater(
                        upstream,
                        self._cluster_self_payload,
                        interval_s=float(self.config.get("cluster.heartbeat_interval_ms"))
                        / 1e3,
                        logger=self.logger(),
                        on_directives=self._apply_directives,
                    )
            return self._cluster_heartbeater

    def _cluster_status_fn(self):
        """/cluster/status for the read plane: the federation rollup where
        one runs (a leader or standalone node); on an election-enabled
        follower an election-only view, so routers and operators see the
        term and the leader's coordinates from any member."""
        fed = self.federation()
        if fed is not None:
            return fed.status
        if not self.election_enabled():
            return None

        def status() -> dict:
            return {"cluster": {"election": self.election().status()}, "members": []}

        return status

    # -- leader election -----------------------------------------------------------

    def election_enabled(self) -> bool:
        return self.cluster_enabled() and bool(self.config.get("cluster.election.enabled"))

    def _election_wal_dir(self) -> str:
        """The shared directory the leases and the term lineage live in: by
        default the WAL directory every member shares."""
        d = str(self.config.get("cluster.election.wal_dir") or "")
        return d or str(self.config.get("store.wal.dir") or "")

    def election(self):
        """Lease-based leader election over the shared WAL directory; None
        unless cluster.enabled and cluster.election.enabled. Built lazily so
        the advertised URLs are the bound ports: the serve path reaches it
        through lambdas, never captures it when a plane is built."""
        with self._lock:
            if self._election is None and self.election_enabled():
                wal_dir = self._election_wal_dir()
                if not wal_dir:
                    raise ErrMalformedInput(
                        "cluster.election.enabled requires a shared WAL "
                        "directory (store.wal.dir or cluster.election.wal_dir)"
                    )
                from ..cluster import ElectionManager, LeaseStore

                cfg = self.config
                self._election = ElectionManager(
                    LeaseStore(wal_dir),
                    instance_id=self.cluster_instance_id(),
                    lease_ttl_s=float(cfg.get("cluster.election.lease_ttl_s")),
                    heartbeat_interval_s=float(
                        cfg.get("cluster.election.heartbeat_interval_ms")
                    ) / 1e3,
                    priority=int(cfg.get("cluster.election.priority")),
                    read_url=self._cluster_url("read"),
                    write_url=self._cluster_url("write"),
                    promote_fn=self._election_promote,
                    retarget_fn=self._election_retarget,
                    position_fn=lambda: self.store().version,
                    metrics=self.metrics(),
                    logger=self.logger(),
                )
            return self._election

    def _election_promote(self) -> None:
        """The winning candidate's hook: replay the shared WAL into the local
        store (no acked write lost: each hit the WAL before its ack), then
        serve the replication feed, so the other followers retarget here
        without re-bootstrapping."""
        t0 = time.perf_counter()
        wal_dir = self._election_wal_dir()
        rep = self.replicator()
        if rep is not None:
            result = rep.promote(wal_dir)
            self.logger().info("promoted via election", **result)
            self.last_promotion = dict(result)
        if self._promoted_source is None:
            from ..cluster import PromotedReplicationSource

            src = PromotedReplicationSource(
                self.store(), wal_dir, sync=str(self.config.get("store.wal.sync"))
            )
            src.open()
            self._promoted_source = src
        self.last_promotion["s"] = time.perf_counter() - t0

    def _election_retarget(self, lease: dict) -> None:
        """The losing candidate's and a follower's hook: tail the new
        leader's feed. The cursor carries over (the same shared WAL
        directory), so there is no checkpoint re-bootstrap."""
        target = str(lease.get("write_url") or "")
        if not target:
            return
        rep = self._replicator
        if rep is not None:
            rep.retarget(target)
        hb = self._cluster_heartbeater
        if hb is not None:
            hb.upstream = target.rstrip("/")
            hb.url = f"{hb.upstream}/cluster/heartbeat"

    def _write_read_only(self) -> bool:
        """The write planes' gate, asked per mutation. Under election only
        the holder of a live, unfenced lease accepts mutations: a promoted
        follower opens up, a fenced ex-leader shuts mid-flight. Otherwise a
        follower refuses them."""
        em = self._election
        if em is not None:
            return not em.is_writable()
        return self.replication_role() == "follower"

    def _apply_directives(self, directives: dict) -> None:
        """A follower's side of the heartbeat control channel: the leader's
        reply carries fleet directives (the QoS scale while the aggregate
        burn alert fires)."""
        qos = self.qos()
        if qos is None:
            return
        scale = directives.get("qos_scale")
        if scale is not None:
            qos.set_scale(float(scale), reason=str(directives.get("reason") or ""))

    def _federation_directives(self):
        fed = self._federation
        return fed.directives() if fed is not None else None

    # -- snaptokens ------------------------------------------------------------

    def snaptoken(self) -> str:
        """Write-plane snaptoken: the store's durable position, a
        structured ``z<version>.<segment>.<offset>`` token on a WAL'd store,
        the bare version counter otherwise (replication/token.py parses
        both)."""
        store = self.store()
        current_token = getattr(store, "current_token", None)
        if current_token is not None:
            return str(current_token())
        return str(store.version)

    def _served_version(self) -> int:
        """The version checks are actually answered at (engine-served
        under bounded freshness, else the store's)."""
        served = getattr(self.check_engine(), "served_version", None)
        if served is not None:
            return served()
        return self.store().version

    def _answering_version(self) -> int:
        """The version the NEXT check will answer at: the caches' stamp.
        Never served_version, which lags writes under strong freshness and
        would keep a stale answer alive past a delete."""
        answering = getattr(self.check_engine(), "answering_version", None)
        if answering is not None:
            return answering()
        return self.store().version

    def read_snaptoken(self) -> str:
        """Read-plane snaptoken: the version checks are answered at. Under
        bounded freshness the engine may serve an older snapshot while a
        rebuild runs; the token names that snapshot."""
        return str(self._served_version())

    # -- serving ---------------------------------------------------------------

    def is_serving(self) -> bool:
        """Readiness: up after bring-up; down while the device breaker holds
        it down (an open circuit, a real device error) and while the device
        supervisor recovers or serves from a host residency."""
        sup = self._device_supervisor
        return (
            self._serving
            and self._breaker_ok
            and (sup is None or sup.serving_ok())
        )

    def _sync_health(self) -> None:
        if self._health is not None:
            self._health.set_serving(self.is_serving())

    @property
    def grpc_enabled(self) -> bool:
        """Whether the planes serve gRPC (False until probed)."""
        return self._grpc_api is not None

    def _grpc(self):
        """The gRPC plane's builders (api/grpc_servers.py), imported here
        and nowhere else; None when grpc or google.protobuf do not import,
        with the reason kept. A grpc-max-message-size set in the config
        then raises instead of being ignored."""
        with self._lock:
            if not self._grpc_probed:
                self._grpc_probed = True
                try:
                    from ..api import grpc_servers
                except ImportError as e:
                    missing = (e.name or "").split(".")[0]
                    if missing not in ("grpc", "google"):
                        raise
                    self.grpc_off_reason = (
                        f"gRPC is off: {e.name} does not import ({e}); the "
                        "planes serve REST only"
                    )
                    for key in _GRPC_SIZE_KEYS:
                        if self.config.is_set(key):
                            raise ErrMalformedInput(
                                f"{key} is set, but the gRPC plane needs the "
                                f"{e.name} package, which does not import"
                            ) from e
                else:
                    self._grpc_api = grpc_servers
            return self._grpc_api

    def _health_servicer(self):
        with self._lock:
            if self._health is None:
                from ..api.services import HealthServicer

                self._health = HealthServicer()
            return self._health

    def read_plane(self) -> PlaneServer:
        with self._lock:
            if self._read_plane is None:
                router = build_read_router(
                    self.store(), self.checker(), self.read_snaptoken,
                    self.version, healthy_fn=self.is_serving,
                    expand_engine=self.expand_engine(),
                    list_engine=self.list_engine(),
                    encoded_front=self.encoded_front(),
                    # the list routes' snaptoken gate (the check routes
                    # reach the same wait through the batcher)
                    version_waiter=getattr(
                        self.check_engine(), "wait_for_version", None
                    ),
                    max_freshness_wait_s=self._freshness_cap_s,
                    default_criticality=self.default_criticality(),
                    cors=self.config.cors("read"),
                    metrics=self.metrics(),
                    logger=self.logger(),
                    telemetry=self.check_telemetry(),
                    replication_waiter=self.version_waiter(),
                    cluster_status_fn=self._cluster_status_fn(),
                )
                from ..api.debug import DebugAPI

                DebugAPI(self.debug_context()).register(router)
                api = self._grpc()
                grpc_server = None
                if api is not None:
                    grpc_server = api.build_read_grpc_server(
                        self.checker(),
                        self.expand_engine(),
                        self.store(),
                        self.read_snaptoken,
                        self.version,
                        self._health_servicer(),
                        max_workers=self._grpc_workers(),
                        max_message_bytes=int(
                            self.config.get("serve.read.grpc-max-message-size")
                        ),
                        max_freshness_wait_s=self._freshness_cap_s,
                        encoded_front=self.encoded_front(),
                        list_engine=self.list_engine(),
                        list_version_waiter=getattr(
                            self.check_engine(), "wait_for_version", None
                        ),
                        default_criticality=self.default_criticality(),
                        logger=self.logger(),
                        metrics=self.metrics(),
                        tracer=self.tracer(),
                        telemetry=self.check_telemetry(),
                        replication_waiter=self.version_waiter(),
                    )
                read_port, grpc_port = self._shared_read_ports
                self._read_plane = PlaneServer(
                    router, self.config.read_api_host(),
                    read_port or self.config.read_api_port(), grpc_server,
                    grpc_port=grpc_port, reuse_port=read_port != 0,
                    ssl_context=self._ssl_context("read"),
                    expose_backends=bool(
                        self.config.get("serve.read.expose_backend_ports", default=False)
                    ),
                )
            return self._read_plane

    def build_read_plane_shared(self, read_port: int, grpc_port: int) -> PlaneServer:
        """The read plane bound to the fixed ports every pool process shares
        with SO_REUSEPORT (driver/replicas.py)."""
        with self._lock:
            self._shared_read_ports = (read_port, grpc_port)
            self._read_plane = None  # rebuilt against the fixed ports
            return self.read_plane()

    def write_plane(self) -> PlaneServer:
        with self._lock:
            if self._write_plane is None:
                follower = self.replication_role() == "follower"
                rep = self.replicator()
                router = build_write_router(
                    self.store(), self.version, healthy_fn=self.is_serving,
                    cors=self.config.cors("write"),
                    metrics=self.metrics(),
                    logger=self.logger(),
                    read_only=self._write_read_only,
                    leader_hint_fn=(
                        (lambda: self.election().leader_hint())
                        if self.election_enabled()
                        else None
                    ),
                    replication_source=self.replication_source(),
                    # an election-enabled follower may be promoted later: its
                    # /replication/* routes delegate to the promoted source
                    replication_source_fn=(
                        (lambda: self._promoted_source)
                        if self.election_enabled() and follower
                        else None
                    ),
                    replication_status_fn=rep.lag if rep is not None else None,
                    cluster_membership=self.cluster_membership(),
                    directives_fn=(
                        self._federation_directives if self.cluster_enabled() else None
                    ),
                )
                api = self._grpc()
                grpc_server = None
                if api is not None:
                    grpc_server = api.build_write_grpc_server(
                        self.store(),
                        self.snaptoken,
                        self.version,
                        self._health_servicer(),
                        max_message_bytes=int(
                            self.config.get("serve.write.grpc-max-message-size")
                        ),
                        logger=self.logger(),
                        metrics=self.metrics(),
                        tracer=self.tracer(),
                        read_only=self._write_read_only,
                    )
                self._write_plane = PlaneServer(
                    router, self.config.write_api_host(),
                    self.config.write_api_port(), grpc_server,
                    ssl_context=self._ssl_context("write"),
                    expose_backends=bool(
                        self.config.get("serve.write.expose_backend_ports", default=False)
                    ),
                )
            return self._write_plane

    def _ssl_context(self, plane: str):
        """TLS termination at the plane's public port when
        serve.<plane>.tls.{cert,key}.path are set; ALPN offers h2 (gRPC
        clients require it) and http/1.1."""
        cert = self.config.get(f"serve.{plane}.tls.cert.path", default=None)
        key = self.config.get(f"serve.{plane}.tls.key.path", default=None)
        if not cert or not key:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        ctx.set_alpn_protocols(["h2", "http/1.1"])
        return ctx

    def _grpc_workers(self) -> int:
        # every in-flight check holds a worker: size the pool so a batch
        # can fill, capped (as the reference)
        cap = max(64, 32 * (os.cpu_count() or 1))
        return min(int(self.config.get("engine.max_batch")), cap, 512)

    def start_all(self) -> tuple[int, int]:
        """Warm the check engine up (the closure build, the query path at
        max_batch), fork the read replicas when serve.read.workers > 1, then
        start both planes; returns (read_port, write_port). Readiness flips
        only after bring-up. Workers of a SQL store are spawned first
        instead: each builds its own residency from the database, so their
        boots overlap this process's (the reference spawns them after its
        warmup)."""
        self.apply_log_config()
        store = self.store()  # a SQL store's migrations run here, before any worker
        spawned = not getattr(store, "process_private", False)
        if spawned:
            self._spawn_workers(*self._pool_sizes())
        engine = self.check_engine()
        replicator = self.replicator()
        if replicator is not None:
            # a follower: seed from the leader's checkpoint and start the
            # tail before the warmup, so the warmed snapshot and closure
            # cover the seeded graph, not an empty store
            _log.info("follower bootstrap from %s", replicator.upstream)
            replicator.start()
            self.follower_boot = dict(replicator.seed_stats)
            _log.info("follower replication started: version %d, leader version %d",
                      store.version, replicator.leader_version)
        if hasattr(store, "recovery"):
            # the durable write plane: seed the snapshot's CSR from the
            # checkpoint (the warmup below then skips its derive when the
            # versions line up) and let later checkpoints carry the CSR
            self._prime_recovered_csr(store)
            store.csr_provider = self._checkpoint_csr
        t_warm = time.perf_counter()
        if hasattr(engine, "warmup"):
            engine.warmup(int(self.config.get("engine.max_batch")))
        if replicator is not None:
            self.follower_boot["warmup_s"] = time.perf_counter() - t_warm
        # the snapshot CSR the expand engine and the overlay walk: deriving
        # it is an O(E log E) sort that belongs in warmup, not inside the
        # first live Expand (as the reference does)
        self.snapshots().snapshot().csr()
        # freeze the long-lived object graph (store rows, vocab keys,
        # closure artifacts) out of the cyclic GC: a full collection over
        # millions of immortal objects would land inside random requests
        # as tail latency
        gc.freeze()
        if not spawned:
            # before checker(), the planes and the gRPC server start threads
            self._start_replicas(engine)
        read_port = self.read_plane().start()
        write_port = self.write_plane().start()
        if not self.grpc_enabled:
            _log.warning(self.grpc_off_reason)
        # the cluster plane comes up once the bound ports are known: the
        # self payload and the heartbeats advertise real URLs, never :0
        self._bound_read_port, self._bound_write_port = read_port, write_port
        if self.cluster_enabled():
            self._start_cluster_plane()
        if bool(self.config.get("scrub.enabled")):
            # the scrubber's thread, after the fork like every thread
            self.scrubber().start()
        if bool(self.config.get("telemetry.profiler.enabled")):
            # the continuous sampling profiler: started here, after any
            # replica fork, so its thread never meets the fork inventory
            self.profiler().start()
        if bool(self.config.get("autotune.enabled")):
            # the feedback controller's thread: the same after-the-fork
            # rule. Turned off by a reload, its every tick short-circuits;
            # turned on by one, the config watcher starts it
            self.autotuner().start()
        self._start_config_watcher()
        self.mark_serving()
        return read_port, write_port

    def _start_cluster_plane(self) -> None:
        hb = self.cluster_heartbeater()
        if hb is not None:
            hb.start()
        fed = self.federation()
        if fed is not None:
            fed.start()
        em = self.election() if self.election_enabled() else None
        if em is not None:
            if self.replication_role() in ("", "leader"):
                # the configured leader claims the bootstrap lease before
                # any follower may campaign
                em.ensure_leadership()
            em.start()
        _log.info(
            "cluster plane started: instance %s, role %s, federation %s, "
            "election %s", self.cluster_instance_id(),
            self.replication_role() or "leader", fed is not None, em is not None,
        )

    def apply_log_config(self) -> None:
        """log.level and log.format onto the package logger."""
        from ..telemetry.logging import configure_logging

        configure_logging(
            level=str(self.config.get("log.level")),
            format=str(self.config.get("log.format")),
        )

    def _start_config_watcher(self, poll_interval_s: float = _CONFIG_POLL_S) -> None:
        """Hot-reload the config FILE while serving (reference
        provider.go:58-104): a changed mtime reloads; a file that fails
        validation is logged and the previous config keeps serving."""
        if not self.config.config_file or self._config_watcher is not None:
            return
        self._config_watch_stop = threading.Event()
        self._config_watcher = threading.Thread(
            target=self._watch_config,
            args=(self.config.config_file, poll_interval_s, self._config_watch_stop),
            name="config-watcher",
            daemon=True,
        )
        self._config_watcher.start()

    def _watch_config(self, path: str, poll_interval_s: float, stop) -> None:
        from ..telemetry.logging import get_logger
        from .config import HOT_ENGINE_KEYS

        log = get_logger("server")
        try:
            last = os.stat(path).st_mtime
        except OSError:
            last = 0.0
        # the hot engine knobs' file values at boot: a reload applies a knob
        # only when the operator edited it, never over a set_hot value on a
        # mere touch of the file
        knob_file = {k: self.config.file_value(k) for k in HOT_ENGINE_KEYS}
        while not stop.wait(poll_interval_s):
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if mtime == last:
                continue
            last = mtime
            try:
                applied = self.config.reload()
            except Exception as e:
                log.warn("config reload failed; keeping previous config", error=str(e))
                continue
            if not applied:
                continue
            log.info("config reloaded", changed=applied)
            if "log" in applied:
                self.apply_log_config()
            if "engine" in applied:
                self._reload_hot_knobs(knob_file, log)
            if "scrub" in applied and bool(self.config.get("scrub.enabled")):
                # turned on after boot: build and start it now (turned off,
                # its own cycle sees enabled_fn false)
                try:
                    self.scrubber().start()
                except Exception as e:
                    log.warn("scrubber start failed", error=str(e))
            if "autotune" in applied and bool(self.config.get("autotune.enabled")):
                # the same contract as the scrubber's
                try:
                    self.autotuner().start()
                except Exception as e:
                    log.warn("autotuner start failed", error=str(e))
            if "tracing" in applied and self._tracer is not None:
                self._tracer.reconfigure(**self._tracing_config())
            # overload.enabled needs no step: the controller reads it per
            # decision

    def _reload_hot_knobs(self, knob_file: dict, log) -> None:
        """Each hot engine knob the file edit changed, through the same
        appliers set_hot's path uses; the operator's edit outranks (and
        drops) a set_hot override."""
        from .config import HOT_ENGINE_KEYS

        appliers = self._hot_knob_appliers()
        for key in HOT_ENGINE_KEYS:
            new_v = self.config.file_value(key)
            if new_v == knob_file.get(key):
                continue
            knob_file[key] = new_v
            self.config.clear_hot(key)
            fn = appliers.get(key)
            if fn is None:
                continue
            try:
                fn(new_v)
                log.info("hot knob reloaded", key=key, value=new_v)
            except Exception as e:
                log.warn("hot knob reload apply failed", key=key, error=str(e))

    def _prime_recovered_csr(self, store) -> None:
        """Install the CSR arrays a checkpoint carried into the boot
        snapshot: only when the checkpoint's CSR was derived at exactly this
        version and the padded shapes agree (the padding buckets are the
        reference's, deterministic in node and edge counts, so a match means
        the same graph). ``csr_primed`` records whether it happened."""
        rep = store.recovery
        if rep.csr is None:
            return
        try:
            import numpy as np

            snap = self.snapshots().snapshot()
            indptr, indices = rep.csr
            if (
                rep.csr_version == snap.version
                and snap._csr is None
                and len(indptr) == snap.padded_nodes + 1
                and len(indices) == snap.padded_edges
            ):
                snap._csr = (
                    np.asarray(indptr, dtype=np.int32),
                    np.asarray(indices, dtype=np.int32),
                )
                snap._csr_edges = snap.num_edges
                snap._csr_extra = None
                self.csr_primed = True
                _log.info("snapshot CSR primed from the checkpoint at version %d",
                          snap.version)
        except Exception as e:
            _log.warning("checkpoint CSR priming failed; warmup derives it: %s", e)

    def _checkpoint_csr(self):
        """CSR provider for checkpoints: the current snapshot's fully derived
        CSR, or None (never forces a derive: a checkpoint must not pay an
        O(E log E) sort on the write path)."""
        mgr = self._snapshots
        if mgr is None:
            return None
        snap = mgr._snap
        if (
            snap is None
            or snap.version != self.store().version
            or snap._csr is None
            or snap._csr_edges != snap.num_edges
        ):
            return None
        return snap.version, snap._csr

    def mark_serving(self) -> None:
        """Readiness on: /health and the gRPC health service say SERVING
        (unless the device breaker is open)."""
        if self.grpc_enabled:
            self._health_servicer()
        self._serving = True
        self._sync_health()

    def _start_replicas(self, engine) -> None:
        """Fork max(serve.read.workers, serve.read.wire_workers) - 1 read
        replicas of this process, which then binds the shared read port as
        replica 0 (wire workers count only while serve.read.encoded is on).
        Only the closure engine in host query mode qualifies (a forked child
        must not touch CUDA); anything else serves from one process with one
        log line, as does a fork the thread inventory refuses. With wire
        workers, the ring is built before the fork and its consumer started
        after it."""
        n_workers, wire_workers = self._pool_sizes()
        n_pool = max(n_workers, wire_workers)
        if n_pool <= 1:
            return
        if not (hasattr(engine, "host_queries") and engine.host_queries()):
            _log.warning(
                "read workers require the closure engine in host query mode; "
                "serving single-process (engine %s)", type(engine).__name__,
            )
            return
        from ..graph import vocabsync
        from .replicas import ReplicaPool, resolve_free_ports

        host = self.config.read_api_host() or "0.0.0.0"
        read_port, grpc_port = resolve_free_ports(
            [(host, self.config.read_api_port()), ("127.0.0.1", 0)]
        )
        # mint the vocab wire lineage before forking, so every pool process
        # answers the encoded and vocab routes with the same identity
        vocabsync.lineage_of(self.snapshots().snapshot().vocab)
        wire_ring = None
        if wire_workers > 1:
            from ..engine.shmring import WireRing

            wire_ring = WireRing(n_pool - 1)  # one endpoint per child
        pool = ReplicaPool(self, n_pool)
        pool.wire_ring = wire_ring
        # wait out transient threads (a rebuild, the overlay's warm), but
        # give up early on an offender that stays the same
        t0 = time.monotonic()
        offender, since = None, t0
        while time.monotonic() - t0 < _FORK_QUIESCE_S:
            now = time.monotonic()
            if engine._rebuilding:
                offender, since = None, now
            else:
                try:
                    pool._enforce_fork_inventory()
                    break
                except RuntimeError as e:
                    if str(e) != offender:
                        offender, since = str(e), now
                    elif now - since >= _FORK_STABLE_S:
                        break
            time.sleep(0.05)
        try:
            pool.fork_replicas(read_port, grpc_port)
        except RuntimeError as e:
            if wire_ring is not None:
                wire_ring.close()
            _log.warning("cannot fork read replicas; serving single-process: %s", e)
        else:
            self._replica_pool = pool
            if wire_ring is not None:
                # the parent side: close the child ends (a worker's death
                # must read as EOF here), then start the consumer threads
                # that feed the one batcher
                from ..engine.shmring import RingServer

                wire_ring.parent_seal()
                self._wire_ring = wire_ring
                self._ring_server = RingServer(wire_ring, self._ring_handler)
                self._ring_server.start()
            _log.info(
                "read replicas forked: %d processes on read port %d "
                "(%d wire workers)", n_pool, read_port, wire_workers,
            )
        self._shared_read_ports = (read_port, grpc_port)

    def _pool_sizes(self) -> tuple[int, int]:
        """(serve.read.workers, serve.read.wire_workers); wire workers count
        only while serve.read.encoded is on."""
        wire_workers = 1
        if bool(self.config.get("serve.read.encoded")):
            wire_workers = int(self.config.get("serve.read.wire_workers"))
        return int(self.config.get("serve.read.workers")), wire_workers

    def _spawn_workers(self, n_workers: int, wire_workers: int) -> None:
        """A SQL-backed store scales its read plane out by spawning fresh
        workers (driver/spawn_workers.py), never by forking: the database is
        the shared state. Wire workers need the fork pool's ring, so they
        are ignored here with one log line, as the reference does."""
        from .replicas import resolve_free_ports
        from .spawn_workers import SpawnWorkerPool

        if wire_workers > 1:
            _log.warning(
                "serve.read.wire_workers needs the fork replica pool "
                "(a process-private store); ignoring %d", wire_workers,
            )
        if n_workers <= 1:
            return
        host = self.config.read_api_host() or "0.0.0.0"
        read_port, grpc_port = resolve_free_ports(
            [(host, self.config.read_api_port()), ("127.0.0.1", 0)]
        )
        pool = SpawnWorkerPool(self, n_workers)
        pool.start(read_port, grpc_port)
        self._replica_pool = pool
        self._shared_read_ports = (read_port, grpc_port)
        _log.info("read workers spawned: %d processes on read port %d",
                  n_workers, read_port)

    def stop_all(self) -> None:
        self._serving = False  # readiness first, so balancers stop routing
        if self._health is not None:
            self._health.set_serving(False)
        # the cluster plane next: stop advertising and scraping a node about
        # to lose its serving surfaces. A clean stop releases the lease, so
        # the survivors fail over in one heartbeat, not a TTL
        if self._election is not None:
            self._election.stop(release=True)
            self._election = None
        if self._federation is not None:
            self._federation.stop()
            self._federation = None
        if self._cluster_heartbeater is not None:
            self._cluster_heartbeater.stop()
            self._cluster_heartbeater = None
        if self._replica_pool is not None:
            self._replica_pool.stop()
            self._replica_pool = None
        # the ring after the pool: the workers holding the child ends are
        # gone, so stopping the consumer threads strands no frame
        if self._ring_server is not None:
            self._ring_server.stop()
            self._ring_server = None
        if self._wire_ring is not None:
            self._wire_ring.close()
            self._wire_ring = None
        if self._autotuner is not None:
            # before the batcher closes: a knob move mid-shutdown must not
            # race reconfigure() against close()
            self._autotuner.stop()
            self._autotuner = None
        if self._scrubber is not None:
            self._scrubber.stop()
        if self._profiler is not None:
            self._profiler.stop()
        if self._config_watcher is not None:
            self._config_watch_stop.set()
            self._config_watcher.join(timeout=5)
            self._config_watcher = None
        if self._read_plane is not None:
            self._read_plane.stop()
        if self._write_plane is not None:
            self._write_plane.stop()
        if self._checker is not None:
            self._checker.close()
        if self._device_supervisor is not None:
            self._device_supervisor.stop()
        if self._promoted_source is not None:
            # after the write plane: the last acked mutation has run its
            # delta listener, so the adopted WAL is complete
            self._promoted_source.close()
            self._promoted_source = None
        if self._replicator is not None:
            self._replicator.stop()
        if self._store is not None and hasattr(self._store, "close_durable"):
            # final checkpoint + WAL close: the next boot recovers from the
            # checkpoint instead of replaying the whole log
            self._store.close_durable()
        if self._snapshots is not None:
            self._snapshots.close()
        if self._namespace_manager is not None and hasattr(
            self._namespace_manager, "close"
        ):
            self._namespace_manager.close()  # a watcher's thread
        if self._flight is not None:
            self._flight.close()  # the final ring flush, faulthandler off
        if self._tracer is not None:
            # ship the last partial OTLP batch, then end the exporter
            self._tracer.flush(timeout_s=3.0)
            self._tracer.close()
