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
the caller passes ``device="cpu"``; without CUDA it raises. The sharded
tiers, which this package does not have yet, fail with an error that names
their roadmap item (12).

``serve.read.workers`` N > 1 serves the read port from N processes: after
the warmup ``start_all`` forks N - 1 read replicas (``driver/replicas.py``)
that share the read port through ``SO_REUSEPORT``, then binds its own
planes. A forked child must not touch CUDA, so with ``engine.query_mode:
auto`` the closure engine is built in host query mode; any other engine
(a device query mode, the frontier engines, the host oracle) serves from
one process, and ``start_all`` logs one line saying so.

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
import threading
import time
from typing import Optional

from .. import __version__
from ..api.daemon import PlaneServer
from ..api.rest import build_read_router, build_write_router
from ..engine.batcher import CheckBatcher, DirectChecker
from ..engine.cache import CheckResultCache
from ..engine.check import CheckEngine
from ..graph.snapshot import SnapshotManager
from ..store.columnar import ColumnarTupleStore
from ..store.memory import InMemoryTupleStore
from ..utils.errors import ErrMalformedInput
from ..utils.kernels import resolve_device
from .config import Config

_SHARDED_MSG = (
    "sharded serving (engine.mode sharded, engine.sharding.enabled) is not "
    "ported to keto_tpu_torch yet: ROADMAP item 12, the multi-device tiers"
)
_GRPC_SIZE_KEYS = (
    "serve.read.grpc-max-message-size",
    "serve.write.grpc-max-message-size",
)

_log = logging.getLogger("keto_tpu_torch")

# how long start_all waits for transient threads (a closure rebuild, the
# overlay's groupings warm) to end before forking read replicas, and how
# long one unchanged offender may persist before it gives up early
_FORK_QUIESCE_S = 180.0
_FORK_STABLE_S = 2.0


class Registry:
    def __init__(self, config: Optional[Config] = None, device=None):
        self.config = config if config is not None else Config()
        self.device = resolve_device(device)
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
        # the gRPC plane: its builders module once probed (None when grpc or
        # google.protobuf do not import), why it is off, and the health
        # service both planes share
        self._grpc_probed = False
        self._grpc_api = None
        self.grpc_off_reason = ""
        self._health = None

    # -- providers -------------------------------------------------------------

    def namespace_manager(self):
        with self._lock:
            if self._namespace_manager is None:
                self._namespace_manager = self.config.namespace_manager()
            return self._namespace_manager

    def store(self):
        with self._lock:
            if self._store is None:
                dsn = self.config.dsn()
                if dsn in ("memory", "sqlite://:memory:", ""):
                    cls = InMemoryTupleStore
                elif dsn == "columnar":
                    cls = ColumnarTupleStore
                else:
                    raise ErrMalformedInput(
                        f"unsupported DSN {dsn!r}: keto_tpu_torch supports "
                        "'memory' and 'columnar'"
                    )
                self._store = cls(namespace_manager=self.namespace_manager())
            return self._store

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

    def _build_check_engine(self):
        cfg = self.config
        max_depth = cfg.read_api_max_depth()
        mode = cfg.engine_mode()
        if mode == "sharded" or (
            bool(cfg.get("engine.sharding.enabled")) and mode != "host"
        ):
            raise ErrMalformedInput(_SHARDED_MSG)
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
                device=self.device,
            )
        from ..engine.device import DeviceCheckEngine

        # 'device' -> size-based choice; 'dense'/'scatter'/'packed' force it
        return DeviceCheckEngine(
            self.snapshots(),
            max_depth=max_depth,
            mode=mode if mode in ("dense", "scatter", "packed") else "auto",
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
                    self._checker = CheckBatcher(
                        engine,
                        max_batch=max_batch,
                        max_queue=int(cfg.get("engine.max_queue")),
                        max_freshness_wait_s=float(
                            cfg.get("serve.read.max_freshness_wait_s")
                        ),
                        cache=(
                            CheckResultCache(cache_size) if cache_size > 0 else None
                        ),
                        version_fn=self._answering_version,
                        pipeline_depth=int(cfg.get("engine.pipeline_depth")),
                        encode_workers=int(cfg.get("engine.encode_workers")),
                        encoded_cache_size=int(cfg.get("engine.encoded_cache_size")),
                        qos=self.qos(),
                        overload=self.overload(),
                    )
            return self._checker

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
                )
            return self._qos

    def overload(self):
        """The overload-control plane (engine/overload.py): the AIMD limit
        and CoDel discipline at the batcher's admission, the criticality
        brownout ladder and the accepts/requests throttle. None unless
        overload.enabled (the reference's live kill switch waits for hot
        reload, ROADMAP 14.4)."""
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
                # the flight recorder and the logger wait for ROADMAP 14.5
                brownout = BrownoutController(
                    hysteresis_s=float(cfg.get("overload.hysteresis_ms")) / 1e3,
                    min_dwell_s=float(cfg.get("overload.dwell_ms")) / 1e3,
                    history=int(cfg.get("overload.history")),
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
        allowed = front.check(
            req, timeout=float(self.config.get("serve.read.max_freshness_wait_s"))
        )
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

    # -- snaptokens ------------------------------------------------------------

    def snaptoken(self) -> str:
        """Write-plane snaptoken: the store's version counter."""
        return str(self.store().version)

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
        return self._serving

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
                    max_freshness_wait_s=float(
                        self.config.get("serve.read.max_freshness_wait_s")
                    ),
                    default_criticality=self.default_criticality(),
                )
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
                        max_freshness_wait_s=float(
                            self.config.get("serve.read.max_freshness_wait_s")
                        ),
                        encoded_front=self.encoded_front(),
                        list_engine=self.list_engine(),
                        list_version_waiter=getattr(
                            self.check_engine(), "wait_for_version", None
                        ),
                        default_criticality=self.default_criticality(),
                    )
                read_port, grpc_port = self._shared_read_ports
                self._read_plane = PlaneServer(
                    router, self.config.read_api_host(),
                    read_port or self.config.read_api_port(), grpc_server,
                    grpc_port=grpc_port, reuse_port=read_port != 0,
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
                router = build_write_router(
                    self.store(), self.version, healthy_fn=self.is_serving
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
                    )
                self._write_plane = PlaneServer(
                    router, self.config.write_api_host(),
                    self.config.write_api_port(), grpc_server,
                )
            return self._write_plane

    def _grpc_workers(self) -> int:
        # every in-flight check holds a worker: size the pool so a batch
        # can fill, capped (as the reference)
        import os

        cap = max(64, 32 * (os.cpu_count() or 1))
        return min(int(self.config.get("engine.max_batch")), cap, 512)

    def start_all(self) -> tuple[int, int]:
        """Warm the check engine up (the closure build, the query path at
        max_batch), fork the read replicas when serve.read.workers > 1, then
        start both planes; returns (read_port, write_port). Readiness flips
        only after bring-up."""
        engine = self.check_engine()
        if hasattr(engine, "warmup"):
            engine.warmup(int(self.config.get("engine.max_batch")))
        # freeze the long-lived object graph (store rows, vocab keys,
        # closure artifacts) out of the cyclic GC: a full collection over
        # millions of immortal objects would land inside random requests
        # as tail latency
        gc.freeze()
        # before checker(), the planes and the gRPC server start threads
        self._start_replicas(engine)
        read_port = self.read_plane().start()
        write_port = self.write_plane().start()
        if not self.grpc_enabled:
            _log.warning(self.grpc_off_reason)
        self.mark_serving()
        return read_port, write_port

    def mark_serving(self) -> None:
        """Readiness on: /health and the gRPC health service say SERVING."""
        if self.grpc_enabled:
            self._health_servicer().set_serving(True)
        self._serving = True

    def _start_replicas(self, engine) -> None:
        """Fork max(serve.read.workers, serve.read.wire_workers) - 1 read
        replicas of this process, which then binds the shared read port as
        replica 0 (wire workers count only while serve.read.encoded is on).
        Only the closure engine in host query mode qualifies (a forked child
        must not touch CUDA); anything else serves from one process with one
        log line, as does a fork the thread inventory refuses. With wire
        workers, the ring is built before the fork and its consumer started
        after it."""
        n_workers = int(self.config.get("serve.read.workers"))
        wire_workers = 1
        if bool(self.config.get("serve.read.encoded")):
            wire_workers = int(self.config.get("serve.read.wire_workers"))
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

    def stop_all(self) -> None:
        self._serving = False  # readiness first, so balancers stop routing
        if self._health is not None:
            self._health.set_serving(False)
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
        if self._read_plane is not None:
            self._read_plane.stop()
        if self._write_plane is not None:
            self._write_plane.stop()
        if self._checker is not None:
            self._checker.close()
        if self._snapshots is not None:
            self._snapshots.close()
