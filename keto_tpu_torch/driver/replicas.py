"""Read-replica worker pool: fork-shared residency, SO_REUSEPORT serving,
parent-side supervision with delta-stream resync (counterpart of
``keto_tpu/driver/replicas.py``).

One interpreter caps the served check far below what the engine answers:
every request costs the process's interpreter lock an HTTP exchange. The
pool forks N - 1 read replicas after the store and the closure are
resident, so the host arrays (tuple columns, CSRs, the host closure D) are
shared copy-on-write, with no serialization. Each replica:

- binds the same read port (and the same loopback gRPC port) with
  SO_REUSEPORT; the kernel spreads accepted connections over the replicas;
- owns a full serving stack (REST plane, gRPC server, check batcher) with
  fresh post-fork locks;
- stays fresh through a parent-to-child delta stream: the parent forwards
  every store delta over a socketpair, and the replica applies it to its own
  store copy, which drives its own snapshot manager and write overlay.

The parent keeps the write plane (one writer) and serves reads too, as
replica 0. With wire workers (``serve.read.wire_workers``) the registry
hands the pool a ``WireRing`` before the fork: child ``i`` claims endpoint
``i - 1`` and its encoded front ships batches to the parent's batcher; the
zygote drops every ring end, so a respawned replica answers encoded frames
from its own engine, as in the reference. A child never touches CUDA: the
registry forks only an engine in host query mode (``engine/closure.py``),
whose D, D^T, overlay patches and list gathers are numpy, and every child
clears ``allow_device_builds``, so a replica past its overlay answers from
the exact live-store oracle instead of building. A CUDA call in a child
raises; nothing catches that into another path.

Fork discipline: the fork happens before the parent creates any gRPC
server, check batcher or plane thread, at a quiesced moment (warmup done,
no in-flight writes); ``_enforce_fork_inventory`` refuses to fork with any
other live Python thread (the namespace watchers and the config watcher are
admitted). Bulk store loads after the pool starts are not supported (the
delta stream cannot describe them).

Config: a serving replica re-arms a watched namespace source (a file, a
directory or ``ws://``; ``restart_after_fork``), so every process sees a
namespace added after the fork. The config file is watched by the parent
alone, as in the reference: a reloaded hot knob (``engine.pipeline_depth``
and the rest) reaches the parent's batcher only, and each replica keeps the
knobs it was forked with.

Self-healing:

- **Supervision.** A parent thread polls every replica's delta socket; EOF
  means the replica died (SIGKILL, OOM). The dead replica is pruned, logged
  and replaced.
- **Zygote respawn.** A non-serving zygote is forked first, before any
  server exists. It holds the shared residency, applies the same delta
  stream on its one thread, and forks replacement replicas on demand; each
  respawn inherits near-current state for the cost of a fork. A spawn
  command ships the replica's delta socket by fd passing
  (``socket.send_fds``).
- **Resync.** A replica announces its store version on boot and again the
  moment it sees a version gap. The parent replays the missing frames from
  a bounded delta log; a gap older than the log gets ``("restart",)``, and
  the replica exits to be respawned fresh.

Every child exits when its parent's end of the socket closes, so no
replica outlives its parent. The fault sites (``faults.py``):
``delta.slow`` stalls a broadcast, ``delta.drop`` skips one frame for one
replica (the resync fills the gap), ``replica.crash`` kills a replica with a
delta in hand; a respawn command carries the parent's current armed state.
The pool exports the reference's families: ``keto_replica_respawns_total``,
``keto_replica_resyncs_total`` and the ``keto_replica_children`` gauge. Each
replica rebuilds its tracer's OTLP exporter after the fork
(``Tracer.restart_after_fork``), and ``otlp-exporter`` is a thread the fork
inventory admits, as in the reference.
Only process-private stores (memory, columnar, and the durable wrapper
over them) reach this pool; a SQL store's state is the database, and the
registry spawns fresh workers for it instead (``driver/spawn_workers.py``).
"""

from __future__ import annotations

import gc
import logging
import os
import pickle
import select
import signal
import socket
import struct
import threading
import traceback
from collections import deque
from typing import Optional

from ..faults import FAULTS

_LEN = struct.Struct("!I")
_log = logging.getLogger("keto_tpu_torch")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One length-prefixed frame, or None at EOF."""
    head = b""
    while len(head) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _LEN.unpack(head)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def resolve_free_ports(specs: list[tuple[str, int]]) -> list[int]:
    """Resolve every port-0 spec to a concrete free port, holding all the
    probe sockets open until the whole set is chosen (bind-close-bind in
    turn could hand one port out twice). The pool needs concrete numbers
    before forking so every replica binds the same ports; the window between
    close and rebind is the standard cost of an SO_REUSEPORT pool."""
    held = []
    out = []
    try:
        for host, port in specs:
            if port != 0:
                out.append(port)
                continue
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host or "0.0.0.0", 0))
            held.append(s)
            out.append(s.getsockname()[1])
    finally:
        for s in held:
            s.close()
    return out


def _reset_inherited_locks(registry, serving: bool = True) -> None:
    """Fresh synchronization primitives for a forked process. The fork
    happens quiesced, so no lock is held, but an inherited RLock also keeps
    the parent's owner bookkeeping: replace them all.

    ``serving=False`` is the zygote's variant: locks only, no thread-starting
    re-arms, so the zygote stays single-threaded and its forks stay safe."""
    store = registry.store()
    inner = getattr(store, "inner", store)  # the durable wrapper's store
    if inner is not store:
        store._mutate_lock = threading.Lock()
        store._ckpt_lock = threading.Lock()
    inner._lock = threading.RLock()
    inner._deliver_lock = threading.Lock()
    inner._deliver_cv = threading.Condition()
    inner._deliver_owner = None
    vocab = getattr(inner, "vocab", None)
    if vocab is not None:
        vocab._h_lock = threading.Lock()
    registry._lock = threading.RLock()
    registry.snapshots()._lock = threading.RLock()
    engine = registry.check_engine()
    engine._lock = threading.Lock()
    engine._build_lock = threading.Lock()
    engine._state_cv = threading.Condition()
    engine._rebuilding = False
    # a replica that outgrows its overlay answers from the live-store
    # oracle: a forked child must not touch CUDA, and builds nothing
    engine.allow_device_builds = False
    state = engine._state
    if state is not None and hasattr(state, "rev_lock"):
        state.rev_lock = threading.Lock()
    ov = engine._overlay
    if ov is not None:
        ov._lock = threading.Lock()
        ov._groupings_build_lock = threading.Lock()
        if serving:
            # the parent's warm thread (if any) did not survive the fork
            ov.warm_groupings_async()
    if not serving:
        return
    # a namespace watcher lost its poll or reader thread at the fork: re-arm
    # it, so the replica keeps tracking namespace changes (the config file
    # itself is watched by the parent alone)
    inner = getattr(registry.config._namespace_manager, "inner", None)
    if inner is not None and hasattr(inner, "restart_after_fork"):
        inner.restart_after_fork()
    # the OTLP exporter's flusher thread is gone too: rebuild it, so the
    # spans a replica serves still reach the collector
    if registry._tracer is not None:
        registry._tracer.restart_after_fork()


class _Link:
    """The parent's handle on one replica: its pid (-1 until known: mid-fork,
    or a zygote respawn whose pid report is in flight), the delta socket, and
    a send lock serializing the two parent-side writers (the store's
    broadcast and the supervisor's replays) so frames never interleave."""

    __slots__ = ("pid", "sock", "lock")

    def __init__(self, pid: int, sock: socket.socket):
        self.pid = pid
        self.sock = sock
        self.lock = threading.Lock()


class ReplicaPool:
    """Forks `n_replicas - 1` children (the parent serves as replica 0)."""

    # Python threads a quiesced serve boot may have alive at fork time: the
    # namespace watchers and the config watcher are permanent loops whose
    # locks a serving replica re-arms after the fork (a watched namespace
    # directory must not cost the pool). Any other thread is a liveness
    # hazard for the children (a thread inside a critical section is cloned
    # holding its lock) and refuses the fork: the check batcher's dispatcher
    # and encode workers, the overlay's groupings warm, the closure rebuild
    # worker, the plane and gRPC threads all must not exist yet. The store's
    # notifier has no thread.
    FORK_SAFE_THREADS = (
        "MainThread",
        "pydev",
        "namespace-watcher",
        "namespace-ws-watcher",
        "otlp-exporter",
        "config-watcher",
    )

    # a replica that cannot drain its delta socket within this budget is
    # killed: the write path must never block on a sick reader
    SEND_TIMEOUT_S = 5.0
    # resync replay window; a replica whose gap starts older than this many
    # frames is restarted (respawned near-current from the zygote)
    DELTA_LOG_FRAMES = 4096

    def __init__(self, registry, n_replicas: int):
        self.registry = registry
        self.n_replicas = n_replicas
        self._children: list[_Link] = []
        self._bcast_lock = threading.Lock()
        self._zygote: Optional[_Link] = None
        self._zygote_pid = -1
        self._ports: tuple[int, int] = (0, 0)
        # bounded replay window for the resync handshake: (version, frame)
        self._delta_log: deque = deque(maxlen=self.DELTA_LOG_FRAMES)
        self._log_lock = threading.Lock()
        self._pending_spawns: deque = deque()  # links awaiting a pid report
        self._supervisor: Optional[threading.Thread] = None
        self._stopping = False
        self._wake_r: Optional[socket.socket] = None
        self._wake_w: Optional[socket.socket] = None
        self.n_respawns = 0
        self._m_respawns = self._m_resyncs = None
        # the wire workers' shared-memory ring (engine/shmring.py), set by
        # the registry before fork_replicas when serve.read.wire_workers > 1
        self.wire_ring = None

    def alive(self) -> int:
        """Processes serving the read port: the parent and every live
        replica whose pid is known."""
        with self._bcast_lock:
            pids = [link.pid for link in self._children if link.pid > 0]
        n = 1
        for pid in pids:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                continue
            n += 1
        return n

    def child_pids(self) -> list[int]:
        with self._bcast_lock:
            return [link.pid for link in self._children]

    # -- parent side -------------------------------------------------------------

    def fork_replicas(self, read_port: int, grpc_port: int) -> None:
        """Fork the zygote and the children; each child enters _child_main
        and never returns. Must run before the parent creates any gRPC
        server, batcher or plane thread.

        Subscribes to the delta feed before forking: subscribing after would
        open a window where a write lands unbroadcast, a version gap no
        replica could fill. A write landing mid-loop is safe both ways:
        forked children receive the frame; later children inherit the
        post-write store and drop the frame as stale."""
        # the inventory first: failing after subscribing would leave a
        # childless pool pickling every future write
        self._enforce_fork_inventory()
        self._ports = (read_port, grpc_port)
        metrics = self.registry.metrics()
        self._m_respawns = metrics.counter(
            "keto_replica_respawns_total",
            "dead read replicas replaced by the supervisor (zygote forks)",
        )
        self._m_resyncs = metrics.counter(
            "keto_replica_resyncs_total",
            "delta-log replays served to lagging or freshly-spawned "
            "replicas",
        )
        metrics.gauge(
            "keto_replica_children",
            "live forked read replicas (excludes the parent, replica 0)",
            fn=lambda: len(self._children),
        )
        store = self.registry.store()
        if self.n_replicas > 1:
            store.subscribe_deltas(self._broadcast)
        try:
            self._fork_zygote()
            self._fork_loop(read_port, grpc_port)
            self._start_supervisor()
        except BaseException:
            store.unsubscribe_deltas(self._broadcast)
            self.stop()
            raise

    def _fork_zygote(self) -> None:
        """Fork the non-serving zygote first, while this process can still
        fork safely: it is the only source of replacement replicas once the
        parent's servers and threads exist."""
        if self.n_replicas <= 1:
            return
        parent_sock, child_sock = socket.socketpair()
        # registered before the fork, as in _fork_loop: frames broadcast
        # mid-fork wait in the buffer and the zygote drops the stale ones
        with self._bcast_lock:
            self._zygote = _Link(-1, parent_sock)
        try:
            pid = os.fork()
        except BaseException:
            with self._bcast_lock:
                self._zygote = None
            parent_sock.close()
            child_sock.close()
            raise
        if pid == 0:
            parent_sock.close()
            if self.wire_ring is not None:
                # the zygote and every replica it respawns hold no ring end:
                # a stray copy would hide a worker's (or the parent's) death,
                # and a respawned replica answers encoded frames locally
                self.wire_ring.drop_inherited()
                self.wire_ring = None
            try:
                self._zygote_main(child_sock)
            finally:
                os._exit(0)
        child_sock.close()
        self._zygote_pid = pid
        with self._bcast_lock:
            if self._zygote is not None:
                self._zygote.pid = pid

    def _fork_loop(self, read_port: int, grpc_port: int) -> None:
        for i in range(1, self.n_replicas):
            parent_sock, child_sock = socket.socketpair()
            link = _Link(-1, parent_sock)
            # register the socket before forking: a broadcast landing between
            # fork and registration would reach neither the child's socket
            # nor its fork snapshot. Frames broadcast before the fork sit in
            # the buffer and the child drops them as stale
            with self._bcast_lock:
                self._children.append(link)
            try:
                pid = os.fork()
            except BaseException:
                with self._bcast_lock:
                    if link in self._children:
                        self._children.remove(link)
                parent_sock.close()
                child_sock.close()
                raise
            if pid == 0:
                parent_sock.close()
                if self.wire_ring is not None:
                    # endpoint i - 1 belongs to child i (the endpoints are
                    # numbered over the children; the parent has none)
                    self.registry._wire_ring_client = self.wire_ring.child_claim(i - 1)
                try:
                    self._child_main(child_sock, read_port, grpc_port)
                finally:
                    os._exit(0)
            child_sock.close()
            with self._bcast_lock:
                if link in self._children:
                    link.pid = pid
                else:
                    # _broadcast pruned the placeholder (a send timeout in the
                    # fork window): the child gets no deltas, so it must not
                    # serve
                    try:
                        os.kill(pid, signal.SIGKILL)
                        os.waitpid(pid, 0)
                    except (ProcessLookupError, ChildProcessError):
                        pass

    def _enforce_fork_inventory(self) -> None:
        """Forking after threads exist is defensible only when every live
        Python thread is known and quiescent. The registry waits out the
        transient ones before calling; this check makes that contract hold."""
        unexpected = [
            t.name
            for t in threading.enumerate()
            if t is not threading.current_thread()
            and not t.name.startswith(self.FORK_SAFE_THREADS)
        ]
        if unexpected:
            raise RuntimeError(
                "refusing to fork read replicas with unexpected live "
                f"threads: {unexpected} (quiesce or stop them first, or "
                "serve single-process)"
            )

    def _send_to(self, link: _Link, payload: bytes) -> None:
        with link.lock:
            link.sock.settimeout(self.SEND_TIMEOUT_S)
            _send_frame(link.sock, payload)

    def _broadcast(self, version, inserted, deleted) -> None:
        """Forward one store delta to every replica and the zygote (on the
        writer's thread). Bounded: a stalled replica is killed and pruned
        rather than wedging every later write behind a full socket buffer."""
        payload = pickle.dumps(
            ("delta", version, list(inserted or []), list(deleted or [])),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        with self._log_lock:
            self._delta_log.append((version, payload))
        # fault sites: stall the broadcast (a replica staleness window), or
        # skip this frame for ONE serving replica — the version gap the
        # resync handshake exists to detect and fill
        FAULTS.maybe_sleep("delta.slow")
        drop_one = FAULTS.should_fire("delta.drop")
        with self._bcast_lock:
            links = list(self._children)
            zygote = self._zygote
        dead = []
        for link in links:
            if drop_one:
                drop_one = False
                continue
            try:
                self._send_to(link, payload)
            except OSError:  # socket.timeout is an OSError
                dead.append(link)
        if zygote is not None:
            try:
                self._send_to(zygote, payload)
            except OSError:
                # a wedged zygote cannot fork fresh replicas anyway; drop it
                # rather than stall the write path
                self._drop_zygote(zygote)
        for link in dead:
            self._kill_link(link)

    def _kill_link(self, link: _Link) -> None:
        with self._bcast_lock:
            if link in self._children:
                self._children.remove(link)
        try:
            link.sock.close()
        except OSError:
            pass
        # pid < 0 marks a mid-fork placeholder: never signal a negative pid
        # (that signals a process group)
        if link.pid > 0:
            try:
                os.kill(link.pid, signal.SIGKILL)  # it cannot serve fresh reads
            except (ProcessLookupError, PermissionError):
                pass
            try:
                # zygote-forked replicas are grandchildren, not ours to reap
                # (the zygote ignores SIGCHLD, so the kernel reaps them)
                os.waitpid(link.pid, os.WNOHANG)
            except ChildProcessError:
                pass

    def _drop_zygote(self, zygote: _Link) -> None:
        with self._bcast_lock:
            if self._zygote is zygote:
                self._zygote = None
        try:
            zygote.sock.close()
        except OSError:
            pass
        if zygote.pid > 0:
            try:
                os.kill(zygote.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                os.waitpid(zygote.pid, os.WNOHANG)
            except ChildProcessError:
                pass

    # -- supervisor ---------------------------------------------------------------

    def _start_supervisor(self) -> None:
        if self.n_replicas <= 1:
            return
        self._wake_r, self._wake_w = socket.socketpair()
        self._supervisor = threading.Thread(
            target=self._supervise, name="replica-supervisor", daemon=True
        )
        self._supervisor.start()

    def _supervise(self) -> None:
        """select() on every replica socket and the zygote's. Readable means a
        control frame (a resync request, a spawned-pid report) or EOF (a
        death). EOF detects the death of direct children and of
        zygote-forked grandchildren alike, which waitpid cannot see."""
        while not self._stopping:
            with self._bcast_lock:
                links = list(self._children)
                zygote = self._zygote
            socks = {link.sock: link for link in links}
            rlist = list(socks) + [self._wake_r]
            if zygote is not None:
                rlist.append(zygote.sock)
            try:
                readable, _, _ = select.select(rlist, [], [], 1.0)
            except (OSError, ValueError):
                continue  # a socket was closed mid-select; look again
            for sock in readable:
                if self._stopping or sock is self._wake_r:
                    return
                if zygote is not None and sock is zygote.sock:
                    self._read_zygote(zygote)
                    continue
                link = socks.get(sock)
                if link is not None:
                    self._read_child(link)

    def _read_child(self, link: _Link) -> None:
        try:
            frame = _recv_frame(link.sock)
        except OSError:
            frame = None
        if frame is None:
            _log.warning("read replica died; respawning (pid %d)", link.pid)
            self._kill_link(link)
            self._respawn()
            return
        try:
            msg = pickle.loads(frame)  # frames written by this pool's replicas
        except Exception:
            _log.warning("garbled control frame from replica (pid %d)", link.pid)
            return
        if msg[0] == "resync":
            self._resync(link, int(msg[1]))

    def _resync(self, link: _Link, have_version: int) -> None:
        """Replay versions (have_version, current] from the delta log, or
        order a restart when the gap predates the log."""
        store = self.registry.store()
        with self._log_lock:
            frames = [(v, p) for v, p in self._delta_log if v > have_version]
            oldest_logged = self._delta_log[0][0] if self._delta_log else None
        need_from = have_version + 1
        if store.version > have_version and (
            oldest_logged is None or need_from < oldest_logged
        ):
            # the gap starts before the replay window: restart the replica
            # fresh from the near-current zygote
            _log.warning(
                "replica gap predates the delta log; restarting replica "
                "(pid %d, have %d, oldest logged %s)",
                link.pid, have_version, oldest_logged,
            )
            try:
                self._send_to(link, pickle.dumps(("restart",)))
            except OSError:
                self._kill_link(link)
                self._respawn()
            return
        if self._m_resyncs is not None:
            self._m_resyncs.inc()
        try:
            for _v, payload in frames:
                self._send_to(link, payload)
        except OSError:
            self._kill_link(link)
            self._respawn()
            return
        if frames:
            _log.info(
                "replayed %d delta frames to replica (pid %d) from version %d",
                len(frames), link.pid, need_from,
            )

    def _respawn(self) -> None:
        """Ask the zygote for a replacement replica. The new delta socket is
        made here and its child end shipped to the zygote by fd passing, so
        the parent registers it (and buffers broadcasts to it) before the
        replacement exists."""
        with self._bcast_lock:
            zygote = self._zygote
        if zygote is None:
            _log.warning(
                "no zygote available; pool capacity permanently reduced "
                "(%d children)", len(self._children),
            )
            return
        parent_sock, child_sock = socket.socketpair()
        link = _Link(-1, parent_sock)
        with self._bcast_lock:
            self._children.append(link)
        self._pending_spawns.append(link)
        try:
            # the current fault snapshot rides along: a fault armed at boot
            # and disarmed since must not come back in the replacement
            cmd = pickle.dumps(
                ("spawn", self._ports, FAULTS.snapshot()),
                protocol=pickle.HIGHEST_PROTOCOL,
            )
            with zygote.lock:
                zygote.sock.settimeout(self.SEND_TIMEOUT_S)
                _send_frame(zygote.sock, cmd)
                # the fd follows its command one to one, under the same lock
                socket.send_fds(zygote.sock, [b"F"], [child_sock.fileno()])
        except OSError:
            with self._bcast_lock:
                if link in self._children:
                    self._children.remove(link)
            if link in self._pending_spawns:
                self._pending_spawns.remove(link)
            parent_sock.close()
            self._drop_zygote(zygote)
            _log.warning("zygote unreachable; pool capacity permanently reduced")
        else:
            self.n_respawns += 1
            if self._m_respawns is not None:
                self._m_respawns.inc()
        finally:
            child_sock.close()

    def _read_zygote(self, zygote: _Link) -> None:
        try:
            frame = _recv_frame(zygote.sock)
        except OSError:
            frame = None
        if frame is None:
            self._drop_zygote(zygote)
            _log.warning("zygote died; dead replicas can no longer be respawned")
            return
        try:
            msg = pickle.loads(frame)  # frames written by this pool's zygote
        except Exception:
            return
        if msg[0] == "spawned" and self._pending_spawns:
            link = self._pending_spawns.popleft()
            pid = int(msg[1])
            with self._bcast_lock:
                present = link in self._children
                if present:
                    link.pid = pid
            if present:
                _log.info("read replica respawned from the zygote (pid %d)", pid)
            else:
                # the placeholder was pruned (stalled during the spawn): the
                # replacement must not serve without a delta feed
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

    def stop(self) -> None:
        self._stopping = True
        self.registry.store().unsubscribe_deltas(self._broadcast)
        if self._wake_w is not None:
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
            self._supervisor = None
        with self._bcast_lock:
            links = list(self._children)
            self._children.clear()
            zygote = self._zygote
            self._zygote = None
        if zygote is not None:
            links.append(zygote)
        # closing the delta socket alone ends a replica (EOF on its feed);
        # SIGTERM covers one that is not reading it
        for link in links:
            try:
                link.sock.close()
            except OSError:
                pass
            if link.pid > 0:
                try:
                    os.kill(link.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        for link in links:
            if link.pid > 0:
                try:
                    os.waitpid(link.pid, 0)
                except ChildProcessError:
                    pass  # grandchildren are reaped by the kernel
        for s in (self._wake_r, self._wake_w):
            if s is not None:
                s.close()
        self._wake_r = self._wake_w = None

    # -- zygote ------------------------------------------------------------------

    def _zygote_main(self, sock: socket.socket) -> None:
        """The non-serving fork source. Single-threaded by construction: one
        loop applies delta frames (so respawned replicas start near-current)
        and forks replacement replicas on spawn commands."""
        _reset_child_process()
        # replacement replicas are this process's children; the kernel reaps
        # them, so a dead one never lingers as a zombie
        signal.signal(signal.SIGCHLD, signal.SIG_IGN)
        reg = self.registry
        _reset_inherited_locks(reg, serving=False)
        self._drop_parent_side()
        gc.freeze()
        store = reg.store()
        held: dict[int, tuple] = {}
        max_held = 1024
        while True:
            try:
                frame = _recv_frame(sock)
            except OSError:  # a reset: the parent went away too
                frame = None
            if frame is None:
                os._exit(0)  # the parent went away
            msg = pickle.loads(frame)  # frames written by the parent
            if msg[0] == "delta":
                _, version, inserted, deleted = msg
                if version <= store.version:
                    continue  # a frame from before the fork
                held[version] = (inserted, deleted)
                while (nxt := store.version + 1) in held:
                    ins, dels = held.pop(nxt)
                    store.transact_relation_tuples(ins, dels)
                if len(held) > max_held:
                    # an unfillable gap: a stale zygote would respawn
                    # replicas the delta log cannot catch up
                    os._exit(3)
            elif msg[0] == "spawn":
                _, ports, fault_snapshot = msg
                _msg, fds, _flags, _addr = socket.recv_fds(sock, 1, 1)
                if not fds:
                    continue
                # the parent's CURRENT fault state, not the one inherited at
                # the zygote's fork: disarmed faults must not resurrect
                FAULTS.load(fault_snapshot)
                pid = os.fork()
                if pid == 0:
                    sock.close()
                    child_sock = socket.socket(fileno=fds[0])
                    try:
                        self._child_main(child_sock, *ports)
                    finally:
                        os._exit(0)
                os.close(fds[0])
                try:
                    _send_frame(sock, pickle.dumps(("spawned", pid)))
                except OSError:
                    os._exit(0)

    # -- child side --------------------------------------------------------------

    def _drop_parent_side(self) -> None:
        """In a forked process: close the inherited parent-side sockets
        (writing to a sibling's would corrupt the parent's stream) and drop
        the store's subscription to _broadcast (a replica applying a delta
        must not broadcast it again)."""
        for link in self._children:
            try:
                link.sock.close()
            except OSError:
                pass
        self._children = []
        if self._zygote is not None:
            try:
                self._zygote.sock.close()
            except OSError:
                pass
            self._zygote = None
        self.registry.store().unsubscribe_deltas(self._broadcast)

    def _child_main(self, sock: socket.socket, read_port: int, grpc_port: int) -> None:
        _reset_child_process()
        reg = self.registry
        _reset_inherited_locks(reg)
        self._drop_parent_side()
        gc.freeze()  # the inherited residency is immortal here too

        # the delta stream into this replica's store: applying through the
        # normal transact path drives the replica's own snapshot manager and
        # write overlay, so freshness (snaptokens, wait_for_version) holds
        # per replica
        store = reg.store()

        def _feed() -> None:
            try:
                _apply_stream()
            except OSError:
                pass  # a reset or a broken pipe: the parent went away
            os._exit(0)

        def _apply_stream() -> None:
            # the parent broadcasts in version order, so frames normally
            # arrive contiguous. A frame arriving early (a respawn whose
            # zygote state lags the stream) is held while the parent replays
            # the gap from its delta log. Only an unfillable gap is fatal,
            # and the supervisor respawns the replica fresh
            held: dict[int, tuple] = {}
            max_held = 1024
            resync_requested = False
            # boot handshake: where this replica's store starts. Direct forks
            # start current; zygote respawns start where the zygote was
            _send_frame(sock, pickle.dumps(("resync", store.version)))
            while True:
                frame = _recv_frame(sock)
                if frame is None:
                    os._exit(0)  # the parent went away
                msg = pickle.loads(frame)  # frames written by the parent
                if msg[0] == "restart":
                    os._exit(5)  # the delta log cannot catch this replica up
                if msg[0] != "delta":
                    continue
                _, version, inserted, deleted = msg
                if version <= store.version:
                    # already reflected (a frame from before the fork, or a
                    # replay overlap): drop, never hold
                    continue
                # fault site: die where a sick replica would, with a delta
                # in hand, before applying it
                if FAULTS.should_fire("replica.crash"):
                    os._exit(9)
                held[version] = (inserted, deleted)
                while (nxt := store.version + 1) in held:
                    ins, dels = held.pop(nxt)
                    store.transact_relation_tuples(ins, dels)
                    if store.version != nxt:
                        os._exit(3)  # one frame must bump the version once
                if held and not resync_requested:
                    _send_frame(sock, pickle.dumps(("resync", store.version)))
                    resync_requested = True
                elif not held:
                    resync_requested = False
                if len(held) > max_held:
                    os._exit(3)  # the gap outlived the replay window

        try:
            threading.Thread(target=_feed, name="replica-feed", daemon=True).start()
            reg.build_read_plane_shared(read_port, grpc_port).start()
            reg.mark_serving()
        except BaseException:
            # a replica that cannot serve must die, not linger as capacity
            # the parent counts (a port taken between resolve and bind)
            traceback.print_exc()
            os._exit(4)
        # the planes serve on their own threads; _feed ends the process when
        # the parent goes away
        threading.Event().wait()


def _reset_child_process() -> None:
    """First steps in a forked process: one intra-op thread for torch (a
    forked child must not reuse the parent's OpenMP pool, as a DataLoader
    worker does not), and the default handlers for SIGINT and SIGTERM (the
    parent's may set an event nothing here waits on)."""
    import torch

    torch.set_num_threads(1)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
