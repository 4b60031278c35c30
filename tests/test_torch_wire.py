"""keto_tpu_torch's wire workers against keto_tpu's, on the CPU.

The shared-memory ring (``engine/shmring.py``) first, in process, for each
package: the ring cases of ``tests/test_wire_encoded.py`` (a roundtrip, a
remote error revived typed, the parent's death failing pending futures
typed, a dead worker retiring only its lane, slot exhaustion as a
retryable 429, a deadline leaving its slot leased until the ack,
``RingBackend``), then the encoded front's two ring modes (QoS deferred to
the ring, the parent front skipping the epoch gate). A response carries the
parent handler's attribution stages in both packages (the merge into the
worker's ledger is in ``tests/test_torch_attribution.py``).

Then a wire server of each package, ``serve.read.wire_workers`` 3 with
``engine.query_mode: host``, booted in a fresh interpreter (this file run
as a script, ``python tests/test_torch_wire.py torch|jax``, through
``keto_tpu_torch/poolharness.py``), so no pytest worker forks. The same
tuples go to both write ports and the same encoded frames to both read
ports, on fresh connections that SO_REUSEPORT spreads over the three
processes: the response frames must be byte-equal between the packages,
the answers the host oracle's, and the parents' ring handlers must have
answered frames. A stale-epoch frame gets 409 until the client resyncs; a
leaf insert reaches encoded frames; a SIGKILLed wire worker retires only
its lane and its respawn serves frames locally; stop_all leaves no process
and unlinks the ring. In process, without a fork: ``query_mode: auto``
with ``wire_workers`` 4 and ``workers`` 1 serves single-process with one
warning (the reference's rule: ``auto`` turns to host for workers > 1
only), and wire workers count only while ``serve.read.encoded`` is on.
Every wait has a deadline. Tolerance: none, answers are booleans and the
frames bytes.
"""

import json
import logging
import os
import pickle
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # run as a script, the harness imports from here

from keto_tpu_torch.poolharness import (  # noqa: E402
    PoolProcess,
    count_ring_frames,
    emit,
    live_pids,
    serve_commands,
)

WIRE_VALUES = {
    "namespaces": [{"id": 1, "name": "n"}],
    "log": {"level": "error"},
    "serve": {
        "read": {"port": 0, "host": "127.0.0.1", "workers": 1, "wire_workers": 3},
        "write": {"port": 0, "host": "127.0.0.1"},
    },
    "engine": {"max_batch": 64, "query_mode": "host"},
}
BOOT_S = 120.0


# -- the harness: one wire server per fresh interpreter ---------------------------


def harness(package: str) -> None:
    """Serve `package` ("torch" or "jax") with 3 wire workers until stdin
    says stop. The parent's ring handler is wrapped to count the frames it
    answers."""
    if package == "torch":
        from keto_tpu_torch.driver import Config, Registry

        logging.basicConfig(level=logging.INFO)
        reg = Registry(Config(values=WIRE_VALUES), device="cpu")
        read_port, write_port = reg.start_all()
        stop_all = reg.stop_all
    else:
        import asyncio

        from keto_tpu.driver import Config, Registry

        reg = Registry(Config(values=WIRE_VALUES))
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True).start()
        read_port, write_port = asyncio.run_coroutine_threadsafe(
            reg.start_all(), loop
        ).result(timeout=BOOT_S)

        def stop_all():
            asyncio.run_coroutine_threadsafe(reg.stop_all(), loop).result(timeout=30)

    pool, ring = reg._replica_pool, reg._wire_ring
    ring_frames = count_ring_frames(reg._ring_server)

    def describe(_arg: str = "") -> dict:
        children = [link.pid for link in pool._children] if pool is not None else []
        return {
            "read": read_port,
            "write": write_port,
            "children": children,
            "alive": 1 + len(live_pids(p for p in children if p > 0)),
            "zygote": pool._zygote_pid if pool is not None else -1,
            "host": bool(reg.check_engine().host_queries()),
            "endpoints": len(ring.endpoints) if ring is not None else 0,
            "shm": ring.shm.name if ring is not None else "",
            "ring_frames": ring_frames(),
        }

    def stop() -> dict:
        stop_all()
        return {"stopped": True}

    emit(describe())
    serve_commands({"pool": describe}, stop)


class WireServer(PoolProcess):
    """The test side of one harness process."""

    def __init__(self, package: str):
        self.package = package
        super().__init__(
            [sys.executable, str(Path(__file__).resolve()), package],
            cwd=str(REPO), name=f"{package} wire harness",
        )

    def boot(self) -> None:
        self.info = self.next_doc(BOOT_S)
        self.read = f"http://127.0.0.1:{self.info['read']}"
        self.write = f"http://127.0.0.1:{self.info['write']}"


# -- the ring, in process, for each package ----------------------------------------


@pytest.fixture(params=["torch", "jax"])
def pkg(request):
    """One package's ring module, errors and codec."""
    if request.param == "torch":
        from keto_tpu_torch.api import wirecodec
        from keto_tpu_torch.engine import shmring
        from keto_tpu_torch.telemetry import attribution
        from keto_tpu_torch.utils import errors
    else:
        from keto_tpu.api import wirecodec
        from keto_tpu.engine import shmring
        from keto_tpu.telemetry import attribution
        from keto_tpu.utils import errors
    return SimpleNamespace(
        name=request.param, ring=shmring, errors=errors, wirecodec=wirecodec,
        attribution=attribution,
    )


def _echo_handler(frame: bytes) -> bytes:
    return b"echo:" + frame


class TestWireRing:
    def test_roundtrip(self, pkg):
        r = pkg.ring
        ring = r.WireRing(2, slots_per_endpoint=2, slot_bytes=4096)
        def handler(frame: bytes) -> bytes:
            pkg.attribution.ledger_mark("kernel")  # the parent's ledger
            return _echo_handler(frame)

        server = r.RingServer(ring, handler)
        server.start()
        clients = [r.RingClient(ring, ring.endpoints[0]),
                   r.RingClient(ring, ring.endpoints[1])]
        try:
            for i, cl in enumerate(clients):
                kind, body, stages = pickle.loads(cl.submit(f"frame-{i}".encode(), timeout=10))
                assert kind == "ok" and body == f"echo:frame-{i}".encode()
                assert set(stages) == {"kernel"}  # the reference's stage set
        finally:
            for cl in clients:
                cl.close()
            server.stop()
            ring.close()

    def test_remote_error_revives_typed(self, pkg):
        r = pkg.ring

        def boom(frame):
            raise pkg.errors.ErrResourceExhausted("device is saturated")

        ring = r.WireRing(1, slot_bytes=4096)
        server = r.RingServer(ring, boom)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        try:
            kind, shipped, _ = pickle.loads(cl.submit(b"x", timeout=10))
            assert kind == "err"
            err = r.RingRemoteError(shipped)
            assert err.status_code == 429
            assert err.grpc_code == "RESOURCE_EXHAUSTED"
            assert err.retry_after_s == 1
            assert "saturated" in str(err)
            assert err.envelope()["error"]["code"] == 429
        finally:
            cl.close()
            server.stop()
            ring.close()

    def test_parent_death_fails_pending_futures_typed(self, pkg):
        """The parent vanishes while requests are in flight: every pending
        future fails with the typed RingError, none is lost."""
        r = pkg.ring
        hold = threading.Event()

        def stuck(frame):
            hold.wait(10)
            return b"late"

        ring = r.WireRing(1, slots_per_endpoint=2, slot_bytes=4096)
        server = r.RingServer(ring, stuck)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        errs = []

        def call():
            try:
                cl.submit(b"x", timeout=30)
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=call, daemon=True) for _ in range(2)]
        try:
            for th in threads:
                th.start()
            time.sleep(0.2)
            for ep in ring.endpoints:  # the parent's doorbell ends close
                ep.parent_sock.close()
            for th in threads:
                th.join(timeout=10)
            assert not any(th.is_alive() for th in threads)
            assert len(errs) == 2
            assert all(isinstance(e, r.RingError) for e in errs), errs
            assert all(e.status_code == 503 for e in errs)
            with pytest.raises(r.RingError):
                cl.submit(b"y", timeout=1)  # a broken ring stays typed
        finally:
            hold.set()
            cl.close()
            server._stopping = True
            for th in server._threads:  # the stuck handler finishes first
                th.join(timeout=10)
            ring.close()

    def test_dead_worker_retires_only_its_lane(self, pkg, caplog):
        r = pkg.ring
        ring = r.WireRing(2, slot_bytes=4096)
        server = r.RingServer(ring, _echo_handler)
        server.start()
        cl0 = r.RingClient(ring, ring.endpoints[0])
        cl1 = r.RingClient(ring, ring.endpoints[1])
        try:
            with caplog.at_level(logging.WARNING, logger="keto_tpu_torch"):
                cl0.submit(b"a", timeout=10)
                # worker 1 dies: its process exit closes every copy of its
                # end, which shutdown stands in for (a close here would not
                # reach the parent while cl1's reader blocks on the socket)
                ring.endpoints[1].child_sock.shutdown(socket.SHUT_RDWR)
                cl1.close()
                deadline = time.monotonic() + 10
                while server._threads[1].is_alive() and time.monotonic() < deadline:
                    time.sleep(0.02)
            assert not server._threads[1].is_alive()  # its lane retired
            assert server._threads[0].is_alive()
            assert pickle.loads(cl0.submit(b"b", timeout=10))[0] == "ok"
            if pkg.name == "torch":
                said = [x for x in caplog.records if "retiring its ring lane" in x.getMessage()]
                assert len(said) == 1 and "endpoint 1 " in said[0].getMessage()
        finally:
            cl0.close()
            server.stop()
            ring.close()

    def test_slot_exhaustion_is_retryable_429(self, pkg):
        r = pkg.ring
        hold = threading.Event()

        def stuck(frame):
            hold.wait(10)
            return b"done"

        ring = r.WireRing(1, slots_per_endpoint=1, slot_bytes=4096)
        server = r.RingServer(ring, stuck)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        th = threading.Thread(target=lambda: cl.submit(b"x", timeout=30), daemon=True)
        try:
            th.start()
            time.sleep(0.2)  # the only slot is leased now
            t0 = time.monotonic()
            with pytest.raises(pkg.errors.ErrResourceExhausted) as ei:
                cl.submit(b"y", timeout=0.3)
            assert time.monotonic() - t0 < 5
            assert ei.value.status_code == 429
        finally:
            hold.set()
            th.join(timeout=10)
            assert not th.is_alive()
            cl.close()
            server.stop()
            ring.close()

    def test_deadline_leaves_slot_leased_until_ack(self, pkg):
        r = pkg.ring
        release = threading.Event()

        def slow(frame):
            release.wait(10)
            return b"slow"

        ring = r.WireRing(1, slots_per_endpoint=1, slot_bytes=4096)
        server = r.RingServer(ring, slow)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        try:
            with pytest.raises(pkg.errors.DeadlineExceeded):
                cl.submit(b"x", timeout=0.2)
            # still leased: a late response must not land in a reused slot
            with pytest.raises(pkg.errors.ErrResourceExhausted):
                cl.submit(b"y", timeout=0.3)
            release.set()  # the parent answers; the ack recycles the slot
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                try:
                    payload = cl.submit(b"z", timeout=1.0)
                    break
                except (pkg.errors.ErrResourceExhausted, pkg.errors.DeadlineExceeded):
                    time.sleep(0.05)
            else:
                pytest.fail("slot never recycled after the late ack")
            assert pickle.loads(payload)[0] == "ok"
        finally:
            release.set()
            cl.close()
            server.stop()
            ring.close()

    def test_concurrent_submitters_get_their_own_answers(self, pkg):
        """More submitter threads than slots and cores, the switch interval
        shortened: every answer is its own request's echo (a slot reused
        before its ack, or a crossed future, would hand one thread
        another's payload) and every slot comes back."""
        r = pkg.ring
        ring = r.WireRing(2, slots_per_endpoint=3, slot_bytes=4096)
        server = r.RingServer(ring, _echo_handler)
        server.start()
        clients = [r.RingClient(ring, ep) for ep in ring.endpoints]
        wrong, done = [], []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)

        def submitter(t: int) -> None:
            cl = clients[t % 2]
            for i in range(40):
                frame = f"{t}:{i}".encode()
                while True:
                    try:
                        payload = cl.submit(frame, timeout=10)
                        break
                    except pkg.errors.ErrResourceExhausted:
                        continue  # every slot leased: retry, as a client would
                kind, body, _ = pickle.loads(payload)
                if (kind, body) != ("ok", b"echo:" + frame):
                    wrong.append((frame, kind, body))
            done.append(t)

        threads = [threading.Thread(target=submitter, args=(t,), daemon=True)
                   for t in range(24)]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
            for cl in clients:
                cl.close()
            server.stop()
            ring.close()
        assert not wrong, wrong[:3]
        assert sorted(done) == list(range(24))
        assert all(cl._free.qsize() == 3 for cl in clients)

    def test_an_oversized_frame_is_refused_before_the_doorbell(self, pkg):
        r = pkg.ring
        ring = r.WireRing(1, slot_bytes=4096)
        server = r.RingServer(ring, _echo_handler)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        try:
            with pytest.raises(pkg.errors.ErrMalformedInput, match="split the batch"):
                cl.submit(b"x" * 5000, timeout=5)
            assert pickle.loads(cl.submit(b"ok", timeout=5))[0] == "ok"  # slot freed
        finally:
            cl.close()
            server.stop()
            ring.close()

    def test_ring_backend(self, pkg):
        """The worker's backend: the batch crosses as a request frame, the
        parent's response frame comes back decoded; a parent-side error is
        raised typed."""
        r, wc = pkg.ring, pkg.wirecodec
        seen = {}

        def handler(frame):
            req = wc.decode_check_request(frame)
            seen.update(start=req.start.tolist(), target=req.target.tolist(),
                        lineage=req.lineage, epoch=req.epoch, ns=req.ns.tolist())
            if req.epoch == 5:
                raise pkg.errors.ErrUnavailable("closure rebuilding")
            return wc.encode_check_response(np.array([True, False]), "z1")

        ring = r.WireRing(1, slot_bytes=4096)
        server = r.RingServer(ring, handler)
        server.start()
        cl = r.RingClient(ring, ring.endpoints[0])
        try:
            backend = r.RingBackend(cl)
            req = wc.decode_check_request(wc.encode_check_request(
                np.array([0, 1], dtype=np.int32), np.array([2, 3], dtype=np.int32),
                lineage="ab" * 8, epoch=4, ns=np.array([0, 0], dtype=np.int32),
            ))
            allowed = backend.ring_submit(req, req.start, req.target, timeout=10)
            assert [bool(v) for v in allowed] == [True, False]
            assert seen == {"start": [0, 1], "target": [2, 3], "lineage": "ab" * 8,
                            "epoch": 4, "ns": [0, 0]}
            req.epoch = 5
            with pytest.raises(r.RingRemoteError) as ei:
                backend.ring_submit(req, req.start, req.target, timeout=10)
            assert ei.value.status_code == 503 and "rebuilding" in str(ei.value)
        finally:
            cl.close()
            server.stop()
            ring.close()


# -- the encoded front's ring modes --------------------------------------------------


@pytest.fixture(params=["torch", "jax"])
def front_pkg(request):
    if request.param == "torch":
        from keto_tpu_torch.api import wirecodec
        from keto_tpu_torch.api.encoded import EncodedCheckFront
        from keto_tpu_torch.graph import SnapshotManager, vocabsync
        from keto_tpu_torch.relationtuple import RelationTuple
        from keto_tpu_torch.store import InMemoryTupleStore
        from keto_tpu_torch.utils.errors import ErrVocabEpochMismatch
    else:
        from keto_tpu.api import wirecodec
        from keto_tpu.api.encoded import EncodedCheckFront
        from keto_tpu.graph import SnapshotManager, vocabsync
        from keto_tpu.relationtuple import RelationTuple
        from keto_tpu.store import InMemoryTupleStore
        from keto_tpu.utils.errors import ErrVocabEpochMismatch
    return SimpleNamespace(
        wirecodec=wirecodec, Front=EncodedCheckFront, Manager=SnapshotManager,
        vocabsync=vocabsync, T=RelationTuple.from_string, Store=InMemoryTupleStore,
        Mismatch=ErrVocabEpochMismatch,
    )


def test_front_defers_qos_to_the_ring(front_pkg):
    """In a wire worker the front derives and debits no ns counts: the
    parent debits once from the frame's ns column, which crosses intact;
    ids out of range are clamped to the dummy node before the hop."""
    p = front_pkg
    store = p.Store()
    store.write_relation_tuples(p.T("n:o#r@u"))
    mgr = p.Manager(store)
    snap = mgr.snapshot()
    seen = {}

    class FakeRingBackend:
        def ring_submit(self, req, start, target, timeout=None):
            seen.update(ns=req.ns, start=np.asarray(start).tolist(), timeout=timeout)
            return np.array([False] * len(start))

        def check_batch_encoded(self, *a, **kw):  # must not be reached
            raise AssertionError("the local batcher was called in a wire worker")

    front = p.Front(mgr, FakeRingBackend())
    req = p.wirecodec.decode_check_request(p.wirecodec.encode_check_request(
        np.array([0, 10**6], dtype=np.int32), np.array([1, 1], dtype=np.int32),
        lineage=p.vocabsync.lineage_of(snap.vocab),
        epoch=p.vocabsync.epoch_of(snap.vocab), ns=np.array([0, 0], dtype=np.int32),
    ))
    assert list(front.check(req, timeout=2.5)) == [False, False]
    np.testing.assert_array_equal(seen["ns"], [0, 0])
    assert seen["start"] == [0, snap.dummy_node] and seen["timeout"] == 2.5


def test_parent_front_skips_the_epoch_gate(front_pkg):
    """validate=False (the parent's ring consumer): an older epoch of the
    same lineage passes, since the worker already gated it."""
    p = front_pkg
    store = p.Store()
    store.write_relation_tuples(p.T("n:o#r@u"))
    mgr = p.Manager(store)
    vocab = mgr.snapshot().vocab
    lineage = p.vocabsync.lineage_of(vocab)
    old_epoch = p.vocabsync.epoch_of(vocab)
    store.write_relation_tuples(p.T("n:o2#r@u2"))  # the epoch moves on

    class Oracle:
        def check_batch_encoded(self, s, t, depths=None, min_version=0, timeout=None,
                                ns_counts=None):
            return np.array([True] * len(s))

    req = p.wirecodec.decode_check_request(p.wirecodec.encode_check_request(
        np.array([0], dtype=np.int32), np.array([1], dtype=np.int32),
        lineage=lineage, epoch=old_epoch,
    ))
    with pytest.raises(p.Mismatch):
        p.Front(mgr, Oracle()).check(req)
    assert list(p.Front(mgr, Oracle(), validate=False).check(req)) == [True]


# -- the wire servers ---------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    out = {}
    try:
        for package in ("torch", "jax"):  # both boot at once
            out[package] = WireServer(package)
        for server in out.values():
            server.boot()
        yield out
    finally:
        for server in out.values():
            if not server.stopped:
                try:
                    server.stop(60.0)
                except Exception:
                    pass
            server.kill_group()


def _request(method: str, url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_frame(server, frame: bytes):
    from keto_tpu_torch.client.vocabcache import post_frame

    return post_frame(server.read, frame, timeout=30.0)


def _write_both(servers, *strings) -> None:
    from keto_tpu_torch.relationtuple import RelationTuple

    for s in strings:
        body = RelationTuple.from_string(s).to_dict()
        for server in servers.values():
            assert _request("PUT", f"{server.write}/relation-tuples", body)[0] == 201


def _settle(servers, marker: str) -> None:
    """Write a marker to both servers and wait until every process of each
    answers it (24 agreeing fresh-connection checks): deltas apply in
    version order, so the writes before it have landed too."""
    import urllib.parse

    _write_both(servers, f"n:{marker}#view@m")
    q = urllib.parse.urlencode(
        {"namespace": "n", "object": marker, "relation": "view", "subject_id": "m"}
    )
    for server in servers.values():
        deadline = time.monotonic() + 60
        streak = 0
        while streak < 24:
            assert time.monotonic() < deadline, f"{server.package}: {marker} never settled"
            if _request("GET", f"{server.read}/check?{q}")[0] == 200:
                streak += 1
            else:
                streak = 0
                time.sleep(0.05)


def _graph(seed: int):
    rng = np.random.default_rng(seed)
    tuples = {}
    for _ in range(60):
        obj = f"o{rng.integers(12)}"
        if rng.random() < 0.45:
            sub = f"(n:o{rng.integers(12)}#r)"
        else:
            sub = f"u{rng.integers(8)}"
        tuples[f"n:{obj}#r@{sub}"] = None
    probes = [f"n:o{rng.integers(13)}#r@u{rng.integers(9)}" for _ in range(48)]
    return list(tuples), probes


class Mirror:
    """The tuples written so far, and the host oracle over them."""

    def __init__(self):
        from keto_tpu_torch.engine import CheckEngine
        from keto_tpu_torch.store import InMemoryTupleStore

        self.store = InMemoryTupleStore()
        self.oracle = CheckEngine(self.store, max_depth=5)

    def write(self, *strings):
        from keto_tpu_torch.relationtuple import RelationTuple

        self.store.write_relation_tuples(*(RelationTuple.from_string(s) for s in strings))

    def check(self, strings):
        from keto_tpu_torch.relationtuple import RelationTuple

        return self.oracle.batch_check([RelationTuple.from_string(s) for s in strings])


@pytest.fixture(scope="module")
def mirror(servers):
    m = Mirror()
    tuples, _ = _graph(21)
    _write_both(servers, *tuples)
    m.write(*tuples)
    _settle(servers, "settled-0")
    m.write("n:settled-0#view@m")
    return m


def _caches(servers):
    from keto_tpu_torch.client import VocabCache

    return {p: VocabCache(s.read, timeout=30.0).bootstrap() for p, s in servers.items()}


def _frames_of(cache, probes, rows: int = 8):
    return [cache.frame(probes[i:i + rows]) for i in range(0, len(probes), rows)]


def test_forked_with_two_wire_workers(servers):
    for server in servers.values():
        info = server.info
        assert len(info["children"]) == 2 and all(p > 0 for p in info["children"])
        assert info["zygote"] > 0 and info["alive"] == 3
        assert info["host"] and info["endpoints"] == 2 and info["shm"]
        assert os.path.exists(f"/dev/shm/{info['shm']}")
    assert any("read replicas forked: 3 processes" in line and "(3 wire workers)" in line
               for line in servers["torch"].lines)


def test_response_frames_byte_equal_between_the_packages(servers, mirror):
    from keto_tpu_torch.api import wirecodec

    _, probes = _graph(21)
    caches = _caches(servers)
    assert caches["torch"]._keys == caches["jax"]._keys  # the same ids on both
    want = mirror.check(probes)
    ring_before = {p: s.ask("pool")["ring_frames"] for p, s in servers.items()}
    bodies = {p: [] for p in servers}
    for _ in range(4):  # fresh connections: spread over the three processes
        for p, server in servers.items():
            for frame in _frames_of(caches[p], probes):
                status, body = _post_frame(server, frame)
                assert status == 200, (p, status, body[:200])
                bodies[p].append(body)
    assert bodies["torch"] == bodies["jax"]
    got = []
    for body in bodies["torch"][: len(probes) // 8]:
        got += [bool(v) for v in wirecodec.decode_check_response(body)[0]]
    assert got == want
    for p, server in servers.items():
        # both wire workers' frames reached the parent's one batcher
        assert server.ask("pool")["ring_frames"] > ring_before[p], p


def test_a_stale_epoch_frame_gets_409_then_the_client_resyncs(servers, mirror):
    from keto_tpu_torch.api import wirecodec

    caches = _caches(servers)
    probes = ["n:o1#r@fresh-user", "n:o2#r@u1"]
    stale = {p: caches[p].frame(probes) for p in servers}
    _write_both(servers, "n:o1#r@fresh-user")  # interns a key: the epoch moves
    mirror.write("n:o1#r@fresh-user")
    _settle(servers, "settled-1")
    mirror.write("n:settled-1#view@m")
    want = mirror.check(probes)
    for p, server in servers.items():
        for _ in range(12):  # every process, wire workers included, gates
            status, body = _post_frame(server, stale[p])
            assert status == 409, (p, status)
            details = json.loads(body)["error"]["details"]
            assert details["reason"] == "vocab_epoch_mismatch"
            assert details["server_epoch"] > caches[p].epoch
        caches[p].sync()
        for _ in range(12):
            status, body = _post_frame(server, caches[p].frame(probes))
            assert status == 200, (p, status)
            assert [bool(v) for v in wirecodec.decode_check_response(body)[0]] == want


def test_a_leaf_insert_is_visible_to_encoded_frames(servers, mirror):
    from keto_tpu_torch.api import wirecodec

    probe = ["n:o3#r@u7", "n:o4#r@u7"]
    _write_both(servers, "n:o3#r@u7")
    mirror.write("n:o3#r@u7")
    _settle(servers, "settled-2")
    mirror.write("n:settled-2#view@m")
    want = mirror.check(probe)
    assert want[0]
    caches = _caches(servers)
    for p, server in servers.items():
        for _ in range(12):
            status, body = _post_frame(server, caches[p].frame(probe))
            assert status == 200
            assert [bool(v) for v in wirecodec.decode_check_response(body)[0]] == want


def test_a_killed_wire_worker_retires_its_lane_only(servers, mirror):
    from keto_tpu_torch.api import wirecodec

    _, probes = _graph(21)
    want = mirror.check(probes[:8])
    for p, server in servers.items():
        victim = server.ask("pool", 30.0)["children"][0]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            doc = server.ask("pool", 30.0)
            kids = doc["children"]
            if (doc["alive"] == 3 and victim not in kids and len(kids) == 2
                    and all(k > 0 for k in kids)):
                break
            time.sleep(0.1)
        assert doc["alive"] == 3 and victim not in doc["children"], (p, doc)
        cache = _caches({p: server})[p]
        before = doc["ring_frames"]
        for _ in range(48):  # the respawn answers locally, the other worker by ring
            status, body = _post_frame(server, cache.frame(probes[:8]))
            assert status == 200, (p, status, body[:200])
            assert [bool(v) for v in wirecodec.decode_check_response(body)[0]] == want
        assert server.ask("pool")["ring_frames"] > before, p
    lines = "".join(servers["torch"].lines)
    assert "wire worker endpoint 0 closed; retiring its ring lane" in lines
    assert "read replica respawned from the zygote" in lines


def test_stop_all_leaves_no_process_and_unlinks_the_ring(servers):
    for server in servers.values():
        doc = server.ask("pool", 30.0)
        pids = [p for p in doc["children"] if p > 0] + [doc["zygote"]]
        assert server.stop(60.0) == {"stopped": True}
        assert server.proc.returncode == 0
        deadline = time.monotonic() + 30
        while live_pids(pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert live_pids(pids) == [], (server.package, pids)
        assert not os.path.exists(f"/dev/shm/{doc['shm']}")


# -- in process, no fork ------------------------------------------------------------


def test_auto_with_wire_workers_serves_single_process_with_one_warning(caplog):
    """The reference's rule: engine.query_mode auto turns to host only for
    serve.read.workers > 1, so wire workers on a device-mode engine serve
    from one process, and the encoded route answers from the local batcher."""
    from keto_tpu_torch.client import VocabCache
    from keto_tpu_torch.client.vocabcache import batch_check_encoded
    from keto_tpu_torch.driver import Config, Registry

    values = json.loads(json.dumps(WIRE_VALUES))
    values["serve"]["read"]["wire_workers"] = 4
    values["engine"]["query_mode"] = "auto"
    reg = Registry(Config(values=values), device="cpu")
    with caplog.at_level(logging.INFO, logger="keto_tpu_torch"):
        read_port, write_port = reg.start_all()
    try:
        said = [r for r in caplog.records if "read workers require" in r.getMessage()]
        assert len(said) == 1 and said[0].levelno == logging.WARNING
        assert not any("forked" in r.getMessage() for r in caplog.records)
        assert reg._replica_pool is None and reg._wire_ring is None
        assert reg._ring_server is None and not reg.check_engine().host_queries()
        tup = {"namespace": "n", "object": "d", "relation": "v", "subject_id": "a"}
        assert _request("PUT", f"http://127.0.0.1:{write_port}/relation-tuples", tup)[0] == 201
        cache = VocabCache(f"http://127.0.0.1:{read_port}").bootstrap()
        assert batch_check_encoded(cache, ["n:d#v@a", "n:d#v@b"]) == [True, False]
    finally:
        reg.stop_all()


def test_wire_workers_count_only_with_the_encoded_tier(caplog):
    from keto_tpu_torch.driver import Config, Registry

    values = json.loads(json.dumps(WIRE_VALUES))
    values["serve"]["read"]["encoded"] = False
    reg = Registry(Config(values=values), device="cpu")
    with caplog.at_level(logging.INFO, logger="keto_tpu_torch"):
        reg.start_all()
    try:
        assert reg.check_engine().host_queries()
        assert reg._replica_pool is None and reg._wire_ring is None
        assert reg.encoded_front() is None
        assert not any("read workers" in r.getMessage() or "forked" in r.getMessage()
                       for r in caplog.records)
    finally:
        reg.stop_all()


if __name__ == "__main__":
    harness(sys.argv[1])
