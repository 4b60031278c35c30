"""keto_tpu_torch's CheckBatcher vs keto_tpu's, on the CPU.

Each scenario runs against both packages' batchers with the same stub
engine: coalescing of concurrent checks into one engine batch, the shed at
``max_queue`` (429), the typed close (503), ``min_version`` through
``engine.wait_for_version``, deadlines (504), error propagation and the
watchdog restart after a dispatcher death. Then both batchers serve the
same concurrent checks over real closure engines. The pipelined shape
over DeviceCheckEngine(mode="packed", device="cpu") answers like the
serial shape and like keto_tpu's pipelined batcher, compacts batches to
their encoded-cache misses, fails only the batch of a dying stage, and
fails in-flight work typed on close. Every wait has a timeout. Tolerance:
exact.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keto_tpu.engine import batcher as jbatcher
from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.engine import ClosureCheckEngine as TClosure
from keto_tpu_torch.engine import batcher as tbatcher
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.relationtuple.columns import CheckColumns
from keto_tpu_torch.store import InMemoryTupleStore as TStore

from test_torch_closure_engine import random_requests, random_tuples

torch.set_num_threads(1)

PACKAGES = {"jax": jbatcher, "torch": tbatcher}


class Die(BaseException):
    """Kills the dispatcher thread (not an Exception: the batch handler
    does not catch it, the watchdog does)."""


class StubEngine:
    """Answers `allowed = len(object) is even`; optionally holds each batch
    until released, raises, or dies, and records every call."""

    def __init__(self, hold=False):
        self.calls = []
        self.waits = []
        self.entered = threading.Event()
        self.release = threading.Event()
        if not hold:
            self.release.set()
        self.fail_with = None

    def batch_check(self, requests, max_depth=0, depths=None):
        self.calls.append(len(requests))
        self.entered.set()
        assert self.release.wait(timeout=30), "stub engine never released"
        if self.fail_with is not None:
            exc, self.fail_with = self.fail_with, None
            raise exc
        return [len(r.object) % 2 == 0 for r in requests]

    def wait_for_version(self, min_version, timeout_s=30.0):
        self.waits.append((min_version, timeout_s))


def reqs(n, cls=TTuple):
    return [cls.from_string(f"n:{'o' * (i % 3 + 1)}#r@u{i}") for i in range(n)]


def make(pkg, engine, **kw):
    kw.setdefault("window_s", 0.0)
    return PACKAGES[pkg].CheckBatcher(engine, **kw)


def wait_until(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_coalesces_waiting_checks_into_one_batch(pkg):
    eng = StubEngine(hold=True)
    b = make(pkg, eng, max_batch=64)
    try:
        with ThreadPoolExecutor(16) as pool:
            first = pool.submit(b.check, reqs(1)[0])
            assert eng.entered.wait(timeout=30)
            rest = [pool.submit(b.check, r) for r in reqs(15)]
            wait_until(lambda: len(b._queue) == 15)
            eng.release.set()
            answers = [first.result(timeout=30)] + [f.result(timeout=30) for f in rest]
        assert eng.calls == [1, 15]
        assert answers[1:] == [len(r.object) % 2 == 0 for r in reqs(15)]
    finally:
        b.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_batches_are_capped_at_max_batch(pkg):
    eng = StubEngine(hold=True)
    b = make(pkg, eng, max_batch=4)
    try:
        with ThreadPoolExecutor(12) as pool:
            first = pool.submit(b.check, reqs(1)[0])
            assert eng.entered.wait(timeout=30)
            rest = [pool.submit(b.check, r) for r in reqs(10)]
            wait_until(lambda: len(b._queue) == 10)
            eng.release.set()
            first.result(timeout=30)
            for f in rest:
                f.result(timeout=30)
        assert eng.calls == [1, 4, 4, 2]
        # a caller-assembled batch skips the queue, sliced at max_batch
        assert b.check_batch(reqs(9)) == [len(r.object) % 2 == 0 for r in reqs(9)]
        assert eng.calls[4:] == [4, 4, 1]
    finally:
        b.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_sheds_at_max_queue(pkg):
    eng = StubEngine(hold=True)
    b = make(pkg, eng, max_batch=1, max_queue=3)
    try:
        with ThreadPoolExecutor(8) as pool:
            inflight = pool.submit(b.check, reqs(1)[0])
            assert eng.entered.wait(timeout=30)
            queued = [pool.submit(b.check, r) for r in reqs(3)]
            wait_until(lambda: len(b._queue) == 3)
            with pytest.raises(PACKAGES[pkg].BatcherOverloaded) as e:
                b.check(reqs(1)[0])
            assert e.value.status_code == 429
            assert e.value.envelope()["error"]["message"] == (
                "The check queue is full; retry with backoff."
            )
            eng.release.set()
            assert inflight.result(timeout=30) is False
            assert [f.result(timeout=30) for f in queued] == [False, True, False]
    finally:
        b.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_close_fails_waiters_typed(pkg):
    eng = StubEngine(hold=True)
    b = make(pkg, eng, max_batch=1)
    b.close_join_s = 0.2
    with ThreadPoolExecutor(4) as pool:
        inflight = pool.submit(b.check, reqs(1)[0])
        assert eng.entered.wait(timeout=30)
        queued = pool.submit(b.check, reqs(2)[1])
        wait_until(lambda: len(b._queue) == 1)
        b.close()  # the engine is wedged: the join budget runs out
        for f in (inflight, queued):
            with pytest.raises(PACKAGES[pkg].BatcherClosed) as e:
                f.result(timeout=30)
            assert e.value.status_code == 503
        with pytest.raises(PACKAGES[pkg].BatcherClosed):
            b.check(reqs(1)[0])
        with pytest.raises(PACKAGES[pkg].BatcherClosed):
            b.check_batch(reqs(2))
        eng.release.set()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_min_version_waits_on_the_engine(pkg):
    eng = StubEngine()
    b = make(pkg, eng, max_freshness_wait_s=7.5)
    try:
        b.check(reqs(1)[0], min_version=4)
        b.check_batch(reqs(3), min_version=5, timeout=2.0)
        b.check(reqs(1)[0])  # no snaptoken: no wait
        assert eng.waits == [(4, 7.5), (5, 2.0)]
    finally:
        b.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_deadlines_and_engine_errors(pkg):
    from keto_tpu.utils.errors import DeadlineExceeded as JDeadline
    from keto_tpu_torch.utils.errors import DeadlineExceeded as TDeadline

    deadline_exc = JDeadline if pkg == "jax" else TDeadline
    eng = StubEngine()
    b = make(pkg, eng)
    try:
        with pytest.raises(deadline_exc) as e:
            b.check(reqs(1)[0], deadline=time.monotonic() - 1)
        assert e.value.status_code == 504
        with pytest.raises(deadline_exc):
            b.check_batch(reqs(2), deadline=time.monotonic() - 1)
        assert eng.calls == []  # dead on arrival: the engine never ran
        eng.fail_with = ValueError("engine says no")
        with pytest.raises(ValueError, match="engine says no"):
            b.check(reqs(1)[0])
        assert b.check(reqs(2)[1]) is True  # the dispatcher lives on
    finally:
        b.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_watchdog_restarts_a_dead_dispatcher(pkg):
    eng = StubEngine()
    b = make(pkg, eng)
    try:
        eng.fail_with = Die()
        with pytest.raises(PACKAGES[pkg].DispatcherCrashed) as e:
            b.check(reqs(1)[0])
        assert e.value.status_code == 500
        # the replacement loop serves the next checks
        assert b.check(reqs(2)[1]) is True
        assert b.check(reqs(3)[2]) is False
        if pkg == "torch":
            assert b.n_restarts == 1
    finally:
        b.close()


def test_concurrent_checks_over_closure_engines_agree():
    """Both batchers over real closure engines: 256 checks from 32 threads
    answer alike, in fewer batches than checks."""
    rng = np.random.default_rng(5)
    tuples = random_tuples(rng, 12, 8, 100)
    jstore, tstore = JStore(), TStore()
    jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
    tstore.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
    jb = jbatcher.CheckBatcher(
        JClosure(JManager(jstore), query_mode="device", freshness="strong"),
        window_s=0.002,
    )
    tb = tbatcher.CheckBatcher(
        TClosure(TManager(tstore), freshness="strong", device="cpu"),
        window_s=0.002,
    )
    strings = random_requests(rng, 12, 8, k=256)
    try:
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(lambda s: tb.check(TTuple.from_string(s)), strings))
            want = list(pool.map(lambda s: jb.check(JTuple.from_string(s)), strings))
        assert got == want
        assert tb.n_batches < len(strings)
        assert tb.mean_batch_size() == len(strings) / tb.n_batches
    finally:
        jb.close()
        tb.close()


# -- the pipelined shape ---------------------------------------------------------


def packed_pair(seed=5, n_objects=12, n_users=8, n_edges=100):
    from keto_tpu.engine.device import DeviceCheckEngine as JDevice
    from keto_tpu_torch.engine import DeviceCheckEngine as TDevice

    rng = np.random.default_rng(seed)
    tuples = random_tuples(rng, n_objects, n_users, n_edges)
    jstore, tstore = JStore(), TStore()
    jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
    tstore.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
    jeng = JDevice(JManager(jstore), mode="packed")
    teng = TDevice(TManager(tstore), mode="packed", device="cpu")
    return rng, tstore, jeng, teng


def test_pipelined_packed_answers_like_serial_and_the_reference():
    """64 concurrent checks through the port's pipelined batcher over
    DeviceCheckEngine(mode="packed", device="cpu"), its serial batcher,
    and keto_tpu's pipelined batcher over its packed engine: the same
    answers; then a repeat is answered by the encoded cache alone."""
    from keto_tpu_torch.ops import packed

    rng, tstore, jeng, teng = packed_pair()
    strings = random_requests(rng, 12, 8, k=63)
    reqs = [TTuple.from_string(s) for s in strings]
    depths = [int(d) for d in rng.integers(0, 7, size=len(reqs))]
    tp = tbatcher.CheckBatcher(
        teng, pipeline_depth=2, encode_workers=2, encoded_cache_size=1024,
        version_fn=lambda: tstore.version, window_s=0.002,
    )
    ts = tbatcher.CheckBatcher(teng, pipeline_depth=0, window_s=0.002)
    jp = jbatcher.CheckBatcher(jeng, pipeline_depth=2, encode_workers=2, window_s=0.002)
    assert tp.pipelined and not ts.pipelined and jp.pipelined
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(tp.check, reqs, depths))
            serial = list(pool.map(ts.check, reqs, depths))
            want = list(pool.map(jp.check, [JTuple.from_string(s) for s in strings], depths))
        assert got == serial == want
        assert got == teng.batch_check(reqs, depths=depths)
        stats = tp.pipeline_stats()
        assert stats["pipelined"] and stats["batches"] == tp.n_batches >= 1
        assert 1 <= stats["max_batches_in_pipeline"] and stats["batches_in_pipeline"] == 0
        assert stats["encoded_cache_entries"] > 0
        before = packed.packed_propagate.launches
        with ThreadPoolExecutor(16) as pool:
            again = list(pool.map(tp.check, reqs, depths))
        assert again == got and packed.packed_propagate.launches == before
        # the caller-assembled forms agree and share the encoded cache
        s_ids, t_ids = teng.snapshots.snapshot().encode_requests(reqs)
        assert tp.check_batch_encoded(s_ids, t_ids, depths=depths) == got
        assert tp.check_batch_columnar(CheckColumns.from_tuples(reqs)) == (
            teng.batch_check(reqs)
        )
    finally:
        tp.close()
        ts.close()
        jp.close()


def test_encoded_cache_compacts_to_the_misses():
    """Half the batch is cached: compact() moves the misses to the front
    and resets the freed tail to the inert padding (dummy node, depth 0 in
    packed mode), and the launched half answers exactly."""
    rng, tstore, _, teng = packed_pair(seed=9)
    reqs = [TTuple.from_string(s) for s in random_requests(rng, 12, 8, k=40)]
    want = teng.batch_check(reqs)
    enc = teng.encode_batch(reqs)
    keys, n = enc.keys(), enc.n
    miss = list(range(1, n, 2))
    enc.compact(miss)
    try:
        assert enc.n == len(miss) and enc.b == 4096
        assert enc.keys() == [keys[i] for i in miss]
        assert enc.requests == [reqs[i] for i in miss]
        assert enc.depths is not None and len(enc.depths) == len(miss)
        dummy = enc.dg.dummy
        assert (enc.start[len(miss):] == dummy).all()
        assert (enc.target[len(miss):] == dummy).all()
        assert (enc.depth[len(miss):] == 0).all()
        got = teng.decode_launched(teng.launch_encoded(enc))
    finally:
        enc.release()
    assert got == [want[i] for i in miss]
    # through the batcher: a batch with some rows cached launches the rest
    b = tbatcher.CheckBatcher(
        teng, encoded_cache_size=1024, version_fn=lambda: tstore.version
    )
    try:
        cols = CheckColumns.from_tuples
        assert b.check_batch_columnar(cols(reqs[::3])) == want[::3]
        assert b.check_batch_columnar(cols(reqs)) == want
        assert b.encoded_cache.hits >= len(reqs[::3])
    finally:
        b.close()


class GatedEngine:
    """A DeviceCheckEngine (dense, CPU) whose launch stage can be held, and
    whose `stage` dies (a BaseException the stage loop does not catch) on a
    batch that holds a request for object "die"."""

    def __init__(self, stage=None):
        from keto_tpu_torch.engine import DeviceCheckEngine as TDevice

        store = TStore()
        store.write_relation_tuples(
            TTuple.from_string("n:doc#view@(n:grp#member)"),
            TTuple.from_string("n:grp#member@alice"),
        )
        self.inner = TDevice(TManager(store), mode="dense", device="cpu")
        self.stage = stage
        self.entered = threading.Event()
        self.gate = threading.Event()
        self.gate.set()

    def _maybe_die(self, stage, enc):
        if stage == self.stage and any(r.object == "die" for r in enc.requests):
            raise Die()

    def encode_batch(self, requests, max_depth=0, depths=None):
        enc = self.inner.encode_batch(requests, max_depth, depths)
        self._maybe_die("encode", enc)
        return enc

    def launch_encoded(self, enc):
        self.entered.set()
        assert self.gate.wait(timeout=30), "gate never opened"
        self._maybe_die("launch", enc)
        return self.inner.launch_encoded(enc)

    def decode_launched(self, launched):
        self._maybe_die("decode", launched.enc)
        return self.inner.decode_launched(launched)

    def batch_check(self, requests, max_depth=0, depths=None):
        return self.inner.batch_check(requests, max_depth, depths)


@pytest.mark.parametrize("stage", ["encode", "launch", "decode"])
def test_a_stage_death_fails_only_its_batch(stage):
    eng = GatedEngine(stage)
    eng.gate.clear()
    b = tbatcher.CheckBatcher(eng, pipeline_depth=2, encode_workers=2, window_s=0.0)
    alice = TTuple.from_string("n:doc#view@alice")
    try:
        with ThreadPoolExecutor(4) as pool:
            held = pool.submit(b.check, alice)  # batch A, held in launch
            assert eng.entered.wait(timeout=30)
            doomed = pool.submit(b.check, TTuple.from_string("n:die#view@alice"))
            if stage == "encode":
                with pytest.raises(tbatcher.DispatcherCrashed) as e:
                    doomed.result(timeout=30)
                assert e.value.status_code == 500
            eng.gate.set()
            assert held.result(timeout=30) is True  # A survives
            with pytest.raises(tbatcher.DispatcherCrashed):
                doomed.result(timeout=30)
        assert b.n_restarts == 1
        assert b.check(alice) is True  # the restarted stage serves on
        assert b.check(TTuple.from_string("n:doc#view@bob")) is False
        assert b.pipeline_stats()["batches_in_pipeline"] == 0
    finally:
        eng.gate.set()
        b.close()


def test_close_fails_in_flight_pipeline_work_typed():
    eng = GatedEngine()
    eng.gate.clear()
    b = tbatcher.CheckBatcher(eng, pipeline_depth=1, encode_workers=1, window_s=0.0)
    b.close_join_s = 0.2
    alice = TTuple.from_string("n:doc#view@alice")
    try:
        with ThreadPoolExecutor(4) as pool:
            inflight = pool.submit(b.check, alice)
            assert eng.entered.wait(timeout=30)
            queued = [pool.submit(b.check, alice) for _ in range(3)]
            wait_until(lambda: b.n_dispatched == 4 or len(b._queue) > 0)
            b.close()  # the launch stage is wedged: the join budget runs out
            for f in [inflight] + queued:
                with pytest.raises(tbatcher.BatcherClosed) as e:
                    f.result(timeout=30)
                assert e.value.status_code == 503
            with pytest.raises(tbatcher.BatcherClosed):
                b.check(alice)
    finally:
        eng.gate.set()


def test_pipeline_stays_serial_for_the_closure_engine():
    """Only engines with the split encode/launch/decode API pipeline, as in
    the reference: the closure engine keeps the serial loop."""
    store = TStore()
    store.write_relation_tuples(TTuple.from_string("n:doc#view@alice"))
    b = tbatcher.CheckBatcher(
        TClosure(TManager(store), device="cpu"), pipeline_depth=2,
        encoded_cache_size=64,
    )
    try:
        assert not b.pipelined and b.encoded_cache is None
        assert b.pipeline_stats() == {
            "pipelined": False, "queue_depth": 0, "max_queue": 8 * 4096,
            "max_batch": 4096, "batches": 0, "mean_batch": 0.0, "restarts": 0,
            "deadline_expired": {},
        }
        assert b.check(TTuple.from_string("n:doc#view@alice")) is True
    finally:
        b.close()
