"""keto_tpu_torch's CheckBatcher (serial shape) vs keto_tpu's, on the CPU.

Each scenario runs against both packages' batchers with the same stub
engine: coalescing of concurrent checks into one engine batch, the shed at
``max_queue`` (429), the typed close (503), ``min_version`` through
``engine.wait_for_version``, deadlines (504), error propagation and the
watchdog restart after a dispatcher death. Then both batchers serve the
same concurrent checks over real closure engines. Every wait has a
timeout. Tolerance: exact.
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
