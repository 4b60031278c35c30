"""keto_tpu_torch's result cache and per-namespace qos vs keto_tpu's, on
the CPU.

The same operation script drives ``CheckResultCache`` of both packages
(version-stamped LRU: a new version clears, a put for a superseded version
is dropped, bulk probes, resize, clear) and every probe returns the same
answer. ``NamespaceQos`` of both packages, each under the same injected
clock, admit or throttle the same debits with the same ``Retry-After``.
Then the batcher wiring: the cache answers repeated checks without the
engine, a write moves the answering version and the next check sees it,
and a throttled tenant gets a 429 before the queue. Tolerance: exact.
"""

import numpy as np
import pytest

from keto_tpu.engine.cache import CheckResultCache as JCache
from keto_tpu.engine.qos import NamespaceQos as JQos
from keto_tpu.engine.qos import QosThrottled as JThrottled
from keto_tpu_torch.engine import ClosureCheckEngine
from keto_tpu_torch.engine.batcher import CheckBatcher
from keto_tpu_torch.engine.cache import CheckResultCache as TCache
from keto_tpu_torch.engine.qos import NamespaceQos as TQos
from keto_tpu_torch.engine.qos import QosThrottled as TThrottled
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.relationtuple import RelationTuple
from keto_tpu_torch.relationtuple.columns import CheckColumns
from keto_tpu_torch.store import InMemoryTupleStore


def cache_script(rng, n_ops=400):
    ops = []
    version = 1
    for _ in range(n_ops):
        roll = rng.random()
        key = ("k", int(rng.integers(12)))
        if roll < 0.05:
            version += 1
        if roll < 0.35:
            ops.append(("put", version - int(rng.random() < 0.1), key, bool(rng.random() < 0.5)))
        elif roll < 0.6:
            ops.append(("get", version, key))
        elif roll < 0.75:
            keys = [("k", int(k)) for k in rng.integers(12, size=5)]
            ops.append(("get_many", version, keys))
        elif roll < 0.9:
            keys = [("k", int(k)) for k in rng.integers(12, size=4)]
            ops.append(("put_many", version, keys, [bool(v) for v in rng.random(4) < 0.5]))
        elif roll < 0.95:
            ops.append(("resize", int(rng.integers(2, 10))))
        else:
            ops.append(("clear",))
    return ops


def run_cache(cache, ops):
    out = []
    for op in ops:
        if op[0] == "put":
            cache.put(op[1], op[2], op[3])
        elif op[0] == "get":
            out.append(cache.get(op[1], op[2]))
        elif op[0] == "get_many":
            out.append(cache.get_many(op[1], op[2]))
        elif op[0] == "put_many":
            cache.put_many(op[1], op[2], op[3])
        elif op[0] == "resize":
            cache.resize(op[1])
        else:
            cache.clear()
        out.append(len(cache))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("capacity", [4, 64])
def test_cache_script_matches_the_reference(seed, capacity):
    ops = cache_script(np.random.default_rng(seed))
    assert run_cache(TCache(capacity), ops) == run_cache(JCache(capacity), ops)


def test_cache_version_and_lru_semantics():
    c = TCache(2, name="encoded")
    assert c.name == "encoded"
    assert c.get(1, "a") is None  # first probe adopts version 1
    c.put(1, "a", True)
    c.put(1, "b", False)
    assert c.get(1, "a") is True  # a is now the most recent
    c.put(1, "c", True)  # evicts b, the least recent
    assert c.get_many(1, ["a", "b", "c"]) == [True, None, True]
    c.put(0, "d", True)  # computed at a superseded version: dropped
    assert c.get(1, "d") is None
    assert c.get(2, "a") is None and len(c) == 0  # a new version clears
    assert (c.hits, c.misses) == (3, 4)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def qos_script(rng, n_ops=300):
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.2:
            ops.append(("tick", float(rng.random() * 0.8)))
        elif roll < 0.8:
            ops.append(("admit", str(rng.choice(["a", "b", "hot", "free"])),
                        int(rng.integers(1, 6))))
        else:
            ops.append(("counts", {"a": int(rng.integers(1, 4)),
                                   "hot": int(rng.integers(1, 4))}))
    return ops


def run_qos(qos_cls, throttled, clock, ops):
    qos = qos_cls(
        rate=5.0, burst=8.0,
        overrides={"hot": {"rate": 2.0, "burst": 3.0}, "free": {"rate": 0}},
        clock=clock,
    )
    out = []
    for op in ops:
        if op[0] == "tick":
            clock.t += op[1]
            continue
        try:
            if op[0] == "admit":
                qos.admit(op[1], op[2])
            else:
                qos.admit_counts(op[1])
            out.append("ok")
        except throttled as e:
            out.append((e.namespace, e.retry_after_s, e.status_code, e.message))
    out.append({ns: round(b.tokens, 6) for ns, b in qos._buckets.items()})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_qos_decisions_match_the_reference(seed):
    ops = qos_script(np.random.default_rng(seed))
    got = run_qos(TQos, TThrottled, Clock(), ops)
    want = run_qos(JQos, JThrottled, Clock(), ops)
    assert got == want
    assert any(o != "ok" for o in got[:-1]) and "ok" in got


def test_qos_retry_after_is_sized_to_the_refill():
    clock = Clock()
    qos = TQos(rate=2.0, burst=4.0, clock=clock)
    qos.admit("n", 4)
    with pytest.raises(TThrottled) as e:
        qos.admit("n", 4)
    assert e.value.retry_after_s == 2 and e.value.status_code == 429
    clock.t += 2.0  # refilled 4 tokens
    qos.admit("n", 4)
    TQos(rate=0.0, clock=clock).admit("n", 10**6)  # rate <= 0 admits all


def closure_batcher(**kw):
    store = InMemoryTupleStore()
    store.write_relation_tuples(
        RelationTuple.from_string("n:doc#view@(n:grp#member)"),
        RelationTuple.from_string("n:grp#member@alice"),
    )
    eng = ClosureCheckEngine(SnapshotManager(store), freshness="strong", device="cpu")
    calls = []
    batch_check = eng.batch_check

    def counting(requests, *a, **k):
        calls.append(len(requests))
        return batch_check(requests, *a, **k)

    eng.batch_check = counting
    return store, eng, calls, CheckBatcher(
        eng, window_s=0.0, version_fn=eng.answering_version, **kw
    )


def test_result_cache_answers_repeats_and_sees_writes():
    store, eng, calls, b = closure_batcher(cache=TCache(64))
    alice = RelationTuple.from_string("n:doc#view@alice")
    try:
        assert b.check(alice) is True
        assert b.check(alice) is True
        assert calls == [1]  # the second answer came from the cache
        assert b.cache.hits == 1
        assert b.check_batch([alice, alice]) == [True, True]
        assert calls == [1]
        # a delete moves the answering version: the stale True is gone
        store.delete_relation_tuples(RelationTuple.from_string("n:grp#member@alice"))
        assert b.check(alice) is False
        assert b.check_batch([alice]) == [False]
        cols = CheckColumns(["n"], ["doc"], ["view"], ["alice"]).validate()
        assert b.check_batch_columnar(cols) == [False]
        assert b.check_batch_columnar(cols) == [False]  # row-key cache hit
    finally:
        b.close()


def test_qos_throttles_every_entry_point_before_the_engine():
    store, eng, calls, b = closure_batcher(
        qos=TQos(rate=1.0, burst=3.0, overrides={"free": {"rate": 0}})
    )
    alice = RelationTuple.from_string("n:doc#view@alice")
    try:
        assert b.check_batch([alice] * 3) == [True] * 3
        with pytest.raises(TThrottled) as e:
            b.check(alice)
        assert e.value.status_code == 429 and e.value.retry_after_s == 1
        cols = CheckColumns(["n"] * 2, ["doc"] * 2, ["view"] * 2, ["alice"] * 2)
        with pytest.raises(TThrottled):
            b.check_batch_columnar(cols.validate())
        with pytest.raises(TThrottled):
            b.check_batch_encoded([0], [1], ns_counts={"n": 1})
        # ids 0 and 1 are n:doc#view and n:grp#member (insertion order)
        assert b.check_batch_encoded([0], [1], ns_counts={"free": 1}) == [True]
        assert calls == [3]
    finally:
        b.close()
