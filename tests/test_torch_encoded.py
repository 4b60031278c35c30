"""keto_tpu_torch's id-native wire tier vs keto_tpu's, on the CPU.

- ``wirecodec``: request and response frames are byte-equal between the
  two packages, each decodes the other's frames, and truncated or foreign
  frames fail with the same ErrMalformedInput message.
- ``vocabsync``: the namespace table, the snapshot and delta pages and the
  409 envelope (``details`` with the resync hint) are equal for the same
  store history. The lineage follows the vocab object: both packages keep
  one append-only vocab across a delete-triggered rebuild (ids are not
  reassigned, so the lineage stays), and a new vocab object (a new store
  or manager) gets a new lineage.
- ``VocabCache`` bootstraps from a port server over ``/vocab/snapshot`` in
  small pages, encodes to the server's ids, round-trips
  ``/check/batch-encoded`` with the answers of ``/check/batch``, is bounced
  with a 409 after a write that interns keys, and catches up over
  ``/vocab/deltas``.

Tolerance: exact.
"""

import numpy as np
import pytest

from keto_tpu.api import wirecodec as jcodec
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.graph import vocabsync as jsync
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu.utils.errors import ErrMalformedInput as JMalformed
from keto_tpu.utils.errors import ErrVocabEpochMismatch as JMismatch
from keto_tpu_torch.api import wirecodec as tcodec
from keto_tpu_torch.api.encoded import EncodedCheckFront
from keto_tpu_torch.client import VocabCache, batch_check_encoded
from keto_tpu_torch.client.vocabcache import post_frame
from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.graph import vocabsync as tsync
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.store import ColumnarTupleStore
from keto_tpu_torch.store import InMemoryTupleStore as TStore
from keto_tpu_torch.utils.errors import ErrMalformedInput as TMalformed
from keto_tpu_torch.utils.errors import ErrVocabEpochMismatch as TMismatch

from test_torch_closure_engine import random_requests, random_tuples

FRAMES = {
    "bare": dict(),
    "ns": dict(ns=[0, 1, 2, -1, 0]),
    "depths": dict(depths=[0, 1, 5, 9, 2]),
    "all": dict(ns=[3, 3, 0, 1, 2], depths=[1, 2, 3, 4, 5], min_version=77,
                traceparent="00-abc-def-01"),
    "odd_traceparent": dict(traceparent="x" * 7),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_request_frames_are_byte_equal_both_ways(name):
    kw = FRAMES[name]
    start = np.array([0, 5, -1, 2**31 - 1, 7], dtype=np.int32)
    target = np.array([1, 2, 3, 4, -5], dtype=np.int32)
    t = tcodec.encode_check_request(start, target, lineage="abcd" * 4, epoch=99, **kw)
    j = jcodec.encode_check_request(start, target, lineage="abcd" * 4, epoch=99, **kw)
    assert t == j
    for frame, decode in ((j, tcodec.decode_check_request),
                          (t, jcodec.decode_check_request)):
        d = decode(frame)
        assert np.array_equal(d.start, start) and np.array_equal(d.target, target)
        assert (d.lineage, d.epoch) == ("abcd" * 4, 99)
        assert d.min_version == kw.get("min_version", 0)
        assert d.traceparent == kw.get("traceparent")
        for col in ("ns", "depths"):
            if col in kw:
                assert np.array_equal(getattr(d, col), kw[col])
            else:
                assert getattr(d, col) is None


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4096, 4099])
def test_response_frames_are_byte_equal_both_ways(n):
    allowed = np.random.default_rng(n).random(n) < 0.4
    t = tcodec.encode_check_response(allowed, "42")
    j = jcodec.encode_check_response(allowed, "42")
    assert t == j
    for frame, decode in ((j, tcodec.decode_check_response),
                          (t, jcodec.decode_check_response)):
        got, tok = decode(frame)
        assert np.array_equal(got, allowed) and tok == "42"


def malformed(decode, exc, frame):
    try:
        decode(frame)
    except exc as e:
        return e.message
    return None


@pytest.mark.parametrize("frame", [
    b"", b"KTE1", b"XXXX" + b"\0" * 60,
    jcodec.encode_check_request([1, 2], [3, 4], lineage="l", epoch=1)[:-3],
])
def test_malformed_request_frames_fail_alike(frame):
    want = malformed(jcodec.decode_check_request, JMalformed, frame)
    got = malformed(tcodec.decode_check_request, TMalformed, frame)
    assert got == want and got is not None


@pytest.mark.parametrize("frame", [
    b"", b"KTR1\0\0", jcodec.encode_check_response([True] * 20, "t")[:-2],
])
def test_malformed_response_frames_fail_alike(frame):
    want = malformed(jcodec.decode_check_response, JMalformed, frame)
    got = malformed(tcodec.decode_check_response, TMalformed, frame)
    assert got == want and got is not None


def store_pair(tuples):
    jstore, tstore = JStore(), TStore()
    jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
    tstore.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
    return jstore, tstore


TUPLES = ["n:doc#view@(n:grp#member)", "n:grp#member@alice",
          "files:f1#read@(n:grp#member)", "other:x#y@bob", "n:doc#edit@carol"]


def test_namespace_table_and_pages_match():
    jstore, tstore = store_pair(TUPLES)
    jm, tm = JManager(jstore), TManager(tstore)
    jv, tv = jm.snapshot().vocab, tm.snapshot().vocab
    jt, tt = jsync.ns_table_of(jv), tsync.ns_table_of(tv)
    assert tt.names == jt.names == ["n", "files", "other"]
    assert [tt.id_of(n) for n in ("n", "other", "zzz")] == [0, 2, tsync.NS_UNKNOWN]
    assert tt.name_of(5) == jt.name_of(5) == tsync.NS_UNKNOWN_LABEL
    assert tsync.epoch_of(tv) == jsync.epoch_of(jv) == len(tv)

    def strip(page):
        assert len(page.pop("lineage")) == 16
        return page

    for offset, limit in ((0, 3), (3, 3), (6, 100), (100, 5), (-4, 0)):
        assert strip(tsync.snapshot_page(tv, offset, limit)) == strip(
            jsync.snapshot_page(jv, offset, limit)
        )
    e0 = len(tv)
    for s in ("files:f2#read@dave", "n:grp#member@erin"):
        jstore.write_relation_tuples(JTuple.from_string(s))
        tstore.write_relation_tuples(TTuple.from_string(s))
    jv, tv = jm.snapshot().vocab, tm.snapshot().vocab
    page_t = tsync.delta_page(tv, tsync.lineage_of(tv), e0)
    page_j = jsync.delta_page(jv, jsync.lineage_of(jv), e0)
    assert strip(page_t) == strip(page_j)
    assert page_t["keys"] == [["files", "f2", "read"], ["dave"], ["erin"]]
    assert tsync.ns_table_of(tv).names == ["n", "files", "other"]


@pytest.mark.parametrize("client", [("stale", 0), ("stale", 3), ("own", -1), ("own", 10**6)])
def test_mismatch_envelopes_match(client):
    jstore, tstore = store_pair(TUPLES)
    jv, tv = JManager(jstore).snapshot().vocab, TManager(tstore).snapshot().vocab
    # one lineage for both vocabs, so the envelopes compare whole
    jv._wire_lineage = tv._wire_lineage = "feedfacecafebeef"
    lineage = "feedfacecafebeef" if client[0] == "own" else "0123456789abcdef"
    results = []
    for sync, exc, vocab in ((tsync, TMismatch, tv), (jsync, JMismatch, jv)):
        with pytest.raises(exc) as e:
            sync.delta_page(vocab, lineage, client[1])
        out = [e.value.status_code, e.value.envelope()]
        with pytest.raises(exc) as e:
            sync.validate_epoch(vocab, lineage, len(vocab) + 3)
        out.append(e.value.envelope())
        results.append(out)
    assert results[0] == results[1]
    assert results[0][0] == 409
    details = results[0][1]["error"]["details"]
    assert details["reason"] == "vocab_epoch_mismatch"
    assert details["resync"] == (
        "/vocab/snapshot" if client[0] == "stale"
        else f"/vocab/deltas?lineage=feedfacecafebeef&from={client[1]}"
    )
    tsync.validate_epoch(tv, "feedfacecafebeef", len(tv))  # exact match passes


@pytest.mark.parametrize("store_cls", [TStore, ColumnarTupleStore])
def test_lineage_follows_the_vocab_object(store_cls):
    """A delete-triggered rebuild keeps the append-only vocab in both
    packages (the ids of surviving keys do not move), so the lineage and
    the epoch's key prefix stay; only a new vocab object gets a new
    lineage."""
    jstore, _ = store_pair(TUPLES)
    tstore = store_cls()
    tstore.write_relation_tuples(*(TTuple.from_string(s) for s in TUPLES))
    jm, tm = JManager(jstore), TManager(tstore)
    tv0, jv0 = tm.snapshot().vocab, jm.snapshot().vocab
    t_lin, j_lin = tsync.lineage_of(tv0), jsync.lineage_of(jv0)
    keys0 = list(tv0.keys())
    tstore.delete_relation_tuples(TTuple.from_string("n:grp#member@alice"))
    jstore.delete_relation_tuples(JTuple.from_string("n:grp#member@alice"))
    tsnap, jsnap = tm.snapshot(), jm.snapshot()  # the delete rebuilds
    assert tsnap.vocab is tv0 and jsnap.vocab is jv0
    assert tsync.lineage_of(tsnap.vocab) == t_lin
    assert jsync.lineage_of(jsnap.vocab) == j_lin
    assert list(tsnap.vocab.keys())[: len(keys0)] == keys0
    other = store_cls()
    other.write_relation_tuples(*(TTuple.from_string(s) for s in TUPLES))
    assert tsync.lineage_of(TManager(other).snapshot().vocab) != t_lin


def test_front_clamps_ids_and_counts_namespaces():
    _, tstore = store_pair(TUPLES)
    mgr = TManager(tstore)
    seen = {}

    class Backend:
        def check_batch_encoded(self, s, t, **kw):
            seen.update(s=s, t=t, **kw)
            return [False] * len(s)

    front = EncodedCheckFront(mgr, Backend())
    snap = mgr.snapshot()
    vocab = snap.vocab
    frame = tcodec.decode_check_request(tcodec.encode_check_request(
        [0, -1, snap.padded_nodes + 3, 1], [1, 2, 3, 2**31 - 1],
        lineage=tsync.lineage_of(vocab), epoch=len(vocab),
        ns=[0, 0, 1, 9], depths=[1, 2, 3, 4], min_version=5,
    ))
    assert front.check(frame).tolist() == [False] * 4
    d = snap.dummy_node
    assert seen["s"].tolist() == [0, d, d, 1] and seen["t"].tolist() == [1, 2, 3, d]
    assert seen["ns_counts"] == {"n": 2, "files": 1, tsync.NS_UNKNOWN_LABEL: 1}
    assert seen["depths"].tolist() == [1, 2, 3, 4] and seen["min_version"] == 5
    stale = tcodec.decode_check_request(tcodec.encode_check_request(
        [0], [1], lineage=tsync.lineage_of(vocab), epoch=len(vocab) - 1))
    with pytest.raises(TMismatch):
        front.check(stale)
    assert EncodedCheckFront.ns_counts(vocab, None) is None


@pytest.fixture
def server():
    reg = Registry(Config(values={
        "namespaces": [{"id": 1, "name": "n"}],
        "serve": {"read": {"port": 0, "host": "127.0.0.1", "max-depth": 5},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        "engine": {"max_batch": 64},
    }), device="cpu")
    rng = np.random.default_rng(4)
    reg.store().write_relation_tuples(
        *(TTuple.from_string(s) for s in random_tuples(rng, 10, 6, 60))
    )
    read_port, _ = reg.start_all()
    yield reg, f"http://127.0.0.1:{read_port}", rng
    reg.stop_all()


def test_vocab_cache_round_trips_against_a_port_server(server):
    reg, read, rng = server
    cache = VocabCache(read, page_size=7).bootstrap()
    vocab = reg.snapshots().snapshot().vocab
    assert cache.lineage == tsync.lineage_of(vocab)
    assert cache.epoch == len(cache) == len(vocab)
    reqs = random_requests(rng, 10, 6, k=40)
    s, t, ns = cache.encode(reqs)
    tuples = [TTuple.from_string(r) for r in reqs]
    ids = [vocab.lookup((x.namespace, x.object, x.relation)) for x in tuples]
    assert s.tolist() == [-1 if i is None else i for i in ids]
    ids = [vocab.lookup_subject(x.subject) for x in tuples]
    assert t.tolist() == [-1 if i is None else i for i in ids]
    assert ns[-1] == cache.ns_id("nope") == tsync.NS_UNKNOWN
    want = reg.checker().check_batch([TTuple.from_string(r) for r in reqs])
    assert batch_check_encoded(cache, reqs) == want
    # a write that interns new keys bounces the stale frame with a 409 ...
    fresh = ["n:o1#r0@newcomer", "n:o2#r1@(n:o1#r0)"]
    stale = cache.frame(fresh)
    reg.store().write_relation_tuples(TTuple.from_string(fresh[0]))
    status, body = post_frame(read, stale)
    assert status == 409
    # ... and sync() catches up over /vocab/deltas; the resend sees the write
    epoch = cache.epoch
    cache.sync()
    assert cache.epoch > epoch and cache.epoch == len(reg.snapshots().snapshot().vocab)
    assert batch_check_encoded(cache, fresh) == reg.checker().check_batch(
        [TTuple.from_string(r) for r in fresh]
    )
    assert batch_check_encoded(cache, fresh)[0] is True
