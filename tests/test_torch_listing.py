"""keto_tpu_torch's list serving vs keto_tpu's, on the CPU.

The same tuple strings, in the same order and made from a numpy seed, go
into a store of each package. The port's ``ListEngine`` over its
``ClosureCheckEngine(device="cpu")`` and keto_tpu's ``ListEngine`` over its
``ClosureCheckEngine(query_mode="device")`` (XLA on the CPU, as
tests/test_listing.py runs it) must list the same items for
``list_objects`` and ``list_subjects``, and both must equal a forward scan
that checks every candidate with the host BFS oracle. The reverse CSRs
(``build_reverse``) and ``D^T`` are compared byte for byte; pages, their
tokens, stale tokens after a write, the overlay's interior inserts and
deletes, and the breaker drill (``_rows_min`` patched to raise) are held
against keto_tpu too. Tolerance: exact — items are strings, CSRs int32 and
``D^T`` uint8.
"""

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.engine.listing import ListEngine as JListEngine
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectID as JID
from keto_tpu.relationtuple import SubjectSet as JSet
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu.utils import errors as jerrors
from keto_tpu_torch.engine import CheckEngine, ClosureCheckEngine
from keto_tpu_torch.engine import listing
from keto_tpu_torch.engine.listing import ListEngine
from keto_tpu_torch.engine.paging import encode_page_token
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.relationtuple import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.store import InMemoryTupleStore
from keto_tpu_torch.utils import errors

from tests.test_torch_device_engine import random_tuples

torch.set_num_threads(1)

DEPTH = 5


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Pair:
    """One tuple graph in both packages, with a closure engine and a list
    engine each."""

    def __init__(self, tuples=(), max_depth=DEPTH, **list_kw):
        self.jstore = JStore()
        self.tstore = InMemoryTupleStore()
        self.write(*tuples)
        self.max_depth = max_depth
        self.jeng = JClosure(
            JManager(self.jstore), max_depth=max_depth, query_mode="device",
            freshness="strong", rebuild_debounce_s=0.0,
        )
        self.teng = ClosureCheckEngine(
            SnapshotManager(self.tstore), max_depth=max_depth, freshness="strong",
            rebuild_debounce_s=0.0, device="cpu",
        )
        self.jlist = JListEngine(self.jeng, **list_kw)
        self.tlist = ListEngine(self.teng, **list_kw)

    def write(self, *strings):
        if strings:
            self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in strings))
            self.tstore.write_relation_tuples(
                *(RelationTuple.from_string(s) for s in strings)
            )

    def delete(self, *strings):
        self.jstore.delete_relation_tuples(*(JTuple.from_string(s) for s in strings))
        self.tstore.delete_relation_tuples(
            *(RelationTuple.from_string(s) for s in strings)
        )

    def objects(self, subject: str, relation: str, namespace: str, **kw):
        """The port's page, after asserting keto_tpu's page is the same."""
        if "#" in subject:
            ns, rest = subject.split(":", 1)
            obj, rel = rest.split("#")
            tsub, jsub = SubjectSet(ns, obj, rel), JSet(ns, obj, rel)
        else:
            tsub, jsub = SubjectID(subject), JID(subject)
        got = self.tlist.list_objects(tsub, relation, namespace, **kw)
        want = self.jlist.list_objects(jsub, relation, namespace, **kw)
        assert (got.items, got.next_page_token, got.version) == (
            want.items, want.next_page_token, want.version
        ), (subject, relation, namespace)
        return got

    def subjects(self, namespace: str, object: str, relation: str, **kw):
        got = self.tlist.list_subjects(namespace, object, relation, **kw)
        want = self.jlist.list_subjects(namespace, object, relation, **kw)
        assert (got.items, got.next_page_token, got.version) == (
            want.items, want.next_page_token, want.version
        ), (namespace, object, relation)
        return got

    def universe(self):
        """Every (namespace, object), relation and subject id the store
        mentions: the candidates of the forward-scan oracle."""
        objects, rels, sids = set(), set(), set()
        for t in self.tstore.all_tuples():
            objects.add((t.namespace, t.object))
            rels.add(t.relation)
            if isinstance(t.subject, SubjectSet):
                objects.add((t.subject.namespace, t.subject.object))
                rels.add(t.subject.relation)
            else:
                sids.add(t.subject.id)
        return sorted(objects), sorted(rels), sorted(sids)

    def oracle_objects(self, subject, relation, namespace):
        chk = CheckEngine(self.tstore, max_depth=self.max_depth)
        objects, _, _ = self.universe()
        return sorted(
            o for ns, o in objects
            if ns == namespace and chk.subject_is_allowed(
                RelationTuple(namespace, o, relation, subject), self.max_depth
            )
        )

    def oracle_subjects(self, namespace, object, relation):
        chk = CheckEngine(self.tstore, max_depth=self.max_depth)
        _, _, sids = self.universe()
        return sorted(
            s for s in sids
            if chk.subject_is_allowed(
                RelationTuple(namespace, object, relation, SubjectID(s)),
                self.max_depth,
            )
        )

    def check_all(self, namespaces=("n",), oracle=True):
        """Both list queries over the whole universe, against keto_tpu and
        (optionally) the forward-scan oracle; returns the answer count."""
        objects, rels, sids = self.universe()
        n_items = 0
        for ns in namespaces:
            for rel in rels:
                subjects = [f"{s}" for s in sids[:4]] + ["nobody"]
                subjects += [f"{o_ns}:{o}#{rel}" for o_ns, o in objects[:3]]
                for sub in subjects:
                    page = self.objects(sub, rel, ns, max_depth=self.max_depth)
                    n_items += len(page.items)
                    if oracle:
                        tsub = (SubjectSet(*sub.replace(":", "#", 1).split("#"))
                                if "#" in sub else SubjectID(sub))
                        assert page.items == self.oracle_objects(tsub, rel, ns), sub
            for o_ns, o in objects:
                for rel in rels:
                    page = self.subjects(o_ns, o, rel, max_depth=self.max_depth)
                    n_items += len(page.items)
                    if oracle:
                        assert page.items == self.oracle_subjects(o_ns, o, rel)
        return n_items


@pytest.mark.parametrize("seed", range(4))
def test_random_graphs_match_keto_tpu_and_the_oracle(seed):
    rng = np.random.default_rng(seed + 950)
    pair = Pair(random_tuples(rng, n_objects=12, n_users=8, n_edges=110))
    assert pair.check_all(oracle=seed < 2) > 50
    assert pair.tlist.n_oracle == 0 and pair.tlist.n_reverse > 0


@pytest.mark.parametrize("depth", [1, 2, 3, 6])
def test_depths(depth):
    rng = np.random.default_rng(960)
    pair = Pair(random_tuples(rng, n_objects=10, n_users=6, n_edges=80), max_depth=depth)
    pair.check_all(oracle=depth in (1, 2))


def test_cycle_unicode_and_two_namespaces():
    pair = Pair([
        "n:a#r@(n:b#r)", "n:b#r@(n:c#r)", "n:c#r@(n:a#r)", "n:c#r@alice",
        "dø:ü#välj@(n:a#r)", "dø:ü#välj@ßob", "dø:ö#välj@(dø:ü#välj)",
        "n:x#r@(dø:ö#välj)", "n:b#r@ßob",
    ])
    assert pair.check_all(namespaces=("n", "dø")) > 0
    assert pair.objects("alice", "r", "n").items == ["a", "b", "c"]  # x: depth 6
    assert pair.objects("alice", "välj", "dø").items == ["ö", "ü"]
    assert pair.subjects("dø", "ö", "välj").items == ["alice", "ßob"]


def test_reverse_csrs_and_d_transpose_are_byte_equal():
    rng = np.random.default_rng(970)
    pair = Pair(random_tuples(rng, n_objects=14, n_users=9, n_edges=140))
    tview = pair.teng.reverse_artifacts()
    jart = pair.jeng.reverse_artifacts()
    for name in ("set_in_indptr", "set_in_vals", "id_out_indptr", "id_out_vals",
                 "in_indptr", "in_vals"):
        a, b = getattr(tview.rev, name), getattr(jart.rev, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (tview.rev.m, tview.rev.padded_nodes) == (jart.rev.m, jart.rev.padded_nodes)
    assert tview.rev.residency_bytes() == jart.rev.residency_bytes()
    d_rev = tview.d_rev.numpy()
    assert d_rev.dtype == np.uint8 and np.array_equal(d_rev, np.asarray(jart.d_rev))
    assert np.array_equal(d_rev, tview.d.numpy().T)
    assert tview.version == jart.version
    assert pair.teng.last_reverse_build_s > 0
    # the residency is built once per snapshot
    again = pair.teng.reverse_artifacts()
    assert again.d_rev is tview.d_rev and again.rev is tview.rev


@pytest.mark.parametrize("page_size", [1, 2, 5])
def test_paged_equals_unpaged_and_tokens_match(page_size):
    rng = np.random.default_rng(980)
    pair = Pair(random_tuples(rng, n_objects=12, n_users=10, n_edges=130))
    for kind, args in (("objects", ("u1", "r0", "n")), ("subjects", ("n", "o3", "r1"))):
        fn = pair.objects if kind == "objects" else pair.subjects
        full = fn(*args).items
        assert len(full) > page_size
        items, token, pages = [], "", 0
        while True:
            page = fn(*args, page_size=page_size, page_token=token)
            items += page.items
            pages += 1
            token = page.next_page_token
            if not token:
                break
        assert items == full and pages == -(-len(full) // page_size)


def test_a_write_between_pages_is_a_stale_token():
    rng = np.random.default_rng(990)
    pair = Pair(random_tuples(rng, n_objects=12, n_users=10, n_edges=130))
    first = pair.objects("u1", "r0", "n", page_size=2)
    assert first.next_page_token
    pair.write("n:o0#r0@u1")
    with pytest.raises(errors.ErrStalePageToken) as got:
        pair.tlist.list_objects(SubjectID("u1"), "r0", "n", page_size=2,
                                page_token=first.next_page_token)
    with pytest.raises(jerrors.ErrStalePageToken):
        pair.jlist.list_objects(JID("u1"), "r0", "n", page_size=2,
                                page_token=first.next_page_token)
    assert got.value.status_code == 409
    bad = {
        "garbage": "%%%",
        "another query": pair.objects("u2", "r0", "n", page_size=2).next_page_token,
        "an expand token": encode_page_token("snap", pair.tstore.version,
                                             {"p": [], "vis": []}),
    }
    for what, token in bad.items():
        assert token, what
        with pytest.raises(errors.ErrMalformedPageToken) as got:
            pair.tlist.list_objects(SubjectID("u1"), "r0", "n", page_size=2,
                                    page_token=token)
        assert type(got.value) is errors.ErrMalformedPageToken, what
        assert got.value.status_code == 400
        with pytest.raises(jerrors.ErrMalformedPageToken):
            pair.jlist.list_objects(JID("u1"), "r0", "n", page_size=2,
                                    page_token=token)


def test_answers_after_interior_insert_and_delete():
    """The overlay absorbs the writes for checks; the list path folds them
    in with a rebuild and answers at the live version."""
    pair = Pair([
        "n:doc#view@(n:team#member)", "n:team#member@(n:sub#member)",
        "n:sub#member@alice", "n:other#member@bob", "n:doc2#view@(n:other#member)",
        "n:team#member@carol",
    ])
    pair.check_all()
    teng = pair.teng
    view = teng.reverse_artifacts()
    art = teng._state
    assert art.d_rev is view.d_rev
    # an interior insert, absorbed by the overlay on the next check
    pair.write("n:sub#member@(n:other#member)")
    assert teng.batch_check([RelationTuple.from_string("n:doc#view@bob")]) == [True]
    assert teng._overlay.n_events == 1 and teng._state is art
    assert art.d_rev is None  # the patch dropped the stale transpose
    # the D^T of the patched D is its transpose again
    patched = teng._ensure_reverse(art)
    assert np.array_equal(patched.d_rev.numpy(), art.d.numpy().T)
    assert pair.objects("bob", "view", "n").items == ["doc", "doc2"]
    assert teng._state is not art  # the list path rebuilt
    pair.check_all()
    # an interior delete
    pair.delete("n:team#member@(n:sub#member)")
    assert teng.batch_check([RelationTuple.from_string("n:doc#view@alice")]) == [False]
    assert pair.objects("alice", "view", "n").items == []
    assert pair.subjects("n", "doc", "view").items == ["carol"]
    pair.check_all()
    assert pair.tlist.n_oracle == 0


def test_breaker_drill(monkeypatch):
    rng = np.random.default_rng(1000)
    clock = Clock()
    pair = Pair(
        random_tuples(rng, n_objects=10, n_users=6, n_edges=90),
        breaker_threshold=2, breaker_cooldown_s=5.0, clock=clock,
    )
    want = [pair.objects(f"u{i}", "r0", "n").items for i in range(4)]

    def broken(mat, rows):
        raise RuntimeError("device gather failed")

    monkeypatch.setattr(listing, "_rows_min", broken)
    le = pair.tlist
    got = []
    for i in range(4):
        page = le.list_objects(SubjectID(f"u{i}"), "r0", "n")
        assert page.source == "oracle"
        got.append(page.items)
    assert got == want
    # two failures open the breaker; the next two never try the gather
    assert le.n_reverse_failures == 2 and le.breaker_open()
    assert le.n_oracle == 4 and isinstance(le.last_failure, RuntimeError)
    assert pair.subjects("n", "o1", "r0").source == "oracle"
    monkeypatch.undo()
    clock.t += 6.0  # cooldown over: the reverse path answers again
    page = le.list_objects(SubjectID("u0"), "r0", "n")
    assert page.source == "reverse" and page.items == want[0]
    assert not le.breaker_open()


def test_reverse_index_off_and_deadlines():
    rng = np.random.default_rng(1010)
    pair = Pair(random_tuples(rng, n_objects=8, n_users=5, n_edges=60))
    want = pair.objects("u1", "r0", "n").items
    pair.teng.reverse_enabled = False
    pair.jeng.reverse_enabled = False
    page = pair.objects("u1", "r0", "n")
    assert page.items == want and page.source == "oracle"
    assert pair.tlist.n_reverse_failures == 0
    with pytest.raises(errors.DeadlineExceeded):
        pair.tlist.list_subjects("n", "o1", "r0", deadline=0.0)


def test_no_closure_answers_from_the_oracle():
    """A snapshot above the interior limit has no resident closure."""
    rng = np.random.default_rng(1020)
    tuples = random_tuples(rng, n_objects=8, n_users=5, n_edges=60)
    teng = ClosureCheckEngine(
        SnapshotManager(InMemoryTupleStore()), interior_limit=2, device="cpu"
    )
    teng.snapshots.store.write_relation_tuples(
        *(RelationTuple.from_string(s) for s in tuples)
    )
    pair = Pair(tuples)
    le = ListEngine(teng)
    for i in range(3):
        page = le.list_objects(SubjectID(f"u{i}"), "r1", "n")
        assert page.source == "oracle"
        assert page.items == pair.objects(f"u{i}", "r1", "n").items
    assert le.n_reverse_failures == 0
