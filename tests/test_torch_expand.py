"""keto_tpu_torch's Expand engines vs keto_tpu's, on the CPU.

The same tuple strings, in the same order and made from a numpy seed, go
into a store of each package. The port's ``SnapshotExpandEngine`` (over the
snapshot's forward CSR) and its store-walking ``ExpandEngine`` must build
the trees keto_tpu's two engines build, ``to_dict()``-equal, on graphs with
cycles and diamonds (where DFS-preorder decides which occurrence of a
repeated set is expanded), at depths 1 to 6. Paged Expand stitched with
``apply_expand_patches`` must equal the unpaged tree, and every page must
equal keto_tpu's page, continuation token strings included. Tolerance:
exact — trees and tokens are compared as JSON values and strings.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keto_tpu.engine.device import SnapshotExpandEngine as JSnapExpand
from keto_tpu.engine.expand import ExpandEngine as JExpand
from keto_tpu.engine.tree import Tree as JTree
from keto_tpu.engine.tree import apply_expand_patches as j_apply_expand_patches
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.namespace import MemoryNamespaceManager as JNamespaces
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectSet as JSet
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu.utils import errors as jerrors
from keto_tpu_torch.engine.device import SnapshotExpandEngine
from keto_tpu_torch.engine.expand import ExpandEngine, ExpandPage
from keto_tpu_torch.engine.paging import encode_page_token
from keto_tpu_torch.engine.tree import NodeType, Tree, apply_expand_patches
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.namespace import MemoryNamespaceManager
from keto_tpu_torch.relationtuple import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.store import InMemoryTupleStore
from keto_tpu_torch.utils import errors

from tests.test_torch_device_engine import random_tuples

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


class Pair:
    """One tuple graph in both packages, with both Expand engines each."""

    def __init__(self, tuples=(), max_depth=5, namespaces=None):
        jns = tns = None
        if namespaces is not None:
            jns, tns = JNamespaces(), MemoryNamespaceManager()
            for name in namespaces:
                jns.add(name)
                tns.add(name)
        self.jstore = JStore(namespace_manager=jns)
        self.tstore = InMemoryTupleStore(namespace_manager=tns)
        self.write(*tuples)
        self.tmgr = SnapshotManager(self.tstore)
        self.jmgr = JManager(self.jstore)
        self.engines = {
            "snap": (
                SnapshotExpandEngine(self.tmgr, max_depth=max_depth),
                JSnapExpand(self.jmgr, max_depth=max_depth),
            ),
            "host": (
                ExpandEngine(self.tstore, max_depth=max_depth),
                JExpand(self.jstore, max_depth=max_depth),
            ),
        }

    def write(self, *strings):
        if strings:
            self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in strings))
            self.tstore.write_relation_tuples(
                *(RelationTuple.from_string(s) for s in strings)
            )

    def tree(self, subject: str, depth=0):
        """The port's tree as a dict (or None), after asserting both port
        engines and both keto_tpu engines agree."""
        ns, rest = subject.split(":", 1)
        obj, rel = rest.split("#")
        out = []
        for name, (teng, jeng) in self.engines.items():
            got = teng.build_tree(SubjectSet(ns, obj, rel), depth)
            want = jeng.build_tree(JSet(ns, obj, rel), depth)
            got_d = None if got is None else got.to_dict()
            want_d = None if want is None else want.to_dict()
            assert got_d == want_d, (name, subject, depth)
            if got is not None:
                assert [str(s) for s in got.flat_subjects()] == [
                    str(s) for s in want.flat_subjects()
                ]
                assert str(got) == str(want)
            out.append(got_d)
        assert out[0] == out[1], subject  # snapshot engine == store walk
        return out[0]


def drain(engine, subject, depth, page_size, stitch=apply_expand_patches):
    """Every page of a paged expand: (stitched tree, [page dicts])."""
    page = engine.build_tree_page(subject, max_depth=depth, page_size=page_size)
    tree, pages = page.tree, [page.to_dict()]
    while page.next_page_token:
        assert len(pages) < 10_000, "paged expand did not terminate"
        page = engine.build_tree_page(
            subject, max_depth=depth, page_size=page_size,
            page_token=page.next_page_token,
        )
        tree = stitch(tree, page.patches)
        pages.append(page.to_dict())
    return tree, pages


def all_sets(n_objects, n_rel=3):
    return [f"n:o{o}#r{r}" for o in range(n_objects) for r in range(n_rel)]


@pytest.mark.parametrize("seed", range(4))
def test_random_graphs_match_keto_tpu(seed):
    rng = np.random.default_rng(seed + 900)
    pair = Pair(random_tuples(rng, n_objects=12, n_users=8, n_edges=110), max_depth=8)
    sizes = []
    for depth in range(1, 7):
        for s in all_sets(12) + ["n:o99#r0", "nope:x#y"]:
            t = pair.tree(s, depth)
            if t is not None:
                sizes.append(len(Tree.from_dict(t).flat_subjects()))
    assert max(sizes) > 20  # the random graphs give deep trees


def test_diamonds_and_cycles_follow_dfs_preorder():
    """a reaches d along two paths and d closes a cycle back to a: which
    occurrence of d is expanded is decided by the visited order."""
    pair = Pair(
        [
            "n:a#r@(n:b#r)", "n:a#r@(n:c#r)", "n:b#r@(n:d#r)",
            "n:c#r@(n:d#r)", "n:c#r@(n:e#r)", "n:e#r@(n:d#r)",
            "n:d#r@(n:a#r)", "n:d#r@u1", "n:e#r@u2", "n:b#r@u3",
        ],
        max_depth=10,
    )
    for depth in range(1, 7):
        for s in ("n:a#r", "n:c#r", "n:d#r", "n:e#r"):
            pair.tree(s, depth)
    tree = Tree.from_dict(pair.tree("n:a#r", 6))
    b, c = tree.children
    assert b.children[0].type == NodeType.UNION  # d expanded under b first
    assert c.children[0].type == NodeType.LEAF  # the second d is a Leaf
    assert str(b.children[0].children[0].subject) == "n:a#r"  # the cycle


@pytest.mark.parametrize("page_size", [1, 3, 17])
@pytest.mark.parametrize("seed", range(2))
def test_paged_stitches_to_unpaged_and_matches_keto_tpu(seed, page_size):
    rng = np.random.default_rng(seed + 910)
    pair = Pair(random_tuples(rng, n_objects=10, n_users=6, n_edges=90), max_depth=6)
    multi = 0
    for s in all_sets(10)[::2]:
        ns, rest = s.split(":", 1)
        obj, rel = rest.split("#")
        for name, (teng, jeng) in pair.engines.items():
            want_tree = teng.build_tree(SubjectSet(ns, obj, rel), 6)
            got_tree, pages = drain(teng, SubjectSet(ns, obj, rel), 6, page_size)
            j_tree, j_pages = drain(
                jeng, JSet(ns, obj, rel), 6, page_size, j_apply_expand_patches
            )
            assert pages == j_pages, (name, s)  # token strings included
            assert (got_tree and got_tree.to_dict()) == (
                want_tree and want_tree.to_dict()
            ), (name, s)
            assert (j_tree and j_tree.to_dict()) == (got_tree and got_tree.to_dict())
            multi += len(pages) > 1
    assert multi > 0


def test_bad_tokens_raise_the_same_errors():
    pair = Pair(["n:a#r@(n:b#r)", "n:b#r@u1", "n:b#r@u2", "n:a#r@u3"])
    for name, (teng, jeng) in pair.engines.items():
        page = teng.build_tree_page(SubjectSet("n", "a", "r"), page_size=1)
        jpage = jeng.build_tree_page(JSet("n", "a", "r"), page_size=1)
        assert page.next_page_token == jpage.next_page_token
        other = "host" if name == "snap" else "snap"
        bad = {
            "garbage": "!!not-a-token",
            "truncated": page.next_page_token[:7],
            "cross-engine": encode_page_token(other, 0, {"p": [], "vis": []}),
            "list token": encode_page_token("list", 0, {"q": [], "o": 1}),
        }
        for what, token in bad.items():
            with pytest.raises(errors.ErrMalformedPageToken) as got:
                teng.build_tree_page(SubjectSet("n", "a", "r"), page_size=1,
                                     page_token=token)
            with pytest.raises(jerrors.ErrMalformedPageToken) as want:
                jeng.build_tree_page(JSet("n", "a", "r"), page_size=1,
                                     page_token=token)
            assert type(got.value).__name__ == type(want.value).__name__, what
            assert got.value.status_code == want.value.status_code == 400, what
    token = pair.engines["snap"][0].build_tree_page(
        SubjectSet("n", "a", "r"), page_size=1
    ).next_page_token
    htoken = pair.engines["host"][0].build_tree_page(
        SubjectSet("n", "a", "r"), page_size=1
    ).next_page_token
    pair.write("n:b#r@u9")  # the store moves: both cursors are stale
    for (teng, jeng), tok in zip(pair.engines.values(), (token, htoken)):
        with pytest.raises(errors.ErrStalePageToken) as got:
            teng.build_tree_page(SubjectSet("n", "a", "r"), page_size=1, page_token=tok)
        with pytest.raises(jerrors.ErrStalePageToken):
            jeng.build_tree_page(JSet("n", "a", "r"), page_size=1, page_token=tok)
        assert got.value.status_code == 409
        assert got.value.envelope()["error"]["status"] == "Conflict"


def test_chain_longer_than_the_recursion_limit_terminates():
    depth = sys.getrecursionlimit() + 300
    pair = Pair(
        [f"n:c{i}#r@(n:c{i + 1}#r)" for i in range(depth)] + [f"n:c{depth}#r@(bottom)"],
        max_depth=depth + 5,
    )
    for teng, _ in pair.engines.values():
        tree = teng.build_tree(SubjectSet("n", "c0", "r"), depth + 5)
        node, levels = tree, 0
        while node.type == NodeType.UNION:
            (node,) = node.children
            levels += 1
        assert node.subject == SubjectID("bottom") and levels == depth + 1
        assert len(tree.flat_subjects()) == depth + 2
        stitched, pages = drain(teng, SubjectSet("n", "c0", "r"), depth + 5, 400)
        assert len(pages) > 1
        assert len(stitched.flat_subjects()) == depth + 2


def test_cat_videos_tree_matches_keto_tpu():
    strings = []
    for path in sorted((REPO / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(path.read_text())
        doc.pop("$schema", None)
        strings.append(str(RelationTuple.from_dict(doc)))
    pair = Pair(strings, namespaces=["videos"])
    tree = pair.tree("videos:/cats/1.mp4#view")
    want = {
        "type": "union",
        "subject_set": {"namespace": "videos", "object": "/cats/1.mp4",
                        "relation": "view"},
    }
    assert {k: tree[k] for k in want} == want
    subjects = [str(s) for s in Tree.from_dict(tree).flat_subjects()]
    assert "*" in subjects and "cat lady" in subjects
    assert "videos:/cats/1.mp4#owner" in subjects and "videos:/cats#owner" in subjects
    assert pair.tree("videos:/cats/2.mp4#view") is not None
    # an unknown namespace: the store walk gets ErrNotFound, the snapshot
    # engine never saw the set; both answer no tree
    assert pair.tree("nope:/x#view") is None


def test_unknown_and_late_sets_have_no_tree():
    pair = Pair(["n:a#r@(n:b#r)", "n:b#r@u1"])
    teng = pair.engines["snap"][0]
    # n:b#r appears as a subject; n:z#q never appears anywhere
    assert pair.tree("n:z#q") is None
    snap = pair.tmgr.snapshot()
    assert snap.vocab.lookup_subject(SubjectSet("n", "z", "q")) is None
    # an id interned beyond the snapshot's width is unknown to it
    late = snap.vocab.intern_subject(SubjectSet("n", "late", "r"))
    while late < snap.padded_nodes:
        late = snap.vocab.intern_subject(SubjectSet("n", f"late{late}", "r"))
    snap.vocab.intern_subject(SubjectSet("n", "late", "r"))
    name = snap.vocab.key(late)
    assert teng.build_tree(SubjectSet(*name), 5) is None
    assert teng.build_tree_page(SubjectSet(*name), 5).tree is None
    assert teng.build_tree(SubjectID("u1"), 5).to_dict() == {
        "type": "leaf", "subject_id": "u1"
    }


def test_snapshot_csr_matches_keto_tpu_and_carries_appends():
    rng = np.random.default_rng(930)
    pair = Pair(random_tuples(rng, n_objects=10, n_users=6, n_edges=80))
    tsnap, jsnap = pair.tmgr.snapshot(), pair.jmgr.snapshot()
    for a, b in zip(tsnap.csr(), jsnap.csr()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pair.write("n:o1#r0@(n:o2#r1)", "n:o1#r0@fresh-user")  # appended, not rebuilt
    tsnap, jsnap = pair.tmgr.snapshot(), pair.jmgr.snapshot()
    assert tsnap._csr_edges < tsnap.num_edges and tsnap._csr_extra
    assert (tsnap._csr_edges, tsnap._csr_extra) == (jsnap._csr_edges, jsnap._csr_extra)
    for nid in range(tsnap.num_nodes):
        assert np.array_equal(tsnap.out_neighbors(nid), jsnap.out_neighbors(nid))
    assert tsnap.out_neighbors(tsnap.padded_nodes + 5).size == 0
    for s in all_sets(10):
        pair.tree(s)
    assert np.array_equal(tsnap.csr()[0], jsnap.csr()[0])  # a full derive


def test_pages_and_patches_wire_form():
    pair = Pair(["n:a#r@(n:b#r)", "n:b#r@u1", "n:b#r@u2"])
    for teng, jeng in pair.engines.values():
        first = teng.build_tree_page(SubjectSet("n", "a", "r"), page_size=1)
        assert first.to_dict() == jeng.build_tree_page(
            JSet("n", "a", "r"), page_size=1
        ).to_dict()
        assert first.next_page_token and "tree" in first.to_dict()
        nxt = teng.build_tree_page(
            SubjectSet("n", "a", "r"), page_size=1, page_token=first.next_page_token
        )
        doc = nxt.to_dict()
        assert doc["patches"][0]["path"] == [0]
        # stitching from the wire form (dicts) equals stitching the objects
        tree = Tree.from_dict(first.to_dict()["tree"])
        apply_expand_patches(tree, [(p["path"], p["tree"]) for p in doc["patches"]])
        assert tree.to_dict() == teng.build_tree(SubjectSet("n", "a", "r")).to_dict()
        assert tree.to_dict() == JTree.from_dict(tree.to_dict()).to_dict()
    assert ExpandPage().to_dict() == {"tree": None}
    with pytest.raises(errors.ErrMalformedInput):
        apply_expand_patches(tree, [([], tree)])
    with pytest.raises(errors.ErrMalformedInput):
        apply_expand_patches(tree, [([5, 0], tree)])
    with pytest.raises(errors.ErrMalformedInput):
        Tree.from_dict({"type": "nope", "subject_id": "x"})
    with pytest.raises(errors.ErrMalformedInput):
        Tree.from_dict({"type": "leaf"})
