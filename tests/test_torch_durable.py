"""keto_tpu_torch's durable write plane against keto_tpu's, on the CPU (the
port of tests/test_recovery.py, with the formats held across packages).

- the WAL: framing round trip, torn tail, mid-log gap, rotation and prune,
  sync policies; the fault sites ``wal.torn_write``, ``wal.corrupt_crc``,
  ``wal.crash_after_append`` and ``wal.enospc``; every case run through
  both packages;
- checkpoints: round trip, ``checkpoint.crash_mid_write``, the damaged and
  the tampered (sha256) checkpoint skipped, pre-sha256 files;
- the durable wrapper: recovery = checkpoint + WAL suffix, a clean reopen,
  fail-stop after an append failure, bulk loads, the background trigger;
- the formats across packages: a WAL segment written from the same deltas
  is byte-equal in both, and each package replays the other's; a
  checkpoint's payload hashes alike and each package restores the other's
  (the .npz files differ only in the zip entries' timestamps);
- the registry: ``store.wal.dir`` wraps memory and columnar stores and is
  ignored on a SQL DSN; a restart recovers every acked write and primes
  the snapshot CSR from the final checkpoint; a process SIGKILLed after
  its acked writes recovers them all;
- the scrubber's WAL and checkpoint kinds (``wal.bitrot`` and a damaged
  checkpoint, each repaired by a fresh checkpoint).

Each package gets its own temporary directory. Tolerances: exact.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("jax", "torch")
KINDS = ("memory", "columnar")


def _pkg(name):
    root = "keto_tpu" if name == "jax" else "keto_tpu_torch"

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    rt = m("relationtuple")
    faults = m("faults")
    store = m("store")
    return SimpleNamespace(
        name=name,
        Tuple=rt.RelationTuple,
        ID=rt.SubjectID,
        Set=rt.SubjectSet,
        Query=rt.RelationQuery,
        FAULTS=faults.FAULTS,
        Injected=faults.FaultInjected,
        wal=m("store.wal"),
        durable=m("store.durable"),
        ckpt=m("graph.checkpoint"),
        kinds={"memory": store.InMemoryTupleStore, "columnar": store.ColumnarTupleStore},
    )


P = {name: _pkg(name) for name in PKGS}


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in P.values():
        p.FAULTS.reset()
    yield
    for p in P.values():
        p.FAULTS.reset()


def _t(p, i, rel="view"):
    return p.Tuple("n", f"o{i}", rel, p.ID(f"u{i % 7}"))


def _tuples_of(p, store):
    return sorted(str(t) for t in store.get_relation_tuples(p.Query(namespace="n"))[0])


def _dir(tmp_path, pkg, *parts):
    d = tmp_path.joinpath(pkg, *parts)
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


# -- the WAL ------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_round_trip_torn_tail_and_reopen(pkg, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    wal = p.wal.WriteAheadLog(d)
    wal.append(1, [_t(p, 0)], [])
    wal.append(2, [p.Tuple("n", "doc", "view", p.Set("n", "g", "member"))], [_t(p, 0)])
    wal.append(3, [], [])
    wal.close()
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert [r.version for r in records] == [1, 2, 3]
    assert records[1].deleted == [_t(p, 0)]
    assert isinstance(records[1].inserted[0].subject, p.Set)
    assert (stats.gap, stats.torn_tail_bytes) == (False, 0)
    seg = os.path.join(d, sorted(os.listdir(d))[-1])
    with open(seg, "ab") as f:
        f.write(b"\x01\x02\x03")  # half a frame header: an unacked torn tail
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert [r.version for r in records] == [1, 2, 3]
    assert (stats.gap, stats.torn_tail_bytes) == (False, 3)
    wal = p.wal.WriteAheadLog(d)  # the append-side open truncates the tail
    wal.append(4, [_t(p, 4)], [])
    wal.close()
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert [r.version for r in records] == [1, 2, 3, 4] and stats.torn_tail_bytes == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_mid_log_corruption_flags_a_gap(pkg, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    wal = p.wal.WriteAheadLog(d)
    for v in range(1, 4):
        wal.append(v, [_t(p, v)], [])
    wal.close()
    seg = os.path.join(d, sorted(os.listdir(d))[-1])
    with open(seg, "r+b") as f:
        f.seek(20)  # inside the first frame's payload
        f.write(b"\xff")
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert stats.gap and len(records) < 3


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_rotation_prune_and_sync_policies(pkg, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg, "rot")
    wal = p.wal.WriteAheadLog(d, segment_bytes=1)  # every append rotates
    for v in range(1, 6):
        wal.append(v, [_t(p, v)], [])
    assert len([n for n in os.listdir(d) if n.endswith(".seg")]) == 5
    assert len(p.wal.sealed_segments(d)) == 4
    assert wal.prune_upto(3) == 3
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert [r.version for r in records] == [4, 5] and not stats.gap
    wal.close()
    for policy in ("always", "interval", "off"):
        dp = _dir(tmp_path, pkg, policy)
        wal = p.wal.WriteAheadLog(dp, sync=policy, sync_interval_ms=5)
        wal.append(1, [_t(p, 1)], [])
        wal.close()
        assert [r.version for r in p.wal.WriteAheadLog.replay(dp)[0]] == [1]
    with pytest.raises(p.wal.WalError):
        p.wal.WriteAheadLog(_dir(tmp_path, pkg, "bad"), sync="sometimes")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("site,versions,torn,bad", [
    ("wal.torn_write", [1], True, 0),
    ("wal.corrupt_crc", [1], True, 1),
    ("wal.crash_after_append", [1, 2], False, 0),
    ("wal.enospc", [1], False, 0),
])
def test_wal_fault_sites(pkg, site, versions, torn, bad, tmp_path):
    """Each append fault: the append raises (never acked); replay keeps the
    acked record, drops or surfaces the faulted one as the reference does,
    and never flags a gap."""
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    wal = p.wal.WriteAheadLog(d)
    wal.append(1, [_t(p, 1)], [])
    p.FAULTS.arm(site)
    with pytest.raises((p.Injected, OSError)):
        wal.append(2, [_t(p, 2)], [])
    records, stats = p.wal.WriteAheadLog.replay(d)
    assert [r.version for r in records] == versions
    assert (stats.torn_tail_bytes > 0, stats.bad_frames, stats.gap) == (torn, bad, False)


def _deltas(p):
    return [
        (1, [_t(p, i) for i in range(5)], []),
        (2, [p.Tuple("n", "doc", "view", p.Set("n", "g", "member"))], [_t(p, 1)]),
        (3, [p.Tuple("n", "a:b#c@d", "view", p.ID("x@y#z"))], []),
    ]


def test_a_wal_segment_is_byte_equal_and_replays_across_packages(tmp_path):
    dirs = {}
    for pkg in PKGS:
        p = P[pkg]
        dirs[pkg] = _dir(tmp_path, pkg)
        wal = p.wal.WriteAheadLog(dirs[pkg])
        for v, ins, dels in _deltas(p):
            wal.append(v, ins, dels)
        wal.append_bulk_marker(4)
        wal.close()
    names = {pkg: sorted(os.listdir(d)) for pkg, d in dirs.items()}
    assert names["jax"] == names["torch"]
    for name in names["torch"]:
        assert (Path(dirs["jax"]) / name).read_bytes() == (Path(dirs["torch"]) / name).read_bytes()
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        records, stats = P[reader].wal.WriteAheadLog.replay(dirs[writer])
        assert [(r.version, r.kind, [str(t) for t in r.inserted], [str(t) for t in r.deleted])
                for r in records] == [
            (v, "delta", [str(t) for t in ins], [str(t) for t in dels])
            for v, ins, dels in _deltas(P[reader])] + [(4, "bulk", [], [])]
        assert not stats.gap


# -- checkpoints ------------------------------------------------------------------------


def _build(p, kind):
    store = p.kinds[kind]()
    store.write_relation_tuples(*[_t(p, i) for i in range(20)])
    store.write_relation_tuples(p.Tuple("n", "doc", "view", p.Set("n", "g", "member")))
    store.delete_relation_tuples(_t(p, 3), _t(p, 7))
    return store


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_round_trip(pkg, kind, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    store = _build(p, kind)
    path = p.ckpt.write_checkpoint(d, store)
    assert os.path.basename(path) == f"ckpt-{store.version:020d}.npz"
    fresh = p.kinds[kind]()
    p.ckpt.load_latest(d).restore_into(fresh)
    assert (fresh.version, len(fresh)) == (store.version, len(store))
    assert _tuples_of(p, fresh) == _tuples_of(p, store)
    fresh.write_relation_tuples(_t(p, 99))  # still a working mutable store
    assert fresh.version == store.version + 1
    fresh.delete_relation_tuples(_t(p, 0))
    assert _t(p, 0) not in fresh.get_relation_tuples(p.Query(namespace="n"))[0]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_crash_mid_write_keeps_the_previous(pkg, kind, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    store = _build(p, kind)
    p.ckpt.write_checkpoint(d, store)
    v1 = store.version
    store.write_relation_tuples(_t(p, 50))
    p.FAULTS.arm("checkpoint.crash_mid_write")
    with pytest.raises(p.Injected):
        p.ckpt.write_checkpoint(d, store)
    assert p.ckpt.load_latest(d).version == v1
    p.ckpt.write_checkpoint(d, store)  # supersedes it and sweeps the litter
    assert p.ckpt.load_latest(d).version == store.version
    assert not [n for n in os.listdir(d) if ".tmp." in n]


def _tamper(path):
    """One payload value changed, the old meta kept: the zip stays valid, so
    only the sha256 can catch it."""
    with np.load(path, allow_pickle=False) as npz:
        arrays = {n: npz[n] for n in npz.files}
    for name, arr in sorted(arrays.items()):
        if name != "meta" and arr.dtype.kind in "iu" and arr.size:
            arr = arr.copy()
            arr.flat[0] ^= 1
            arrays[name] = arr
            break
    np.savez(path.removesuffix(".npz"), **arrays)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("damage", ["truncate", "tamper"])
def test_a_damaged_checkpoint_is_skipped(pkg, kind, damage, tmp_path):
    p = P[pkg]
    d = _dir(tmp_path, pkg)
    store = _build(p, kind)
    p.ckpt.write_checkpoint(d, store, keep=5)
    v1 = store.version
    store.write_relation_tuples(_t(p, 51))
    newest = p.ckpt.write_checkpoint(d, store, keep=5)
    if damage == "truncate":
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) // 2)
    else:
        _tamper(newest)
        with pytest.raises(p.ckpt.CheckpointError, match="sha256"):
            p.ckpt.load_checkpoint(newest)
    ckpt = p.ckpt.load_latest(d)
    assert ckpt.version == v1 and ckpt.meta.get("skipped_damaged")


@pytest.mark.parametrize("pkg", PKGS)
def test_a_pre_sha256_checkpoint_still_loads(pkg, tmp_path):
    p = P[pkg]
    store = _build(p, "columnar")
    path = p.ckpt.write_checkpoint(_dir(tmp_path, pkg), store)
    with np.load(path, allow_pickle=False) as npz:
        arrays = {n: npz[n] for n in npz.files}
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    meta.pop("sha256")
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path.removesuffix(".npz"), **arrays)
    fresh = p.kinds["columnar"]()
    p.ckpt.load_checkpoint(path).restore_into(fresh)
    assert _tuples_of(p, fresh) == _tuples_of(p, store)


@pytest.mark.parametrize("kind", KINDS)
def test_a_checkpoint_restores_across_packages(kind, tmp_path):
    """The same writes into each package's store: the payload hashes alike
    (the .npz bytes differ only in the zip entries' timestamps), and each
    package restores the other's checkpoint to the same tuples, version and
    vocab."""
    paths, stores = {}, {}
    for pkg in PKGS:
        p = P[pkg]
        stores[pkg] = _build(p, kind)
        rng = np.random.default_rng(0)
        csr = (np.arange(9, dtype=np.int32), rng.integers(0, 8, 16).astype(np.int32))
        paths[pkg] = p.ckpt.write_checkpoint(_dir(tmp_path, pkg), stores[pkg], csr=csr)
    metas = {pkg: P[pkg].ckpt.load_checkpoint(paths[pkg]).meta for pkg in PKGS}
    assert metas["jax"]["sha256"] == metas["torch"]["sha256"]
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        p = P[reader]
        ck = p.ckpt.load_checkpoint(paths[writer])
        fresh = p.kinds[kind]()
        ck.restore_into(fresh)
        assert ck.csr_version == fresh.version and len(ck.csr[0]) == 9
        assert _tuples_of(p, fresh) == _tuples_of(P[writer], stores[writer])
        assert fresh.version == stores[writer].version
        if kind == "columnar":
            assert fresh.vocab._key_of == stores[writer].vocab._key_of


# -- the durable wrapper ----------------------------------------------------------------


def _durable(p, tmp_path, kind, **kw):
    kw.setdefault("checkpoint_interval_versions", 10**9)
    kw.setdefault("checkpoint_interval_s", 0.0)
    return p.durable.DurableTupleStore(p.kinds[kind](), _dir(tmp_path, p.name, "wal"), **kw)


def _recover(p, tmp_path, kind):
    fresh = p.kinds[kind]()
    wal = _dir(tmp_path, p.name, "wal")
    return fresh, p.durable.recover_store(fresh, wal, os.path.join(wal, "checkpoints"))


def _recovery_script(pkg, kind, tmp_path) -> list:
    p = P[pkg]
    out = []
    store = _durable(p, tmp_path, kind)
    store.write_relation_tuples(*[_t(p, i) for i in range(10)])
    store.delete_relation_tuples(_t(p, 2))
    store.transact_relation_tuples([_t(p, 77)], [_t(p, 5)])
    # no close: a crash (sync=always has fsynced every append)
    fresh, rep = _recover(p, tmp_path, kind)
    out.append((rep.gap, rep.replayed_deltas, rep.final_version, _tuples_of(p, fresh)))
    assert _tuples_of(p, fresh) == _tuples_of(p, store)
    store.checkpoint_now()
    ckpt_v = store.last_checkpoint_version()
    store.write_relation_tuples(_t(p, 100))
    store.delete_relation_tuples(_t(p, 1))
    fresh, rep = _recover(p, tmp_path, kind)
    out.append((rep.gap, rep.checkpoint_version == ckpt_v, rep.replayed_deltas,
                rep.final_version, _tuples_of(p, fresh)))
    assert _tuples_of(p, fresh) == _tuples_of(p, store)
    v = store.version
    store.close_durable()  # the final checkpoint
    store2 = _durable(p, tmp_path, kind)
    out.append((store2.recovery.checkpoint_version == v, store2.recovery.replayed_deltas,
                store2.version))
    store2.write_relation_tuples(_t(p, 200))
    p.FAULTS.arm("wal.torn_write")
    with pytest.raises(p.Injected):
        store2.write_relation_tuples(_t(p, 201))
    with pytest.raises(p.wal.WalError):  # fail-stopped
        store2.write_relation_tuples(_t(p, 202))
    fresh, rep = _recover(p, tmp_path, kind)
    # the faulted write was applied in memory but never acked, and it is
    # not in the log
    out.append((rep.gap, rep.final_version, str(_t(p, 201)) in _tuples_of(p, fresh)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_recovery_matches_the_reference(kind, tmp_path):
    got = _recovery_script("torch", kind, tmp_path)
    assert got == _recovery_script("jax", kind, tmp_path)
    assert [g[:3] for g in got[:2]] == [(False, 3, 3), (False, True, 2)]
    assert got[2] == (True, 0, 5) and got[3] == (False, 6, False)


@pytest.mark.parametrize("pkg", PKGS)
def test_bulk_load_checkpoints_synchronously_and_a_lost_one_degrades_loudly(pkg, tmp_path):
    p = P[pkg]
    store = _durable(p, tmp_path / "a", "columnar")
    src = [("n", f"o{i}", "view") for i in range(500)]
    dst = [(f"u{i % 11}",) for i in range(500)]
    store.bulk_load_edges(src, dst)
    assert store.last_checkpoint_version() == store.version
    fresh, rep = _recover(p, tmp_path / "a", "columnar")
    assert (rep.gap, len(fresh), fresh.version) == (False, len(store), store.version)
    store = _durable(p, tmp_path / "b", "columnar")
    p.FAULTS.arm("checkpoint.crash_mid_write")
    with pytest.raises(p.Injected):
        store.bulk_load_edges([("n", "o", "view")], [("u1",)])
    fresh, rep = _recover(p, tmp_path / "b", "columnar")
    assert rep.gap and any("bulk" in n for n in rep.notes)
    assert rep.final_version == store.version


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
def test_background_checkpoint_trigger(pkg, kind, tmp_path):
    p = P[pkg]
    store = _durable(p, tmp_path, kind, checkpoint_interval_versions=5)
    for i in range(7):
        store.write_relation_tuples(_t(p, i))
    deadline = time.monotonic() + 10.0
    while store.last_checkpoint_version() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert store.last_checkpoint_version() >= 5
    store.close_durable()


# -- the registry's durable seams ---------------------------------------------------------


def _values(dsn, wal_dir="", **extra):
    v = {
        "dsn": dsn,
        "namespaces": [{"id": 1, "name": "n"}],
        "serve": {"read": {"port": 0, "host": "127.0.0.1"},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        "engine": {"max_batch": 64},
    }
    if wal_dir:
        v["store"] = {"wal": {"dir": wal_dir}}
    v.update(extra)
    return v


def _registry(values):
    from keto_tpu_torch.driver import Config, Registry

    return Registry(Config(values=values), device="cpu")


def test_wal_dir_wraps_memory_and_columnar_and_is_ignored_on_sql(tmp_path, caplog):
    from keto_tpu_torch.store.durable import DurableTupleStore

    for dsn in ("memory", "columnar"):
        store = _registry(_values(dsn, str(tmp_path / dsn))).store()
        assert isinstance(store, DurableTupleStore)
        assert type(store.inner).__name__ == {
            "memory": "InMemoryTupleStore", "columnar": "ColumnarTupleStore"}[dsn]
        store.close_durable()
    with caplog.at_level("WARNING", logger="keto_tpu_torch"):
        store = _registry(_values(f"sqlite://{tmp_path}/k.db", str(tmp_path / "sql"))).store()
    assert type(store).__name__ == "SQLTupleStore"
    assert "already durable" in caplog.text and not (tmp_path / "sql").exists()
    store.close()


def _rbac_lines(rng, n_users=30, n_groups=6, n_docs=40):
    lines = [f"n:g{g}#member@u{u}" for u in range(n_users)
             for g in rng.choice(n_groups, 2, replace=False)]
    lines += [f"n:g{g}#member@(n:g{g + 1}#member)" for g in range(n_groups - 1)]
    lines += [f"n:d{d}#view@(n:g{rng.integers(n_groups)}#member)" for d in range(n_docs)]
    lines += [f"n:d{d}#view@u{rng.integers(n_users)}" for d in range(0, n_docs, 3)]
    return list(dict.fromkeys(lines))


def _requests(rng, k=120):
    return [f"n:d{rng.integers(40)}#view@u{rng.integers(33)}" for _ in range(k)]


@pytest.mark.parametrize("kind", KINDS)
def test_a_restart_recovers_and_primes_the_csr(kind, tmp_path):
    """Writes through a durable registry, stop_all (its final checkpoint
    carries the snapshot CSR the warmup derived), a second boot: the CSR is
    primed from the checkpoint and equals a fresh derive, and the closure
    engine answers as the host oracle. A write after that boot leaves the
    snapshot's CSR carried forward, not derived, so the next final
    checkpoint carries none (the reference's rule: a checkpoint never pays
    for a derive) and the third boot derives it in warmup; every write is
    back each time."""
    from keto_tpu_torch.engine.check import CheckEngine
    from keto_tpu_torch.relationtuple import RelationTuple as T

    rng = np.random.default_rng(1)
    lines = _rbac_lines(rng)
    values = _values(kind, str(tmp_path / "wal"))
    reg = _registry(values)
    reg.store().write_relation_tuples(*[T.from_string(x) for x in lines])
    reg.start_all()
    assert reg.csr_primed is False
    reg.stop_all()

    reg2 = _registry(values)
    store = reg2.store()
    assert (store.recovery.gap, store.recovery.replayed_deltas,
            store.recovery.final_version) == (False, 0, 1)
    reg2.start_all()
    assert reg2.csr_primed is True
    assert reg2._device_status()["recovery"]["csr_primed"] is True
    snap = reg2.snapshots().snapshot()
    primed = snap._csr
    snap._csr = None
    derived = snap.csr()
    assert all(np.array_equal(a, b) for a, b in zip(primed, derived))
    reqs = [T.from_string(x) for x in _requests(rng)] + [T.from_string("n:d1#view@u99")]
    want = CheckEngine(store).batch_check(reqs)
    assert reg2.checker().check_batch(reqs) == want and not want[-1]
    store.write_relation_tuples(T.from_string("n:d1#view@u99"))
    assert reg2.checker().check_batch(reqs[-1:], min_version=2) == [True]
    reg2.stop_all()

    reg3 = _registry(values)
    assert reg3.store().recovery.final_version == 2
    reg3.start_all()
    assert reg3.csr_primed is False
    assert reg3.checker().check_batch(reqs) == CheckEngine(reg3.store()).batch_check(reqs)
    reg3.stop_all()


def test_a_forked_replica_gets_fresh_locks_on_the_wrapped_store(tmp_path):
    """The fork pool serves a durable store (process-private): after a fork
    the replica replaces the inner store's locks, not attributes of the
    wrapper that the store never reads, and the wrapper's own locks."""
    from keto_tpu_torch.driver.replicas import _reset_inherited_locks

    reg = _registry(_values("columnar", str(tmp_path / "wal")))
    store = reg.store()
    reg.check_engine()
    before = (store.inner._lock, store.inner._deliver_lock, store._mutate_lock,
              store._ckpt_lock, store.inner.vocab._h_lock)
    _reset_inherited_locks(reg, serving=False)
    after = (store.inner._lock, store.inner._deliver_lock, store._mutate_lock,
             store._ckpt_lock, store.inner.vocab._h_lock)
    assert all(a is not b for a, b in zip(before, after))
    assert "_lock" not in vars(store)
    store.close_durable()


_KILL_CHILD = r"""
import json, sys
sys.path.insert(0, {repo!r})
from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.relationtuple import RelationTuple as T
reg = Registry(Config(values=json.loads({values!r})), device="cpu")
store = reg.store()
acked = []
for line in json.loads({lines!r}):
    store.write_relation_tuples(T.from_string(line))
    acked.append(line)
    print("ACK " + line, flush=True)
if {delete!r}:
    store.delete_relation_tuples(T.from_string({delete!r}))
    print("DEL " + {delete!r}, flush=True)
print("DONE", flush=True)
sys.stdin.read()
"""


@pytest.mark.parametrize("kind", KINDS)
def test_a_sigkilled_writer_loses_no_acked_write(kind, tmp_path):
    """A child process writes through a durable registry store (sync
    always) and is SIGKILLed after acking: a new registry recovers every
    acked write and the delete, from the WAL alone."""
    from keto_tpu_torch.relationtuple import RelationTuple as T

    lines = [f"n:d{i}#view@u{i % 5}" for i in range(40)] + ["n:g#member@(n:h#member)"]
    values = _values(kind, str(tmp_path / "wal"))
    code = _KILL_CHILD.format(repo=str(REPO), values=json.dumps(values),
                              lines=json.dumps(lines), delete=lines[3])
    child = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    try:
        out = []
        for line in child.stdout:
            out.append(line.strip())
            if line.strip() == "DONE":
                break
        assert out[-1] == "DONE", out[-5:]
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    acked = {x[4:] for x in out if x.startswith("ACK ")} - {lines[3]}
    reg = _registry(values)
    store = reg.store()
    assert store.recovery.replayed_deltas == len(lines) + 1 and not store.recovery.gap
    got = {str(t) for t in store.snapshot()[0]}
    assert got == {str(T.from_string(x)) for x in acked}
    store.close_durable()


# -- the scrubber's WAL and checkpoint kinds ---------------------------------------------


def test_scrub_detects_wal_bitrot_and_a_damaged_checkpoint(tmp_path):
    from keto_tpu_torch.engine.scrub import (
        ACTION_CHECKPOINT_REBUILD,
        KIND_CHECKPOINT,
        KIND_WAL,
        ScrubDaemon,
    )
    from keto_tpu_torch.faults import FAULTS

    p = P["torch"]
    store = _durable(p, tmp_path, "memory", segment_bytes=1)  # every append rotates
    for i in range(6):
        store.write_relation_tuples(_t(p, i))
    store.checkpoint_now()
    store.write_relation_tuples(_t(p, 10), _t(p, 11))
    store.write_relation_tuples(_t(p, 12))
    daemon = ScrubDaemon(engine_fn=lambda: None, store_fn=lambda: store,
                         wal_segments_per_cycle=8, max_repairs_per_cycle=4)
    ev = daemon.step()
    assert ev["clean"]
    kinds = {f.get("kind"): f for f in ev["findings"]}
    assert kinds[KIND_WAL]["mismatches"] == 0 and kinds[KIND_WAL]["sealed"] >= 1
    assert kinds[KIND_CHECKPOINT]["mismatches"] == 0

    FAULTS.arm("wal.bitrot")
    ev = daemon.step()
    kinds = {f.get("kind"): f for f in ev["findings"]}
    assert not ev["clean"] and kinds[KIND_WAL]["mismatches"] == 1
    assert daemon.repairs == {ACTION_CHECKPOINT_REBUILD: 1}
    assert store.last_checkpoint_version() == store.version  # re-anchored
    assert daemon.step()["clean"]  # the damaged segment was pruned

    newest = p.ckpt.list_checkpoints(store.checkpoint_dir)[-1][1]
    _tamper(newest)
    store.write_relation_tuples(_t(p, 13))
    ev = daemon.step()
    kinds = {f.get("kind"): f for f in ev["findings"]}
    assert kinds[KIND_CHECKPOINT]["mismatches"] == 1
    assert daemon.repairs[ACTION_CHECKPOINT_REBUILD] == 2
    assert p.ckpt.load_latest(store.checkpoint_dir).version == store.version
    fresh, rep = _recover(p, tmp_path, "memory")
    assert not rep.gap and _tuples_of(p, fresh) == _tuples_of(p, store)
    store.close_durable()
