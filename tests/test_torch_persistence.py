"""keto_tpu_torch's SQL persistence against keto_tpu's, on the CPU (the port
of tests/test_store.py's contract over every backend, tests/test_dialect.py,
tests/test_persistence_sqlite.py and tests/test_legacy_migration.py).

- the Manager contract over the memory, columnar, sqlite, postgres (the
  in-tree pgfake server over the in-tree wire driver), mysql (the in-tree
  DB-API shim) and cockroach (pgfake again, with the cockroach overlays)
  backends, each case run on each package's own store of that backend;
  one scripted session per backend whose observable outputs (pages,
  tokens, versions, deltas, errors) are equal between the packages;
- the dialect cases, the migration overlays, the migrations (the failing
  migration's complete rollback included), durability across a reopen,
  network isolation, the legacy single-table migrator;
- ``SnapshotManager`` over sqlite: the port's
  ``ClosureCheckEngine(device="cpu")`` answers equal keto_tpu's closure
  engine over a database of the same contents, through a write.

Each package gets its own temporary directory and its own fake server.
Tolerances: exact.
"""

import importlib
import sqlite3
import threading
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_device_engine import random_requests, random_tuples

PKGS = ("jax", "torch")
BACKENDS = ("memory", "columnar", "sqlite", "postgres", "mysql", "cockroach")


def _pkg(name: str) -> SimpleNamespace:
    root = "keto_tpu" if name == "jax" else "keto_tpu_torch"

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    rt = m("relationtuple")
    return SimpleNamespace(
        name=name,
        Tuple=rt.RelationTuple,
        ID=rt.SubjectID,
        Set=rt.SubjectSet,
        Query=rt.RelationQuery,
        Page=m("utils.pagination").PaginationOptions,
        errors=m("utils.errors"),
        ns=m("namespace.definitions"),
        store=m("store"),
        persistence=m("persistence"),
        dialect=m("persistence.dialect"),
        migrator=m("persistence.migrator"),
        sqlstore=m("persistence.sqlstore"),
        legacy=m("persistence.legacy"),
        pgwire=m("persistence.pgwire"),
        pgfake=m("persistence.pgfake"),
        graph=m("graph"),
        closure=m("engine.closure"),
    )


P = {name: _pkg(name) for name in PKGS}


@pytest.fixture(scope="module")
def pg_servers():
    """One fake postgres server per package (each with its own temporary
    directory); each test opens its own logical database."""
    servers = {name: P[name].pgfake.start_server() for name in PKGS}
    yield servers
    for srv in servers.values():
        srv.stop()


def open_store(pkg: str, backend: str, nsm, tmp_path, pg_servers):
    p = P[pkg]
    if backend == "memory":
        return p.store.InMemoryTupleStore(namespace_manager=nsm)
    if backend == "columnar":
        return p.store.ColumnarTupleStore(namespace_manager=nsm)
    if backend == "sqlite":
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        return p.persistence.SQLiteTupleStore(str(d / "keto.db"), namespace_manager=nsm)
    db = uuid.uuid4().hex[:12]
    if backend == "mysql":
        return p.sqlstore.SQLTupleStore(
            p.dialect.MySQLDialect(), f"mysql+fake:///my_{db}", namespace_manager=nsm
        )
    dsn = f"postgres://keto@127.0.0.1:{pg_servers[pkg].port}/{backend}_{db}"
    if backend == "postgres":
        from importlib import import_module

        pg = import_module(p.persistence.__name__ + ".postgres")
        return pg.PostgresTupleStore(dsn, namespace_manager=nsm)
    return p.sqlstore.SQLTupleStore(p.dialect.CockroachDialect(), dsn, namespace_manager=nsm)


@pytest.fixture(params=[(pkg, b) for b in BACKENDS for pkg in PKGS],
                ids=lambda pb: f"{pb[0]}-{pb[1]}")
def env(request, tmp_path, pg_servers):
    """(package namespace, namespace manager, store) for one backend of one
    package."""
    pkg, backend = request.param
    p = P[pkg]
    nsm = p.ns.MemoryNamespaceManager()
    store = open_store(pkg, backend, nsm, tmp_path, pg_servers)
    yield p, nsm, store
    close = getattr(store, "close", None)
    if close is not None:
        close()


# -- the Manager contract, per backend and package ---------------------------------


def test_write_and_read_back(env):
    p, nsm, store = env
    nsm.add("write-ns")
    tuples = [
        p.Tuple("write-ns", "obj", "rel", p.ID("sub")),
        p.Tuple("write-ns", "obj", "rel", p.Set("write-ns", "sub obj", "sub rel")),
    ]
    store.write_relation_tuples(*tuples)
    for t in tuples:
        assert store.get_relation_tuples(t.to_query()) == ([t], "")


def test_unknown_namespace(env):
    p, _, store = env
    with pytest.raises(p.errors.ErrNotFound):
        store.write_relation_tuples(p.Tuple("unknown namespace", "", "", p.ID("")))
    with pytest.raises(p.errors.ErrNotFound):
        store.get_relation_tuples(p.Query(namespace="nope"))


def test_duplicate_write_is_idempotent(env):
    """The same tuple twice leaves one row and an empty second delta; the
    subject-set case is the one a unique index over raw nullable columns
    gets wrong."""
    p, nsm, store = env
    nsm.add("dup-ns")
    deltas = []
    store.subscribe_deltas(lambda v, ins, dels: deltas.append(len(ins or [])))
    for t in (p.Tuple("dup-ns", "obj", "rel", p.ID("sub")),
              p.Tuple("dup-ns", "obj", "rel", p.Set("dup-ns", "grp", "member"))):
        store.write_relation_tuples(t)
        store.write_relation_tuples(t)
        assert store.get_relation_tuples(t.to_query())[0] == [t]
    assert deltas == [1, 0, 1, 0]


def test_query_combinations(env):
    p, nsm, store = env
    nsm.add("get-ns")
    tuples = [p.Tuple("get-ns", f"o {i % 2}", f"r {i % 4}", p.ID(f"s {i}"))
              for i in range(10)]
    store.write_relation_tuples(*tuples)
    cases = [
        (p.Query(namespace="get-ns"), tuples),
        (p.Query(namespace="get-ns", object="o 0"), tuples[0::2]),
        (p.Query(namespace="get-ns", relation="r 0"), tuples[0::4]),
        (p.Query(namespace="get-ns", object="o 0", relation="r 0"),
         [tuples[0], tuples[4], tuples[8]]),
        (p.Query(namespace="get-ns", subject=p.ID("s 3")), [tuples[3]]),
        (p.Query(namespace="get-ns", object="o 1", relation="r 1", subject=p.ID("s 1")),
         [tuples[1]]),
    ]
    for query, expected in cases:
        assert store.get_relation_tuples(query) == (expected, "")


def test_pagination(env):
    p, nsm, store = env
    nsm.add("page-ns")
    tuples = [p.Tuple("page-ns", "o", "r", p.ID(f"s{i:03d}")) for i in range(25)]
    store.write_relation_tuples(*tuples)
    seen, token, pages = [], "", 0
    while True:
        resp, token = store.get_relation_tuples(
            p.Query(namespace="page-ns"), p.Page(token=token, size=10))
        seen += resp
        pages += 1
        if not token:
            break
    assert pages == 3 and seen == tuples
    with pytest.raises(p.errors.ErrMalformedPageToken):
        store.get_relation_tuples(p.Query(namespace="page-ns"),
                                  p.Page(token="not a token !!"))


def test_delete_and_delete_all(env):
    p, nsm, store = env
    nsm.add("del-ns")
    keep = p.Tuple("del-ns", "o", "r", p.ID("keep"))
    kill = p.Tuple("del-ns", "o", "r", p.ID("kill"))
    a = [p.Tuple("del-ns", "a", "r", p.ID(f"s{i}")) for i in range(3)]
    store.write_relation_tuples(keep, kill, *a)
    store.delete_relation_tuples(kill)
    assert store.get_relation_tuples(p.Query(namespace="del-ns"))[0] == [keep, *a]
    store.delete_all_relation_tuples(p.Query(namespace="del-ns", object="a"))
    assert store.get_relation_tuples(p.Query(namespace="del-ns"))[0] == [keep]


def test_transact_and_its_rollback(env):
    """Insert and delete atomically; a failing insert applies nothing
    (reference manager_requirements.go:399-445)."""
    p, nsm, store = env
    nsm.add("tx-ns")
    old = p.Tuple("tx-ns", "o", "r", p.ID("old"))
    new = p.Tuple("tx-ns", "o", "r", p.ID("new"))
    store.write_relation_tuples(old)
    store.transact_relation_tuples(insert=[new], delete=[old])
    assert store.get_relation_tuples(p.Query(namespace="tx-ns"))[0] == [new]
    bad = p.Tuple("unknown-ns", "o", "r", p.ID("bad"))
    good = p.Tuple("tx-ns", "o", "r", p.ID("good"))
    with pytest.raises(p.errors.ErrNotFound):
        store.transact_relation_tuples(insert=[good, bad], delete=[new])
    assert store.get_relation_tuples(p.Query(namespace="tx-ns"))[0] == [new]


def test_version_counter_and_deltas(env):
    p, nsm, store = env
    nsm.add("ver-ns")
    got = []
    store.subscribe_deltas(lambda v, ins, dels: got.append(
        (v, [str(t) for t in ins or []], [str(t) for t in dels or []])))
    v0 = store.version
    t = p.Tuple("ver-ns", "o", "r", p.ID("s"))
    store.write_relation_tuples(t)
    assert store.version == v0 + 1
    store.delete_all_relation_tuples(p.Query(namespace="ver-ns"))
    assert store.version == v0 + 2
    assert got == [(v0 + 1, [str(t)], []), (v0 + 2, [], [str(t)])]
    assert len(store) == 0


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("backend", ("memory", "columnar", "sqlite"))
def test_concurrent_writers_deliver_in_version_order(pkg, backend, tmp_path):
    p = P[pkg]
    store = open_store(pkg, backend, None, tmp_path, None)
    deltas = []
    store.subscribe_deltas(lambda v, ins, dels: deltas.append(v))
    n_threads, n_writes = 8, 25
    barrier = threading.Barrier(n_threads)

    def writer(wid):
        barrier.wait()
        for i in range(n_writes):
            store.write_relation_tuples(p.Tuple("ns", f"o{wid}", "r", p.ID(f"s{i}")))

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert deltas == list(range(1, n_threads * n_writes + 1))


def _session(pkg: str, backend: str, tmp_path, pg_servers) -> list:
    """One scripted session's observable outputs, as plain values."""
    p = P[pkg]
    nsm = p.ns.MemoryNamespaceManager()
    nsm.add("s")
    store = open_store(pkg, backend, nsm, tmp_path, pg_servers)
    out = []
    store.subscribe_deltas(lambda v, ins, dels: out.append(
        ("delta", v, sorted(map(str, ins or [])), sorted(map(str, dels or [])))))
    rows = [p.Tuple.from_string(s) for s in (
        "s:doc#view@(s:team#member)", "s:team#member@alice", "s:team#member@bob",
        "s:doc#owner@carol", "s:other#view@alice", "s:doc#view@alice",
    )]
    store.write_relation_tuples(*rows)
    store.write_relation_tuples(rows[1])
    token = ""
    while True:
        page, token = store.get_relation_tuples(p.Query(namespace="s"), p.Page(token, 2))
        out.append(("page", [str(t) for t in page], token))
        if not token:
            break
    store.transact_relation_tuples(insert=[p.Tuple.from_string("s:doc#view@dave")],
                                   delete=[rows[2]])
    store.delete_all_relation_tuples(p.Query(namespace="s", object="other"))
    try:
        store.write_relation_tuples(p.Tuple.from_string("zz:x#y@z"))
    except p.errors.KetoError as e:
        out.append(("error", type(e).__name__, e.status_code))
    out.append(("all", sorted(str(t) for t in store.snapshot()[0]), store.version,
                len(store)))
    close = getattr(store, "close", None)
    if close is not None:
        close()
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_session_is_observed_alike_in_both_packages(backend, tmp_path, pg_servers):
    assert _session("torch", backend, tmp_path, pg_servers) == _session(
        "jax", backend, tmp_path, pg_servers)


# -- dialects and migration overlays ------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_dialect_spellings(pkg):
    d = P[pkg].dialect
    assert d.PostgresDialect().sql("SELECT * FROM t WHERE a = ? AND b = ?") == (
        "SELECT * FROM t WHERE a = %s AND b = %s")
    assert d.SQLiteDialect().sql("a = ?") == "a = ?"
    cols = ("a", "b")
    assert "INSERT OR IGNORE" in d.SQLiteDialect().insert_ignore("t", cols)
    pg = d.PostgresDialect().insert_ignore("t", cols)
    assert "ON CONFLICT DO NOTHING" in pg and "INSERT INTO t" in pg
    assert "INSERT IGNORE INTO t" in d.MySQLDialect().insert_ignore("t", cols)
    assert d.MySQLDialect().sql("a = ?") == "a = %s"
    assert set(d.DIALECTS) == {"sqlite", "postgres", "cockroach", "mysql"}


@pytest.mark.parametrize("dsn,name,native", [
    ("memory", "sqlite", ":memory:"),
    ("sqlite:///tmp/x.db", "sqlite", "/tmp/x.db"),
    ("sqlite://:memory:", "sqlite", ":memory:"),
    ("postgres://u:p@h/db", "postgres", "postgres://u:p@h/db"),
    ("postgresql://u@h/db", "postgres", "postgresql://u@h/db"),
    ("cockroach://u@h:26257/db", "cockroach", "postgres://u@h:26257/db"),
    ("mysql://u:p@h/db", "mysql", "mysql://u:p@h/db"),
    ("mysql+fake:///x", "mysql", "mysql+fake:///x"),
    ("mongodb://nope", None, None),
])
def test_dsn_dispatch_matches(dsn, name, native):
    got = []
    for pkg in PKGS:
        try:
            d, n = P[pkg].dialect.dialect_for_dsn(dsn)
            got.append((d.name, n))
        except ValueError:
            got.append((None, None))
    assert got[0] == got[1] == (name, native)


@pytest.mark.parametrize("pkg", PKGS)
def test_wire_driver_against_the_fake(pkg, pg_servers):
    """The postgres dialect connects through the in-tree wire driver; types,
    rowcounts and a server error then a recovery."""
    p = P[pkg]
    port = pg_servers[pkg].port
    conn = p.dialect.PostgresDialect().connect(f"postgres://keto@127.0.0.1:{port}/wire")
    try:
        cur = conn.cursor()
        cur.execute("SELECT %s + %s", (20, 22))
        assert cur.fetchone()[0] == 42
        cur.execute("CREATE TABLE t (n BIGINT, x DOUBLE PRECISION, s TEXT)")
        cur.execute("INSERT INTO t VALUES (%s, %s, %s), (%s, %s, %s)",
                    (1, 1.5, "it's", 2, None, None))
        assert cur.rowcount == 2
        conn.commit()
        cur.execute("SELECT n, x, s FROM t ORDER BY n")
        assert cur.fetchall() == [(1, 1.5, "it's"), (2, None, None)]
        conn.rollback()
        with pytest.raises(p.pgwire.Error):
            conn.cursor().execute("SELECT * FROM missing_table")
        conn.rollback()
        cur = conn.cursor()
        cur.execute("SELECT %s", ("ok",))
        assert cur.fetchone() == ("ok",)
        conn.rollback()
    finally:
        conn.close()


@pytest.mark.parametrize("dialect", ["sqlite", "postgres", "cockroach", "mysql"])
def test_migration_overlays_match(dialect):
    """Each dialect's migration ladder (generic files with its overlays) is
    the same in both packages, file contents included."""
    ladders = []
    for pkg in PKGS:
        p = P[pkg]
        ladders.append([
            (m.version, m.name, m.up_sql, m.down_sql)
            for m in p.migrator.load_migrations(
                p.sqlstore._MIGRATIONS_DIR, dialect=p.dialect.DIALECTS[dialect])
        ])
    assert ladders[0] == ladders[1] and len(ladders[1]) == 3
    v0 = dict((v, up) for v, _, up, _ in ladders[1])["20220101000000"]
    marker = {"sqlite": "AUTOINCREMENT", "postgres": "BIGSERIAL",
              "cockroach": "BIGSERIAL", "mysql": "AUTO_INCREMENT"}[dialect]
    assert marker in v0


def test_every_overlay_has_a_generic_twin():
    import os

    d = P["torch"].sqlstore._MIGRATIONS_DIR
    names = sorted(os.listdir(d))
    assert len(names) == 11
    for fname in names:
        for marker in (".postgres.", ".mysql.", ".cockroach."):
            if marker in fname:
                assert fname.replace(marker, ".") in names


# -- migrations, durability, isolation (sqlite) ------------------------------------


def _nsm(pkg):
    m = P[pkg].ns.MemoryNamespaceManager()
    m.add("n")
    return m


def _sqlite(pkg, path, **kw):
    return P[pkg].persistence.SQLiteTupleStore(str(path), namespace_manager=_nsm(pkg), **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_migrations_up_status_down(pkg, tmp_path):
    s = _sqlite(pkg, tmp_path / "m.db", auto_migrate=False)
    assert s.migrator.has_pending()
    assert [m.applied for m in s.migrator.status()] == [False] * 3
    assert len(s.migrator.up()) == 3 and not s.migrator.has_pending()
    assert len(s.migrator.down(steps=3)) == 3 and s.migrator.has_pending()
    s.migrator.up()
    s.write_relation_tuples(P[pkg].Tuple.from_string("n:o#r@alice"))
    assert len(s) == 1
    s.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_failing_migration_rolls_back_completely(pkg, tmp_path):
    """A failing multi-statement migration leaves no partial DDL and no
    version row."""
    mdir = tmp_path / "migrations"
    mdir.mkdir()
    (mdir / "001_bad.up.sql").write_text(
        "CREATE TABLE good_one (id INTEGER PRIMARY KEY);\n"
        "CREATE TABLE bad one (syntax error here;\n")
    (mdir / "001_bad.down.sql").write_text("DROP TABLE good_one;\n")
    conn = sqlite3.connect(str(tmp_path / "rb.db"))
    m = P[pkg].migrator.Migrator(conn, str(mdir))
    with pytest.raises(sqlite3.OperationalError):
        m.up()
    tables = {r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    assert "good_one" not in tables and m.applied_versions() == set()
    conn.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_tuples_version_and_network_survive_reopen(pkg, tmp_path):
    T = P[pkg].Tuple.from_string
    path = tmp_path / "d.db"
    s = _sqlite(pkg, path)
    s.write_relation_tuples(T("n:o#r@alice"), T("n:o#r@bob"))
    s.delete_relation_tuples(T("n:o#r@bob"))
    nid, v = s.network_id, s.version
    s.close()
    s2 = _sqlite(pkg, path)
    assert (s2.network_id, s2.version) == (nid, v) == (nid, 2)
    assert s2.snapshot() == ([T("n:o#r@alice")], 2)
    s2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_two_networks_one_database(pkg, tmp_path):
    T = P[pkg].Tuple.from_string
    path = tmp_path / "iso.db"
    s1 = _sqlite(pkg, path, network_id="n1")
    s2 = _sqlite(pkg, path, network_id="n2")
    s1.write_relation_tuples(T("n:o#r@alice"))
    s2.write_relation_tuples(T("n:o#r@bob"))
    q = P[pkg].Query(namespace="n")
    assert s1.get_relation_tuples(q)[0] == [T("n:o#r@alice")]
    assert s2.get_relation_tuples(q)[0] == [T("n:o#r@bob")]
    assert s1.version == s2.version == 1
    s1.close()
    s2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_database_written_by_one_package_reads_in_the_other(pkg, tmp_path):
    """The schema is one: the other package opens the file, adopts its
    network and sees its tuples and version."""
    other = "jax" if pkg == "torch" else "torch"
    path = tmp_path / "shared.db"
    s = _sqlite(pkg, path)
    s.write_relation_tuples(P[pkg].Tuple.from_string("n:doc#view@(n:g#member)"),
                            P[pkg].Tuple.from_string("n:g#member@alice"))
    nid = s.network_id
    s.close()
    r = _sqlite(other, path)
    assert r.network_id == nid and r.version == 1
    assert [str(t) for t in r.all_tuples()] == ["n:doc#view@n:g#member", "n:g#member@alice"]
    r.close()


# -- the legacy single-table migrator ------------------------------------------------


def _legacy(pkg, path, namespaces=None, rows=()):
    p = P[pkg]
    if namespaces is None:
        namespaces = (p.ns.Namespace(name="videos", id=7),)
    store = p.persistence.SQLiteTupleStore(
        str(path), namespace_manager=p.ns.MemoryNamespaceManager(*namespaces))
    m = p.legacy.SingleTableMigrator(store)
    if namespaces:
        ns = namespaces[0]
        m.create_legacy_table(ns)
        store._conn.executemany(
            f'INSERT INTO "{p.legacy.legacy_table_name(ns)}" '
            "(shard_id, object, relation, subject, commit_time) "
            "VALUES (?, ?, ?, ?, CURRENT_TIMESTAMP)",
            [("s", o, r, s) for o, r, s in rows])
        store._conn.commit()
    return store, m


def _legacy_script(pkg, tmp_path) -> list:
    p = P[pkg]
    d = tmp_path / pkg
    d.mkdir()
    out = []
    store, m = _legacy(pkg, d / "a.db", rows=[
        ("/cats", "owner", "cat lady"), ("/cats/1.mp4", "view", "videos:/cats#owner")])
    ns = store.namespace_manager.get_namespace_by_name("videos")
    out.append([n.name for n in m.legacy_namespaces()])
    out.append(m.migrate_namespace(ns))
    out.append([str(t) for t in store.get_relation_tuples(p.Query(namespace="videos"))[0]])
    m.migrate_down(ns)
    out.append(m.legacy_namespaces())
    store.close()
    store, m = _legacy(pkg, d / "b.db", rows=[("o1", "r", "good"), ("o2", "r", "x#y")])
    try:
        m.migrate_namespace(store.namespace_manager.get_namespace_by_name("videos"))
    except p.legacy.ErrInvalidTuples as e:
        out.append([(i.object, i.relation, i.subject) for i in e.invalid])
    out.append(len(store))
    store.close()
    store, m = _legacy(pkg, d / "c.db", namespaces=())
    m.create_legacy_table(p.ns.Namespace(name="x", id=42))
    found = m.legacy_namespaces()
    out.append(found[0].name)
    try:
        m.migrate_namespace(found[0])
    except p.errors.ErrMalformedInput as e:
        out.append("namespace config" in str(e))
    store.close()
    return out


def test_the_legacy_migrator_matches_the_reference(tmp_path):
    got = _legacy_script("torch", tmp_path)
    assert got == _legacy_script("jax", tmp_path)
    assert got == [
        ["videos"], (2, []),
        ["videos:/cats#owner@cat lady", "videos:/cats/1.mp4#view@videos:/cats#owner"],
        [], [("o2", "r", "x#y")], 1, "<unconfigured:42>", True,
    ]


# -- the snapshot layer over sqlite ---------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_closure_engines_over_sqlite_agree(seed, tmp_path):
    """The same tuples in each package's own sqlite file: the port's closure
    engine on the CPU answers as keto_tpu's closure engine (device query
    mode on the JAX CPU backend) and as the host oracle, before and after a
    write and a delete through the store."""
    rng = np.random.default_rng(seed)
    lines = random_tuples(rng, 40, 20, 160)
    reqs = random_requests(rng, 40, 20, k=96)
    engines, stores = {}, {}
    for pkg in PKGS:
        p = P[pkg]
        d = tmp_path / pkg
        d.mkdir()
        s = p.persistence.SQLiteTupleStore(str(d / "g.db"))
        s.write_relation_tuples(*[p.Tuple.from_string(x) for x in lines])
        mgr = p.graph.SnapshotManager(s)
        kw = {"device": "cpu"} if pkg == "torch" else {"query_mode": "device"}
        engines[pkg] = p.closure.ClosureCheckEngine(mgr, freshness="strong", **kw)
        stores[pkg] = s
    oracle = importlib.import_module("keto_tpu_torch.engine.check").CheckEngine(stores["torch"])

    def answers():
        out = {}
        for pkg in PKGS:
            T = P[pkg].Tuple.from_string
            out[pkg] = engines[pkg].batch_check([T(r) for r in reqs])
        T = P["torch"].Tuple.from_string
        out["oracle"] = oracle.batch_check([T(r) for r in reqs])
        return out

    got = answers()
    assert got["torch"] == got["jax"] == got["oracle"]
    assert any(got["torch"]) and not all(got["torch"])
    for pkg in PKGS:
        T = P[pkg].Tuple.from_string
        stores[pkg].write_relation_tuples(T("n:o1#r0@(n:o2#r1)"), T("n:o2#r1@u1"))
        stores[pkg].delete_relation_tuples(T(lines[0]))
    got = answers()
    assert got["torch"] == got["jax"] == got["oracle"]
    for s in stores.values():
        s.close()
