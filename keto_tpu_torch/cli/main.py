"""The keto_tpu_torch command line (counterpart of ``keto_tpu/cli/main.py``,
the reference's cmd/root.go command tree, on ``argparse``).

    python -m keto_tpu_torch.cli [--read-remote H:P] [--write-remote H:P] VERB ...

Every verb of the reference, with its arguments, options, output text,
``--format human|json`` and exit codes:

- ``serve`` — the read (:4466) and write (:4467) planes on the CUDA card;
- ``check``, ``expand``, ``relation-tuple create|delete|delete-all|get``
  and ``status`` — gRPC clients of a running server (``cli/remote.py``, the
  only module of the CLI that imports grpc); remotes resolve flag ->
  ``KETO_READ_REMOTE``/``KETO_WRITE_REMOTE`` -> 127.0.0.1:4466/4467, dialled
  with a 3 s timeout;
- ``relation-tuple parse``, ``version`` — local;
- ``migrate status|up|down``, ``namespace validate``, ``namespace migrate
  legacy|up|down|status`` and ``doctor`` — SQL and files only, no device;
- ``debug snapshot`` — a support bundle pulled over REST from ``/debug``.

Errors print ``Error: <message>`` on stderr and exit 1; a usage error
exits 2. ``status --cluster`` prints the leader's fleet view
(``/cluster/status``) and exits 1 when the fleet is red; ``debug snapshot
--cluster`` adds every alive member's bundle under ``cluster/<instance>/``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Optional, Sequence

DEFAULT_READ_REMOTE = "127.0.0.1:4466"
DEFAULT_WRITE_REMOTE = "127.0.0.1:4467"

class CliError(Exception):
    """A failed verb: ``Error: <message>`` on stderr, exit 1."""


class _Aborted(Exception):
    """A declined confirmation: ``Aborted!`` on stderr, exit 1."""


def echo(message: str = "", err: bool = False) -> None:
    stream = sys.stderr if err else sys.stdout
    stream.write(f"{message}\n")
    stream.flush()


def confirm(text: str, abort: bool = False) -> bool:
    """Ask ``text [y/N]:`` on stdout and read the answer from stdin; a
    declined (or unanswered) question aborts when ``abort``."""
    sys.stdout.write(f"{text} [y/N]: ")
    sys.stdout.flush()
    line = sys.stdin.readline()
    if not line:  # end of input
        echo()
        raise _Aborted()
    yes = line.strip().lower() in ("y", "yes")
    if abort and not yes:
        raise _Aborted()
    return yes


def read_remote(args) -> str:
    return args.read_remote or os.environ.get("KETO_READ_REMOTE") or DEFAULT_READ_REMOTE


def write_remote(args) -> str:
    return args.write_remote or os.environ.get("KETO_WRITE_REMOTE") or DEFAULT_WRITE_REMOTE


def _remote():
    """The gRPC verbs' module; a CliError naming grpc where it is missing."""
    try:
        from . import remote
    except ImportError as e:
        raise CliError(
            "this verb speaks gRPC to the server, and grpc (grpcio and "
            f"protobuf) does not import here: {e}"
        ) from None
    return remote


# -- serve ---------------------------------------------------------------------


def serve(args) -> int:
    """Start the read (:4466) and write (:4467) servers on the CUDA card
    (reference cmd/server/serve.go). With ``profiling: cpu`` in the config,
    the serve lifetime's MAIN THREAD (the registry's bring-up: snapshot,
    closure build, warmup) runs under cProfile and its pstats go to
    ``--profile-out`` on shutdown. cProfile is per thread, so the request
    threads are not captured."""
    from ..driver import Config, Registry

    config = Config(config_file=args.config_file)
    if args.workers > 0:
        config.set_override("serve.read.workers", args.workers)

    def run() -> None:
        registry = Registry(config)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda _signum, _frame: stop.set())
        read_port, write_port = registry.start_all()
        planes = "REST + gRPC" if registry.grpc_enabled else "REST"
        echo(f"read API serving on :{read_port} ({planes})")
        echo(f"write API serving on :{write_port} ({planes})")
        stop.wait()
        echo("shutting down gracefully...")
        registry.stop_all()

    if str(config.get("profiling", default="") or "") == "cpu":
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
        try:
            run()
        finally:
            profiler.disable()
            profiler.dump_stats(args.profile_out)
            echo(f"cpu profile written to {args.profile_out}")
    else:
        run()
    return 0


# -- relation-tuple (local) ----------------------------------------------------


def read_tuple_sources(sources) -> list:
    """JSON tuples from files, directories, or '-' for stdin (reference
    cmd/relationtuple/create.go:35-100)."""
    from ..relationtuple.definitions import RelationTuple

    out = []

    def from_text(text: str):
        data = json.loads(text)
        for item in data if isinstance(data, list) else [data]:
            item.pop("$schema", None)
            out.append(RelationTuple.from_dict(item))

    for src in sources or ("-",):
        if src == "-":
            from_text(sys.stdin.read())
        elif os.path.isdir(src):
            for name in sorted(os.listdir(src)):
                if name.endswith(".json"):
                    with open(os.path.join(src, name)) as f:
                        from_text(f.read())
        else:
            with open(src) as f:
                from_text(f.read())
    return out


def parse(args) -> int:
    """Parse the human-readable ns:obj#rel@subject grammar into JSON;
    //-comments and blank lines are skipped (reference
    cmd/relationtuple/parse.go:47-88)."""
    from ..relationtuple.definitions import parse_tuples_text

    for src in args.sources or ("-",):
        if src == "-":
            text = sys.stdin.read()
        else:
            with open(src) as f:
                text = f.read()
        for t in parse_tuples_text(text):
            echo(json.dumps(t.to_dict()))
    return 0


# -- migrate -------------------------------------------------------------------


def _sqlite_path(config_file, message: str):
    from ..driver import Config

    cfg = Config(config_file=config_file)
    dsn = cfg.dsn()
    if not dsn.startswith("sqlite://") or dsn == "sqlite://:memory:":
        raise CliError(message)
    return cfg, dsn[len("sqlite://"):]


def _store_for_migrate(config_file):
    from ..persistence import SQLiteTupleStore

    _, path = _sqlite_path(
        config_file, "DSN has no migrations (the in-memory store migrates implicitly)"
    )
    # no auto-migrate: these verbs exist to inspect and apply explicitly
    return SQLiteTupleStore(path, auto_migrate=False)


def migrate_status(args) -> int:
    store = _store_for_migrate(args.config_file)
    for s in store.migrator.status():
        echo(f"{s.version}\t{s.name}\t{'applied' if s.applied else 'pending'}")
    return 0


def migrate_up(args) -> int:
    store = _store_for_migrate(args.config_file)
    pending = [s for s in store.migrator.status() if not s.applied]
    if not pending:
        echo("already up to date")
        return 0
    for s in pending:
        echo(f"pending: {s.version} {s.name}")
    if not args.yes:
        confirm("Apply these migrations?", abort=True)
    echo(f"applied {len(store.migrator.up())} migrations")
    return 0


def migrate_down(args) -> int:
    store = _store_for_migrate(args.config_file)
    if not args.yes:
        confirm(f"Roll back {args.steps} migrations?", abort=True)
    echo(f"rolled back {len(store.migrator.down(steps=args.steps))} migrations")
    return 0


# -- doctor --------------------------------------------------------------------


def doctor(args) -> int:
    """Offline integrity fsck of the durable state: CRC-rescan every WAL
    segment, sha256-verify every checkpoint, then recover into a scratch
    store and print its anti-entropy digest. Read-only — safe against a
    live directory. Exit 0 clean, 1 corruption found, 2 usage error.

    The scratch store takes the kind of the newest sound checkpoint (the
    reference always recovers into a memory store, which ignores a columnar
    checkpoint and then reports its bulk loads as a WAL gap)."""
    from ..graph.checkpoint import CheckpointError, list_checkpoints, load_checkpoint
    from ..replication.digest import compute_digest
    from ..store import ColumnarTupleStore, InMemoryTupleStore
    from ..store.durable import recover_store
    from ..store.wal import ReplayStats, _list_segments, _scan_segment, verify_segment

    wal_dir, checkpoint_dir = args.wal_dir, args.checkpoint_dir
    if wal_dir is None:
        from ..driver import Config

        wal_dir = str(Config(config_file=args.config_file).get("store.wal.dir") or "")
    if not wal_dir:
        echo("doctor: no WAL directory (pass --wal-dir or set store.wal.dir)", err=True)
        return 2
    if not os.path.isdir(wal_dir):
        echo(f"doctor: {wal_dir} is not a directory", err=True)
        return 2
    if checkpoint_dir is None:
        from ..driver import Config

        checkpoint_dir = str(
            Config(config_file=args.config_file).get("checkpoint.dir") or ""
        ) or os.path.join(wal_dir, "checkpoints")

    report = {
        "wal_dir": wal_dir,
        "checkpoint_dir": checkpoint_dir,
        "wal": {"segments": [], "ok": True},
        "checkpoints": {"files": [], "ok": True},
        "recovery": None,
        "digest": None,
        "ok": True,
    }

    # 1) every WAL segment gets the sealed-segment treatment except the
    # tail, which is scanned under replay's torn-tail contract (an unacked
    # torn suffix is a normal crash artifact, not damage)
    segs = _list_segments(wal_dir)
    for i, (first_version, path) in enumerate(segs):
        final = i == len(segs) - 1
        if final:
            stats = ReplayStats()
            recs, _end = _scan_segment(path, final=True, stats=stats)
            res = {
                "path": path,
                "ok": not stats.gap,
                "records": len(recs),
                "bad_frames": stats.bad_frames,
                "gap": stats.gap,
                "notes": list(stats.notes),
                "torn_tail_bytes": stats.torn_tail_bytes,
            }
        else:
            res = verify_segment(path)
        res["first_version"] = first_version
        res["final"] = final
        report["wal"]["segments"].append(res)
        if not res["ok"]:
            report["wal"]["ok"] = False

    # 2) every checkpoint, not just the newest — an older one is the
    # fallback when the newest is damaged, so its health matters too
    kind = "memory"  # of the newest sound checkpoint: the scratch store's
    for version, path in list_checkpoints(checkpoint_dir):
        entry = {"path": path, "version": version, "ok": True}
        try:
            ck = load_checkpoint(path)  # verifies the payload sha256
            entry["sha256"] = ck.meta.get("sha256")
            kind = ck.kind
            ck.close()
        except (CheckpointError, OSError) as e:
            entry["ok"] = False
            entry["error"] = str(e)
            report["checkpoints"]["ok"] = False
        report["checkpoints"]["files"].append(entry)

    # 3) full recovery into a scratch store + state digest: proves the
    # checkpoint+WAL pair reconstructs, and gives the operator a digest to
    # compare across disks
    try:
        scratch = ColumnarTupleStore() if kind == "columnar" else InMemoryTupleStore()
        rec = recover_store(scratch, wal_dir, checkpoint_dir)
        report["recovery"] = {
            "checkpoint_version": rec.checkpoint_version,
            "replayed_deltas": rec.replayed_deltas,
            "final_version": rec.final_version,
            "gap": rec.gap,
            "torn_tail_bytes": rec.torn_tail_bytes,
            "notes": list(rec.notes),
        }
        if rec.gap:
            report["ok"] = False
        report["digest"] = compute_digest(scratch, chunk_size=max(1, args.chunk_size))
    except Exception as e:
        report["recovery"] = {"error": f"{type(e).__name__}: {e}"}
        report["ok"] = False

    if not (report["wal"]["ok"] and report["checkpoints"]["ok"]):
        report["ok"] = False

    if args.fmt == "json":
        echo(json.dumps(report, indent=2))
    else:
        echo(f"wal: {len(segs)} segments in {wal_dir}")
        for s in report["wal"]["segments"]:
            state = "ok" if s["ok"] else "CORRUPT"
            tail = " (tail)" if s["final"] else ""
            echo(
                f"  {os.path.basename(s['path'])}{tail}: {state}, {s['records']} records"
                + (f", notes: {'; '.join(s['notes'])}" if s["notes"] else "")
            )
        echo(f"checkpoints: {len(report['checkpoints']['files'])} in {checkpoint_dir}")
        for c in report["checkpoints"]["files"]:
            state = "ok" if c["ok"] else f"CORRUPT ({c.get('error')})"
            echo(f"  {os.path.basename(c['path'])}: {state}")
        rec = report["recovery"]
        if rec and "error" not in rec:
            echo(
                f"recovery: version {rec['final_version']} "
                f"({rec['replayed_deltas']} deltas replayed"
                + (", WAL GAP" if rec["gap"] else "")
                + ")"
            )
            d = report["digest"]
            echo(f"digest: {d['count']} tuples, {len(d['chunks'])} chunks "
                 f"@ {d['chunk_size']} ({d['algo']})")
        elif rec:
            echo(f"recovery FAILED: {rec['error']}")
        echo("status: " + ("CLEAN" if report["ok"] else "CORRUPT"))
    return 0 if report["ok"] else 1


# -- debug snapshot ------------------------------------------------------------

#: bundle file -> route, the reference's set: a server answers every one
#: of them, and an endpoint that fails lands in the bundle's errors.txt
SNAPSHOT_ENDPOINTS = (
    ("stacks.txt", "/debug/stacks"),
    ("config.json", "/debug/config"),
    ("graph.json", "/debug/graph"),
    ("flight.json", "/debug/flight"),
    ("traces.json", "/debug/traces"),
    ("metrics.prom", "/metrics"),
    ("pipeline.json", "/pipeline"),
    ("version.json", "/version"),
)


def debug_snapshot(args) -> int:
    """Bundle a support tarball from a live server: thread stacks, redacted
    config, the graph panel with device stats, the flight recorder, the
    recent traces, the metrics exposition, pipeline occupancy and the
    version; every endpoint that failed is listed in ``errors.txt``. Safe
    to attach to a ticket — /debug/config redacts secrets server-side. With
    ``--cluster``, walks the leader's membership (``/cluster/status``) and
    pulls the same bundle from every alive member."""
    import io
    import tarfile
    import urllib.error
    import urllib.request

    base = (args.url or f"http://{read_remote(args)}").rstrip("/")
    fetched: list[tuple[str, bytes]] = []
    errors: list[str] = []

    def pull(base_url: str, prefix: str = "") -> None:
        for name, path in SNAPSHOT_ENDPOINTS:
            req = urllib.request.Request(base_url + path)
            if args.token:
                req.add_header("X-Debug-Token", args.token)
            try:
                with urllib.request.urlopen(req, timeout=args.timeout_s) as resp:
                    fetched.append((prefix + name, resp.read()))
            except (urllib.error.URLError, OSError, ValueError) as e:
                errors.append(f"{prefix}{path}: {e}")

    pull(base)
    if args.cluster:
        try:
            with urllib.request.urlopen(base + "/cluster/status",
                                        timeout=args.timeout_s) as resp:
                cluster_status = resp.read()
            fetched.append(("cluster_status.json", cluster_status))
            members = json.loads(cluster_status.decode("utf-8")).get("members", [])
        except (urllib.error.URLError, OSError, ValueError) as e:
            members = []
            errors.append(f"/cluster/status: {e}")
        for m in members:
            member_url = (m.get("read_url") or "").rstrip("/")
            instance = m.get("instance_id") or "unknown"
            if not member_url or member_url == base:
                continue
            if not m.get("alive", True):
                errors.append(f"cluster/{instance}: member down, skipped")
                continue
            pull(member_url, prefix=f"cluster/{instance}/")
    if not fetched:
        raise CliError(f"could not reach {base} — " + "; ".join(errors[:3]))
    out = args.out or f"keto-debug-{time.strftime('%Y%m%d-%H%M%S')}.tar.gz"
    files = fetched + ([("errors.txt", ("\n".join(errors) + "\n").encode())]
                       if errors else [])
    with tarfile.open(out, "w:gz") as tar:
        for name, body in files:
            info = tarfile.TarInfo(name=name)
            info.size = len(body)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(body))
    echo(f"wrote {out} ({len(fetched)} files"
         + (f", {len(errors)} endpoints failed" if errors else "") + ")")
    return 0


# -- namespace -----------------------------------------------------------------


def namespace_validate(args) -> int:
    """Validate namespace files (reference cmd/namespace/validate.go:21-58)."""
    from ..namespace.watcher import parse_namespace_file
    from ..utils.errors import ErrMalformedInput

    for f in args.files:
        if not os.path.exists(f):
            echo(f"Error: Invalid value for 'FILES...': Path {f!r} does not exist.",
                 err=True)
            return 2
    failed = False
    for f in args.files:
        try:
            echo(f"{f}: OK ({len(parse_namespace_file(f))} namespaces)")
        except (ErrMalformedInput, OSError) as e:
            failed = True
            echo(f"{f}: INVALID — {e}", err=True)
    return 1 if failed else 0


def _legacy_migrator(config_file):
    from ..persistence import SQLiteTupleStore
    from ..persistence.legacy import SingleTableMigrator

    cfg, path = _sqlite_path(
        config_file, "namespace migrate legacy requires a persistent sqlite DSN"
    )
    return SingleTableMigrator(
        SQLiteTupleStore(path, namespace_manager=cfg.namespace_manager())
    )


def namespace_migrate_legacy(args) -> int:
    """Migrate v0.6-layout per-namespace tables into the single-table store
    (reference cmd/namespace/migrate_legacy.go:18-117). With no namespace
    argument, migrates every legacy namespace found."""
    from ..persistence.legacy import ErrInvalidTuples

    migrator = _legacy_migrator(args.config_file)
    if args.namespace_name is not None:
        try:
            targets = [migrator.namespace_manager.get_namespace_by_name(
                args.namespace_name)]
        except Exception as e:
            raise CliError(f"there seems to be a problem with the config: {e}")
        if not args.yes:
            confirm(f"Are you sure you want to migrate namespace "
                    f"{args.namespace_name!r}?", abort=True)
    else:
        targets = migrator.legacy_namespaces()
        if not targets:
            echo("Could not find legacy namespaces, there seems nothing to be done.")
            return 0
        listing = "".join(f"  {n.name}\n" for n in targets)
        if not args.yes:
            confirm(f"I found the following legacy namespaces:\n{listing}"
                    "Do you want to migrate all of them?", abort=True)
    for ns in targets:
        if not args.down_only:
            try:
                migrated, _ = migrator.migrate_namespace(ns)
            except ErrInvalidTuples as e:
                raise CliError(
                    f"encountered error while migrating: {e.message}\n"
                    "Aborting. Please recreate the listed tuples manually."
                )
            echo(f"migrated {migrated} tuples from namespace {ns.name}")
        if args.yes or confirm(
            f"Do you want to migrate namespace {ns.name} down? This will delete "
            "all data in the legacy table."
        ):
            migrator.migrate_down(ns)
            echo(f"Successfully migrated down namespace {ns.name}.")
    return 0


def namespace_migrate_up(args) -> int:
    """Deprecated no-op (reference cmd/namespace/migrate_up.go)."""
    echo("deprecated: per-namespace schema migrations are no longer necessary; "
         "see `keto namespace migrate legacy` for data migration")
    return 0


def namespace_migrate_down(args) -> int:
    """Deprecated no-op (reference cmd/namespace/migrate_down.go)."""
    echo("deprecated: per-namespace schema migrations are no longer necessary; "
         "see `keto namespace migrate legacy --down-only`")
    return 0


def namespace_migrate_status(args) -> int:
    """List legacy per-namespace tables still present in the database
    (reference cmd/namespace/migrate_status.go)."""
    found = _legacy_migrator(args.config_file).legacy_namespaces()
    if args.namespace_name is not None:
        found = [n for n in found if n.name == args.namespace_name]
    if not found:
        echo("no legacy namespace tables found")
        return 0
    for ns in found:
        echo(f"{ns.id}\t{ns.name}\tlegacy table present")
    return 0


# -- status / version ----------------------------------------------------------


def status(args) -> int:
    """Health of the read API; --block watches until SERVING (reference
    cmd/status/root.go:28-110). With --cluster, the leader's
    /cluster/status: the per-member green/yellow/red rollup (replication
    lag, SLO burn, breaker state, heartbeat liveness); exit 1 when red."""
    if args.cluster:
        return cluster_status(args)
    return _remote().status(args)


def cluster_status(args) -> int:
    import urllib.request

    url = f"http://{read_remote(args)}/cluster/status"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    except OSError as e:
        raise CliError(f"could not fetch {url}: {e}") from None
    summary = payload.get("cluster", {})
    echo(
        f"cluster: {summary.get('health', '?')} "
        f"({summary.get('alive', '?')}/{summary.get('members', '?')} "
        f"alive, aggregate burn {summary.get('aggregate_burn_rate', '?')})"
    )
    election = summary.get("election")
    if election:
        expires = election.get("lease_expires_in_s")
        echo(
            f"election: term={election.get('observed_term', '?')} "
            f"leader={election.get('leader_id') or '?'} "
            f"lease_expires_in={expires if expires is not None else '?'}s "
            f"transitions={election.get('transitions', '?')} "
            f"last={election.get('last_transition') or '-'}"
        )
    if summary.get("degraded"):
        echo(f"degraded: fleet QoS tightened (directives={summary.get('directives')})")
    for m in payload.get("members", []):
        lag = m.get("lag_versions")
        burn = m.get("burn_rate")
        line = (
            f"  {m.get('health', '?'):6s} "
            f"{m.get('instance_id', '?')} "
            f"role={m.get('role', '?')} "
            f"alive={m.get('alive')} "
            f"lag_versions={lag if lag is not None else '?'} "
            f"burn={burn if burn is not None else '?'} "
            f"qps={m.get('qps') if m.get('qps') is not None else '?'}"
        )
        reasons = m.get("reasons") or []
        if reasons:
            line += "  [" + "; ".join(reasons) + "]"
        echo(line)
    return 1 if summary.get("health") == "red" else 0


def version(args) -> int:
    """Print the build version (reference cmd/root.go:60)."""
    from .. import __version__

    echo(__version__)
    return 0


# -- the parser ----------------------------------------------------------------


def _grpc_verb(name: str):
    return lambda args: getattr(_remote(), name)(args)


def _format_option(p) -> None:
    p.add_argument("--format", dest="fmt", default="human", choices=("human", "json"))


def _config_option(p) -> None:
    p.add_argument("--config", "-c", dest="config_file", default=None)


def _query_options(p) -> None:
    for name in ("--namespace", "--object", "--relation", "--subject-id"):
        p.add_argument(name, default=None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="keto_tpu_torch",
        description="keto_tpu_torch — Zanzibar-style permission server on CUDA.",
    )
    ap.add_argument("--read-remote", default=None,
                    help="gRPC remote of the read API (host:port)")
    ap.add_argument("--write-remote", default=None,
                    help="gRPC remote of the write API (host:port)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("serve", help="start the read (:4466) and write (:4467) servers")
    _config_option(p)
    p.add_argument("--profile-out", default="keto_profile.out",
                   help="where `profiling: cpu` writes its pstats dump on shutdown")
    p.add_argument("--workers", type=int, default=0,
                   help="read-replica processes sharing the read port via "
                   "SO_REUSEPORT (0 = use serve.read.workers from the config)")
    p.set_defaults(func=serve)

    p = sub.add_parser("check", help="check whether SUBJECT has RELATION on "
                       "NAMESPACE:OBJECT")
    for name in ("subject", "relation", "namespace", "object"):
        p.add_argument(name)
    p.add_argument("--max-depth", type=int, default=0)
    _format_option(p)
    p.set_defaults(func=_grpc_verb("check"))

    p = sub.add_parser("expand", help="expand NAMESPACE:OBJECT#RELATION into its tree")
    for name in ("relation", "namespace", "object"):
        p.add_argument(name)
    p.add_argument("--max-depth", type=int, default=0)
    _format_option(p)
    p.set_defaults(func=_grpc_verb("expand"))

    rt = sub.add_parser("relation-tuple", help="create, delete, query and parse "
                        "relation tuples").add_subparsers(dest="sub", required=True)
    for verb in ("create", "delete"):
        p = rt.add_parser(verb, help=f"{verb} tuples from JSON files, dirs, or stdin")
        p.add_argument("sources", nargs="*")
        p.set_defaults(func=_grpc_verb(verb))
    p = rt.add_parser("delete-all", help="delete all tuples matching the query flags")
    _query_options(p)
    p.add_argument("--force", action="store_true", help="skip confirmation")
    p.set_defaults(func=_grpc_verb("delete_all"))
    p = rt.add_parser("get", help="query tuples as a table or JSON")
    _query_options(p)
    p.add_argument("--page-size", type=int, default=100)
    p.add_argument("--page-token", default="")
    _format_option(p)
    p.set_defaults(func=_grpc_verb("get"))
    p = rt.add_parser("parse", help="parse ns:obj#rel@subject lines into JSON")
    p.add_argument("sources", nargs="*")
    p.set_defaults(func=parse)

    mg = sub.add_parser("migrate", help="apply or inspect SQL schema migrations"
                        ).add_subparsers(dest="sub", required=True)
    p = mg.add_parser("status")
    _config_option(p)
    p.set_defaults(func=migrate_status)
    p = mg.add_parser("up")
    _config_option(p)
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.set_defaults(func=migrate_up)
    p = mg.add_parser("down")
    p.add_argument("steps", type=int)
    _config_option(p)
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.set_defaults(func=migrate_down)

    p = sub.add_parser("doctor", help="offline integrity check of the WAL and "
                       "checkpoints")
    _config_option(p)
    p.add_argument("--wal-dir", default=None,
                   help="WAL directory (default: store.wal.dir from the config)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory (default: checkpoint.dir, else "
                   "<wal-dir>/checkpoints)")
    p.add_argument("--chunk-size", type=int, default=1024,
                   help="tuples per digest chunk in the recovered-state digest")
    _format_option(p)
    p.set_defaults(func=doctor)

    dbg = sub.add_parser("debug", help="live-server introspection helpers"
                         ).add_subparsers(dest="sub", required=True)
    p = dbg.add_parser("snapshot", help="bundle a support tarball from a live server")
    p.add_argument("--url", default=None,
                   help="base URL of the read plane (default: http://<read-remote>)")
    p.add_argument("--out", "-o", default=None,
                   help="output tarball path (default: keto-debug-<ts>.tar.gz)")
    p.add_argument("--token", default=None, help="debug token (debug.token)")
    p.add_argument("--timeout", dest="timeout_s", type=float, default=10.0,
                   help="per-endpoint fetch timeout in seconds")
    p.add_argument("--cluster", action="store_true",
                   help="aggregate a support bundle from every cluster member "
                   "(discovered via the leader's /cluster/status), one "
                   "cluster/<instance_id>/ subtree per member")
    p.set_defaults(func=debug_snapshot)

    nsp = sub.add_parser("namespace", help="namespace utilities"
                         ).add_subparsers(dest="sub", required=True)
    p = nsp.add_parser("validate", help="validate namespace files")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=namespace_validate)
    nm = nsp.add_parser("migrate", help="namespace data migrations"
                        ).add_subparsers(dest="subsub", required=True)
    p = nm.add_parser("legacy", help="migrate v0.6 per-namespace tables")
    p.add_argument("namespace_name", nargs="?", default=None)
    _config_option(p)
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.add_argument("--down-only", action="store_true",
                   help="only drop the legacy table(s), do not copy data")
    p.set_defaults(func=namespace_migrate_legacy)
    for verb, func in (("up", namespace_migrate_up), ("down", namespace_migrate_down)):
        p = nm.add_parser(verb, help="deprecated no-op")
        p.add_argument("namespace_name")
        p.set_defaults(func=func)
    p = nm.add_parser("status", help="list legacy per-namespace tables")
    p.add_argument("namespace_name", nargs="?", default=None)
    _config_option(p)
    p.set_defaults(func=namespace_migrate_status)

    p = sub.add_parser("status", help="health of the read API")
    p.add_argument("--block", action="store_true",
                   help="wait until the server is SERVING")
    p.add_argument("--timeout", dest="timeout_s", type=float, default=0,
                   help="give up after this many seconds (0 = forever)")
    p.add_argument("--cluster", action="store_true",
                   help="show the leader's fleet view (/cluster/status) "
                   "instead of the local health probe")
    p.set_defaults(func=status)

    p = sub.add_parser("version", help="print the build version")
    p.set_defaults(func=version)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:  # usage errors and --help
        return e.code if isinstance(e.code, int) else 2
    try:
        return args.func(args)
    except CliError as e:
        echo(f"Error: {e}", err=True)
        return 1
    except _Aborted:
        echo("Aborted!", err=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
