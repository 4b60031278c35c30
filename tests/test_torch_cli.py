"""keto_tpu_torch's CLI against keto_tpu's click CLI, on the CPU.

The cases of ``tests/test_cli.py`` go through the port's ``cli.main(argv)``
against a port server (``Registry(device="cpu")``, ``TorchServer``) and
through the reference's click CLI against a keto_tpu server
(``JaxServer``) holding the same tuples; each step's exit code, stdout and
stderr must be equal (the version string masked). Then, each package
against files it wrote itself: ``migrate status|up|down`` and ``namespace
migrate legacy|status|up|down`` on a temporary sqlite file per package,
``doctor`` (human and ``--format json``) on a WAL and checkpoint directory
written by each package, clean and with bitrot, and ``namespace
validate``. ``debug snapshot`` against the port server: the bundle's file
list, and an error list naming exactly the routes the port does not serve
yet. Two subprocesses of ``python -m keto_tpu_torch.cli`` (``version``,
and ``check`` against the port server) import neither ``jax`` nor
``keto_tpu`` (``-X importtime`` lists every module a process imports).
Tolerances: exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest
from click.testing import CliRunner

from keto_tpu.cli import cli as ref_cli
from keto_tpu_torch.cli.main import SNAPSHOT_ENDPOINTS
from keto_tpu_torch.cli.main import main as port_main
from tests.test_torch_durable import P as DURABLE
from tests.test_torch_persistence import _legacy
from tests.test_torch_rest import JaxServer, TorchServer

REPO = Path(__file__).resolve().parent.parent
VERSION = "0.3.0"


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServer()
    torch_server = TorchServer()
    yield {"jax": jax_server, "torch": torch_server}
    torch_server.stop()
    jax_server.stop()


def run_port(argv, stdin=""):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = port_main([str(a) for a in argv])
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def run_ref(argv, stdin=""):
    res = CliRunner().invoke(ref_cli, [str(a) for a in argv], input=stdin)
    if res.exception is not None and not isinstance(res.exception, SystemExit):
        raise res.exception
    out = res.stdout
    for line in stdin.splitlines():  # CliRunner echoes a prompt's answer
        out = out.replace(f"]: {line}\n", "]: ", 1)
    return res.exit_code, out, res.stderr


RUN = {"jax": run_ref, "torch": run_port}


def remotes(server):
    return ["--read-remote", f"127.0.0.1:{server.read_port}",
            "--write-remote", f"127.0.0.1:{server.write_port}"]


def both(servers, argv, stdin=""):
    """Run `argv` through each package's CLI against its own server; the two
    (rc, stdout, stderr) must be equal. Returns the port's."""
    got = {}
    for pkg in ("jax", "torch"):
        rc, out, err = RUN[pkg](remotes(servers[pkg]) + list(argv), stdin)
        got[pkg] = (rc, out.replace(VERSION, "<version>"), err)
    assert got["torch"] == got["jax"], argv
    return got["torch"]


def local(argv, stdin=""):
    """A verb that needs no server, through both CLIs: equal, the port's."""
    got = {pkg: RUN[pkg](argv, stdin) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"], argv
    return got["torch"]


TUPLES = [
    {"namespace": "videos", "object": "/cats", "relation": "owner",
     "subject_id": "cat lady"},
    {"namespace": "videos", "object": "/cats/1.mp4", "relation": "view",
     "subject_set": {"namespace": "videos", "object": "/cats", "relation": "owner"}},
]


def test_version_and_status(servers):
    rc, out, _ = both(servers, ["version"])
    assert rc == 0 and out == "<version>\n"
    rc, out, _ = both(servers, ["status"])
    assert rc == 0 and out == "SERVING\n"
    rc, out, _ = both(servers, ["status", "--block", "--timeout", "5"])
    assert rc == 0 and out == "SERVING\n"


def test_parse():
    text = "// a comment\nvideos:/cats#owner@(cat lady)\n\nn:o#r@n:s#t // trailing\n"
    rc, out, _ = local(["relation-tuple", "parse", "-"], text)
    assert rc == 0
    assert [json.loads(line) for line in out.splitlines()] == [
        {"namespace": "videos", "object": "/cats", "relation": "owner",
         "subject_id": "cat lady"},
        {"namespace": "n", "object": "o", "relation": "r",
         "subject_set": {"namespace": "n", "object": "s", "relation": "t"}},
    ]


def test_create_check_expand_get_delete(servers, tmp_path):
    both(servers, ["relation-tuple", "delete-all", "--force"])
    rc, out, _ = both(servers, ["relation-tuple", "create", "-"], json.dumps(TUPLES))
    assert rc == 0 and "created 2" in out
    rc, out, _ = both(servers, ["check", "cat lady", "view", "videos", "/cats/1.mp4"])
    assert (rc, out) == (0, "Allowed\n")
    rc, out, _ = both(servers, ["check", "dog guy", "view", "videos", "/cats/1.mp4"])
    assert (rc, out) == (1, "Denied\n")
    rc, out, _ = both(servers, ["check", "cat lady", "view", "videos", "/cats/1.mp4",
                                "--format", "json"])
    assert (rc, json.loads(out)) == (0, {"allowed": True})
    rc, out, _ = both(servers, ["check", "videos:/cats#owner", "view", "videos",
                                "/cats/1.mp4", "--max-depth", "1"])
    assert rc in (0, 1)
    rc, out, _ = both(servers, ["expand", "view", "videos", "/cats/1.mp4"])
    assert rc == 0 and "cat lady" in out
    rc, out, _ = both(servers, ["expand", "view", "videos", "/cats/1.mp4",
                                "--format", "json"])
    assert rc == 0 and json.loads(out)["type"] == "union"
    rc, out, _ = both(servers, ["expand", "view", "videos", "/nothing"])
    assert rc == 0
    rc, out, _ = both(servers, ["relation-tuple", "get", "--namespace", "videos",
                                "--format", "json"])
    assert rc == 0 and len(json.loads(out)["relation_tuples"]) == 2
    rc, out, _ = both(servers, ["relation-tuple", "get", "--namespace", "videos"])
    assert rc == 0 and out.startswith("NAMESPACE") and "cat lady" in out
    rc, out, _ = both(servers, ["relation-tuple", "get", "--namespace", "videos",
                                "--page-size", "1"])
    assert rc == 0 and "next page token:" in out
    rc, out, _ = both(servers, ["relation-tuple", "get", "--subject-id", "cat lady",
                                "--format", "json"])
    assert rc == 0 and len(json.loads(out)["relation_tuples"]) == 1
    # a file and a directory as sources
    one = tmp_path / "one.json"
    one.write_text(json.dumps(TUPLES[0]))
    rc, out, _ = both(servers, ["relation-tuple", "delete", str(one)])
    assert (rc, out) == (0, "deleted 1 relation tuples\n")
    rc, out, _ = both(servers, ["check", "cat lady", "view", "videos", "/cats/1.mp4"])
    assert rc == 1
    src = tmp_path / "dir"
    src.mkdir()
    (src / "a.json").write_text(json.dumps(TUPLES[0]))
    (src / "skip.txt").write_text("not json")
    rc, out, _ = both(servers, ["relation-tuple", "create", str(src)])
    assert (rc, out) == (0, "created 1 relation tuples\n")
    rc, out, _ = both(servers, ["relation-tuple", "delete-all", "--namespace", "videos",
                                "--object", "/cats", "--force"])
    assert (rc, out) == (0, "deleted all matching relation tuples\n")
    rc, out, _ = both(servers, ["relation-tuple", "get", "--namespace", "videos",
                                "--format", "json"])
    assert [t["object"] for t in json.loads(out)["relation_tuples"]] == ["/cats/1.mp4"]
    # confirmation declined: nothing deleted, Aborted!
    rc, out, err = both(servers, ["relation-tuple", "delete-all", "--namespace",
                                  "videos"], "n\n")
    assert rc == 1 and "Aborted!" in err
    rc, out, _ = both(servers, ["relation-tuple", "delete-all", "--namespace", "videos"],
                      "y\n")
    assert rc == 0
    rc, out, _ = both(servers, ["relation-tuple", "get", "--namespace", "videos",
                                "--format", "json"])
    assert json.loads(out)["relation_tuples"] == []


def test_server_errors_are_equal(servers):
    rc, out, err = both(servers, ["relation-tuple", "create", "-"], json.dumps(
        {"namespace": "nope", "object": "o", "relation": "r", "subject_id": "s"}))
    assert rc == 1 and err.startswith("Error: NOT_FOUND")
    rc, out, err = both(servers, ["relation-tuple", "get", "--page-token", "garbage!!"])
    assert rc == 1 and err.startswith("Error: INVALID_ARGUMENT")
    rc, out, err = both(servers, ["check", "u", "view", "nope", "o"])
    assert rc in (1,)


def test_usage_errors_exit_2():
    for argv in (["check", "only-one"], ["expand"], ["nope"],
                 ["check", "a", "b", "c", "d", "--format", "xml"]):
        assert run_port(argv)[0] == 2 == run_ref(argv)[0], argv


def test_connection_error():
    rc, out, err = local(["--read-remote", "127.0.0.1:1", "status"])
    assert rc == 1 and err == "Error: cannot connect to 127.0.0.1:1 within 3s\n"
    rc, out, err = local(["--read-remote", "127.0.0.1:1", "check", "a", "b", "c", "d"])
    assert rc == 1 and "cannot connect" in err


def test_remotes_from_the_environment(servers, monkeypatch):
    for pkg in ("jax", "torch"):
        monkeypatch.setenv("KETO_READ_REMOTE", f"127.0.0.1:{servers[pkg].read_port}")
        rc, out, _ = RUN[pkg](["status"])
        assert (rc, out) == (0, "SERVING\n"), pkg


def test_namespace_validate(tmp_path):
    good = tmp_path / "ns.yml"
    good.write_text("- name: videos\n  id: 1\n")
    also = tmp_path / "ns.json"
    also.write_text(json.dumps({"namespaces": [{"name": "a"}, {"name": "b", "id": 2}]}))
    bad = tmp_path / "bad.yml"
    bad.write_text("- nope: x\n")
    rc, out, _ = local(["namespace", "validate", good, also])
    assert rc == 0 and out.splitlines() == [f"{good}: OK (1 namespaces)",
                                            f"{also}: OK (2 namespaces)"]
    rc, out, err = local(["namespace", "validate", good, bad])
    assert rc == 1 and "INVALID" in err
    assert run_port(["namespace", "validate", tmp_path / "missing.yml"])[0] == 2


def _config(path: Path, dsn: str, namespaces=()) -> Path:
    path.write_text(json.dumps({"dsn": dsn, "namespaces": list(namespaces)}))
    return path


def per_package(tmp_path, argv_of, stdin=""):
    """Run each package's CLI on its own files: argv_of(pkg) -> argv."""
    got = {}
    for pkg in ("jax", "torch"):
        rc, out, err = RUN[pkg](argv_of(pkg), stdin)
        got[pkg] = (rc, out.replace(str(tmp_path / pkg), "<dir>"),
                    err.replace(str(tmp_path / pkg), "<dir>"))
    assert got["torch"] == got["jax"], argv_of("torch")
    return got["torch"]


def test_migrate_status_up_down(tmp_path):
    cfg = {}
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        cfg[pkg] = _config(tmp_path / pkg / "keto.json", f"sqlite://{tmp_path / pkg}/keto.db")
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "status", "-c", cfg[p]])
    assert rc == 0 and "pending" in out and "applied" not in out
    rc, out, err = per_package(tmp_path, lambda p: ["migrate", "up", "-c", cfg[p]], "n\n")
    assert rc == 1 and "Aborted!" in err
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "up", "-c", cfg[p], "--yes"])
    assert rc == 0 and "applied" in out
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "status", "-c", cfg[p]])
    assert rc == 0 and "pending" not in out
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "up", "-c", cfg[p]])
    assert (rc, out) == (0, "already up to date\n")
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "down", "1", "-c", cfg[p],
                                                  "--yes"])
    assert (rc, out) == (0, "rolled back 1 migrations\n")
    rc, out, _ = per_package(tmp_path, lambda p: ["migrate", "status", "-c", cfg[p]])
    assert out.count("pending") == 1
    mem = _config(tmp_path / "mem.json", "memory")
    rc, out, err = local(["migrate", "status", "-c", mem])
    assert rc == 1 and "DSN has no migrations" in err


def test_namespace_migrate_legacy(tmp_path):
    cfg = {}
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        db = tmp_path / pkg / "legacy.db"
        store, _ = _legacy(pkg, db, rows=[
            ("/cats", "owner", "cat lady"), ("/cats/1.mp4", "view", "videos:/cats#owner")])
        store.close()
        cfg[pkg] = _config(tmp_path / pkg / "keto.json", f"sqlite://{db}",
                           [{"name": "videos", "id": 7}])
    rc, out, _ = per_package(tmp_path, lambda p: ["namespace", "migrate", "status",
                                                  "-c", cfg[p]])
    assert (rc, out) == (0, "7\tvideos\tlegacy table present\n")
    rc, out, _ = per_package(tmp_path, lambda p: ["namespace", "migrate", "legacy",
                                                  "videos", "-c", cfg[p], "--yes"])
    assert rc == 0 and out.splitlines() == [
        "migrated 2 tuples from namespace videos",
        "Successfully migrated down namespace videos.",
    ]
    rc, out, _ = per_package(tmp_path, lambda p: ["namespace", "migrate", "status",
                                                  "videos", "-c", cfg[p]])
    assert (rc, out) == (0, "no legacy namespace tables found\n")
    rc, out, _ = per_package(tmp_path, lambda p: ["namespace", "migrate", "legacy",
                                                  "-c", cfg[p], "--yes"])
    assert (rc, out) == (0, "Could not find legacy namespaces, there seems nothing "
                            "to be done.\n")
    rc, out, err = per_package(tmp_path, lambda p: ["namespace", "migrate", "legacy",
                                                    "nope", "-c", cfg[p], "--yes"])
    assert rc == 1 and "problem with the config" in err
    for verb in ("up", "down"):
        rc, out, _ = local(["namespace", "migrate", verb, "videos"])
        assert rc == 0 and out.startswith("deprecated:")


def _durable_dir(pkg: str, root: Path, bitrot: bool = False) -> str:
    """A WAL and checkpoint directory written by `pkg`'s durable memory store:
    writes, a checkpoint, more writes, no close (a crash)."""
    p = DURABLE[pkg]
    wal = root / pkg / "wal"
    wal.mkdir(parents=True)
    store = p.durable.DurableTupleStore(
        p.kinds["memory"](), str(wal), checkpoint_interval_versions=10**9,
        checkpoint_interval_s=0.0, segment_bytes=512,
    )
    store.write_relation_tuples(*[p.Tuple("n", f"o{i}", "view", p.ID(f"u{i % 7}"))
                                  for i in range(20)])
    store.checkpoint_now()
    for i in range(12):
        store.write_relation_tuples(p.Tuple("n", f"x{i}", "view", p.ID("u")))
    store.delete_relation_tuples(p.Tuple("n", "o3", "view", p.ID("u3")))
    if bitrot:
        assert p.wal.inject_bitrot(str(wal))
    return str(wal)


@pytest.mark.parametrize("bitrot", [False, True], ids=["clean", "bitrot"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_doctor_is_equal_on_each_packages_directory(writer, bitrot, tmp_path):
    wal = _durable_dir(writer, tmp_path, bitrot)
    reports = {}
    for fmt in ("json", "human"):
        got = {pkg: RUN[pkg](["doctor", "--wal-dir", wal, "--chunk-size", "8",
                              "--format", fmt]) for pkg in ("jax", "torch")}
        assert got["torch"] == got["jax"], fmt
        reports[fmt] = got["torch"]
    rc, out, _ = reports["json"]
    doc = json.loads(out)
    assert rc == (1 if bitrot else 0) and doc["ok"] is not bitrot
    if not bitrot:
        assert doc["recovery"]["gap"] is False and doc["digest"]["count"] == 31
        assert len(doc["wal"]["segments"]) > 1 and doc["checkpoints"]["files"]
        assert reports["human"][1].endswith("status: CLEAN\n")
    else:
        assert reports["human"][1].endswith("status: CORRUPT\n")


def test_doctor_usage_errors(tmp_path):
    rc, _, err = local(["doctor"])
    assert rc == 2 and "no WAL directory" in err
    rc, _, err = local(["doctor", "--wal-dir", tmp_path / "missing"])
    assert rc == 2 and "is not a directory" in err


def test_doctor_recovers_a_columnar_directory_without_a_gap(tmp_path):
    """A columnar checkpoint restores into a columnar scratch store, so the
    bulk load it holds is not reported as a WAL gap."""
    p = DURABLE["torch"]
    wal = tmp_path / "wal"
    store = p.durable.DurableTupleStore(p.kinds["columnar"](), str(wal),
                                        checkpoint_interval_versions=10**9,
                                        checkpoint_interval_s=0.0)
    store.bulk_load_edges([("n", f"o{i}", "view") for i in range(50)],
                          [(f"u{i}",) for i in range(50)])
    store.write_relation_tuples(p.Tuple("n", "extra", "view", p.ID("u")))
    rc, out, _ = run_port(["doctor", "--wal-dir", wal, "--format", "json"])
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] and not doc["recovery"]["gap"]
    assert doc["digest"]["count"] == len(store) == 51


def test_debug_snapshot_bundle(servers, tmp_path):
    """The bundle holds every endpoint of the reference's set, each fetched
    from the port's server, and no errors.txt."""
    out_path = tmp_path / "bundle.tar.gz"
    rc, out, _ = run_port(remotes(servers["torch"]) + ["debug", "snapshot", "-o",
                                                        out_path])
    assert rc == 0 and out == f"wrote {out_path} (8 files)\n"
    with tarfile.open(out_path) as tar:
        names = tar.getnames()
        version = json.loads(tar.extractfile("version.json").read())
        graph = json.loads(tar.extractfile("graph.json").read())
        flight = json.loads(tar.extractfile("flight.json").read())
        traces = json.loads(tar.extractfile("traces.json").read())
        prom = tar.extractfile("metrics.prom").read().decode()
    assert names == [n for n, _ in SNAPSHOT_ENDPOINTS]
    assert set(flight) >= {"stats", "records", "slo", "checks"}
    assert set(traces) == {"spans"}
    assert "# TYPE keto_http_requests_total counter" in prom
    assert version == {"version": VERSION} and isinstance(graph, dict)
    rc, _, err = run_port(["debug", "snapshot", "--url", "http://127.0.0.1:1",
                           "-o", tmp_path / "none.tgz"])
    assert rc == 1 and err.startswith("Error: could not reach http://127.0.0.1:1")


def _imported_roots(stderr: str) -> set:
    roots = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            roots.add(name.split(".")[0])
    return roots


@pytest.mark.parametrize("verb", ["version", "check"])
def test_a_cli_process_imports_neither_jax_nor_keto_tpu(verb, servers):
    argv = ["version"]
    if verb == "check":
        argv = ["--read-remote", f"127.0.0.1:{servers['torch'].read_port}",
                "check", "nobody", "view", "videos", "/cats/1.mp4"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "keto_tpu_torch.cli", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    roots = _imported_roots(proc.stderr)
    assert "keto_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "keto_tpu"}, sorted(roots)
    if verb == "version":
        assert (proc.returncode, proc.stdout) == (0, f"{VERSION}\n")
    else:
        assert (proc.returncode, proc.stdout) == (1, "Denied\n")
