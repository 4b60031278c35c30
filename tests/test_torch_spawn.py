"""keto_tpu_torch's spawned read workers against keto_tpu's, on the CPU.

A SQL store's state is the database, so ``serve.read.workers`` N spawns
N - 1 fresh worker interpreters (``driver/spawn_workers.py``), never forks.
Two servers, each with ``serve.read.workers`` 3 over its own sqlite file
holding the same tuples, boot in fresh interpreters (this file run as a
script: ``python tests/test_torch_spawn.py torch|jax <db path>``), as
``tests/test_torch_replicas.py`` does, so nothing forks a pytest worker. The
port runs ``Registry(config, device="cpu")``, whose workers get the same
device; keto_tpu its own ``Registry`` on the JAX CPU backend. Each harness
prints its ports and worker pids on a ``POOL`` line once every worker
serves, and answers ``pool`` and ``stop`` on stdin.

Every probe opens a fresh connection, so SO_REUSEPORT spreads the probes
over the three processes. Covered: two workers spawned, each a separate
interpreter in host query mode; answers equal between the packages and
the host oracle; a write through the parent's write port visible from every
worker (24 consecutive agreeing probes, as ``tests/test_replicas.py``);
no process left after ``stop_all``. In process: a memory store with
workers > 1 still forks (process-private), and the worker's config pins.
Every wait has a deadline.
"""

import os
import sys
import time
import urllib.parse
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # run as a script, the harness imports from here

from keto_tpu_torch.poolharness import (  # noqa: E402
    PoolProcess,
    emit,
    live_pids,
    serve_commands,
)
from tests.test_torch_replicas import (  # noqa: E402
    _check,
    _converges,
    _random_graph,
    _request,
)

BOOT_S = 180.0


def values(db: str) -> dict:
    return {
        "dsn": f"sqlite://{db}",
        "namespaces": [{"id": 1, "name": "n"}],
        "log": {"level": "error"},
        "serve": {
            "read": {"port": 0, "host": "127.0.0.1", "workers": 3},
            "write": {"port": 0, "host": "127.0.0.1"},
        },
        "engine": {"max_batch": 64},
    }


def seed_tuples() -> list[dict]:
    return _random_graph(23)[0]


# -- the harness: one spawn-pool server per fresh interpreter --------------------------


def harness(package: str, db: str) -> None:
    """Fill `db` with the seed tuples, then serve a 3-worker spawn pool of
    `package` ("torch" or "jax") over it until stdin says stop."""
    if package == "torch":
        import logging

        from keto_tpu_torch.driver import Config, Registry
        from keto_tpu_torch.relationtuple import RelationTuple

        logging.basicConfig(level=logging.INFO)
        reg = Registry(Config(values=values(db)), device="cpu")
        reg.store().write_relation_tuples(*map(RelationTuple.from_dict, seed_tuples()))
        read_port, write_port = reg.start_all()
        pool = reg._replica_pool
        ready = pool.wait_ready(BOOT_S)
        docs = pool.ready_docs()
        stop_all = reg.stop_all
    else:
        import asyncio
        import threading

        from keto_tpu.driver import Config, Registry
        from keto_tpu.relationtuple import RelationTuple

        reg = Registry(Config(values=values(db)))
        reg.store().write_relation_tuples(*map(RelationTuple.from_dict, seed_tuples()))
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True).start()
        read_port, write_port = asyncio.run_coroutine_threadsafe(
            reg.start_all(), loop).result(timeout=BOOT_S)
        pool = reg._replica_pool
        # the reference's pool reports liveness only; the probes below wait
        # for the answers themselves
        ready = pool.wait_ready(BOOT_S)
        docs = []

        def stop_all():
            asyncio.run_coroutine_threadsafe(reg.stop_all(), loop).result(timeout=60)

    pids = [p.pid for p in pool._procs]

    def describe(_arg: str = "") -> dict:
        return {
            "read": read_port,
            "write": write_port,
            "workers": pids,
            "alive": 1 + len(live_pids(pids)),
            "ready": ready,
            "docs": docs,
            "pool": type(pool).__name__,
        }

    def stop() -> dict:
        stop_all()
        return {"stopped": True}

    emit(describe())
    serve_commands({"pool": describe}, stop)


class SpawnServer(PoolProcess):
    def __init__(self, package: str, db: str):
        self.package = package
        super().__init__(
            [sys.executable, str(Path(__file__).resolve()), package, db],
            cwd=str(REPO), name=f"{package} spawn harness",
        )

    def boot(self) -> None:
        self.info = self.next_doc(BOOT_S)
        self.read = f"http://127.0.0.1:{self.info['read']}"
        self.write = f"http://127.0.0.1:{self.info['write']}"


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    servers = {}
    try:
        for package in ("torch", "jax"):  # both boot at once
            db = tmp_path_factory.mktemp(package) / "keto.db"
            servers[package] = SpawnServer(package, str(db))
        for server in servers.values():
            server.boot()
        yield servers
    finally:
        for server in servers.values():
            if not server.stopped:
                try:
                    server.stop(60.0)
                except Exception:
                    pass
            server.kill_group()


def _all_serve(server, probe, want: int, tries: int = 24) -> bool:
    return _converges(server, probe, want, tries=tries, timeout=BOOT_S)


def test_two_fresh_workers_are_spawned(pools):
    for server in pools.values():
        info = server.info
        assert info["pool"] == "SpawnWorkerPool" and info["ready"]
        assert len(info["workers"]) == 2 and info["alive"] == 3
        assert os.getpid() not in info["workers"]
    docs = pools["torch"].info["docs"]
    assert [d["pid"] for d in docs] == pools["torch"].info["workers"]
    # the spec's pins and the parent's device: host query mode on the CPU;
    # the worker never initialised CUDA and launched no kernel
    for d in docs:
        assert (d["device"], d["query_mode"], d["cuda_initialized"], d["b1_launches"]) == (
            "cpu", "host", False, 0)
        assert d["store_version"] == 1 and d["boot_s"] > 0
    assert any("read workers spawned: 3 processes" in line
               for line in pools["torch"].lines)


def test_answers_equal_the_reference_and_the_oracle(pools):
    from keto_tpu_torch.engine.check import CheckEngine
    from keto_tpu_torch.relationtuple import RelationTuple
    from keto_tpu_torch.store import InMemoryTupleStore

    oracle_store = InMemoryTupleStore()
    oracle_store.write_relation_tuples(*map(RelationTuple.from_dict, seed_tuples()))
    oracle = CheckEngine(oracle_store)
    _, probes = _random_graph(23)
    for p in probes:
        want = 200 if oracle.subject_is_allowed(RelationTuple.from_dict(p)) else 403
        got = [_check(server, p)[0] for server in pools.values() for _ in range(3)]
        assert got == [want] * 6, (p, got)


def test_a_write_is_visible_from_every_worker(pools):
    """A worker learns of another process's write from the database's
    version, never from a delta: it rebuilds at once instead of waiting out
    the closure engine's in-process delivery wait (5 s)."""
    tup = {"namespace": "n", "object": "doc", "relation": "view", "subject_id": "zed"}
    for server in pools.values():
        assert _all_serve(server, tup, 403, tries=6)
        t0 = time.monotonic()
        status, _ = _request("PUT", f"{server.write}/relation-tuples", tup)
        assert status == 201
        assert _all_serve(server, tup, 200), server.package
        assert time.monotonic() - t0 < 5.0, (server.package, time.monotonic() - t0)
    for server in pools.values():
        url = f"{server.write}/relation-tuples?{urllib.parse.urlencode(tup)}"
        assert _request("DELETE", url)[0] == 204
    for server in pools.values():
        assert _all_serve(server, tup, 403), server.package


def test_stop_all_leaves_no_process(pools):
    for server in pools.values():
        pids = server.ask("pool", 30.0)["workers"]
        assert server.stop(60.0) == {"stopped": True}
        assert server.proc.returncode == 0
        deadline = time.monotonic() + 30
        while live_pids(pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert live_pids(pids) == [], (server.package, pids)


# -- in process, no spawn ------------------------------------------------------------


def test_worker_values_pin_one_process_and_host_queries(tmp_path, monkeypatch):
    from keto_tpu_torch.driver import Config, Registry
    from keto_tpu_torch.driver.spawn_workers import worker_values

    reg = Registry(Config(values=values(str(tmp_path / "k.db"))), device="cpu")
    v = worker_values(reg, allow_accel=False)
    assert v["serve"]["read"]["workers"] == 1 and v["engine"]["query_mode"] == "host"
    assert v["dsn"] == reg.config.dsn() and reg.config.get("serve.read.workers") == 3
    v = worker_values(reg, allow_accel=True)
    assert v["serve"]["read"]["workers"] == 1 and "query_mode" not in v["engine"]


@pytest.mark.parametrize("dsn,private", [
    ("memory", True), ("columnar", True), ("sqlite", False), ("mysql+fake", False),
])
def test_only_sql_stores_are_spawned(dsn, private, tmp_path):
    from keto_tpu_torch.driver import Config, Registry

    if dsn == "sqlite":
        dsn = f"sqlite://{tmp_path}/k.db"
    elif dsn == "mysql+fake":
        dsn = f"mysql+fake:///spawn_{os.getpid()}"
    v = values(str(tmp_path / "unused.db"))
    v["dsn"] = dsn
    store = Registry(Config(values=v), device="cpu").store()
    assert getattr(store, "process_private", False) is private


if __name__ == "__main__":
    harness(sys.argv[1], sys.argv[2])
