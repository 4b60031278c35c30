"""keto_tpu_torch's read-replica pool against keto_tpu's, on the CPU.

Two pool servers, each with ``serve.read.workers`` 3, boot in fresh
interpreters (this file run as a script: ``python
tests/test_torch_replicas.py torch|jax``), so each fork starts from a
process that holds only its server and never from a test worker. The port
runs ``Registry(config, device="cpu")`` (the closure engine forced into
host query mode), keto_tpu its own ``Registry`` (host query mode on the
CPU backend). Each harness prints its ports and pool on a ``POOL`` line
and answers ``pool`` and ``stop`` on stdin (``keto_tpu_torch/poolharness.py``,
shared with ``chip_smoke.py``'s pool server).

The same tuples go to both write ports; every probe opens a fresh
connection, so SO_REUSEPORT spreads the probes over the replicas and 24
consecutive agreeing answers cover the pool (``_converges``, as
``tests/test_replicas.py``). Covered: forked and serving with two children;
writes and deletes reaching every replica; the indirect path; answers
equal between the packages; a SIGKILLed child respawned from the zygote
(in both pools); no process left after ``stop_all``. In process, without a
fork: the inventory refusing a stray thread, ``auto`` with workers > 1
building a host-mode engine, a device query mode serving single-process
with one log line, and ``serve --workers``. Every wait has a deadline.
"""

import json
import logging
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
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

POOL_VALUES = {
    "namespaces": [{"id": 1, "name": "n"}],
    "log": {"level": "error"},
    "serve": {
        "read": {"port": 0, "host": "127.0.0.1", "workers": 3},
        "write": {"port": 0, "host": "127.0.0.1"},
    },
    "engine": {"max_batch": 64},
}
BOOT_S = 120.0


# -- the harness: one pool server per fresh interpreter ---------------------------


def harness(package: str) -> None:
    """Serve a 3-worker pool of `package` ("torch" or "jax") until stdin
    says stop."""
    if package == "torch":
        from keto_tpu_torch.driver import Config, Registry

        logging.basicConfig(level=logging.INFO)
        reg = Registry(Config(values=POOL_VALUES), device="cpu")
        read_port, write_port = reg.start_all()
        stop_all = reg.stop_all
    else:
        import asyncio

        from keto_tpu.driver import Config, Registry

        reg = Registry(Config(values=POOL_VALUES))
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True).start()
        read_port, write_port = asyncio.run_coroutine_threadsafe(
            reg.start_all(), loop
        ).result(timeout=BOOT_S)

        def stop_all():
            asyncio.run_coroutine_threadsafe(reg.stop_all(), loop).result(timeout=30)

    pool = reg._replica_pool

    def describe(_arg: str = "") -> dict:
        children = [link.pid for link in pool._children] if pool is not None else []
        return {
            "read": read_port,
            "write": write_port,
            "children": children,
            "alive": 1 + len(live_pids(p for p in children if p > 0)),
            "zygote": pool._zygote_pid if pool is not None else -1,
            "host": bool(reg.check_engine().host_queries()),
        }

    def stop() -> dict:
        stop_all()
        return {"stopped": True}

    emit(describe())
    serve_commands({"pool": describe}, stop)


class PoolServer(PoolProcess):
    """The test side of one harness process."""

    def __init__(self, package: str):
        self.package = package
        super().__init__(
            [sys.executable, str(Path(__file__).resolve()), package],
            cwd=str(REPO), name=f"{package} harness",
        )

    def boot(self) -> None:
        """Wait for the harness's first POOL line: the pool is serving."""
        self.info = self.next_doc(BOOT_S)
        self.read = f"http://127.0.0.1:{self.info['read']}"
        self.write = f"http://127.0.0.1:{self.info['write']}"


@pytest.fixture(scope="module")
def pools():
    servers = {}
    try:
        for package in ("torch", "jax"):  # both boot at once
            servers[package] = PoolServer(package)
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


# -- HTTP helpers ------------------------------------------------------------------


def _request(method: str, url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _check(server: PoolServer, params: dict):
    """One GET /check on a fresh connection (urllib closes each one)."""
    return _request("GET", f"{server.read}/check?{urllib.parse.urlencode(params)}")


def _converges(server: PoolServer, params: dict, want_status: int,
               tries: int = 24, timeout: float = 60.0) -> bool:
    """`tries` consecutive fresh-connection probes agree: SO_REUSEPORT
    spreads them over the replicas, so the streak covers the pool."""
    deadline = time.monotonic() + timeout
    streak = 0
    while streak < tries and time.monotonic() < deadline:
        if _check(server, params)[0] == want_status:
            streak += 1
        else:
            streak = 0
            time.sleep(0.05)
    return streak >= tries


def _write_both(pools, method: str, body: dict) -> None:
    results = []
    for server in pools.values():
        if method == "PUT":
            results.append(_request("PUT", f"{server.write}/relation-tuples", body)[0])
        else:
            url = f"{server.write}/relation-tuples?{urllib.parse.urlencode(body)}"
            results.append(_request("DELETE", url)[0])
    assert results[0] == results[1] == (201 if method == "PUT" else 204)


def _flat(t: dict) -> dict:
    """A tuple body as GET /check query parameters."""
    out = {k: v for k, v in t.items() if k != "subject_set"}
    for k, v in t.get("subject_set", {}).items():
        out[f"subject_set.{k}"] = v
    return out


# -- the pools ----------------------------------------------------------------------


def test_forked_and_serving_with_two_children(pools):
    for server in pools.values():
        info = server.info
        assert len(info["children"]) == 2 and all(p > 0 for p in info["children"])
        assert info["zygote"] > 0 and info["alive"] == 3
        assert info["host"]  # workers > 1 forces host query mode
    assert any("read replicas forked: 3 processes" in line for line in pools["torch"].lines)


def test_write_and_delete_reach_every_replica(pools):
    tup = {"namespace": "n", "object": "doc", "relation": "view", "subject_id": "alice"}
    _write_both(pools, "PUT", tup)
    for server in pools.values():
        assert _converges(server, tup, 200), server.package
    _write_both(pools, "DELETE", tup)
    for server in pools.values():
        assert _converges(server, tup, 403), server.package


def test_indirect_path_through_replicas(pools):
    for body in (
        {"namespace": "n", "object": "g", "relation": "m", "subject_id": "bob"},
        {"namespace": "n", "object": "doc2", "relation": "view",
         "subject_set": {"namespace": "n", "object": "g", "relation": "m"}},
    ):
        _write_both(pools, "PUT", body)
    probe = {"namespace": "n", "object": "doc2", "relation": "view", "subject_id": "bob"}
    for server in pools.values():
        assert _converges(server, probe, 200), server.package


def _random_graph(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    tuples = []
    for _ in range(40):
        obj = f"o{rng.integers(10)}"
        if rng.random() < 0.45:
            sub = {"subject_set": {"namespace": "n", "object": f"o{rng.integers(10)}",
                                   "relation": "r"}}
        else:
            sub = {"subject_id": f"u{rng.integers(8)}"}
        tuples.append({"namespace": "n", "object": obj, "relation": "r", **sub})
    probes = [
        {"namespace": "n", "object": f"o{rng.integers(10)}", "relation": "r",
         "subject_id": f"u{rng.integers(9)}"}
        for _ in range(40)
    ]
    return tuples, probes


def _answers_equal(pools, probes, timeout: float = 30.0) -> None:
    """Both pools give the same answer to every probe. A replica applies a
    delta a moment after the write returns, so a probe that lands on one
    still applying it is asked again until the deadline."""
    deadline = time.monotonic() + timeout
    for p in probes:
        while True:
            got = [_check(server, p) for server in pools.values()]
            if got[0] == got[1] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert got[0] == got[1], (p, got)
        assert got[0][0] in (200, 403)


def _settle(pools, marker: str) -> None:
    """Write a marker tuple to both pools and wait until every replica of
    each answers it: frames apply in version order, so the writes before
    it have landed too."""
    tup = {"namespace": "n", "object": marker, "relation": "view", "subject_id": "m"}
    _write_both(pools, "PUT", tup)
    for server in pools.values():
        assert _converges(server, tup, 200), server.package


def test_answers_equal_between_the_packages(pools):
    tuples, probes = _random_graph(11)
    for t in tuples:
        _write_both(pools, "PUT", t)
    _settle(pools, "settled-1")
    _answers_equal(pools, probes)
    for t in tuples[:5]:
        _write_both(pools, "DELETE", _flat(t))
    _settle(pools, "settled-2")
    _answers_equal(pools, probes)


def test_a_killed_child_is_respawned_from_the_zygote(pools):
    for server in pools.values():
        victim = server.ask("pool", 30.0)["children"][0]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            doc = server.ask("pool", 30.0)
            kids = doc["children"]
            if (doc["alive"] == 3 and victim not in kids and len(kids) == 2
                    and all(p > 0 for p in kids)):
                break
            time.sleep(0.1)
        assert doc["alive"] == 3 and victim not in doc["children"], (server.package, doc)
    lines = "".join(pools["torch"].lines)
    assert "read replica died; respawning" in lines
    assert "read replica respawned from the zygote" in lines
    # the respawned replica serves the writes made before its birth and after
    tup = {"namespace": "n", "object": "after-kill", "relation": "view", "subject_id": "eve"}
    _write_both(pools, "PUT", tup)
    for server in pools.values():
        assert _converges(server, tup, 200), server.package
    _answers_equal(pools, _random_graph(11)[1])


def test_stop_all_leaves_no_process(pools):
    for server in pools.values():
        doc = server.ask("pool", 30.0)
        pids = [p for p in doc["children"] if p > 0] + [doc["zygote"]]
        assert server.stop(60.0) == {"stopped": True}
        assert server.proc.returncode == 0
        deadline = time.monotonic() + 30
        while live_pids(pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert live_pids(pids) == [], (server.package, pids)


# -- in process, no fork ------------------------------------------------------------


def test_the_inventory_refuses_a_stray_thread():
    from keto_tpu_torch.driver.replicas import ReplicaPool

    stop = threading.Event()
    rogue = threading.Thread(target=stop.wait, name="rogue-worker", daemon=True)
    rogue.start()
    try:
        pool = ReplicaPool.__new__(ReplicaPool)
        with pytest.raises(RuntimeError, match="rogue-worker"):
            pool._enforce_fork_inventory()
    finally:
        stop.set()
        rogue.join(timeout=10)
    assert not rogue.is_alive()


@pytest.mark.parametrize("workers,host", [(3, True), (1, False)])
def test_auto_with_workers_builds_a_host_mode_engine(workers, host):
    from keto_tpu_torch.driver import Config, Registry

    values = {"serve": {"read": {"workers": workers}}}
    engine = Registry(Config(values=values), device="cpu").check_engine()
    assert engine.query_mode == ("host" if host else "auto")
    assert engine.host_queries() is host


def test_a_device_query_mode_serves_single_process_with_one_log_line(caplog):
    from keto_tpu_torch.driver import Config, Registry

    values = dict(POOL_VALUES, engine={"max_batch": 64, "query_mode": "device"})
    reg = Registry(Config(values=values), device="cpu")
    with caplog.at_level(logging.INFO, logger="keto_tpu_torch"):
        read_port, write_port = reg.start_all()
    try:
        said = [r for r in caplog.records if "read workers require" in r.getMessage()]
        assert len(said) == 1 and said[0].levelno == logging.WARNING
        assert not any("forked" in r.getMessage() for r in caplog.records)
        assert reg._replica_pool is None
        tup = {"namespace": "n", "object": "d", "relation": "v", "subject_id": "a"}
        status, _ = _request("PUT", f"http://127.0.0.1:{write_port}/relation-tuples", tup)
        assert status == 201
        status, _ = _request(
            "GET", f"http://127.0.0.1:{read_port}/check?{urllib.parse.urlencode(tup)}"
        )
        assert status == 200
    finally:
        reg.stop_all()


def test_serve_workers_overrides_the_config(tmp_path, monkeypatch):
    from keto_tpu_torch import driver
    from keto_tpu_torch.cli import main as cli

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"serve": {"read": {"workers": 2}}}))
    seen = []

    class Stop(Exception):
        pass

    class FakeRegistry:
        def __init__(self, config):
            seen.append(int(config.get("serve.read.workers")))

        def start_all(self):
            raise Stop

    monkeypatch.setattr(driver, "Registry", FakeRegistry)
    for argv, want in ((["--workers", "4"], 4), ([], 2)):
        with pytest.raises(Stop):
            cli.main(["serve", "-c", str(cfg), *argv])
        assert seen.pop() == want


if __name__ == "__main__":
    harness(sys.argv[1])
