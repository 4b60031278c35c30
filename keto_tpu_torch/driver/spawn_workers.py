"""Spawned read-worker pool for SQL-backed stores (counterpart of
``keto_tpu/driver/spawn_workers.py``).

The fork pool (``replicas.py``) shares in-memory residency copy-on-write:
the right shape for process-private stores. A SQL store is the opposite
case: the database is the shared state (the reference's scale-out model is
stateless replicas behind a balancer over one SQL database), and forking is
wrong there, since replicas re-applying deltas over inherited connections
would double-commit. So SQL stores scale out by spawning fresh workers:

- each worker is a clean interpreter (``python -m
  keto_tpu_torch.driver.worker``: no inherited threads, locks or
  connections) that builds its own registry from the parent's config and
  opens its own database connection;
- every worker binds the same read ports with SO_REUSEPORT, as the fork
  pool does;
- freshness needs no delta stream: the closure engine re-checks
  ``store.version`` per batch and rebuilds through its bounded-staleness
  machinery; the database is the coordination point.

The parent keeps the write plane and serves reads as worker 0.

Device policy, as the reference's: a worker runs ``engine.query_mode:
host`` unless ``KETO_WORKER_ALLOW_ACCEL=1`` is set, where it keeps the
parent's placement and builds its own D on the card. The reference also
hides the accelerator from a host-mode worker, because one process holds
libtpu; nothing hides a CUDA card from a process, and the port hides
nothing: a worker's ``Registry`` gets the parent's device (``cpu`` in the
tests, ``cuda`` on the card) and resolves it as every entry point does.

A worker prints one ``KETO_WORKER_READY <json>`` line once its read plane
serves (its pid, boot seconds, query mode, device, whether this process
initialised CUDA, and the closure kernel's launches); the pool reads each
worker's output, echoes every other line to its own stderr, and
``wait_ready`` waits for those lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

READY_PREFIX = "KETO_WORKER_READY "


def worker_values(registry, allow_accel: bool) -> dict:
    """The worker's config values: the parent's, with the worker-critical
    keys pinned (one process per worker, and host query mode unless the
    accelerator is allowed)."""
    values = json.loads(json.dumps(registry.config._data))
    serve = values.setdefault("serve", {})
    serve.setdefault("read", {})["workers"] = 1
    if not allow_accel:
        values.setdefault("engine", {})["query_mode"] = "host"
    return values


def worker_overrides(registry, allow_accel: bool) -> dict:
    """The worker's flag overrides: the parent's, with the same pins. An
    override outranks the environment the worker inherits, so a
    ``KETO_SERVE_READ_WORKERS`` there cannot make a worker spawn a pool of
    its own."""
    overrides = dict(registry.config._overrides)
    overrides["serve.read.workers"] = 1
    if not allow_accel:
        overrides["engine.query_mode"] = "host"
    return overrides


class SpawnWorkerPool:
    """Spawns ``n_workers - 1`` fresh worker processes (parent is worker 0)."""

    def __init__(self, registry, n_workers: int):
        self.registry = registry
        self.n_workers = n_workers
        self._procs: list[subprocess.Popen] = []
        self._ready: dict[int, dict] = {}
        self._cond = threading.Condition()

    def start(self, read_port: int, grpc_port: int) -> None:
        allow_accel = os.environ.get("KETO_WORKER_ALLOW_ACCEL") == "1"
        spec = {
            "config": worker_values(self.registry, allow_accel),
            "overrides": worker_overrides(self.registry, allow_accel),
            "device": str(self.registry.device),
            "ports": [read_port, grpc_port],
        }
        # the parent's environment, KETO_* settings included, reaches the
        # worker's config as it reached the parent's
        env = dict(os.environ)
        env["KETO_WORKER_SPEC"] = json.dumps(spec)
        # the worker imports this very package, wherever the parent runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p
        )
        for _ in range(1, self.n_workers):
            proc = subprocess.Popen(
                [sys.executable, "-m", "keto_tpu_torch.driver.worker"],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            self._procs.append(proc)
            threading.Thread(
                target=self._read, args=(proc,), name="spawn-worker-log", daemon=True
            ).start()

    def _read(self, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            if line.startswith(READY_PREFIX):
                doc = json.loads(line[len(READY_PREFIX):])
                with self._cond:
                    self._ready[proc.pid] = doc
                    self._cond.notify_all()
            else:
                sys.stderr.write(line)
        with self._cond:
            self._cond.notify_all()  # EOF: the worker exited

    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def alive(self) -> int:
        return 1 + sum(1 for p in self._procs if p.poll() is None)

    def ready_docs(self) -> list[dict]:
        """The ready line of every worker that printed one, in spawn order."""
        with self._cond:
            return [self._ready[p.pid] for p in self._procs if p.pid in self._ready]

    def wait_ready(self, timeout_s: float = 60.0) -> bool:
        """Wait until every worker serves (printed its ready line); False at
        the timeout or as soon as a worker has exited without serving."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                if any(p.poll() is not None and p.pid not in self._ready
                       for p in self._procs):
                    return False
                if all(p.pid in self._ready for p in self._procs):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.5))

    def stop(self, timeout_s: float = 10.0) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        self._procs.clear()

