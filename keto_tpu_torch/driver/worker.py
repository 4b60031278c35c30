"""Spawned read-worker entry: ``python -m keto_tpu_torch.driver.worker``
(counterpart of ``keto_tpu/driver/worker.py``).

Reads the JSON spec from ``KETO_WORKER_SPEC`` (written by
``spawn_workers.SpawnWorkerPool``: the config values, the parent's flag
overrides with the worker's pins, the parent's device and the pool's shared
ports), builds its own registry over the environment it inherited — its own database
connection, its own snapshot and engine residency — warms the engine up,
and serves the read plane on the pool's SO_REUSEPORT ports. Freshness comes
from the engine's own ``store.version`` checks against the shared database;
no delta stream, no fork, no inherited state.

Prints one ``KETO_WORKER_READY <json>`` line once it serves (its pid,
boot seconds, device, query mode, whether it initialised CUDA and what its
allocator then holds on the card, and the closure kernel's launches).
Exits 0 on SIGTERM (the pool's stop), 4 on a boot failure, so the parent
sees a dead worker.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback


def main() -> int:
    t0 = time.perf_counter()
    spec = json.loads(os.environ["KETO_WORKER_SPEC"])
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    from ..engine import masked_spmv
    from .config import Config
    from .registry import Registry
    from .spawn_workers import READY_PREFIX

    try:
        cfg = Config(values=spec["config"], flag_overrides=spec.get("overrides"))
        reg = Registry(cfg, device=spec["device"])
        reg.apply_log_config()
        engine = reg.check_engine()
        if hasattr(engine, "warmup"):
            engine.warmup(int(reg.config.get("engine.max_batch")))
        read_port, grpc_port = spec["ports"]
        plane = reg.build_read_plane_shared(read_port, grpc_port)
        plane.start()
        reg.mark_serving()
    except BaseException:
        traceback.print_exc()
        return 4
    import torch

    host_queries = getattr(engine, "host_queries", None)
    doc = {
        "pid": os.getpid(),
        "boot_s": time.perf_counter() - t0,
        "device": str(reg.device),
        "query_mode": (
            ("host" if host_queries() else "device") if host_queries else None
        ),
        "cuda_initialized": torch.cuda.is_initialized(),
        "cuda_reserved_mib": (
            torch.cuda.memory_reserved() / 2**20 if torch.cuda.is_initialized() else 0.0
        ),
        "b1_launches": masked_spmv.masked_step.launches,
        "store_version": reg.store().version,
    }
    print(READY_PREFIX + json.dumps(doc), flush=True)
    stop.wait()
    try:
        plane.stop()
    except Exception:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
