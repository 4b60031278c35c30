"""The system under test, booted as a user runs it: ``keto_tpu_torch``'s
``Registry(Config(...))`` with ``start_all()`` serving REST on its read and
write ports, in this process. The only module of the benchmark that
imports the program; from it the benchmark takes the store's bulk load,
the registry's bring-up, and its counters (the attribution ledger and the
check batcher's pipeline stats)."""

from __future__ import annotations

import copy
import time


def with_overrides(values: dict, overrides: dict) -> dict:
    """``values`` with dotted keys (``serve.read.max-depth``) replaced."""
    out = copy.deepcopy(values)
    for dotted, v in (overrides or {}).items():
        node = out
        *path, last = dotted.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


class System:
    def __init__(self, program: dict, device, overrides: dict = None):
        self.values = with_overrides(program, overrides)
        self.device = device
        self.reg = None
        self.ingest_s = self.start_all_s = 0.0
        self.read_port = self.write_port = 0

    def boot(self, src_keys: list, dst_keys: list) -> None:
        from keto_tpu_torch.driver import Config, Registry

        # env={}: the run's environment never reconfigures the program
        self.reg = Registry(Config(values=self.values, env={}), device=self.device)
        store = self.reg.store()
        t = time.perf_counter()
        store.bulk_load_edges(src_keys, dst_keys)
        self.ingest_s = time.perf_counter() - t
        t = time.perf_counter()
        self.read_port, self.write_port = self.reg.start_all()
        self.start_all_s = time.perf_counter() - t

    def counters(self) -> dict:
        """The program's counters now: the attribution ledger's snapshot
        and the check batcher's pipeline stats."""
        att = self.reg.attribution()
        checker = self.reg.checker()
        pipe = checker.pipeline_stats() if hasattr(checker, "pipeline_stats") else None
        return {"t": time.monotonic(),
                "attribution": att.snapshot() if att is not None else None,
                "pipeline": pipe}

    def stop(self) -> None:
        if self.reg is not None:
            self.reg.stop_all()
            self.reg = None
