"""Device telemetry: per-device memory, kernel builds, host<->device
transfer bytes, per-stage wall time and the graph panel (counterpart of
``keto_tpu/telemetry/devstats.py``).

One process-wide collector (``DEVSTATS``), because the tally points live
deep in the engine's hot path (the batcher's stages, the device engine's
staging copies). Tallies accumulate for the life of the process.

Device memory is sampled from PyTorch's CUDA allocator, under the keys of
JAX's ``memory_stats()`` that the reference reads:

- ``bytes_limit``       ``torch.cuda.mem_get_info()[1]`` (the card's total);
- ``bytes_in_use``      ``torch.cuda.memory_allocated()``;
- ``peak_bytes_in_use`` ``torch.cuda.max_memory_allocated()``;
- ``bytes_reserved``    ``torch.cuda.memory_reserved()`` (the caching
  allocator's hold, which has no JAX counterpart).

A process samples only when it has initialised CUDA itself: a forked read
replica inherits the parent's ``torch`` state but may not touch the card
("Cannot re-initialize CUDA in forked subprocess"), and a CPU process has
no card. Those get no device entries, which ``HbmAdmission`` reads as
"admission off", as the reference does on a CPU backend.

Kernel builds replace JAX's compilation events: ``utils/kernels.py`` calls
:meth:`DeviceStatsCollector.record_compile` with each nvcc build's seconds
and ``native/`` with the gcc build's. The metrics binding (``bind``) waits
for ROADMAP 14.5.
"""

from __future__ import annotations

import threading
import time

import torch


def cuda_ready() -> bool:
    """Whether this process may ask the CUDA allocator anything: CUDA
    initialised here, not inherited through a fork. A flag test only: it
    calls into no CUDA library, so a forked child stays clean."""
    return torch.cuda.is_initialized()


class DeviceStatsCollector:
    def __init__(self):
        self._lock = threading.Lock()
        self._transfer_bytes = {"h2d": 0.0, "d2h": 0.0}
        self._stage_seconds: dict[str, float] = {}
        self._compiles = 0
        self._compile_seconds = 0.0
        self._graph_panel_fn = None

    def set_graph_panel(self, fn) -> None:
        """The zero-arg callable behind the panel's ``graph`` entry (the
        registry's graph shape)."""
        self._graph_panel_fn = fn

    # -- tally points (called from the engine hot path) -----------------------

    def record_transfer(self, nbytes: int, direction: str = "h2d") -> None:
        with self._lock:
            self._transfer_bytes[direction] = (
                self._transfer_bytes.get(direction, 0.0) + nbytes
            )

    def record_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stage_seconds[stage] = self._stage_seconds.get(stage, 0.0) + seconds

    def record_compile(self, seconds: float) -> None:
        with self._lock:
            self._compiles += 1
            self._compile_seconds += seconds

    # -- introspection --------------------------------------------------------

    def sample_devices(self) -> list[dict]:
        """One entry per CUDA device with its memory statistics; empty where
        this process may not ask (see the module docstring)."""
        if not cuda_ready():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            entry = {
                "id": i,
                "platform": "cuda",
                "device_kind": torch.cuda.get_device_name(i),
            }
            try:
                entry["memory_stats"] = {
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1],
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                    "bytes_reserved": torch.cuda.memory_reserved(i),
                }
            except Exception:
                pass  # a sick context: the entry without its statistics
            out.append(entry)
        return out

    def peak_bytes(self):
        """This process's high-water mark of allocated bytes on the current
        card (``max_memory_allocated``): the one number the admission reads
        per batch, with no other call into the driver. None where this
        process may not ask."""
        if not cuda_ready():
            return None
        try:
            return torch.cuda.max_memory_allocated()
        except Exception:
            return None  # a sick context: no sample

    def panel(self) -> dict:
        """The /debug/graph payload: graph shape, device samples and the
        lifetime transfer, stage and build tallies."""
        graph = {}
        fn = self._graph_panel_fn
        if fn is not None:
            try:
                graph = fn() or {}
            except Exception:
                graph = {}
        with self._lock:
            transfer = dict(self._transfer_bytes)
            stages = {k: round(v, 6) for k, v in self._stage_seconds.items()}
            compiles = self._compiles
            compile_s = round(self._compile_seconds, 3)
        return {
            "sampled_at": time.time(),
            "graph": graph,
            "devices": self.sample_devices(),
            "transfer_bytes": transfer,
            "stage_seconds": stages,
            "jit_compilations": compiles,
            "jit_compile_seconds": compile_s,
        }


DEVSTATS = DeviceStatsCollector()
