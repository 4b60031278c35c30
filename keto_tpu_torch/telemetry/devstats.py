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
- ``peak_bytes_in_use`` the process's high-water mark: the larger of
  ``torch.cuda.max_memory_allocated()`` and every mark folded in before a
  peak window reset it (see below), so the reported mark never falls;
- ``bytes_reserved``    ``torch.cuda.memory_reserved()`` (the caching
  allocator's hold, which has no JAX counterpart).

A process samples only when it has initialised CUDA itself: a forked read
replica inherits the parent's ``torch`` state but may not touch the card
("Cannot re-initialize CUDA in forked subprocess"), and a CPU process has
no card. Those get no device entries, which ``HbmAdmission`` reads as
"admission off", as the reference does on a CPU backend.

Per-batch peak windows (``window_enter``/``window_exit``): HBM admission
learns a batch's bytes from the allocator's peak over the batch, not from a
rise of the process's high-water mark, which an earlier, larger peak hides
for good. The first batch to enter while no other is in flight folds the
mark into the running maximum and resets the allocator's peak
(``torch.cuda.reset_peak_memory_stats``); batches that enter while the
window is open share it. Each batch keeps its own entry: the bytes in use
and the allocator's cumulative allocated and freed bytes at that moment.
Its charge at exit is the smaller of two bounds on its own rise:

- the window's peak over its own entry's bytes in use, plus every byte
  freed since it entered (a neighbour's or any other free while it is in
  flight can only have offset its own bytes by that much);
- every byte allocated since it entered (its own allocations are among
  them).

Each bound is at least the batch's own rise, so the charge is never an
underestimate; a neighbour's allocations and the batch's own frees make it
an overestimate, which is safe. The window is one per process, because the
allocator's peak is: a reader of ``max_memory_allocated`` in such a process
sees the current window only, so reports read :meth:`peak_bytes`, and a
report of one span resets through :meth:`reset_peak`.

Kernel builds replace JAX's compilation events: ``utils/kernels.py`` calls
:meth:`DeviceStatsCollector.record_compile` with each nvcc build's seconds
and ``native/`` with the gcc build's, so ``keto_device_jit_compilations_total``
counts nvcc and gcc builds here, not ``jax.monitoring`` events.

Device waits (``wait(site)``): every host<->device synchronisation of the
check path (``engine/device.py``, ``ops/packed.py``, ``ops/frontier.py``)
runs inside ``DEVSTATS.wait(site)``, a context manager that times the
block on ``time.perf_counter`` and adds it to
``keto_device_syncs_total{site}`` and ``keto_device_sync_seconds_total
{site}``. On a thread with an ambient request ledger it also charges the
host time since the ledger's last mark to ``launch``, the block to
``kernel``, and the site to the ledger's ``waits``. While a torch profiler records, the block is a
``device.wait:<site>`` range in the trace. The sites:

- ``device.upload``  the three blocking uploads of a batch's start,
  target and depth columns (``launch_encoded``);
- ``packed.loop``    the packed check's native loop on the card, one call
  into the kernel library that waits on the card once a step;
- ``packed.row_ptr`` the packed Python loop's row-pointer tail upload;
- ``packed.bits``    ``_bits``'s upload, once for the initial frontier and
  once per step of the Python loop;
- ``packed.done``    the Python loop's ``done.all()`` read, once per loop
  test;
- ``frontier.done``  the same read in the dense and scatter loops;
- ``device.decode``  the copy of the answers back to the host.

The counters are the port's own: the reference's JAX dispatch has no
such sites. Reading them: a 4 096-row packed batch on the card makes 5
syncs (18 in the Python loop at max-depth 5, whose count climbs with the
steps a loop runs);
the seconds are the host blocked on the card, which includes the card
running other request threads' work on the shared stream. The pipelined
batcher's stage threads, which carry no request ledger, count here too.
``/debug/attribution`` carries the same tally summed over the requests it
recorded, as ``device_waits: {site: {count, seconds}}``.

Packed loops (``record_packed_loop(path, passes)``): each packed check
adds one to ``keto_packed_loops_total{path}`` and its B2 passes to
``keto_packed_passes_total{path}``, ``path`` being ``native`` (the one
call on the card) or ``python`` (the CPU loop, or a caller's own pass
function), so a scrape shows which loop serves and how many passes a loop
runs. Port-only, like the sync families.

``bind`` exports the collector through a ``MetricsRegistry`` (the
reference's families, letter for letter, and the four above): the
transfer, stage and build counters, ``keto_device_count``, the
``keto_device_hbm_*`` gauges and the ``keto_graph_*`` panel gauges.
Every device sample goes through
:func:`cuda_ready` and :meth:`sample_devices`, so a forked host-mode replica
that is scraped never touches CUDA: its device gauges read 0.
``keto_device_hbm_peak_bytes`` reads :meth:`peak_bytes`, the running
maximum, never ``max_memory_allocated``, which the peak windows reset. The
``device`` label is the port's platform and index, ``cuda:0`` on the card
(JAX names the same card ``gpu:0``) and ``cpu:0`` for a registry on the CPU,
as the reference's CPU backend reads.
"""

from __future__ import annotations

import threading
import time

import torch

from .attribution import add_wait, current_ledger
from .metrics import MetricsRegistry
from .tracing import profiler_range

WAIT_RANGE = "device.wait:"

# memory-statistics key -> (gauge name, help), the reference's families
_HBM_KEYS = (
    ("bytes_in_use", "keto_device_hbm_bytes_in_use",
     "HBM bytes currently allocated on the device"),
    ("bytes_limit", "keto_device_hbm_bytes_limit",
     "HBM allocation limit on the device"),
    ("peak_bytes_in_use", "keto_device_hbm_peak_bytes",
     "peak HBM bytes allocated on the device since process start"),
)

# graph-panel dict key -> (gauge name, help)
_PANEL_GAUGES = (
    ("tuples", "keto_graph_tuples",
     "relation tuples in the live store"),
    ("csr_nnz", "keto_graph_csr_nnz",
     "non-zeros (edges) in the snapshot CSR"),
    ("vocab_size", "keto_graph_vocab_size",
     "node vocabulary size of the live snapshot"),
    ("closure_age_s", "keto_graph_closure_age_seconds",
     "seconds since the serving closure artifact was built"),
    ("snapshot_version", "keto_graph_snapshot_version",
     "store version of the live graph snapshot"),
)


class _Wait:
    """One timed synchronisation (``DeviceStatsCollector.wait``)."""

    __slots__ = ("_stats", "site", "_ledger", "_t0", "_range")

    def __init__(self, stats, site: str):
        self._stats = stats
        self.site = site

    def __enter__(self):
        self._ledger = led = current_ledger()
        self._t0 = t0 = time.perf_counter()
        if led is not None:
            led.mark("launch", t0)
        self._range = profiler_range(WAIT_RANGE + self.site)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        dt = t1 - self._t0
        led = self._ledger
        if led is not None:
            led.mark("kernel", t1)
            add_wait(led.waits, self.site, 1, dt)
        self._stats._record_wait(self.site, dt)
        return False


def cuda_ready() -> bool:
    """Whether this process may ask the CUDA allocator anything: CUDA
    initialised here, not inherited through a fork. A flag test only: it
    calls into no CUDA library, so a forked child stays clean."""
    return torch.cuda.is_initialized()


def _allocator_bytes() -> tuple[float, float, float]:
    """The caching allocator's bytes in use and its cumulative allocated
    and freed bytes on the current card."""
    stats = torch.cuda.memory_stats_as_nested_dict()["allocated_bytes"]["all"]
    return float(stats["current"]), float(stats["allocated"]), float(stats["freed"])


class DeviceStatsCollector:
    def __init__(self):
        self._lock = threading.Lock()
        self._transfer_bytes = {"h2d": 0.0, "d2h": 0.0}
        self._stage_seconds: dict[str, float] = {}
        self._compiles = 0
        self._compile_seconds = 0.0
        self._waits: dict[str, list] = {}  # site -> [count, seconds]
        self._packed_loops: dict[str, list] = {}  # path -> [loops, passes]
        self._graph_panel_fn = None
        # the per-batch peak window: batches inside it, and the high-water
        # marks folded in before each reset: the process's, and the span's
        # since the last ``reset_peak``
        self._window_lock = threading.Lock()
        self._window_depth = 0
        self._hwm = 0.0
        self._span = 0.0
        # metric handles from the most recent bind(); None before any
        self._c_transfer = None
        self._c_kernel = None
        self._c_compiles = None
        self._c_compile_s = None
        self._c_syncs = None
        self._c_sync_s = None
        self._c_loops = None
        self._c_passes = None

    # -- wiring ---------------------------------------------------------------

    def bind(
        self, metrics: MetricsRegistry, graph_panel_fn=None, platform: str = "cuda"
    ) -> None:
        """Export this collector through ``metrics``. Re-entrant: each call
        repoints the exported series at the given registry, replaying the
        tallies so far. ``platform`` is the registry's device type: ``cuda``
        labels one series per card, ``cpu`` one ``cpu:0`` series that reads
        0, as the reference's CPU backend does."""
        if graph_panel_fn is not None:
            self._graph_panel_fn = graph_panel_fn
        self._c_transfer = metrics.counter(
            "keto_device_transfer_bytes_total",
            "host<->device bytes staged by the check engines",
            labelnames=("direction",),
        )
        self._c_kernel = metrics.counter(
            "keto_device_kernel_seconds_total",
            "cumulative wall seconds spent in each check-pipeline stage",
            labelnames=("stage",),
        )
        self._c_compiles = metrics.counter(
            "keto_device_jit_compilations_total",
            "kernel builds (nvcc for the CUDA kernels, gcc for the native "
            "host tier) recorded through DEVSTATS.record_compile",
        )
        self._c_compile_s = metrics.counter(
            "keto_device_compile_seconds_total",
            "cumulative wall seconds spent in kernel builds",
        )
        self._c_syncs = metrics.counter(
            "keto_device_syncs_total",
            "host<->device synchronisations of the check path, by site",
            labelnames=("site",),
        )
        self._c_sync_s = metrics.counter(
            "keto_device_sync_seconds_total",
            "wall seconds the host spent blocked on the device, by site",
            labelnames=("site",),
        )
        self._c_loops = metrics.counter(
            "keto_packed_loops_total",
            "packed check loops run, by path: native (one call into the "
            "kernel library) or python",
            labelnames=("path",),
        )
        self._c_passes = metrics.counter(
            "keto_packed_passes_total",
            "B2 propagation passes run by the packed check loops, by path",
            labelnames=("path",),
        )
        with self._lock:
            for site, (n, secs) in self._waits.items():
                self._c_syncs.labels(site=site).inc(n)
                self._c_sync_s.labels(site=site).inc(secs)
            for path, (loops, passes) in self._packed_loops.items():
                self._c_loops.labels(path=path).inc(loops)
                self._c_passes.labels(path=path).inc(passes)
            for direction, nbytes in self._transfer_bytes.items():
                if nbytes:
                    self._c_transfer.labels(direction=direction).inc(nbytes)
            for stage, secs in self._stage_seconds.items():
                if secs:
                    self._c_kernel.labels(stage=stage).inc(secs)
            if self._compiles:
                self._c_compiles.inc(self._compiles)
            if self._compile_seconds:
                self._c_compile_s.inc(self._compile_seconds)
        cuda = platform == "cuda"
        metrics.gauge(
            "keto_device_count",
            "CUDA devices this process samples (1 for a registry on the CPU)",
            fn=(lambda: float(len(self.sample_devices()))) if cuda else (lambda: 1.0),
        )
        hbm_gauges = [
            metrics.gauge(name, help, labelnames=("device",))
            for _, name, help in _HBM_KEYS
        ]
        # the parent process binds before it forks any replica, and only a
        # process on the card binds cuda; device_count reads no context
        n = torch.cuda.device_count() if cuda else 1
        for i in range(n):
            for (key, _, _), gauge in zip(_HBM_KEYS, hbm_gauges):
                gauge.labels(device=f"{platform}:{i}").set_fn(
                    self._hbm_sampler(i, key) if cuda else (lambda: 0.0)
                )
        for key, name, help in _PANEL_GAUGES:
            metrics.gauge(name, help, fn=self._panel_sampler(key))

    def _hbm_sampler(self, index: int, key: str):
        def sample():
            if key == "peak_bytes_in_use":
                return float(self.peak_bytes() or 0.0)
            for entry in self.sample_devices():
                if entry["id"] == index:
                    return float(entry.get("memory_stats", {}).get(key, 0))
            return 0.0

        return sample

    def _panel_sampler(self, key: str):
        def sample():
            fn = self._graph_panel_fn
            if fn is None:
                return 0.0
            try:
                return float((fn() or {}).get(key) or 0)
            except Exception:
                return 0.0

        return sample

    # -- tally points (called from the engine hot path) -----------------------

    def record_transfer(self, nbytes: int, direction: str = "h2d") -> None:
        with self._lock:
            self._transfer_bytes[direction] = (
                self._transfer_bytes.get(direction, 0.0) + nbytes
            )
        c = self._c_transfer
        if c is not None:
            c.labels(direction=direction).inc(nbytes)

    def record_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stage_seconds[stage] = self._stage_seconds.get(stage, 0.0) + seconds
        c = self._c_kernel
        if c is not None:
            c.labels(stage=stage).inc(seconds)

    def wait(self, site: str) -> _Wait:
        """The context manager around one host<->device synchronisation
        (see the module docstring)."""
        return _Wait(self, site)

    def all_done(self, done, site: str) -> bool:
        """``done.all()`` read back to the host, a loop test of the check
        loops, as the sync ``site``."""
        with self.wait(site):
            return bool(done.all())

    def _record_wait(self, site: str, seconds: float) -> None:
        with self._lock:
            add_wait(self._waits, site, 1, seconds)
        c = self._c_syncs
        if c is not None:
            c.labels(site=site).inc()
            self._c_sync_s.labels(site=site).inc(seconds)

    def record_packed_loop(self, path: str, passes: int) -> None:
        """One packed check loop of ``path`` (native or python) that ran
        ``passes`` B2 passes."""
        with self._lock:
            tally = self._packed_loops.setdefault(path, [0, 0])
            tally[0] += 1
            tally[1] += passes
        c = self._c_loops
        if c is not None:
            c.labels(path=path).inc()
            self._c_passes.labels(path=path).inc(passes)

    def record_compile(self, seconds: float) -> None:
        with self._lock:
            self._compiles += 1
            self._compile_seconds += seconds
        if self._c_compiles is not None:
            self._c_compiles.inc()
        if self._c_compile_s is not None:
            self._c_compile_s.inc(seconds)

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
                    "peak_bytes_in_use": self._mark(torch.cuda.max_memory_allocated(i)),
                    "bytes_reserved": torch.cuda.memory_reserved(i),
                }
            except Exception:
                pass  # a sick context: the entry without its statistics
            out.append(entry)
        return out

    def device_peaks(self):
        """``torch.cuda.max_memory_allocated`` of each CUDA device, in device
        order: the per-shard samples of HBM admission's shard model. The
        current device's is its batch peak window's (the windows reset it);
        another device's is its process high-water mark. None where this
        process may not ask."""
        if not cuda_ready():
            return None
        try:
            return [
                float(torch.cuda.max_memory_allocated(i))
                for i in range(torch.cuda.device_count())
            ]
        except Exception:
            return None  # a sick context: no sample

    def _mark(self, peak: float, span: bool = False) -> float:
        with self._window_lock:
            return max(self._span if span else self._hwm, float(peak))

    def _fold_locked(self) -> None:
        peak = float(torch.cuda.max_memory_allocated())
        self._hwm = max(self._hwm, peak)
        self._span = max(self._span, peak)

    def peak_bytes(self, span: bool = False):
        """This process's high-water mark of allocated bytes on the current
        card: ``max_memory_allocated`` with the marks that peak windows
        reset folded in, so it never falls; with ``span`` the mark since
        the last :meth:`reset_peak`. None where this process may not ask."""
        if not cuda_ready():
            return None
        try:
            return self._mark(torch.cuda.max_memory_allocated(), span)
        except Exception:
            return None  # a sick context: no sample

    def reset_peak(self) -> None:
        """Start a new span for ``peak_bytes(span=True)``: the one reset of
        the allocator's peak outside the windows, which the process mark
        survives. While a batch is in flight the allocator's peak is left
        alone (its charge reads it), so the span also holds that window's
        earlier peak."""
        if not cuda_ready():
            return
        with self._window_lock:
            self._fold_locked()
            self._span = 0.0
            if self._window_depth == 0:
                torch.cuda.reset_peak_memory_stats()

    def window_enter(self):
        """A batch enters the per-batch peak window (see the module
        docstring); returns its entry for :meth:`window_exit`, or None
        where this process may not ask."""
        if not cuda_ready():
            return None
        try:
            with self._window_lock:
                if self._window_depth == 0:
                    self._fold_locked()
                    torch.cuda.reset_peak_memory_stats()
                self._window_depth += 1
                return _allocator_bytes()
        except Exception:
            return None  # a sick context: no window

    def window_exit(self, entry):
        """A batch leaves the window; returns its charge in bytes (see the
        module docstring), or None where this process may not ask."""
        if entry is None or not cuda_ready():
            return None
        try:
            with self._window_lock:
                self._window_depth = max(0, self._window_depth - 1)
                peak = float(torch.cuda.max_memory_allocated())
                in_use, allocated, freed = _allocator_bytes()
            in_use0, allocated0, freed0 = entry
            return min(peak - in_use0 + (freed - freed0), allocated - allocated0)
        except Exception:
            return None

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
