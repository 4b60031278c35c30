"""Sampling profiler: stdlib-only wall-clock stack sampling (counterpart of
``keto_tpu/telemetry/profiler.py``).

A daemon thread wakes at a configurable rate, snapshots every thread's
frame via ``sys._current_frames()``, and folds each stack into
``module:function;module:function;...`` keys with hit counts — the
"folded stacks" format flamegraph tooling consumes directly
(``tools/flame.py`` renders it standalone). This answers the question
spans can't: where the *Python interpreter* spends its time between the
instrumented boundaries (serialization loops, vocab probes, lock waits).

Design constraints:

- stdlib only (the runtime image has no py-spy/pyinstrument);
- safe to leave on in production: sampling happens on the profiler's
  own thread, never interrupts serving threads, and the fold table is
  bounded (``max_stacks``; overflow lands in a ``[truncated]`` bucket);
- honest about cost: the profiler measures its own sampling time and
  reports ``self_overhead`` (sampling seconds / elapsed wall seconds).

The folded keys trim each frame's file to the part from the last
``keto_tpu_torch/``, and ``_SELF_MODULES`` names this module by that path,
so the sampler never appears in its own flamegraph.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

# frames whose module starts with one of these are the profiler looking
# at itself; skipping them keeps the flamegraph about the serving stack
_SELF_MODULES = ("keto_tpu_torch/telemetry/profiler",)


def _fold_frame(frame) -> str:
    code = frame.f_code
    mod = code.co_filename
    # trim to a stable, readable module path: everything from the last
    # "keto_tpu_torch/" (or the basename for stdlib/third-party frames)
    i = mod.rfind("keto_tpu_torch/")
    if i >= 0:
        mod = mod[i:]
    else:
        mod = mod.rsplit("/", 1)[-1]
    if mod.endswith(".py"):
        mod = mod[:-3]
    return f"{mod}:{code.co_name}"


class SamplingProfiler:
    """Background wall-clock sampler producing folded stacks.

    ``start``/``stop`` manage the daemon thread; ``folded`` returns the
    current fold table (stack -> samples); ``snapshot`` is the
    ``/debug/pprof`` payload with stats and a flamegraph-ready tree."""

    def __init__(
        self,
        hz: float = 67.0,
        max_stacks: int = 10_000,
        clock=time.perf_counter,
    ):
        # 67 Hz, not 100: a deliberately off-round rate so the sampler
        # doesn't phase-lock with 10ms-periodic work and systematically
        # over/under-count it
        self.hz = max(1.0, min(1000.0, float(hz)))
        self.max_stacks = int(max_stacks)
        self._clock = clock
        self._lock = threading.Lock()
        self._folded: dict[str, int] = {}
        self._samples = 0
        self._truncated = 0
        self._sampling_s = 0.0  # time spent inside _sample_once
        self._started_at: Optional[float] = None
        self._elapsed_before = 0.0  # wall accumulated across start/stop
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._started_at = self._clock()
        self._thread = threading.Thread(
            target=self._run, name="sampling-profiler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=timeout_s)
        self._thread = None
        if self._started_at is not None:
            self._elapsed_before += self._clock() - self._started_at
            self._started_at = None

    def reset(self) -> None:
        with self._lock:
            self._folded.clear()
            self._samples = 0
            self._truncated = 0
            self._sampling_s = 0.0
            self._elapsed_before = 0.0
            if self._started_at is not None:
                self._started_at = self._clock()

    # -- sampling -----------------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            self._sample_once()

    def _sample_once(self) -> None:
        t0 = self._clock()
        me = threading.get_ident()
        names = {
            t.ident: t.name for t in threading.enumerate() if t.ident
        }
        # sys._current_frames() is a point-in-time copy of every
        # thread's top frame — the GIL makes it consistent enough for
        # statistical profiling without stopping the world
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            parts = []
            depth = 0
            f = frame
            while f is not None and depth < 64:
                parts.append(_fold_frame(f))
                f = f.f_back
                depth += 1
            parts.reverse()
            if parts and any(
                parts[-1].startswith(m) for m in _SELF_MODULES
            ):
                continue
            thread_name = names.get(ident, f"thread-{ident}")
            key = f"{thread_name};" + ";".join(parts)
            with self._lock:
                self._samples += 1
                if key in self._folded:
                    self._folded[key] += 1
                elif len(self._folded) < self.max_stacks:
                    self._folded[key] = 1
                else:
                    self._truncated += 1
                    self._folded["[truncated]"] = (
                        self._folded.get("[truncated]", 0) + 1
                    )
        dt = self._clock() - t0
        with self._lock:
            self._sampling_s += dt

    # -- readout ------------------------------------------------------------

    def _elapsed(self) -> float:
        elapsed = self._elapsed_before
        if self._started_at is not None:
            elapsed += self._clock() - self._started_at
        return elapsed

    def self_overhead(self) -> float:
        """Fraction of wall time the sampler itself consumed."""
        elapsed = self._elapsed()
        if elapsed <= 0:
            return 0.0
        with self._lock:
            return self._sampling_s / elapsed

    def folded(self) -> dict[str, int]:
        with self._lock:
            return dict(self._folded)

    def folded_text(self) -> str:
        """The classic folded-stacks text format: one
        ``stack;frames;... count`` line per unique stack, sorted by
        count descending — pipeable into any flamegraph renderer."""
        folds = self.folded()
        lines = [
            f"{stack} {count}"
            for stack, count in sorted(
                folds.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def tree(self) -> dict:
        """Flamegraph-ready nested tree: {name, value, children:[...]}.
        Value of a node = samples in its subtree."""
        root: dict = {"name": "all", "value": 0, "children": {}}
        for stack, count in self.folded().items():
            root["value"] += count
            node = root
            for part in stack.split(";"):
                child = node["children"].get(part)
                if child is None:
                    child = {"name": part, "value": 0, "children": {}}
                    node["children"][part] = child
                child["value"] += count
                node = child

        def materialize(node: dict) -> dict:
            return {
                "name": node["name"],
                "value": node["value"],
                "children": [
                    materialize(c)
                    for c in sorted(
                        node["children"].values(),
                        key=lambda c: -c["value"],
                    )
                ],
            }

        return materialize(root)

    def snapshot(self) -> dict:
        with self._lock:
            samples = self._samples
            truncated = self._truncated
            sampling_s = self._sampling_s
            unique = len(self._folded)
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": samples,
            "unique_stacks": unique,
            "truncated_stacks": truncated,
            "elapsed_s": round(self._elapsed(), 3),
            "sampling_s": round(sampling_s, 6),
            "self_overhead": round(self.self_overhead(), 6),
        }
