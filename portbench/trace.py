"""The traced run's device view: ``torch.profiler`` over a sub-window in the
middle of the measured window (a whole window of a server is a trace too
large to read back), a sampler of the host's Python stacks beside it, and
the reduction of both to device busy time, time per kernel name, and idle
gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from collections import Counter
from pathlib import Path

from .loops.conn import sleep_until

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_START, MARK_END = "portbench.subwindow.start", "portbench.subwindow.end"
SAMPLE_S = 0.01
# a thread whose innermost Python frame is in one of these is waiting
IDLE_FILES = {"threading.py", "queue.py", "selectors.py", "socket.py", "socketserver.py",
              "ssl.py", "subprocess.py", "conn.py", "trace.py", "harness.py"}


def _label(frame):
    """The innermost frame of the program in a thread's stack, as
    ``keto_tpu_torch/<module>:<function>``; None for a thread that runs no
    program code."""
    f = frame
    while f is not None:
        name = f.f_code.co_filename
        if "keto_tpu_torch" in name:
            rel = name[name.rindex("keto_tpu_torch"):].replace(os.sep, "/")
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return None


class StackSampler:
    """Every SAMPLE_S, the labels of the threads that are not waiting."""

    def __init__(self):
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.is_set():
            t = time.monotonic()
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                if os.path.basename(frame.f_code.co_filename) in IDLE_FILES:
                    continue
                if frame.f_code.co_name == "_worker":  # an idle executor thread
                    continue
                label = _label(frame)
                if label is not None:
                    labels.append(label)
            self.samples.append((t, labels))
            self._stop.wait(SAMPLE_S)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(doc: dict, mark_mono: tuple, length_s: float, samples: list) -> dict:
    """Device busy seconds, per-kernel [count, seconds], the top device
    ops and the idle gaps by host label, over the sub-window between the
    two marks (trace microseconds)."""
    events = doc.get("traceEvents", [])
    marks = {e["name"]: e["ts"] for e in events if e.get("name") in (MARK_START, MARK_END)}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if MARK_START in marks and MARK_END in marks:
        lo, hi = float(marks[MARK_START]), float(marks[MARK_END])
    elif dev:
        lo = min(float(e["ts"]) for e in dev)
        hi = lo + length_s * 1e6
    else:
        return {"busy_s": 0.0, "window_s": length_s, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    kernels: dict = {}
    spans = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    # idle time by what the host was doing: each stack sample that falls
    # in an idle gap votes for the program functions running at that
    # instant, and the idle seconds are shared out by the votes
    gaps = []
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle_s = sum(b - a for a, b in gaps) / 1e6
    starts = [a for a, _ in gaps]
    votes: Counter = Counter()
    for t, labels in samples:
        us = lo + (t - mark_mono[0]) * 1e6
        i = bisect.bisect_right(starts, us) - 1
        if i < 0 or us >= gaps[i][1]:
            continue
        if not labels:
            votes["no program thread running"] += 1.0
        for label in labels:
            votes[label] += 1.0 / len(labels)
    total = sum(votes.values())
    by_label = {k: idle_s * v / total for k, v in votes.items()} if total else {}
    top_ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e6, "kernels": kernels,
            "device_ops": [[n[:200], s] for n, s in top_ops],
            "idle_gaps": [[n[:200], v] for n, v in
                          sorted(by_label.items(), key=lambda x: -x[1])[:10]]}


def _all_threads():
    """Record every thread's launches: the program launches its kernels
    from its own threads, not from the one that starts the profiler."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class SubWindow:
    """Profiles [start, start + length] (``time.monotonic``): ``open`` starts
    the profiler (seconds on the card's machine, so before the window),
    ``run`` marks the sub-window, ``finish`` stops and reads the profiler
    after the window. All three are called from the main thread, where
    the profiler registers. ``counters`` reads the program's counters at
    the sub-window's edges."""

    def __init__(self, start: float, length: float, workdir: Path, counters):
        self.start_t, self.length = start, length
        self.workdir = workdir
        self.counters = counters
        self.result: dict = {}
        self.error = None
        self.prof = None
        self.open_s = 0.0
        self.sampler = None
        self.m0 = self.m1 = 0.0
        self.before = self.after = None

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        t = time.monotonic()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            experimental_config=_all_threads())
        self.prof.start()
        self.open_s = time.monotonic() - t

    def run(self) -> None:
        """Marks the sub-window and samples the host's stacks through it."""
        try:
            self._mark()
        except Exception as e:  # the run reports the metrics as missing
            self.error = f"{type(e).__name__}: {e}"

    def _mark(self):
        from torch.profiler import record_function

        sleep_until(self.start_t)
        self.sampler = StackSampler()
        with record_function(MARK_START):
            self.m0 = time.monotonic()
        self.before = self.counters()
        self.sampler.start()
        sleep_until(self.m0 + self.length)
        self.sampler.stop()
        self.after = self.counters()
        with record_function(MARK_END):
            self.m1 = time.monotonic()

    def finish(self) -> None:
        """Stops the profiler and reduces its trace: called once the window
        has closed, since stopping and exporting hold the interpreter for
        seconds."""
        import torch

        prof, self.prof = self.prof, None
        if prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if self.error:
            return
        path = self.workdir / f"trace-{os.getpid()}.json"
        try:
            prof.export_chrome_trace(str(path))
            with open(path) as f:
                doc = json.load(f)
        finally:
            if path.exists():
                path.unlink()
        self.result = reduce_trace(doc, (self.m0, self.m1), self.m1 - self.m0,
                                   self.sampler.samples)
        self.result["counters"] = (self.before, self.after)
        self.result["late_s"] = self.m0 - self.start_t
