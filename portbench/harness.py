"""One run of one cell: generate the graph from the seed and start the
client processes, which load their plans while the program boots on the
graph; warm every shape up (all of that is set-up), open the window at
one instant for every client, collect, read the device's peak memory,
stop the program, judge the answers against the reference, and reduce
everything to the cell's metrics. What a loop kind does is its module's
(``loops/<loop>.py``); nothing here branches on it."""

from __future__ import annotations

import gc
import importlib.util
import json
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from . import judge as judging
from . import loops
from .graph import generate, load_json, rng_for
from .reference import SetGraph
from .roofline import graph_counts
from .system import System
from .trace import SubWindow
from .traffic import STREAM_JUDGE, STREAM_ROWS, RowSampler

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
HOST = "127.0.0.1"
START_GAP_S = 0.25  # from the last client's ready to the window's start


class Run:
    """What one run recorded; the metric readers (``metrics/*.py``) read it."""

    def __init__(self, **kw):
        self.requests = None  # one record per request (``loops/__init__.py``)
        self.trace = None
        self.window = None  # program counters at the window's edges
        self.roofline = None
        self.__dict__.update(kw)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: end to end with ``trace`` off,
    per layer with it on."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class _Clients:
    """The client processes. Each gets the shared plan and its own part
    from a thread of its own, so that the program boots meanwhile."""

    def __init__(self):
        self.procs: list = []
        self._feeds: list = []
        self.error = None

    def start(self, shared: bytes, own: dict) -> None:
        p = subprocess.Popen([sys.executable, "-m", "portbench.loops.client"],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO)
        self.procs.append(p)
        th = threading.Thread(target=self._feed, daemon=True,
                              args=(p, shared, pickle.dumps(own, protocol=pickle.HIGHEST_PROTOCOL)))
        th.start()
        self._feeds.append(th)

    def _feed(self, p, shared: bytes, own: bytes) -> None:
        try:
            p.stdin.write(shared)
            p.stdin.write(own)
            p.stdin.flush()
        except OSError as e:
            self.error = e

    def serve(self, ports: dict) -> None:
        """Hands every client the program's ports, once it serves."""
        for th in self._feeds:
            th.join()
        if self.error is not None:
            raise RuntimeError(f"a client did not take its plan: {self.error}")
        line = (json.dumps(ports) + "\n").encode()
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()

    def wait_ready(self) -> None:
        for p in self.procs:
            line = p.stdout.readline()
            if line.strip() != b"ready":
                raise RuntimeError(f"a client failed its warm-up (exit {p.wait()})")

    def go(self, t0: float) -> None:
        for p in self.procs:
            p.stdin.write(f"{t0!r}\n".encode())
            p.stdin.flush()
            p.stdin.close()
            p.stdin = None  # communicate() below must not touch it

    def results(self, timeout: float) -> list:
        out = []
        for p in self.procs:
            data, _ = p.communicate(timeout=max(1.0, timeout - time.monotonic()))
            if p.returncode != 0:
                raise RuntimeError(f"a client exited {p.returncode}")
            out.extend(pickle.loads(data))
        return out

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


class _MemorySampler:
    """The card's reserved bytes, sampled: the allocator's own peak is
    reset by the program's memory admission windows."""

    def __init__(self, device):
        self.peak = 0
        self.device = device
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import torch

        while not self._stop.is_set():
            self.peak = max(self.peak, int(torch.cuda.memory_reserved(self.device)))
            self._stop.wait(0.25)

    def start(self):
        self._thread.start()

    def read(self) -> int:
        import torch

        self._stop.set()
        self._thread.join()
        return max(self.peak, int(torch.cuda.max_memory_reserved(self.device)),
                   int(torch.cuda.memory_reserved(self.device)))


def _at(t: float, fn, box: list):
    def run():
        time.sleep(max(0.0, t - time.monotonic()))
        box.append(fn())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None, t_start: float = None,
             log=print, config: dict = None, traffic: dict = None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict.
    ``overrides``: dotted program keys set over the configuration's (the
    control runs); ``config``/``traffic``: in place of the cell's files
    (the tests' small sizes)."""
    t_start = time.monotonic() if t_start is None else t_start
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = config or load_json(REPO / next(c["file"] for c in bench["configs"]
                                          if c["name"] == cell["config"]))
    traffic = traffic or load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    loop = loops.load(traffic["loop"])
    depth = int(cfg["program"]["serve"]["read"]["max-depth"])
    grace = float(traffic["grace_seconds"])
    on_card = device != "cpu"

    phases = {}
    mark = [time.monotonic()]

    def phase(name: str) -> None:
        now = time.monotonic()
        phases[name] = now - mark[0]
        mark[0] = now

    phase("start")
    graph = generate(cfg, seed)
    layout = graph.layout
    phase("generate")
    sampler = RowSampler(graph, cfg["check"], traffic["rows"])
    shared = pickle.dumps({"host": HOST, "layout": layout, "sampler": sampler, "seed": seed,
                           "traffic": traffic, "seconds": seconds, "grace": grace},
                          protocol=pickle.HIGHEST_PROTOCOL)
    phase("traffic")
    clients = _Clients()
    memory = _MemorySampler(0) if on_card else None
    system = None
    sub = None
    try:
        for own in loop.client_plans(traffic):
            clients.start(shared, own)
        del shared
        system = System(cfg["program"], device, overrides)
        src_keys, dst_keys = layout.keys(graph.src), layout.keys(graph.dst)
        phase("keys")
        system.boot(src_keys, dst_keys)
        del src_keys, dst_keys
        phase("boot")
        clients.serve({"read_port": system.read_port, "write_port": system.write_port})
        clients.wait_ready()
        phase("warmup")
        log("portbench: set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
            + f"; ingest {system.ingest_s:.3f}, start_all {system.start_all_s:.3f}")
        if memory is not None:
            memory.start()
        if trace:
            # the profiler starts before the window: it takes seconds
            length = float(traffic["trace_seconds"])
            sub = SubWindow(0.0, length, Path(tempfile.gettempdir()), system.counters)
            sub.open()
        t0 = time.monotonic() + START_GAP_S
        end = t0 + seconds
        setup_s = t0 - t_start
        edges: list = []
        timers = [_at(t0, system.counters, edges), _at(end, system.counters, edges)]
        if sub is not None:
            sub.start_t = t0 + (seconds - sub.length) / 2
        clients.go(t0)
        if sub is not None:
            sub.run()
        requests = clients.results(end + grace + 30.0)
        for th in timers:
            th.join()
        if sub is not None:
            sub.finish()
        peak = memory.read() if memory is not None else 0
    finally:
        clients.stop()
        if system is not None:
            system_counts = (system.ingest_s, system.start_all_s)
            system.stop()
    del system
    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()

    run = Run(seconds=seconds, t0=t0, end=end, deadline=end + grace, requests=requests,
              setup={"setup_s": setup_s, "ingest_s": system_counts[0],
                     "start_all_s": system_counts[1]},
              window=tuple(sorted(edges, key=lambda c: c["t"])))

    def rows_of(rec: dict):
        return loop.request_rows(sampler, seed, traffic, STREAM_ROWS, rec["client"], rec["i"])

    if sub is not None:
        if sub.error:
            log(f"portbench: the traced sub-window failed: {sub.error}")
        else:
            log(f"portbench: profiler started in {sub.open_s:.3f} s; the sub-window opened "
                f"{sub.result.get('late_s', 0.0) * 1e3:.3f} ms late, busy "
                f"{sub.result['busy_s']:.6f} of {sub.result['window_s']:.6f} s")
        run.trace = sub.result or None
        if run.trace:
            # the traced run's layer numbers come from the profiled
            # sub-window alone
            run.window = run.trace["counters"]
        if requests:  # B2's bytes: the graph's real rows and one request's probes
            _, targets = rows_of(requests[0])
            run.roofline = {**graph_counts(graph.src, graph.dst, targets), "rows": len(targets)}

    # -- correctness, after the program's state is freed ------------------
    t_judge = time.monotonic()
    ref = SetGraph(layout.n_nodes, graph.src, graph.dst, layout.is_set(np.arange(layout.n_nodes)))
    counts, attempted, failed, judged = judging.judge_run(
        ref, depth, rng_for(seed, STREAM_JUDGE), int(traffic["judge_rows"]), requests, rows_of)
    correct, compared = judging.verdict(counts)
    if judged == 0:
        correct = False
    log(f"portbench: judged {judged} answers against the reference in "
        f"{time.monotonic() - t_judge:.3f} s")

    # -- metrics -------------------------------------------------------------
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": _device_kind(on_card),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace and run.trace:
        dev["busy_s"] = float(run.trace["busy_s"])
        dev["window_s"] = float(run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    log(f"portbench: {traffic['loop']}: {len(requests)} requests, "
        f"{sum(r['rows'] for r in requests)} rows")
    out["compared"] = compared
    return out


def _device_kind(on_card: bool) -> str:
    if not on_card:
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)
