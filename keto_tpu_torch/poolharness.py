"""A read-replica pool server run in an interpreter of its own, and the
side that drives it.

``ReplicaPool`` (``driver/replicas.py``) forks its replicas from the process
that calls ``start_all``, and its fork inventory refuses a process that
holds other threads. A test or a smoke run that drives a pool therefore
starts the server in a fresh interpreter. The server prints one JSON
document per line, each prefixed ``POOL ``, and answers commands read from
its stdin, one per line (``serve_commands``); ``PoolProcess`` is the side
that starts it and asks. The server, its zygote and its replicas share one
process group, so ``PoolProcess.kill_group`` ends all of them.

``client_main`` is one client process of a timed drive: its part (URLs to
GET, with or without headers, or encoded frames to POST) on stdin's first
line, ``ready`` on stdout, the drive from many threads once stdin's next
line comes, then its results with the drive's start and end on the
monotonic clock.

Standard library only (with ``utils/urlfetch.py``, the drive's one
request helper), so that a ``keto_tpu`` pool server (the reference
in the parity tests) can use it without importing torch, and a drive's
client processes start without it (the frame drive's decoder imports
numpy).
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from .utils.urlfetch import fetch

PREFIX = "POOL "


def emit(doc: dict) -> None:
    """Print `doc` as one POOL line."""
    print(PREFIX + json.dumps(doc), flush=True)


def live_pids(pids) -> list[int]:
    """The pids that name a live process: os.kill(pid, 0) finds it, and
    /proc, where it can be read, does not call it a zombie."""
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X"):
                    continue
        except OSError:
            pass  # nothing to read: os.kill found the process
        out.append(pid)
    return out


def count_ring_frames(server) -> Callable[[], int]:
    """Count the encoded frames a wire server's parent answers for its wire
    workers. ``server`` is a started ``RingServer`` of either package, or
    None (no wire workers: the count stays 0). Both packages' consumers
    call ``server.handler(frame)`` afresh for every frame they read, so the
    handler is wrapped in place; returns the count's reader."""
    frames = [0]
    if server is None:
        return lambda: 0
    lock = threading.Lock()
    handler = server.handler

    def counting(frame: bytes) -> bytes:
        with lock:
            frames[0] += 1
        return handler(frame)

    server.handler = counting
    return lambda: frames[0]


def serve_commands(
    handlers: dict[str, Callable[[str], dict]], stop: Callable[[], dict]
) -> int:
    """Answer stdin's commands, ``<name> [<argument>]`` one per line, with
    one POOL line each: ``handlers[name](argument)``'s document, or an
    ``error`` document for an unknown name. ``stop`` ends the loop: its
    document is printed and 0 returned. 1 when stdin closes first."""
    for line in sys.stdin:
        name, _, arg = line.strip().partition(" ")
        if name == "stop":
            emit(stop())
            return 0
        handler = handlers.get(name)
        emit(handler(arg) if handler else {"error": f"unknown command {name!r}"})
    return 1


class PoolProcess:
    """One pool server process: its stdout and stderr as ``lines``, its
    POOL documents in order, and commands written to its stdin."""

    def __init__(self, argv: Sequence[str], cwd: Optional[str] = None,
                 name: str = "pool server", env: Optional[dict] = None):
        self.name = name
        self.proc = subprocess.Popen(
            list(argv), cwd=cwd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True, env=env,
        )
        self.lines: list[str] = []
        self._docs: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.stopped = False

    def _read(self) -> None:
        decoder = json.JSONDecoder()
        for line in self.proc.stdout:
            self.lines.append(line)
            # the server's stderr shares the pipe: a write of another
            # stream may land in a document's line, before or after it
            at = line.find(PREFIX)
            if at < 0:
                continue
            try:
                doc, _ = decoder.raw_decode(line, at + len(PREFIX))
            except ValueError:
                continue  # not a document; kept in lines
            self._docs.put(doc)

    def next_doc(self, timeout: float) -> dict:
        """The next POOL document; RuntimeError with the server's last lines
        when none comes within `timeout` seconds."""
        try:
            return self._docs.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(
                f"{self.name} said nothing in {timeout}s (rc {self.proc.poll()}): "
                + "".join(self.lines[-40:])
            ) from None

    def ask(self, cmd: str, timeout: float = 120.0) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.next_doc(timeout)

    def stop(self, timeout: float = 120.0) -> dict:
        """Ask the server to stop and wait for it to exit; its last document."""
        self.stopped = True
        doc = self.ask("stop", timeout)
        self.proc.wait(timeout=timeout)
        return doc

    def kill_group(self) -> None:
        """SIGKILL the server's process group (a failure's backstop)."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)


def client_main() -> None:
    """One client process of a drive (see the module docstring). Each GET
    answers (status, seconds), with headers (status, seconds, Retry-After),
    and each frame (status, seconds, the answer bits or "")."""
    req = json.loads(sys.stdin.readline())
    # one opener for every thread: urlopen builds its own on first use, and
    # 64 threads doing so at once parse the CA bundle 64 times
    urllib.request.install_opener(urllib.request.build_opener())

    def one(url):
        t0 = time.perf_counter()
        status, body, _ = fetch(url, headers={"Content-Type": "application/json"})
        if body:
            json.loads(body)
        return status, time.perf_counter() - t0

    def one_with(args):
        url, hdrs = args
        t0 = time.perf_counter()
        status, _, headers = fetch(url, headers=hdrs)
        return status, time.perf_counter() - t0, headers.get("Retry-After")

    def one_frame(frame_hex):
        body = bytes.fromhex(frame_hex)
        t0 = time.perf_counter()
        status, raw, _ = fetch(f"{req['read'].rstrip('/')}/check/batch-encoded", body,
                               {"Content-Type": "application/octet-stream"})
        sec = time.perf_counter() - t0
        bits = ""
        if status == 200:
            bits = "".join("1" if v else "0" for v in decode_check_response(raw)[0])
        return status, sec, bits

    if req.get("frames") is not None:
        from .api.wirecodec import decode_check_response

    with ThreadPoolExecutor(req["clients"]) as pool:
        print("ready", flush=True)
        sys.stdin.readline()
        start = time.monotonic()
        if req.get("frames") is not None:
            results = list(pool.map(one_frame, req["frames"]))
        elif req.get("headers") is None:
            results = list(pool.map(one, req["urls"]))
        else:
            results = list(pool.map(one_with, zip(req["urls"], req["headers"])))
        end = time.monotonic()
    json.dump({"results": results, "start": start, "end": end}, sys.stdout)
