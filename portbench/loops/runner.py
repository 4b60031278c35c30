"""The closed loop that the loop kinds drive: each client sends a request,
waits for its reply, and sends the next."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from .conn import JSON, Conn, sleep_until


def run(plan: dict, t0: float, end: float, deadline: float, prepare, parse,
        max_requests: int = 0, prefetch: bool = False) -> list:
    """Each client of ``plan['clients']`` sends ``prepare(client, i)`` =
    (method, path, body, rows) for i = 0, 1, ... from ``t0`` until ``end``
    (or ``max_requests`` each), and records each reply's answers,
    ``parse(status, data)``. With ``prefetch``, request i + 1 is prepared
    on a thread of its own while request i is in flight."""
    out = []
    lock = threading.Lock()

    def client(cid: int):
        conn = Conn(plan["host"], plan["read_port"], timeout=max(1.0, deadline - t0))
        pool = ThreadPoolExecutor(1) if prefetch else None
        try:
            nxt = pool.submit(prepare, cid, 0) if pool else None
            sleep_until(t0)
            i = 0
            while not max_requests or i < max_requests:
                if pool:
                    method, path, body, rows = nxt.result()
                    nxt = pool.submit(prepare, cid, i + 1)
                else:
                    method, path, body, rows = prepare(cid, i)
                send = time.monotonic()
                if send >= end:
                    break
                st, reply = conn.request(method, path, body, JSON if body else None)
                recv = time.monotonic()
                rec = {"client": cid, "i": i, "send": send, "recv": recv, "status": st,
                       "rows": rows, "allowed": parse(st, reply)}
                with lock:
                    out.append(rec)
                i += 1
        finally:
            conn.close()
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in plan["clients"]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def warm(plan: dict, prepare, parse, n: int) -> None:
    """``n`` requests from each client, one after another; raises on one
    with no valid answer."""
    now = time.monotonic()
    recs = run(plan, now, float("inf"), now + 120.0, prepare, parse, max_requests=n)
    bad = [r["status"] for r in recs if len(r["allowed"]) != r["rows"]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(recs)} requests got no answer, "
                           f"statuses {sorted(set(bad))}")
