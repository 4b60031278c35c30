"""Bulk checks in a closed loop: ``clients`` callers, spread over
``procs`` processes, each sending one columnar ``POST /check/batch`` of
``batch_rows`` rows, waiting for its reply, and sending the next. Client
``c``'s request ``i`` holds the rows that ``rng_for(seed, stream, c, i)``
draws; the next body is built while a request is in flight."""

from __future__ import annotations

import json

import numpy as np

from ..graph import rng_for
from ..traffic import STREAM_ROWS, STREAM_WARM, columnar_body
from . import runner


def client_plans(traffic: dict) -> list:
    n, procs = int(traffic["clients"]), int(traffic["procs"])
    return [{"clients": list(range(p, n, procs))} for p in range(procs)]


def request_rows(sampler, seed: int, traffic: dict, stream: int, client: int, i: int):
    return sampler.draw(rng_for(seed, stream, client, i), int(traffic["batch_rows"]))


def answers(status: int, data: bytes) -> np.ndarray:
    """The reply's allowed column as int8, or an empty array."""
    if status != 200:
        return np.zeros(0, dtype=np.int8)
    try:
        col = json.loads(data)["allowed"]
    except (ValueError, KeyError, TypeError):
        return np.zeros(0, dtype=np.int8)
    if not all(isinstance(v, bool) for v in col):
        return np.zeros(0, dtype=np.int8)
    return np.array(col, dtype=np.int8)


def _prepare(plan: dict, stream: int):
    def prepare(c: int, i: int):
        s, t = request_rows(plan["sampler"], plan["seed"], plan["traffic"], stream, c, i)
        body = json.dumps(columnar_body(plan["layout"], s, t)).encode()
        return "POST", "/check/batch", body, len(s)

    return prepare


def warm(plan: dict) -> None:
    runner.warm(plan, _prepare(plan, STREAM_WARM), answers,
                int(plan["traffic"]["warmup_batches"]))


def run(plan: dict, t0: float, end: float, deadline: float) -> list:
    return runner.run(plan, t0, end, deadline, _prepare(plan, STREAM_ROWS), answers,
                      prefetch=True)
