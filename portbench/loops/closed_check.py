"""Single checks in a closed loop: ``connections`` callers, spread over
``procs`` processes, each sending one ``GET /check``, waiting for its
reply, and sending the next. Caller ``c`` takes its rows in chunks of
CHUNK_ROWS, chunk ``k`` drawn by ``rng_for(seed, stream, c, k)``, so that
every chunk holds the traffic's exact shares of rows."""

from __future__ import annotations

import functools

import numpy as np

from ..graph import rng_for
from ..traffic import STREAM_ROWS, STREAM_WARM, check_path
from . import runner
from .conn import check_answer

CHUNK_ROWS = 256


def client_plans(traffic: dict) -> list:
    n, procs = int(traffic["connections"]), int(traffic["procs"])
    return [{"clients": list(range(p, n, procs))} for p in range(procs)]


def _chunk(sampler, seed: int, stream: int, client: int, k: int):
    return sampler.draw(rng_for(seed, stream, client, k), CHUNK_ROWS)


_chunk_again = functools.lru_cache(maxsize=8)(_chunk)


def request_rows(sampler, seed: int, traffic: dict, stream: int, client: int, i: int):
    k, j = divmod(i, CHUNK_ROWS)
    s, t = _chunk_again(sampler, seed, stream, client, k)
    return s[j:j + 1], t[j:j + 1]


def answer(status: int, data: bytes) -> np.ndarray:
    a = check_answer(status, data)
    return np.array([a] if a >= 0 else [], dtype=np.int8)


def _prepare(plan: dict, stream: int):
    paths: dict = {}  # caller -> (chunk, its request paths); one thread a caller

    def prepare(c: int, i: int):
        k, j = divmod(i, CHUNK_ROWS)
        got = paths.get(c)
        if got is None or got[0] != k:
            s, t = _chunk(plan["sampler"], plan["seed"], stream, c, k)
            got = paths[c] = (k, [check_path(plan["layout"], int(a), int(b))
                                  for a, b in zip(s, t)])
        return "GET", got[1][j], None, 1

    return prepare


def warm(plan: dict) -> None:
    runner.warm(plan, _prepare(plan, STREAM_WARM), answer,
                int(plan["traffic"]["warmup_requests"]))


def run(plan: dict, t0: float, end: float, deadline: float) -> list:
    return runner.run(plan, t0, end, deadline, _prepare(plan, STREAM_ROWS), answer)
