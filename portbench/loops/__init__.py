"""The load generators, one module per loop kind, found by the ``loop``
name of a traffic file: ``"loop": "closed_batch"`` is
``loops/closed_batch.py``. They run in separate processes (``client.py``)
and speak raw HTTP over keep-alive connections (``conn.py``).

A loop module has:

- ``client_plans(traffic) -> list[dict]``, in the harness: each client
  process's own part of its plan (the rest, shared by all, is the row
  sampler, the seed, the traffic and the window);
- ``warm(plan)`` and ``run(plan, t0, end, deadline) -> list[dict]``, in a
  client process: the warm-up, which raises ``RuntimeError`` on a request
  with no valid answer, and the window;
- ``request_rows(sampler, seed, traffic, stream, client, i)``, in the
  harness: the (starts, targets) rows of request ``i`` of ``client``,
  drawn again to judge its answers.

Every loop records each request alike, and the metric readers and the
judge read nothing else: ``client``, ``i``, ``send`` and ``recv``
(``time.monotonic()``, which every process on the host shares),
``status``, ``rows`` (the rows the request carried) and ``allowed`` (its
answers as int8; empty where it got no valid answer).
"""

import importlib


def load(name: str):
    """The loop module of a traffic file's ``loop``."""
    return importlib.import_module(f"{__name__}.{name}")
