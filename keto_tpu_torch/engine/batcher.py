"""Check-request batching: concurrent requests -> device-wide batches
(counterpart of ``keto_tpu/engine/batcher.py``, serial shape only).

Callers block on ``check()``; one dispatcher thread drains the queue into
``engine.batch_check(requests, depths=...)`` batches of up to ``max_batch``
— taking whatever accumulated while the previous batch ran (the natural
batching window), plus a short fixed window when only one request waits.

The dispatcher is supervised:

- **watchdog**: a dispatcher death fails exactly the batch it held with
  :class:`DispatcherCrashed` (typed, retryable) and restarts the loop;
  queued requests survive for the replacement.
- **bounded queue**: past ``max_queue`` waiting requests the batcher sheds
  load with :class:`BatcherOverloaded` (HTTP 429) instead of growing the
  queue, and everyone's latency, without bound.
- **typed shutdown**: after ``close()`` no caller hangs past the join
  budget; anything still queued or in flight fails with
  :class:`BatcherClosed`.

``min_version`` (the snaptoken) makes the engine catch up first through
``engine.wait_for_version``. The reference's pipelined shape, its result
and encoded-request caches, and its qos, overload, HBM-admission,
telemetry and scrub hooks are not ported yet.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Optional, Sequence

from ..relationtuple.definitions import RelationTuple
from ..utils.errors import (
    DeadlineExceeded,
    ErrInternal,
    ErrResourceExhausted,
    ErrUnavailable,
)


class BatcherClosed(ErrUnavailable):
    """The batcher was shut down."""

    def default_message(self) -> str:
        return "The check batcher is closed (server shutting down)."


class BatcherOverloaded(ErrResourceExhausted):
    """The dispatch queue is full; this request was shed."""

    def default_message(self) -> str:
        return "The check queue is full; retry with backoff."


class DispatcherCrashed(ErrInternal):
    """The dispatcher thread died while this request was in flight; the
    watchdog restarted it. The request was NOT answered — retryable."""

    def default_message(self) -> str:
        return "The check dispatcher crashed mid-batch and was restarted."


def dispatch_batched(
    engine, requests: Sequence[RelationTuple], max_depth: int, max_batch: int
) -> list[bool]:
    """Dispatch a caller-assembled batch in max_batch slices so one giant
    request cannot balloon the engine's working set."""
    out: list[bool] = []
    for i in range(0, len(requests), max_batch):
        out.extend(
            bool(v)
            for v in engine.batch_check(requests[i : i + max_batch], max_depth)
        )
    return out


class CheckBatcher:
    def __init__(
        self,
        engine,  # anything with batch_check(requests, depths=...) -> list[bool]
        max_batch: int = 4096,
        window_s: float = 0.0002,
        max_queue: int = 0,  # 0 -> 8 * max_batch
        max_freshness_wait_s: float = 30.0,  # snaptoken catch-up cap
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_s
        self.max_queue = max_queue if max_queue > 0 else 8 * max_batch
        self.max_freshness_wait_s = max_freshness_wait_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (request, depth, Future, t_enqueued, deadline)
        self._queue: list[tuple] = []
        # the batch the dispatcher popped but has not answered yet — the
        # watchdog fails exactly these on a dispatcher death, and close()
        # fails them after the join budget
        self._inflight: list[tuple] = []
        self._closed = False
        # close() lets the dispatcher drain for this long before failing
        # the leftovers typed; only a wedged engine ever exhausts it
        self.close_join_s = 5.0
        # dispatch telemetry: queued requests answered, batches formed,
        # watchdog restarts (read by the smoke run and the tests)
        self.n_dispatched = 0
        self.n_batches = 0
        self.n_restarts = 0
        self._thread = threading.Thread(
            target=self._run_guard, name="check-batcher", daemon=True
        )
        self._thread.start()

    def _wait_fresh(self, min_version: int, timeout: Optional[float]) -> None:
        """At-least-as-fresh consistency (the snaptoken): make the serving
        snapshot catch up before answering."""
        wait = getattr(self.engine, "wait_for_version", None)
        if wait is not None:
            wait(
                min_version,
                timeout_s=timeout if timeout is not None else self.max_freshness_wait_s,
            )

    @staticmethod
    def _timeout_for(deadline: Optional[float], timeout: Optional[float]):
        if deadline is None:
            return timeout
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise DeadlineExceeded()  # dead on arrival: touch nothing
        return remaining if timeout is None else min(timeout, remaining)

    def check(
        self,
        request: RelationTuple,
        max_depth: int = 0,
        timeout: Optional[float] = None,
        min_version: int = 0,
        deadline: Optional[float] = None,  # absolute time.monotonic() secs
    ) -> bool:
        if self._closed:
            raise BatcherClosed()
        timeout = self._timeout_for(deadline, timeout)
        if min_version > 0:
            self._wait_fresh(min_version, timeout)
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded()  # the wait consumed the budget
        f: Future = Future()
        with self._cv:
            if self._closed:
                raise BatcherClosed()
            if len(self._queue) >= self.max_queue:
                # a full queue means the engine is already saturated
                # max_queue/max_batch dispatches deep: queueing further
                # only converts overload into latency for every caller
                raise BatcherOverloaded()
            self._queue.append(
                (request, max_depth, f, time.perf_counter(), deadline)
            )
            self._cv.notify()
        try:
            return f.result(timeout=timeout)
        except _FutTimeout:
            if deadline is not None and time.monotonic() >= deadline:
                # the caller's budget ran out while the entry was queued:
                # cancel it so the dispatcher skips it
                f.cancel()
                raise DeadlineExceeded() from None
            raise

    def check_batch(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        min_version: int = 0,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> list[bool]:
        """A caller-assembled batch: already amortized, so it skips the
        queue and dispatches directly on the caller's thread, in max_batch
        slices. `min_version` applies to the whole batch first."""
        if self._closed:
            raise BatcherClosed()
        timeout = self._timeout_for(deadline, timeout)
        if min_version > 0:
            self._wait_fresh(min_version, timeout)
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded()
        return dispatch_batched(self.engine, requests, max_depth, self.max_batch)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        # the dispatcher drains the queue before exiting; the join budget
        # only runs out when the engine itself is wedged — then every
        # waiter is failed typed instead of hanging past shutdown
        self._thread.join(timeout=self.close_join_s)
        with self._cv:
            leftovers = self._queue + self._inflight
            self._queue = []
            self._inflight = []
        for item in leftovers:
            f = item[2]
            if not f.done():
                f.set_exception(BatcherClosed())

    def mean_batch_size(self) -> float:
        """Queued requests answered per dispatched batch (0 before any)."""
        return self.n_dispatched / self.n_batches if self.n_batches else 0.0

    # -- dispatcher ------------------------------------------------------------

    def _await_work(self) -> Optional[list[tuple]]:
        """Block for queued requests; None on clean shutdown with an empty
        queue, else the drained batch (after the accumulation window when
        only one request is waiting)."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return None
            first_only = len(self._queue) == 1
        if first_only and self.window_s > 0:
            # brief accumulation window; under load the previous batch
            # provides the window and this never triggers
            time.sleep(self.window_s)
        with self._cv:
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
            return batch

    @staticmethod
    def _cull(items: list) -> list:
        """Drop entries whose caller gave up: deadline passed (their
        future fails typed) or future cancelled."""
        now = time.monotonic()
        kept = []
        for it in items:
            f, dl = it[2], it[4]
            if f.cancelled():
                continue
            if dl is not None and now >= dl:
                if not f.done():
                    f.set_exception(DeadlineExceeded())
                continue
            kept.append(it)
        return kept

    def _run_guard(self) -> None:
        """Watchdog shell around the dispatch loop: a dispatcher death must
        not strand callers or kill batching for the process lifetime.
        In-flight futures fail typed; queued ones survive for the
        replacement loop."""
        while True:
            try:
                self._run()
                return  # clean close
            except BaseException:
                with self._cv:
                    inflight = self._inflight
                    self._inflight = []
                    closed = self._closed
                for item in inflight:
                    f = item[2]
                    if not f.done():
                        f.set_exception(DispatcherCrashed())
                self.n_restarts += 1
                if closed:
                    return

    def _run(self) -> None:
        while True:
            batch = self._await_work()
            if batch is None:
                return
            batch = self._cull(batch)
            if not batch:
                continue
            with self._cv:
                self._inflight = batch
            self.n_batches += 1
            self.n_dispatched += len(batch)
            requests = [b[0] for b in batch]
            depths = [b[1] for b in batch]
            try:
                results = self.engine.batch_check(requests, depths=depths)
            except Exception as e:  # propagate to every caller in the batch
                for item in batch:
                    f = item[2]
                    if not f.done():
                        f.set_exception(e)
                with self._cv:
                    self._inflight = []
                continue
            for item, allowed in zip(batch, results):
                f = item[2]
                if not f.done():
                    f.set_result(bool(allowed))
            with self._cv:
                self._inflight = []


class DirectChecker:
    """Unbatched adapter: the checker interface over a bare engine (the
    host oracle answers from live data, so there is nothing to batch and
    any min_version is already satisfied). Counterpart of
    ``keto_tpu/api/services.py _DirectChecker``."""

    def __init__(self, engine, max_batch: int = 4096):
        self.engine = engine
        self.max_batch = max_batch

    def check(
        self,
        request: RelationTuple,
        max_depth: int = 0,
        timeout: Optional[float] = None,
        min_version: int = 0,
        deadline: Optional[float] = None,
    ) -> bool:
        del timeout, min_version
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded()
        return self.engine.subject_is_allowed(request, max_depth)

    def check_batch(
        self,
        requests,
        max_depth: int = 0,
        min_version: int = 0,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> list:
        del min_version, timeout
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded()
        return dispatch_batched(self.engine, requests, max_depth, self.max_batch)

    def close(self) -> None:
        pass
