"""Check-request batching: concurrent requests -> device-wide batches
(counterpart of ``keto_tpu/engine/batcher.py``).

Callers block on ``check()``, and the dispatch machinery drains the queue
into engine batches of up to ``max_batch`` — taking whatever accumulated
while the previous batch ran (the natural batching window), plus a short
fixed window when only one request waits. Two dispatch shapes share the
class:

- **serial** (``pipeline_depth=0``, or an engine without the split
  encode/launch/decode API, such as the closure engine): one dispatcher
  thread runs ``engine.batch_check`` strictly in order, one batch in
  flight.
- **pipelined** (``pipeline_depth >= 1`` and an engine with
  ``encode_batch``, i.e. ``DeviceCheckEngine``): encode workers drain the
  queue and vocab-encode on host threads; a launch thread copies each
  batch to the card and runs its steps; a decode thread copies the answers
  back and resolves the callers' futures. Bounded queues between the
  stages cap the batches in flight at about ``pipeline_depth`` past the
  encoders. All stages share the current CUDA stream. The packed loop
  tests for done rows every step, so the launch thread waits on the card
  for most of a batch: what overlaps is the host encode and decode of the
  neighbouring batches, not two device batches. A snapshot-versioned
  encoded-request cache sits in front of the device stage: rows whose
  (start, target, depth) triple was answered at this snapshot version skip
  the kernel, and the batch is compacted before launch.

Caller-assembled batches skip the queue and dispatch on the caller's
thread: ``check_batch`` (tuples), ``check_batch_columnar`` (a
``CheckColumns``, no tuple objects) and ``check_batch_encoded`` (vocab ids,
the id-native wire tier). ``cache`` (a ``CheckResultCache`` stamped with
``version_fn``, the engine's ANSWERING version) answers repeated single
checks and tuple batches without the engine; ``qos`` (a ``NamespaceQos``)
admits per namespace before anything else; ``overload`` (an
``OverloadController``, ``engine/overload.py``) sheds single checks and
tuple batches by criticality class (``critical``, ``default``,
``sheddable``) before they queue, culls queued entries past the CoDel
target, serves newest-first while the standing queue lasts, and relaxes a
snaptoken wait to the current snapshot on its bounded-stale rung. It
learns from each dispatched batch's queue delay, and from how long the
queue stayed empty (a whole interval of it ends a standing queue).

Every stage is supervised:

- **watchdog**: a stage thread death fails exactly the batch that stage
  held with :class:`DispatcherCrashed` (typed, retryable) and restarts the
  stage; queued requests and batches held by other stages survive.
- **bounded queue**: past ``max_queue`` waiting requests the batcher sheds
  load with :class:`BatcherOverloaded` (HTTP 429) instead of growing the
  queue, and everyone's latency, without bound. Behind the overload plane
  it is the hard backstop, the only bound that refuses ``critical``.
- **typed shutdown**: after ``close()`` no caller hangs past the join
  budget; anything still queued or in flight fails with
  :class:`BatcherClosed`.

``min_version`` (the snaptoken) makes the engine catch up first through
``engine.wait_for_version``.

``hbm`` (an ``HbmAdmission``, ``engine/hbm.py``) clamps every chunk the
batcher forms to the device-memory headroom and charges each launched
batch's modeled bytes from launch to decode. ``scrub_observer`` (the
scrubber's ``observe_batch``, ``engine/scrub.py``) taps answered batches
into its replay reservoir. ``reconfigure`` resizes the pipeline on a live
batcher: in-flight batches drain first, queued requests wait out the swap.
Every stage loop carries the ``batcher.*`` fault sites (``faults.py``),
and the stage seconds go to ``DEVSTATS`` (``/debug/graph``).

Telemetry, as in the reference: with a metrics registry the batcher exports
``keto_batcher_*``, ``keto_deadline_expired_total``,
``keto_check_cancelled_total`` and, pipelined, the queue-depth gauges and
``keto_pipeline_stage_seconds``; with a tracer each dispatch or stage runs
under a span (``batcher.dispatch``, ``batcher.encode``, ``batcher.launch``,
``batcher.decode``) that joins one caller's trace; the caller-thread
columnar and encoded dispatches open the three stage spans under their
``batcher.dispatch`` too. The caller's attribution
ledger (``telemetry/attribution.py``) and span context ride each queue
entry, so the stage threads charge queue, encode, launch, kernel and decode
time to the request that waited for them; the caller-assembled batches mark
the ambient ledger on the caller's thread.
"""

from __future__ import annotations

import queue as _queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np

from ..faults import FAULTS
from ..relationtuple.definitions import RelationTuple
from ..telemetry.attribution import current_ledger, ledger_mark
from ..telemetry.devstats import DEVSTATS
from ..telemetry.metrics import deadline_expired_counter, pipeline_stage_histogram
from ..telemetry.tracing import _current_span
from ..utils.errors import (
    DeadlineExceeded,
    ErrInternal,
    ErrResourceExhausted,
    ErrUnavailable,
)
from .cache import CheckResultCache


class BatcherClosed(ErrUnavailable):
    """The batcher was shut down."""

    def default_message(self) -> str:
        return "The check batcher is closed (server shutting down)."


class BatcherOverloaded(ErrResourceExhausted):
    """The dispatch queue is full; this request was shed."""

    def default_message(self) -> str:
        return "The check queue is full; retry with backoff."


class DispatcherCrashed(ErrInternal):
    """A dispatch stage thread died while this request was in flight; the
    watchdog restarted it. The request was NOT answered — retryable."""

    def default_message(self) -> str:
        return "The check dispatcher crashed mid-batch and was restarted."


# close()/clean-shutdown marker passed down the stage queues
_SENTINEL = object()


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


def _raise_unanswered(answers: list) -> None:
    """A caller-assembled batch whose rows the breaker's oracle did not reach
    by the caller's deadline (None answers) fails typed as a whole; the
    rows that were answered ride on the error as ``answers``."""
    if any(v is None for v in answers):
        err = DeadlineExceeded(
            f"{sum(v is None for v in answers)} of {len(answers)} rows were "
            "not answered by the deadline"
        )
        err.answers = answers
        raise err


def _merge(cached: list, miss: list, res) -> list[bool]:
    """Cached answers with the misses' fresh answers filled in (a miss the
    breaker's oracle did not reach stays None)."""
    out = [None if v is None else bool(v) for v in cached]
    for i, v in zip(miss, res):
        out[i] = None if v is None else bool(v)
    return out


class _PBatch:
    """One batch moving through the pipeline: queue items plus per-stage
    artifacts."""

    __slots__ = ("items", "enc", "launched", "keys", "t_encoded", "hbm_token")

    def __init__(self, items):
        # [(request, depth, Future, t_enqueued, deadline, criticality, ledger,
        #   span_ctx), ...]
        self.items = items
        self.enc = None  # EncodedBatch after the encode stage
        self.launched = None  # LaunchedBatch after the launch stage
        self.keys = None  # encoded-cache keys (when the cache is on)
        self.t_encoded = 0.0
        self.hbm_token = 0  # HBM admission reservation; 0 = none held


class _Holder:
    """The batch a stage loop currently owns — what its watchdog fails on a
    crash. Ownership passes to the next queue the moment the loop clears
    the holder, so exactly one owner exists at any time."""

    __slots__ = ("batch",)

    def __init__(self):
        self.batch = None


class CheckBatcher:
    def __init__(
        self,
        engine,  # anything with batch_check(requests, depths=...) -> list[bool]
        max_batch: int = 4096,
        window_s: float = 0.0002,
        max_queue: int = 0,  # 0 -> 8 * max_batch
        # snaptoken catch-up cap: seconds, or a zero-argument callable read
        # per wait (serve.read.max_freshness_wait_s is hot-reloadable)
        max_freshness_wait_s=30.0,
        cache: Optional[CheckResultCache] = None,  # None disables
        version_fn=None,  # ANSWERING-version supplier for cache stamping
        pipeline_depth: int = 0,  # 0 -> serial dispatch (one batch in flight)
        encode_workers: int = 2,
        encoded_cache_size: int = 0,  # 0 disables the encoded-request cache
        qos=None,  # NamespaceQos: per-namespace token-bucket admission
        overload=None,  # OverloadController: adaptive admission + brownout
        hbm=None,  # HbmAdmission: device-memory budget; None disables
        metrics=None,
        tracer=None,  # stage spans join the caller's trace when set
    ):
        self.engine = engine
        self.tracer = tracer
        self.max_batch = max_batch
        self.window_s = window_s
        self.max_queue = max_queue if max_queue > 0 else 8 * max_batch
        self._max_freshness_wait_s = max_freshness_wait_s
        self.cache = cache
        self.version_fn = version_fn
        self.qos = qos
        self.overload = overload
        self.hbm = hbm
        # the scrubber's live-traffic tap (ScrubDaemon.observe_batch): fed
        # every answered batch; never allowed to fail a check
        self.scrub_observer = None
        self.pipeline_depth = pipeline_depth
        self.encode_workers = max(1, encode_workers)
        # pipelining needs the engine's split encode/launch/decode API;
        # engines without it (host oracle, closure) keep the serial loop
        capable = self._pipeline_capable()
        self.pipelined = pipeline_depth >= 1 and capable
        # the encoded-request cache serves the pipelined single-check path,
        # the columnar batches and the encoded batches, so it only needs a
        # capable engine, not the pipeline threads
        self.encoded_cache = (
            CheckResultCache(encoded_cache_size, metrics, name="encoded")
            if capable and encoded_cache_size > 0
            else None
        )
        self._metrics = metrics
        self._m_batch_size = None
        self._m_shed = None
        self._m_restarts = None
        self._m_stage = None
        self._m_columnar = None
        self._m_deadline = None
        self._m_cancelled = None
        if metrics is not None:
            self._m_batch_size = metrics.histogram(
                "keto_batcher_batch_size",
                "requests coalesced per dispatched batch",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
            )
            self._m_shed = metrics.counter(
                "keto_batcher_shed_total",
                "check requests rejected because the dispatch queue was full",
            )
            self._m_restarts = metrics.counter(
                "keto_batcher_dispatcher_restarts_total",
                "dispatch stage thread deaths recovered by the watchdog",
            )
            self._m_columnar = metrics.counter(
                "keto_batcher_columnar_batches_total",
                "caller-assembled batches served through the columnar "
                "zero-object path",
            )
            self._m_deadline = deadline_expired_counter(metrics)
            self._m_cancelled = metrics.counter(
                "keto_check_cancelled_total",
                "check requests dropped because the caller disconnected "
                "before an answer, labeled by the stage that freed the slot",
                labelnames=("stage",),
            )
            metrics.gauge(
                "keto_batcher_queue_depth",
                "check requests waiting for dispatch",
                fn=lambda: len(self._queue),
            )
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (request, depth, Future, t_enqueued, deadline, criticality, ledger,
        #  span_ctx)
        self._queue: list[tuple] = []
        # serial mode: the batch the dispatcher popped but has not answered
        # yet — the watchdog fails exactly these on a dispatcher death, and
        # close() fails them after the join budget
        self._inflight: list[tuple] = []
        # pipelined mode: every batch admitted to the pipeline and not yet
        # resolved, whichever stage or queue owns it
        self._pipe_batches: dict[int, _PBatch] = {}
        self._closed = False
        # reconfigure(): one resize at a time; _quiesce makes every stage
        # loop exit without draining the queue
        self._reconfig_lock = threading.Lock()
        self._quiesce = False
        # close() lets the stages drain for this long before failing the
        # leftovers typed; only a wedged engine ever exhausts it
        self.close_join_s = 5.0
        # dispatch telemetry (read by the smoke run, /pipeline and the
        # tests): queued requests answered, batches formed, watchdog
        # restarts, the most batches in the pipeline at once, and the
        # callers each stage dropped because their deadline had passed
        self.n_dispatched = 0
        self.n_batches = 0
        self.n_restarts = 0
        self.max_in_pipeline = 0
        self._expired: dict[str, int] = {}
        if self.pipelined:
            # launch_q admits roughly one encoded batch per encode worker;
            # decode_q is the in-flight bound: the launch thread blocks
            # putting batch N+pipeline_depth until batch N is decoded
            self._launch_q: _queue_mod.Queue = _queue_mod.Queue(
                maxsize=max(2, self.encode_workers)
            )
            self._decode_q: _queue_mod.Queue = _queue_mod.Queue(
                maxsize=max(1, pipeline_depth)
            )
            self._encoders_live = self.encode_workers
            self._register_pipeline_metrics()
            self._threads = self._spawn_pipeline()
        else:
            self._threads = [self._spawn_dispatcher()]

    def _register_pipeline_metrics(self) -> None:
        """The queue-depth gauges and the stage histogram of the pipelined
        shape. The gauges sample through lambdas, not bound queue methods,
        so a reconfigure() that swaps the queues keeps them live; a second
        registration after a serial -> pipelined transition finds the same
        metrics and rebinds their samplers."""
        metrics = self._metrics
        if metrics is None:
            return
        metrics.gauge(
            "keto_pipeline_launch_queue_depth",
            "encoded batches waiting for kernel dispatch",
        ).set_fn(lambda: self._launch_q.qsize())
        metrics.gauge(
            "keto_pipeline_decode_queue_depth",
            "launched batches in flight awaiting decode",
        ).set_fn(lambda: self._decode_q.qsize())
        self._m_stage = pipeline_stage_histogram(metrics)

    def _pipeline_capable(self) -> bool:
        # a wrapper (the device breaker) says whether its primary pipelines
        sup = getattr(self.engine, "pipeline_supported", None)
        if callable(sup):
            return sup()
        return callable(getattr(self.engine, "encode_batch", None))

    def _spawn_dispatcher(self) -> threading.Thread:
        t = threading.Thread(target=self._run_guard, name="check-batcher", daemon=True)
        t.start()
        return t

    def _spawn_pipeline(self) -> list[threading.Thread]:
        threads = [
            threading.Thread(
                target=self._encode_guard, name=f"check-encode-{i}", daemon=True
            )
            for i in range(self.encode_workers)
        ]
        threads.append(
            threading.Thread(
                target=self._stage_guard,
                args=(self._launch_loop,),
                name="check-launch",
                daemon=True,
            )
        )
        threads.append(
            threading.Thread(
                target=self._stage_guard,
                args=(self._decode_loop,),
                name="check-decode",
                daemon=True,
            )
        )
        for t in threads:
            t.start()
        return threads

    # -- admission -------------------------------------------------------------

    def _wait_fresh(
        self, min_version: int, timeout: Optional[float], relax: bool = False
    ) -> None:
        """At-least-as-fresh consistency (the snaptoken): make the serving
        snapshot catch up before answering. The caches stay safe afterward:
        their stamp is the answering version. With ``relax`` (the single
        check and the tuple batch, as in the reference), the overload
        ladder's bounded-stale rung answers at the current snapshot
        instead: the freshness wait is the cheapest latency to refuse under
        pressure, after hedges."""
        ov = self.overload
        if relax and ov is not None and ov.stale_ok():
            ov.note_stale_served()
            return
        wait = getattr(self.engine, "wait_for_version", None)
        if wait is not None:
            wait(
                min_version,
                timeout_s=timeout if timeout is not None else self.max_freshness_wait_s,
            )

    @property
    def max_freshness_wait_s(self) -> float:
        """The current freshness-wait cap (resolves the hot-reload callable)."""
        cap = self._max_freshness_wait_s
        return float(cap() if callable(cap) else cap)

    def _timeout_for(self, deadline: Optional[float], timeout: Optional[float]):
        if deadline is None:
            return timeout
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            self._note_expired("admission", 1)
            raise DeadlineExceeded()  # dead on arrival: touch nothing
        return remaining if timeout is None else min(timeout, remaining)

    def _admit(
        self,
        min_version: int,
        timeout: Optional[float],
        deadline: Optional[float],
        relax: bool = False,
    ) -> Optional[float]:
        """Deadline and freshness admission shared by every entry point;
        returns the timeout left for the caller's wait."""
        timeout = self._timeout_for(deadline, timeout)
        if min_version > 0:
            self._wait_fresh(min_version, timeout, relax)
            if deadline is not None and time.monotonic() >= deadline:
                self._note_expired("admission", 1)
                raise DeadlineExceeded()  # the wait consumed the budget
        return timeout

    def _admit_counts(self, namespaces) -> None:
        counts: dict[str, int] = {}
        for ns in namespaces:
            counts[ns] = counts.get(ns, 0) + 1
        self.qos.admit_counts(counts)

    def _admit_overload(self, criticality: str) -> None:
        """The adaptive overload plane's decision: brownout by criticality
        class, then the accepts/requests throttle once the ladder sheds; a
        shed is the typed 429 naming its reason."""
        reason = self.overload.admit(len(self._queue), criticality)
        if reason is not None:
            if self._m_shed is not None:
                self._m_shed.inc()
            raise BatcherOverloaded(
                f"The server is overloaded ({reason}, "
                f"criticality={criticality}); retry with backoff."
            )

    # -- entry points ----------------------------------------------------------

    def check(
        self,
        request: RelationTuple,
        max_depth: int = 0,
        timeout: Optional[float] = None,
        min_version: int = 0,
        deadline: Optional[float] = None,  # absolute time.monotonic() secs
        entry_hook=None,  # called with the entry's Future once it is queued:
        # a transport holds it to cancel the entry when its caller goes away
        criticality: str = "default",  # critical | default | sheddable
    ) -> bool:
        if self._closed:
            raise BatcherClosed()
        if self.qos is not None:
            # per-namespace admission precedes everything: a throttled
            # tenant must not consume queue slots, cache probes or a
            # freshness wait
            self.qos.admit(request.namespace)
        timeout = self._admit(min_version, timeout, deadline, relax=True)
        if self.cache is not None:
            version = self.version_fn()
            key = (request, max_depth)
            cached = self.cache.get(version, key)
            if cached is not None:
                return cached
        f: Future = Future()
        # the request's ledger and span context ride the queue entry: the
        # stage threads mark queue/encode/launch/kernel/decode on the ledger
        # and parent their spans to the caller's trace. Everything up to
        # the enqueue is "admission" (transport, freshness wait, cache)
        led = current_ledger()
        if led is not None:
            led.mark("admission")
        span_ctx = _current_span.get()
        with self._cv:
            if self._closed:
                raise BatcherClosed()
            if self.overload is not None:
                # the adaptive plane is the primary shed signal; a cache
                # hit above never reaches it
                self._admit_overload(criticality)
            if len(self._queue) >= self.max_queue:
                # a full queue means the engine is already saturated
                # max_queue/max_batch dispatches deep: queueing further
                # only converts overload into latency for every caller.
                # The hard backstop: it sheds even critical traffic, which
                # the overload ladder never does
                if self._m_shed is not None:
                    self._m_shed.inc()
                raise BatcherOverloaded()
            self._queue.append(
                (request, max_depth, f, time.perf_counter(), deadline,
                 criticality, led, span_ctx)
            )
            self._cv.notify()
        if entry_hook is not None:
            entry_hook(f)
        try:
            result = f.result(timeout=timeout)
        except _FutTimeout:
            if deadline is not None and time.monotonic() >= deadline:
                # the caller's budget ran out while the entry was queued:
                # cancel it so the next stage skips it
                f.cancel()
                raise DeadlineExceeded() from None
            raise
        if self.cache is not None:
            self.cache.put(version, key, result)
        return result

    def check_batch(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        min_version: int = 0,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        criticality: str = "default",
    ) -> list[bool]:
        """A caller-assembled batch: already amortized, so it skips the
        queue and dispatches directly on the caller's thread, in max_batch
        slices. `min_version` applies to the whole batch first. The result
        cache is probed in bulk with the stamp the single path uses."""
        if self._closed:
            raise BatcherClosed()
        if self.qos is not None:
            self._admit_counts(r.namespace for r in requests)
        if self.overload is not None:
            # one decision for the whole batch: it skips the queue but
            # competes with it for engine time, so the same ladder sheds it
            self._admit_overload(criticality)
        self._admit(min_version, timeout, deadline, relax=True)
        if self.cache is None:
            ledger_mark("admission")
            res = self._dispatch_direct(requests, max_depth, deadline)
            ledger_mark("kernel")
            return res
        version = self.version_fn()
        keys = [(r, max_depth) for r in requests]
        cached = self.cache.get_many(version, keys)
        miss = [i for i, v in enumerate(cached) if v is None]
        # admission covers the transport, the freshness wait and the bulk
        # cache probe; the engine has not run yet
        ledger_mark("admission")
        if not miss:
            return [bool(v) for v in cached]
        try:
            res = self._dispatch_direct([requests[i] for i in miss], max_depth, deadline)
        except DeadlineExceeded as e:
            if hasattr(e, "answers"):  # the whole batch's rows, hits included
                e.answers = _merge(cached, miss, e.answers)
            raise
        ledger_mark("kernel")
        self.cache.put_many(version, [keys[i] for i in miss], res)
        out = _merge(cached, miss, res)
        ledger_mark("decode")
        return out

    def _admit_rows(self) -> int:
        """The chunk size the HBM admission currently accepts: max_batch
        clamped to the headroom left by in-flight batches. Asked per chunk,
        since headroom moves as batches decode."""
        if self.hbm is None:
            return self.max_batch
        return max(1, self.hbm.clamp_rows(self.max_batch))

    def _dispatch_direct(self, requests, max_depth: int, deadline=None) -> list[bool]:
        """A caller-assembled tuple batch on the caller's thread, in chunks
        the admission accepts, tapped into the scrubber's reservoir. With a
        deadline, an engine that bounds its host oracle by one
        (``takes_deadline``, the breaker) gets it. Runs under a
        ``batcher.dispatch`` span that joins the caller's trace."""
        kw = {}
        if deadline is not None and getattr(self.engine, "takes_deadline", False):
            kw["deadline"] = deadline
        out: list = []
        with self._span("batcher.dispatch", len(requests)):
            i = 0
            while i < len(requests):
                step = self._admit_rows()
                chunk = requests[i : i + step]
                out.extend(
                    None if v is None else bool(v)
                    for v in self.engine.batch_check(chunk, max_depth, **kw)
                )
                i += step
            _raise_unanswered(out)
            self._tap(requests, out)
        return out

    def _tap(self, requests, results) -> None:
        obs = self.scrub_observer
        if obs is not None:
            try:
                obs(requests, results)
            except Exception:
                pass  # a broken scrub tap must never fail live checks

    def check_batch_columnar(
        self,
        cols,
        max_depth: int = 0,
        min_version: int = 0,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> list[bool]:
        """Columnar twin of ``check_batch``: the batch arrives as a
        ``CheckColumns`` and stays columnar through vocab encode and the
        engine. Engines with the columnar split API probe the encoded
        cache on the (start, target, depth) id triples; the others probe
        the result cache on flat string row keys. No ``RelationTuple``
        objects are built on either path. A ``deadline`` (absolute
        ``time.monotonic()``) bounds the admission and, on the encoded path,
        the breaker's host oracle row by row: rows it has not answered by
        then fail the batch with ``DeadlineExceeded``, whose ``answers``
        holds the rows that were answered."""
        if self._closed:
            raise BatcherClosed()
        n = len(cols)
        if n == 0:
            return []
        if self.qos is not None:
            self._admit_counts(cols.namespaces)
        self._admit(min_version, timeout, deadline)
        if self._m_columnar is not None:
            self._m_columnar.inc()
        # the transport and the freshness wait up to here
        ledger_mark("admission")
        if getattr(self.engine, "encode_columns", None) is None:
            return self._columns_via_engine(cols, max_depth)
        out: list = []
        for chunk in self._column_chunks(cols):
            out.extend(self._dispatch_columns(chunk, max_depth, deadline))
        _raise_unanswered(out)
        return out

    def _column_chunks(self, cols):
        """``cols`` in slices the admission accepts (the batch itself when
        it fits)."""
        n = len(cols)
        i = 0
        while i < n:
            step = self._admit_rows()
            yield cols if i == 0 and n <= step else cols.select(range(i, min(i + step, n)))
            i += step

    def _dispatch_columns(self, cols, max_depth: int, deadline=None) -> list:
        """One encoded columnar dispatch: encode into staging, resolve cache
        hits, launch only the misses. On the caller's thread, so
        ``ledger_mark`` charges each phase to the ambient request ledger."""
        cache = self.encoded_cache
        with self._span("batcher.dispatch", len(cols), columnar=1):
            with self._span("batcher.encode", len(cols)):
                enc = self.engine.encode_columns(cols, max_depth)
                if cache is not None:
                    keys = enc.keys()
                    cached = cache.get_many(enc.version, keys)
                    miss = [i for i, v in enumerate(cached) if v is None]
                ledger_mark("encode")
            if cache is None:
                return self._launch_decode(enc, deadline)
            if not miss:
                enc.release()
                return [bool(v) for v in cached]
            if len(miss) < len(keys):
                enc.compact(miss)

            def fill(res):
                live = [(i, v) for i, v in zip(miss, res) if v is not None]
                cache.put_many(enc.version, [keys[i] for i, _ in live], [v for _, v in live])
                return _merge(cached, miss, res)

            return self._launch_decode(enc, deadline, fill)

    def _span(self, name: str, n: int, **attrs):
        """A caller-thread span of ``n`` rows: ``batcher.dispatch``, or a
        stage under it named as the pipelined path's; nothing without a
        tracer."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, batch_size=n, **attrs)

    def _launch_decode(self, enc, deadline=None, fill=None) -> list:
        """The device stage and the decode of one encoded batch, on the
        caller's thread; ``fill`` maps the answers to the caller's rows
        inside the decode stage. A deadline reaches the breaker as the
        pipeline's per-row deadlines do; a row its oracle skipped stays
        None."""
        if deadline is not None:
            enc.deadlines = [deadline] * enc.n
        with self._span("batcher.launch", enc.n):
            launched = self.engine.launch_encoded(enc)
            ledger_mark("launch")
        with self._span("batcher.decode", enc.n):
            out = [
                None if v is None else bool(v)
                for v in self.engine.decode_launched(launched)
            ]
            if fill is not None:
                out = fill(out)
            ledger_mark("decode")
        return out

    def _columns_via_engine(self, cols, max_depth: int) -> list[bool]:
        """Engines without the columnar split API (closure, host oracle):
        their ``batch_check_columns`` when present, else materialized
        tuples — with the result cache probed in bulk on flat string row
        keys, not request objects."""
        if self.cache is None:
            res = self._run_columns(cols, max_depth)
            ledger_mark("kernel")
            return res
        version = self.version_fn()
        keys = cols.row_keys(max_depth)
        cached = self.cache.get_many(version, keys)
        miss = [i for i, v in enumerate(cached) if v is None]
        ledger_mark("encode")
        if not miss:
            return [bool(v) for v in cached]
        sub = cols.select(miss) if len(miss) < len(cols) else cols
        res = self._run_columns(sub, max_depth)
        ledger_mark("kernel")
        self.cache.put_many(version, [keys[i] for i in miss], res)
        out = _merge(cached, miss, res)
        ledger_mark("decode")
        return out

    def _run_columns(self, cols, max_depth: int) -> list[bool]:
        run = getattr(self.engine, "batch_check_columns", None)
        out: list[bool] = []
        for chunk in self._column_chunks(cols):
            if run is not None:
                out.extend(bool(v) for v in run(chunk, max_depth))
            else:
                out.extend(
                    bool(v)
                    for v in self.engine.batch_check(chunk.materialize(), max_depth)
                )
        return out

    def check_batch_encoded(
        self,
        start_ids,
        target_ids,
        depths=None,
        min_version: int = 0,
        timeout: Optional[float] = None,
        ns_counts: Optional[dict] = None,
    ) -> list[bool]:
        """Pre-encoded id batches (the id-native wire tier): probe the
        encoded cache on (start, target, depth) triples and dispatch only
        the misses through the engine's array path — no per-item Python
        objects end to end. ``ns_counts`` (per-namespace row counts the wire
        front derived from the namespace-id column) is charged against the
        same QoS buckets the string paths use."""
        if self._closed:
            raise BatcherClosed()
        n = len(start_ids)
        if n == 0:
            return []
        if ns_counts and self.qos is not None:
            self.qos.admit_counts(ns_counts)
        self._admit(min_version, timeout, None)
        s = np.asarray(start_ids, dtype=np.int64)
        t = np.asarray(target_ids, dtype=np.int64)
        gmax = int(getattr(self.engine, "global_max_depth", 0) or 0)
        if depths is not None:
            want = np.asarray(depths, dtype=np.int32)
        else:
            want = np.zeros(n, dtype=np.int32)
        d = np.where((want <= 0) | (want > gmax), gmax, want) if gmax > 0 else want
        ledger_mark("admission")
        out: list[bool] = []
        i = 0
        while i < n:
            j = i + self._admit_rows()
            out.extend(self._dispatch_encoded(s[i:j], t[i:j], d[i:j]))
            i = j
        return out

    def _dispatch_encoded(self, s, t, d) -> list[bool]:
        cache = self.encoded_cache
        with self._span("batcher.dispatch", len(s), encoded=1):
            if cache is None or self.version_fn is None:
                out = self._run_encoded(s, t, d)
                ledger_mark("decode")
                return out
            version = self.version_fn()
            keys = list(zip(s.tolist(), t.tolist(), d.tolist()))
            cached = cache.get_many(version, keys)
            miss = [i for i, v in enumerate(cached) if v is None]
            if not miss:
                return [bool(v) for v in cached]
            if len(miss) < len(keys):
                s, t, d = s[miss], t[miss], d[miss]
            res = self._run_encoded(s, t, d)
            cache.put_many(version, [keys[i] for i in miss], res)
            out = _merge(cached, miss, res)
            ledger_mark("decode")
        return out

    def _run_encoded(self, s, t, d) -> list[bool]:
        encode_ids = getattr(self.engine, "encode_ids", None)
        if encode_ids is not None:
            with self._span("batcher.encode", len(s)):
                enc = encode_ids(s, t, d)
                ledger_mark("encode")
            return self._launch_decode(enc)
        check_ids = getattr(self.engine, "check_ids", None)
        if check_ids is None:
            raise ErrInternal(
                "engine has no array-native check path "
                "(check_batch_encoded needs check_ids or encode_ids)"
            )
        # the closure engine's array path wants per-row subject kinds;
        # derive them from the vocab (ids past it read as sets — they clamp
        # to the inert dummy downstream anyway)
        is_id = np.zeros(len(t), dtype=bool)
        snaps = getattr(self.engine, "snapshots", None)
        if snaps is not None:
            is_set = snaps.snapshot().vocab.is_set_array()
            safe = (t >= 0) & (t < len(is_set))
            is_id[safe] = ~is_set[t[safe]]
        return [bool(v) for v in check_ids(s, t, is_id, d)]

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        # the stages drain the queue before exiting; the join budget only
        # runs out when the engine itself is wedged — then every waiter is
        # failed typed instead of hanging past shutdown
        deadline = time.monotonic() + self.close_join_s
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._cv:
            leftovers = self._queue + self._inflight
            self._queue = []
            self._inflight = []
            for b in self._pipe_batches.values():
                leftovers.extend(b.items)
            self._pipe_batches = {}
        for item in leftovers:
            f = item[2]
            if not f.done():
                f.set_exception(BatcherClosed())

    def mean_batch_size(self) -> float:
        """Queued requests answered per dispatched batch (0 before any)."""
        return self.n_dispatched / self.n_batches if self.n_batches else 0.0

    def pipeline_stats(self) -> dict:
        """Queue and stage occupancy (the read plane's ``GET /pipeline``)."""
        with self._lock:
            out = {
                "pipelined": self.pipelined,
                "queue_depth": len(self._queue),
                "max_queue": self.max_queue,
                "max_batch": self.max_batch,
                "batches": self.n_batches,
                "mean_batch": self.mean_batch_size(),
                "restarts": self.n_restarts,
                "deadline_expired": dict(self._expired),
            }
            if self.overload is not None:
                out["overload"] = self.overload.snapshot()
            if self.pipelined:
                out.update(
                    {
                        "pipeline_depth": self.pipeline_depth,
                        "encode_workers": self.encode_workers,
                        "launch_queue_depth": self._launch_q.qsize(),
                        "decode_queue_depth": self._decode_q.qsize(),
                        "batches_in_pipeline": len(self._pipe_batches),
                        "max_batches_in_pipeline": self.max_in_pipeline,
                        "encoded_cache_entries": (
                            len(self.encoded_cache)
                            if self.encoded_cache is not None
                            else 0
                        ),
                    }
                )
        return out

    def reconfigure(
        self,
        pipeline_depth: Optional[int] = None,
        encode_workers: Optional[int] = None,
    ) -> bool:
        """Resize the dispatch pipeline on a live batcher (the seam for
        ``engine.pipeline_depth`` / ``engine.encode_workers``).

        In-flight batches drain FIRST: the quiesce flag makes every stage
        loop exit through :meth:`_await_work` without draining the queue;
        the encode workers' sentinel cascade then flushes everything already
        past encode through launch and decode in order, so a clean resize
        drops or fails no caller. Queued requests wait out the swap and the
        rebuilt stages pick them up. Serial <-> pipelined transitions are
        derived from the engine's capabilities as in ``__init__``.

        Only a wedged engine exhausts the join budget; the batches a wedged
        stage still holds then fail typed (:class:`DispatcherCrashed`), as
        a stage death would.

        Returns True when the pipeline was rebuilt, False for a no-op. The
        ``batcher.reconfigure_stall`` fault site stalls the drain window."""
        with self._reconfig_lock:
            new_depth = (
                self.pipeline_depth if pipeline_depth is None
                else max(0, int(pipeline_depth))
            )
            new_workers = (
                self.encode_workers if encode_workers is None
                else max(1, int(encode_workers))
            )
            if new_depth == self.pipeline_depth and new_workers == self.encode_workers:
                return False
            with self._cv:
                if self._closed:
                    raise BatcherClosed()
                self._quiesce = True
                self._cv.notify_all()
            # the drain window: in-flight batches flush through the sentinel
            # cascade while new arrivals pool in the queue
            FAULTS.maybe_sleep("batcher.reconfigure_stall")
            deadline = time.monotonic() + self.close_join_s
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            stragglers: list[tuple] = []
            with self._cv:
                # a wedged stage keeps its batch past the join budget: fail
                # exactly those typed; queued entries are NOT touched
                stragglers.extend(self._inflight)
                self._inflight = []
                for b in self._pipe_batches.values():
                    stragglers.extend(b.items)
                self._pipe_batches = {}
                self._quiesce = False
                self.pipeline_depth = new_depth
                self.encode_workers = new_workers
                self.pipelined = new_depth >= 1 and self._pipeline_capable()
            for item in stragglers:
                f = item[2]
                if not f.done():
                    f.set_exception(DispatcherCrashed())
            if self.pipelined:
                self._launch_q = _queue_mod.Queue(maxsize=max(2, self.encode_workers))
                self._decode_q = _queue_mod.Queue(maxsize=max(1, new_depth))
                self._encoders_live = self.encode_workers
                self._register_pipeline_metrics()
                self._threads = self._spawn_pipeline()
            else:
                self._threads = [self._spawn_dispatcher()]
            return True

    # -- shared plumbing -------------------------------------------------------

    def _await_work(self) -> Optional[list[tuple]]:
        """Block for queued requests; None on clean shutdown with an empty
        queue — or at once on a reconfigure quiesce, BEFORE draining, so
        queued entries stay for the rebuilt stages — else the drained batch
        (after the accumulation window when only one request is waiting)."""
        with self._cv:
            idle_since = None
            while not self._queue and not self._closed and not self._quiesce:
                if idle_since is None:
                    idle_since = time.monotonic()
                self._cv.wait()
            if idle_since is not None and self.overload is not None:
                # the overload plane learns how long the queue stayed empty
                self.overload.note_idle(time.monotonic() - idle_since)
            if self._quiesce and not self._closed:
                return None
            if self._closed and not self._queue:
                return None
            first_only = len(self._queue) == 1
        if first_only and self.window_s > 0:
            # brief accumulation window; under load the previous batch
            # provides the window and this never triggers
            time.sleep(self.window_s)
        with self._cv:
            return self._drain()

    def _drain(self) -> list[tuple]:
        """Pop the next batch (under the queue lock). Under sustained
        pressure the overload plane culls entries queued past its CoDel
        target, typed 429, and serves the newest entries first."""
        ov = self.overload
        if ov is not None and self._queue:
            cutoff = ov.cull_age_s()
            if cutoff is not None:
                now = time.perf_counter()
                kept: list[tuple] = []
                culled = 0
                for it in self._queue:
                    # critical entries are exempt: only the max_queue
                    # backstop ever drops critical work (LIFO may still
                    # serve it late)
                    if now - it[3] > cutoff and it[5] != "critical":
                        f = it[2]
                        if not f.done():
                            f.set_exception(
                                BatcherOverloaded(
                                    "The check queued past the standing-"
                                    "queue delay target and was culled; "
                                    "retry with backoff."
                                )
                            )
                        culled += 1
                    else:
                        kept.append(it)
                if culled:
                    self._queue[:] = kept
                    ov.note_culled(culled)
            if ov.lifo() and self._queue:
                # adaptive LIFO: the newest entries are the ones most
                # likely to still meet their deadlines
                batch = self._queue[-self._admit_rows() :]
                del self._queue[-len(batch) :]
                return batch
        batch = self._queue[: self._admit_rows()]
        del self._queue[: len(batch)]
        return batch

    def _note_expired(self, stage: str, n: int) -> None:
        if self._m_deadline is not None:
            self._m_deadline.labels(stage=stage).inc(n)
        with self._lock:
            self._expired[stage] = self._expired.get(stage, 0) + n

    def _note_cancelled(self, stage: str, n: int) -> None:
        if self._m_cancelled is not None:
            self._m_cancelled.labels(stage=stage).inc(n)

    def _cull(self, items: list, stage: str) -> tuple[list, list[int]]:
        """Drop entries whose caller gave up — deadline passed (their future
        fails typed) or future cancelled — so the stage ahead never pays for
        them. Returns (kept entries, their indices in ``items``): the index
        list lets the launch stage compact the staged buffers."""
        now = time.monotonic()
        kept: list = []
        keep_idx: list[int] = []
        expired = cancelled = 0
        for i, it in enumerate(items):
            f, dl = it[2], it[4]
            if f.cancelled():
                cancelled += 1
                continue
            if dl is not None and now >= dl:
                if not f.done():
                    f.set_exception(DeadlineExceeded())
                expired += 1
                continue
            kept.append(it)
            keep_idx.append(i)
        if expired:
            self._note_expired(stage, expired)
        if cancelled:
            self._note_cancelled(stage, cancelled)
        return kept, keep_idx

    # -- serial dispatcher -----------------------------------------------------

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
                self._note_restart()
                if closed:
                    return

    def _run(self) -> None:
        while True:
            FAULTS.fire("batcher.dispatcher_die")
            batch = self._await_work()
            if batch is None:
                return
            batch, _ = self._cull(batch, "dispatch")
            if not batch:
                continue
            FAULTS.maybe_sleep("batcher.dispatch_slow")
            with self._cv:
                self._inflight = batch
            self.n_batches += 1
            self.n_dispatched += len(batch)
            if self._m_batch_size is not None:
                self._m_batch_size.observe(len(batch))
            requests = [b[0] for b in batch]
            depths = [b[1] for b in batch]
            t_dispatch = time.perf_counter()
            self._mark_items(batch, "queue", t_dispatch)
            try:
                if self.tracer is not None:
                    with self.tracer.span(
                        "batcher.dispatch",
                        parent=self._batch_parent(batch),
                        batch_size=len(batch),
                    ):
                        results = self.engine.batch_check(requests, depths=depths)
                else:
                    results = self.engine.batch_check(requests, depths=depths)
            except Exception as e:  # propagate to every caller in the batch
                for item in batch:
                    f = item[2]
                    if not f.done():
                        f.set_exception(e)
                with self._cv:
                    self._inflight = []
                continue
            if self.overload is not None:
                # the oldest entry's queue delay and the engine's service
                # time feed the limiter's AIMD/CoDel signal
                self.overload.observe(
                    t_dispatch - min(it[3] for it in batch),
                    time.perf_counter() - t_dispatch,
                )
            # the serial engine call is one piece (encode, kernel and decode
            # in one): all of it is "kernel", marked before the futures
            # resolve so the callers' own marks cannot race it
            self._mark_items(batch, "kernel")
            for item, allowed in zip(batch, results):
                f = item[2]
                if not f.done():
                    f.set_result(bool(allowed))
            self._tap(requests, results)
            with self._cv:
                self._inflight = []

    # -- pipelined stages ------------------------------------------------------

    def _register(self, batch: _PBatch) -> None:
        with self._lock:
            self._pipe_batches[id(batch)] = batch
            self.max_in_pipeline = max(self.max_in_pipeline, len(self._pipe_batches))

    def _complete(self, batch: _PBatch) -> None:
        with self._lock:
            self._pipe_batches.pop(id(batch), None)
        if self.hbm is not None and batch.hbm_token:
            self.hbm.release(batch.hbm_token)
            batch.hbm_token = 0

    def _observe(self, stage: str, seconds: float) -> None:
        if self._m_stage is not None:
            self._m_stage.labels(stage=stage).observe(seconds)
        DEVSTATS.record_stage(stage, seconds)

    def _note_restart(self) -> None:
        self.n_restarts += 1
        if self._m_restarts is not None:
            self._m_restarts.inc()

    @staticmethod
    def _batch_parent(items):
        """The parent of a stage span: the first entry that carries a span
        context. A batch serves many traces and OTLP has no multi-parent,
        so the span joins one representative caller's trace."""
        for it in items:
            if it[7] is not None:
                return it[7]
        return None

    @staticmethod
    def _mark_items(items, stage: str, now: Optional[float] = None) -> None:
        """Charge ``stage`` on every entry's ledger. Safe across threads:
        each entry's marks are sequential (the stage handoffs through the
        bounded queues order them), and they run before the entry's future
        resolves, so they never race the caller's serialize and reply
        marks."""
        for it in items:
            led = it[6]
            if led is not None:
                led.mark(stage, now)

    def _fail_batch(self, batch: _PBatch, exc: BaseException) -> None:
        self._complete(batch)
        if batch.enc is not None:
            batch.enc.release()
        for item in batch.items:
            f = item[2]
            if not f.done():
                f.set_exception(exc)

    def _stage_guard(self, loop_fn) -> None:
        """Watchdog shell shared by the stages: a stage death fails exactly
        the batch that stage held, typed and retryable, then restarts the
        stage. Batches owned by the queues or by other stages are
        untouched."""
        while True:
            holder = _Holder()
            try:
                loop_fn(holder)
                return  # clean close
            except BaseException:
                batch, holder.batch = holder.batch, None
                if batch is not None:
                    self._fail_batch(batch, DispatcherCrashed())
                self._note_restart()
                if self._closed:
                    return

    def _encode_guard(self) -> None:
        self._stage_guard(self._encode_loop)
        # clean exit: the LAST encode worker out sends the shutdown sentinel
        # downstream so launch and decode drain and exit in order
        with self._lock:
            self._encoders_live -= 1
            last = self._encoders_live == 0
        if last:
            self._launch_q.put(_SENTINEL)

    def _encode_loop(self, holder: _Holder) -> None:
        while True:
            items = self._await_work()
            if items is None:
                return
            items, _ = self._cull(items, "encode")
            if not items:
                continue
            if self.tracer is not None:
                with self.tracer.span(
                    "batcher.encode",
                    parent=self._batch_parent(items),
                    batch_size=len(items),
                ):
                    self._encode_step(items, holder)
            else:
                self._encode_step(items, holder)

    def _encode_step(self, items: list, holder: _Holder) -> None:
        batch = _PBatch(items)
        holder.batch = batch
        self._register(batch)
        FAULTS.fire("batcher.encode_die")
        FAULTS.maybe_sleep("batcher.encode_slow")
        with self._lock:
            self.n_batches += 1
            self.n_dispatched += len(items)
        t0 = time.perf_counter()
        queued = t0 - min(it[3] for it in items)
        self._observe("enqueue", queued)
        if self.overload is not None:
            # pipelined shape: the queue delay alone is the limiter signal
            self.overload.observe(queued)
        self._mark_items(items, "queue", t0)
        if self._m_batch_size is not None:
            self._m_batch_size.observe(len(items))
        requests = [it[0] for it in items]
        depths = [it[1] for it in items]
        try:
            enc = self.engine.encode_batch(requests, depths=depths)
        except Exception as e:
            self._fail_batch(batch, e)
            holder.batch = None
            return
        batch.enc = enc
        if self.encoded_cache is not None:
            # rows answered at this snapshot version resolve here; only the
            # misses ride the kernel
            keys = enc.keys()
            cached = self.encoded_cache.get_many(enc.version, keys)
            miss = [i for i, v in enumerate(cached) if v is None]
            if len(miss) < len(items):
                now = time.perf_counter()
                for it, v in zip(items, cached):
                    if v is None:
                        continue
                    if it[6] is not None:
                        it[6].mark("encode", now)
                    if not it[2].done():
                        it[2].set_result(bool(v))
                if not miss:
                    enc.release()
                    self._complete(batch)
                    holder.batch = None
                    self._observe("encode", time.perf_counter() - t0)
                    return
                enc.compact(miss)
                batch.items = [items[i] for i in miss]
                batch.keys = [keys[i] for i in miss]
            else:
                batch.keys = keys
        enc.deadlines = [it[4] for it in batch.items]
        batch.t_encoded = time.perf_counter()
        self._observe("encode", batch.t_encoded - t0)
        self._mark_items(batch.items, "encode", batch.t_encoded)
        # ownership passes to the launch queue; the bounded put is the
        # encode stage's backpressure
        holder.batch = None
        self._launch_q.put(batch)

    def _launch_loop(self, holder: _Holder) -> None:
        while True:
            batch = self._launch_q.get()
            if batch is _SENTINEL:
                self._decode_q.put(_SENTINEL)
                return
            if self.tracer is not None:
                with self.tracer.span(
                    "batcher.launch",
                    parent=self._batch_parent(batch.items),
                    batch_size=len(batch.items),
                ):
                    self._launch_step(batch, holder)
            else:
                self._launch_step(batch, holder)

    def _launch_step(self, batch: _PBatch, holder: _Holder) -> None:
        holder.batch = batch
        # the device stage inherits the dispatcher's fault site: "the
        # dispatcher" is the thread that talks to the device
        FAULTS.fire("batcher.dispatcher_die")
        FAULTS.maybe_sleep("batcher.launch_slow")
        # cull rows that died waiting in the launch queue BEFORE the device
        # stage: compacting the staged buffers here is the last chance not
        # to pay device time for them
        kept, keep_idx = self._cull(batch.items, "launch")
        if not kept:
            batch.enc.release()
            self._complete(batch)
            holder.batch = None
            return
        if len(kept) < len(batch.items):
            batch.enc.compact(keep_idx)
            batch.items = kept
            if batch.keys is not None:
                batch.keys = [batch.keys[i] for i in keep_idx]
        if self.hbm is not None:
            # charge the batch's modeled device memory before the launch;
            # released in _complete/_fail_batch once it leaves the device
            batch.hbm_token = self.hbm.reserve(
                getattr(batch.enc, "b", 0) or 0,
                getattr(batch.enc, "version", 0) or 0,
            )
        try:
            batch.launched = self.engine.launch_encoded(batch.enc)
        except Exception as e:
            # a launch that raises fails its batch typed; it is never
            # re-answered on the CPU (behind the device breaker only an
            # injected fault's batch goes to the oracle instead of raising)
            self._fail_batch(batch, e)
            holder.batch = None
            return
        # launch = launch-queue wait + the enqueue of the steps
        self._observe("launch", time.perf_counter() - batch.t_encoded)
        self._mark_items(batch.items, "launch")
        holder.batch = None
        # bounded put: blocks once pipeline_depth batches await decode,
        # which is what caps the batches in flight
        self._decode_q.put(batch)

    def _decode_loop(self, holder: _Holder) -> None:
        while True:
            batch = self._decode_q.get()
            if batch is _SENTINEL:
                return
            if self.tracer is not None:
                with self.tracer.span(
                    "batcher.decode",
                    parent=self._batch_parent(batch.items),
                    batch_size=len(batch.items),
                ):
                    self._decode_step(batch, holder)
            else:
                self._decode_step(batch, holder)

    def _decode_step(self, batch: _PBatch, holder: _Holder) -> None:
        holder.batch = batch
        FAULTS.fire("batcher.decode_die")
        FAULTS.maybe_sleep("batcher.decode_slow")
        # rows that died on the device still decode (decoding frees the
        # staging buffers) but their callers fail typed now; items stay in
        # place so the results align
        now = time.monotonic()
        n_expired = 0
        for item in batch.items:
            f, dl = item[2], item[4]
            if dl is not None and now >= dl and not f.done():
                f.set_exception(DeadlineExceeded())
                n_expired += 1
        if n_expired:
            self._note_expired("decode", n_expired)
        t0 = time.perf_counter()
        try:
            results = self.engine.decode_launched(batch.launched)
        except Exception as e:
            self._fail_batch(batch, e)
            holder.batch = None
            return
        # device = the wait for the result's copy back
        t1 = time.perf_counter()
        self._observe("device", t1 - t0)
        # a None answer is a row the breaker's oracle skipped because its
        # caller's deadline had passed: that caller already failed typed,
        # and nothing is cached or tapped for it
        for item, allowed in zip(batch.items, results):
            f = item[2]
            led = item[6]
            if led is not None:
                # kernel = launch mark -> the answers are on the host;
                # decode = the rest up to this row's resolution, marked
                # before set_result so the woken caller's marks cannot race
                led.mark("kernel", t1)
                led.mark("decode")
            if allowed is not None and not f.done():
                f.set_result(bool(allowed))
        live = [i for i, v in enumerate(results) if v is not None]
        if live:
            self._tap(
                [batch.items[i][0] for i in live], [results[i] for i in live]
            )
        if self.encoded_cache is not None and batch.keys is not None and live:
            self.encoded_cache.put_many(
                batch.enc.version,
                [batch.keys[i] for i in live],
                [bool(results[i]) for i in live],
            )
        self._complete(batch)
        self._observe("decode", time.perf_counter() - t1)
        holder.batch = None


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
        entry_hook=None,
        criticality: str = "default",
    ) -> bool:
        # no queue: nothing to cancel, nothing to shed
        del timeout, min_version, entry_hook, criticality
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
        criticality: str = "default",
    ) -> list:
        del min_version, timeout, criticality
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded()
        return dispatch_batched(self.engine, requests, max_depth, self.max_batch)

    def close(self) -> None:
        pass
