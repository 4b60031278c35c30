"""Request flight recorder (counterpart of ``keto_tpu/telemetry/flight.py``):
a bounded in-memory ring of the requests
worth explaining after the fact — slow, deadline-missed, or errored —
plus the fatal-path machinery (faulthandler + periodic ring flush to
disk) that makes a crashed or SIGKILLed process leave evidence.

Two layers:

- ``FlightRecorder`` — the ring itself. ``record(**fields)`` appends,
  ``records(n)`` reads newest-first, and when a dump directory is
  configured a daemon thread flushes the ring to ``flight.json`` (atomic
  tmp+rename) every few seconds so the on-disk copy survives SIGKILL,
  while ``install_fatal_dump()`` arms faulthandler and a chained
  excepthook so segfaults and uncaught exceptions dump stacks + ring.

- ``CheckTelemetry`` — the transport seam every check request passes
  through (REST handler executor, gRPC servicer thread). It opens a
  tracer span on the calling thread, times the request, classifies the
  outcome, observes the ``keto_check_duration_seconds`` histogram with a
  trace-id exemplar, feeds the SLO tracker, and flight-records anything
  slow or failed. All dependencies are optional: a bare
  ``CheckTelemetry()`` is a near-free no-op, which is what servicers get
  when no registry wired one in.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Optional

from .attribution import (
    TimeLedger,
    TransportLedger,
    current_ledger,
    reset_current_ledger,
    set_current_ledger,
)
from .metrics import DEFAULT_BUCKETS, MetricsRegistry
from .tracing import Tracer, _current_span, parse_traceparent


class FlightRecorder:
    """Bounded ring buffer of request post-mortems.

    ``dump_dir`` is optional; without it the ring is memory-only (still
    served by /debug/flight). With it, the ring is flushed to
    ``<dump_dir>/flight.json`` by a daemon thread whenever dirty, and
    ``install_fatal_dump()`` arms crash evidence at
    ``<dump_dir>/fatal.stacks``.
    """

    def __init__(
        self,
        capacity: int = 512,
        dump_dir: str = "",
        flush_interval_s: float = 2.0,
        clock=time.time,
    ):
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir
        self._clock = clock
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._fatal_file = None
        self._prev_excepthook = None
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            self._flusher = threading.Thread(
                target=self._flush_loop,
                name="flight-flusher",
                daemon=True,
                args=(max(0.1, float(flush_interval_s)),),
            )
            self._flusher.start()

    # -- recording ------------------------------------------------------------

    def record(self, **fields) -> dict:
        with self._lock:
            rec = {"seq": self._seq, "t": self._clock(), **fields}
            self._seq += 1
            self._ring.append(rec)
        self._dirty.set()
        return rec

    def records(self, n: Optional[int] = None) -> list[dict]:
        """Newest first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out if n is None else out[: max(0, int(n))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "size": len(self._ring),
                "total_recorded": self._seq,
                "dump_dir": self.dump_dir or None,
            }

    # -- disk evidence --------------------------------------------------------

    @property
    def ring_path(self) -> str:
        return os.path.join(self.dump_dir, "flight.json") if self.dump_dir else ""

    @property
    def stacks_path(self) -> str:
        return os.path.join(self.dump_dir, "fatal.stacks") if self.dump_dir else ""

    def flush_to_disk(self) -> Optional[str]:
        """Atomic tmp+rename write of the ring; returns the path."""
        if not self.dump_dir:
            return None
        payload = {
            "flushed_at": self._clock(),
            "pid": os.getpid(),
            "records": self.records(),
        }
        path = self.ring_path
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return path

    def _flush_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            if self._dirty.is_set():
                self._dirty.clear()
                self.flush_to_disk()

    def install_fatal_dump(self) -> None:
        """Arm faulthandler (segfault/deadlock stacks into
        ``fatal.stacks``) and chain the process excepthook so an uncaught
        exception flushes the ring before the interpreter dies."""
        if not self.dump_dir or self._fatal_file is not None:
            return
        self._fatal_file = open(self.stacks_path, "w")
        faulthandler.enable(file=self._fatal_file)
        self._prev_excepthook = sys.excepthook

        def _hook(tp, value, tb):
            try:
                self.dump_fatal()
            except Exception:
                pass
            (self._prev_excepthook or sys.__excepthook__)(tp, value, tb)

        sys.excepthook = _hook

    def dump_fatal(self) -> None:
        """Best-effort evidence dump: flush the ring and write all thread
        stacks. Safe to call from an excepthook or signal handler path."""
        self.flush_to_disk()
        target = self._fatal_file
        if target is None and self.dump_dir:
            try:
                target = open(self.stacks_path, "w")
            except OSError:
                target = None
        if target is not None:
            try:
                faulthandler.dump_traceback(file=target)
                target.flush()
            except Exception:
                pass

    def close(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None
        if self.dump_dir:
            self.flush_to_disk()
        if self._fatal_file is not None:
            # disable before closing the file or a later fault would
            # write through a dangling fd
            try:
                faulthandler.disable()
            except Exception:
                pass
            try:
                self._fatal_file.close()
            except Exception:
                pass
            self._fatal_file = None
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None


class CheckTelemetry:
    """The per-request telemetry seam shared by the REST and gRPC check
    paths. Usage::

        with telemetry.record_check("grpc", batch_size=n, deadline=dl):
            result = checker.check(...)

    The context manager must run on the thread that executes the check
    (the gRPC handler thread / the REST executor worker) so the tracer
    span contextvar is visible downstream.

    Under the REST transport the record adopts the request's ambient
    ``TransportLedger`` instead of starting a ledger of its own, and the
    transport folds it into ``attribution`` after the reply is written;
    the record's own clock still times the histogram, the SLO and the
    flight record.
    """

    SPAN_NAME = "check.request"

    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        flight: Optional[FlightRecorder] = None,
        slo=None,
        slow_s: float = 0.25,
        stages_fn=None,
        attribution=None,
        role: str = "",
    ):
        self.tracer = tracer
        self.flight = flight
        self.slo = slo
        self.slow_s = float(slow_s)
        self.stages_fn = stages_fn
        self.attribution = attribution
        # replication role ("leader"/"follower", "" standalone): stamped
        # on flight records so /debug/flight distinguishes which node a
        # slow or lag-bounced check was served by
        self.role = str(role or "")
        self._hist = None
        self._outcomes = None
        if metrics is not None:
            self._hist = metrics.histogram(
                "keto_check_duration_seconds",
                "end-to-end check latency at the transport seam "
                "(REST handler / gRPC servicer)",
                labelnames=("transport",),
            )
            self._outcomes = metrics.counter(
                "keto_check_requests_total",
                "check requests by transport and outcome",
                labelnames=("transport", "outcome"),
            )
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, str], int] = {}

    def record_check(
        self,
        transport: str,
        batch_size: int = 1,
        deadline: Optional[float] = None,
        detail: Optional[dict] = None,
        traceparent: Optional[str] = None,
        hedge: bool = False,
    ) -> "_CheckRecord":
        """``traceparent`` is the raw W3C header off the wire (REST
        header / gRPC metadata); when present the request span joins the
        caller's trace instead of minting a new one, and the same trace
        id flows to the exemplar and flight record. ``hedge`` tags the
        duplicate a client-side Hedger fired."""
        return _CheckRecord(
            self, transport, batch_size, deadline, detail, traceparent,
            hedge,
        )

    def _classify(self, exc_type) -> str:
        if exc_type is None:
            return "ok"
        name = getattr(exc_type, "__name__", str(exc_type))
        if "Deadline" in name or name == "TimeoutError":
            return "deadline_missed"
        return f"error:{name}"

    def _finish(
        self,
        transport: str,
        duration_s: float,
        outcome: str,
        batch_size: int,
        deadline: Optional[float],
        trace_id: Optional[int],
        detail: Optional[dict],
    ) -> None:
        tid_hex = f"{trace_id:032x}" if trace_id else ""
        if self._hist is not None:
            self._hist.labels(transport=transport).observe(
                duration_s,
                exemplar={"trace_id": tid_hex} if tid_hex else None,
            )
        if self._outcomes is not None:
            self._outcomes.labels(transport=transport, outcome=outcome).inc()
        with self._lock:
            key = (transport, outcome)
            self._counts[key] = self._counts.get(key, 0) + 1
        if self.slo is not None:
            self.slo.record(duration_s, error=(outcome != "ok"))
        slow = duration_s >= self.slow_s
        if self.flight is None or (outcome == "ok" and not slow):
            return
        slack_ms = None
        if deadline is not None:
            slack_ms = round((deadline - time.monotonic()) * 1000.0, 2)
        i = bisect_left(DEFAULT_BUCKETS, duration_s)
        bucket_le = (
            DEFAULT_BUCKETS[i] if i < len(DEFAULT_BUCKETS) else "+Inf"
        )
        stages = None
        if self.stages_fn is not None:
            try:
                stages = self.stages_fn()
            except Exception:
                stages = None
        rec = {
            "trace_id": tid_hex or None,
            "transport": transport,
            "role": self.role or None,
            "outcome": outcome,
            "slow": slow,
            "duration_ms": round(duration_s * 1000.0, 3),
            "bucket_le": bucket_le,
            "batch_size": batch_size,
            "deadline_slack_ms": slack_ms,
            "stages": stages,
        }
        if detail:
            rec.update(detail)
        self.flight.record(**rec)

    def stats(self) -> dict:
        """Outcome counts by transport — the gRPC servicer's debug
        stats surface."""
        with self._lock:
            by_outcome: dict[str, int] = {}
            by_transport: dict[str, int] = {}
            for (transport, outcome), n in self._counts.items():
                by_outcome[outcome] = by_outcome.get(outcome, 0) + n
                by_transport[transport] = by_transport.get(transport, 0) + n
        return {
            "checks": sum(by_outcome.values()),
            "by_outcome": by_outcome,
            "by_transport": by_transport,
            "slow_threshold_ms": round(self.slow_s * 1000.0, 1),
            "flight": self.flight.stats() if self.flight else None,
        }


class _CheckRecord:
    __slots__ = (
        "_tel", "transport", "batch_size", "deadline", "detail",
        "_t0", "_span", "trace_id", "traceparent", "hedge", "ledger",
        "_ledger_token",
    )

    def __init__(
        self, tel, transport, batch_size, deadline, detail,
        traceparent=None, hedge=False,
    ):
        self._tel = tel
        self.transport = transport
        self.batch_size = batch_size
        self.deadline = deadline
        self.detail = detail
        self.traceparent = traceparent
        self.hedge = bool(hedge)
        self._span = None
        self.trace_id = None
        self.ledger = None
        self._ledger_token = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        ambient = current_ledger()
        if isinstance(ambient, TransportLedger) and not ambient.claimed:
            # the REST transport's ledger, open since the body's first
            # byte: this record adopts it, and the transport folds it into
            # the attribution ledger once the reply is written. Up to here
            # the transport read and parsed the request: "admission"
            ambient.claim(self._tel.attribution, self.batch_size)
            ambient.mark("admission", self._t0)
            self.ledger = ambient
        else:
            # the accounting ledger shares t0 with the wall clock so the
            # conservation check (stages sum >= 95% of wall) is exact
            self.ledger = TimeLedger(self._t0)
            self._ledger_token = set_current_ledger(self.ledger)
        remote = (
            parse_traceparent(self.traceparent)
            if self.traceparent
            else None
        )
        if self._tel.tracer is not None:
            attrs = {
                "transport": self.transport,
                "batch_size": self.batch_size,
            }
            if self.hedge:
                attrs["hedge"] = 1
            self._span = self._tel.tracer.span(
                CheckTelemetry.SPAN_NAME, parent=remote, **attrs
            )
            self._span.__enter__()
        cur = _current_span.get()
        if cur is not None:
            self.trace_id = cur.trace_id
        elif remote is not None:
            # no tracer wired, but the caller still sent a trace id:
            # exemplars and flight records adopt it so the operator can
            # correlate by the id the client logged
            self.trace_id = remote.trace_id
        return self

    def mark(self, stage: str) -> None:
        """Attribute time-since-last-mark to ``stage`` on this
        request's ledger (transport handlers mark 'serialize' here)."""
        if self.ledger is not None:
            self.ledger.mark(stage)

    def __exit__(self, exc_type, exc, tb):
        duration_s = time.perf_counter() - self._t0
        outcome = self._tel._classify(exc_type)
        detail = self.detail
        if self.ledger is not None:
            self.ledger.mark("reply")
            if self._ledger_token is not None:
                try:
                    reset_current_ledger(self._ledger_token)
                except ValueError:
                    pass  # exited in a different context; ledger still ours
                self._ledger_token = None
                if self._tel.attribution is not None:
                    self._tel.attribution.record(
                        self.ledger, duration_s, self.batch_size
                    )
            if self.ledger.stages:
                detail = dict(detail or ())
                detail["ledger_ms"] = {
                    k: round(v * 1000.0, 3)
                    for k, v in self.ledger.stages.items()
                }
        if self.hedge:
            detail = dict(detail or ())
            detail["hedge"] = True
        if self._span is not None:
            self._span.attrs["outcome"] = outcome
            self._span.__exit__(exc_type, exc, tb)
        self._tel._finish(
            self.transport,
            duration_s,
            outcome,
            self.batch_size,
            self.deadline,
            self.trace_id,
            detail,
        )
        return False


# the do-nothing default servicers fall back to when no registry wired a
# real one in (no metrics, no tracer, no flight ring — just cheap clock
# reads and dict bookkeeping)
NOOP_CHECK_TELEMETRY = CheckTelemetry()
