"""Device-engine circuit breaker (counterpart of
``keto_tpu/engine/fallback.py``).

The device engine is shared-fate for every check in the process: a failed
kernel launch, a lost card or a numerically sick one used to surface as an
exception on every caller, or worse, as wrong answers. The breaker gives
the read plane an explicit degraded mode:

- every batch answered by the primary engine is *validated* once, at the
  array seam (``batch_check_array``, ``decode_launched_array``): a bool
  array of the batch length, else a failure, not an answer. An engine
  without that seam answers a list, which is walked element by element;
- ``failure_threshold`` consecutive failures trip the breaker for
  ``cooldown_s``, and readiness drops to NOT_SERVING so balancers
  deprioritize this process;
- after the cooldown one probe batch rides the primary (half-open); success
  closes the breaker and restores readiness, failure re-opens it with a
  doubled cooldown (capped) plus jitter, so a flapping device cannot
  phase-lock with the probe cadence.

What answers while the card cannot depends on the cause, because a
fallback must never hide the card:

- a **real** device error (a kernel wrapper's CUDA error, any raise from
  the engine) fails its batch typed, :class:`DeviceKernelError` (503),
  takes readiness down at once and is never re-answered on the CPU; while
  a circuit that real errors opened stays open, every batch fails the same
  way until the half-open probe succeeds on the card;
- an **injected** fault (``faults.FaultInjected``, the ``device.*`` sites)
  and an invalid answer (which only the ``device.batch_nan`` site makes:
  the engines' array seams return bool arrays by construction) take the
  reference's path: the exact host oracle (``CheckEngine`` over the live
  store) answers, and every oracle-answered batch is counted
  (``fallback_batches``). The drills exercise that path on the card.

Every transition logs (``keto_tpu_torch.engine``) and is visible in
``breaker_snapshot`` (``/debug/device``).

:func:`classify_device_error` types each failure and routes it:

- **oom**: the batch was too big for the memory left, not a sick card —
  bisect the encoded batch, re-dispatch the halves on the card against the
  *same* snapshot and merge in order (exact: the kernels answer rows
  independently). Bounded depth; an OOM the bisection cannot absorb fails
  typed when real and goes to the oracle when injected.
- **compile_fail**: a launch the card refuses for one shape — when
  injected, quarantine that (bucket, snapshot-version) shape to the oracle
  without tripping the breaker; when real, fail typed like any real error.
- **device_lost**: a sticky context error or a gone card — force the
  breaker open at once and notify the device supervisor
  (``on_device_lost``), which re-probes and re-inits.
- **transient**: everything else, under the consecutive-failure threshold.

A ``KetoError`` the primary raises (a freshness 503, say) is an answer of
the read path, not a device failure: it passes through uncharged.

The wrapper is transparent: everything the batcher and the registry reach
through (``wait_for_version``, ``answering_version``, ``warmup``, ...)
delegates to the primary. With a metrics registry the breaker exports the
reference's families (``keto_device_engine_failures_total``,
``keto_device_fallback_batches_total``, ``keto_device_circuit_open``,
``keto_fallback_deadline_skips_total``, ``keto_device_oom_bisections_total``,
``keto_compile_quarantine_size``); the same counts are attributes here and
entries of ``breaker_snapshot``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..faults import FaultInjected
from ..relationtuple.definitions import RelationTuple
from ..utils.errors import ErrUnavailable, KetoError

_COOLDOWN_CAP_S = 60.0
#: every open window is stretched by up to this fraction of itself
_JITTER_FRAC = 0.25
#: bisection recursion bound: 2^6 = 64 sub-batches from one OOM at worst
_MAX_BISECT_DEPTH = 6
#: quarantined (bucket, snapshot-version) shapes kept; oldest pruned first
_QUARANTINE_CAP = 64

#: injected-fault sites mapped straight to their error class — the drills
#: arm these instead of fabricating runtime error strings
_FAULT_SITE_KINDS = {
    "device.oom": "oom",
    "device.lost": "device_lost",
    "device.compile_fail": "compile_fail",
}

# the CUDA runtime's words for a context the process can no longer use
# (sticky errors: every later call in the process fails the same way) and
# for a card that is gone
_CUDA_LOST = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "an illegal instruction",
    "uncorrectable ecc",
    "no cuda-capable device",
    "cuda driver",
)
# a launch refused for one shape (grid, block or resources), or a binary
# without code for this card: the other shapes still launch
_CUDA_SHAPE = (
    "too many resources requested for launch",
    "invalid configuration argument",
    "no kernel image is available",
)

_log = logging.getLogger("keto_tpu_torch.engine")


def classify_device_error(err: BaseException) -> str:
    """Type a raised device error: ``oom`` | ``device_lost`` |
    ``compile_fail`` | ``transient``. The reference's XLA status strings
    are kept (a message is a message), and the CUDA runtime's are added."""
    if isinstance(err, FaultInjected):
        return _FAULT_SITE_KINDS.get(err.site, "transient")
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "oom"
    msg = str(err).lower()
    if (
        "resource_exhausted" in msg
        or "out of memory" in msg
        or "failed to allocate" in msg
        or "allocation failure" in msg
    ):
        return "oom"
    if (
        "device_lost" in msg
        or "device lost" in msg
        or "device or resource busy" in msg
        or "failed_precondition: device" in msg
        or any(s in msg for s in _CUDA_LOST)
    ):
        return "device_lost"
    if any(s in msg for s in _CUDA_SHAPE):
        return "compile_fail"
    name = type(err).__name__
    if "compilation failure" in msg or "xla compilation" in msg:
        return "compile_fail"
    if name in ("XlaRuntimeError", "JaxRuntimeError", "JaxStackTraceBeforeTransformation") and (
        "compil" in msg or "mosaic" in msg or "unsupported" in msg
    ):
        return "compile_fail"
    return "transient"


class DeviceKernelError(ErrUnavailable):
    """A batch the card failed for real (a launch, a build or a copy
    raised), or one refused while a circuit that real errors opened is
    still open. Retryable (503): the batch was not answered anywhere."""

    def __init__(self, kind: str, cause: BaseException | str | None = None):
        self.kind = kind
        super().__init__(f"device error ({kind}): {cause}", reason=kind)


class _FallbackAnswered:
    """launch_encoded's return when the batch was answered by the host
    oracle instead of dispatched: decode_launched just unwraps it."""

    __slots__ = ("results",)

    def __init__(self, results: list):
        self.results = results


def _answers(results, n: int) -> Optional[list]:
    """The batch's answers as list[bool], or None when they are not a valid
    answer. A numpy array (the engines' array seam) is checked once, by
    dtype and shape, and converted in C; a list is walked."""
    if isinstance(results, np.ndarray):
        if results.dtype == np.bool_ and results.shape == (n,):
            return results.tolist()
        return None
    if not _valid_batch(results, n):
        return None
    return [bool(v) for v in results]


def _valid_batch(results, n: int) -> bool:
    """The engine contract is list[bool] of the batch length. Anything else
    (short batch, NaN, floats, None) is a sick-device symptom: treat it as
    a failure rather than bool()-coercing garbage into an answer."""
    try:
        if len(results) != n:
            return False
        for v in results:
            # bool and numpy.bool_ are fine; exact 0/1 integers are fine
            # (int is not bool, so check values); everything else — float
            # NaN included — is garbage
            if isinstance(v, bool):
                continue
            if type(v).__name__ == "bool_":  # numpy scalar, no hard dep
                continue
            if isinstance(v, int) and v in (0, 1):
                continue
            return False
    except TypeError:
        return False
    return True


class DeviceFallbackEngine:
    """Circuit breaker around a device-backed check engine with a host
    (exact oracle) fallback.

    ``fallback_factory`` is called at most once, on first need: there is
    no reason to build the oracle on a healthy boot. ``health`` is any
    object with ``set_serving(bool)`` (the registry's readiness).
    """

    def __init__(
        self,
        primary,
        fallback_factory,
        failure_threshold: int = 3,
        cooldown_s: float = 1.0,
        health=None,
        clock=time.monotonic,
        on_device_lost=None,  # DeviceSupervisor.notify_device_lost
        max_bisect_depth: int = _MAX_BISECT_DEPTH,
        jitter_frac: float = _JITTER_FRAC,
        rng=None,  # injectable random.Random for deterministic jitter tests
        metrics=None,
    ):
        self.primary = primary
        self._fallback_factory = fallback_factory
        self._fallback = None
        self.failure_threshold = max(1, failure_threshold)
        self.base_cooldown_s = cooldown_s
        self.health = health
        self._clock = clock
        self._on_device_lost = on_device_lost
        self.max_bisect_depth = max(0, int(max_bisect_depth))
        self.jitter_frac = max(0.0, float(jitter_frac))
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._open_until: Optional[float] = None  # None = closed
        self._cooldown_s = cooldown_s
        self._probing = False  # half-open: one probe at a time
        self._degraded_health = False  # only restore what WE took down
        # the open circuit was (re)opened by a real device error: batches
        # then fail typed instead of reaching the oracle
        self._open_real = False
        self._last_real_error: Optional[str] = None
        # (bucket, snapshot-version) -> quarantined-at (breaker clock):
        # shapes whose launch the card refused, served by the oracle
        # without opening the circuit; insertion-ordered so the cap prunes
        # oldest first
        self._quarantine: dict[tuple, float] = {}
        # the counts the reference exports as metrics
        self.n_failures = 0
        self.n_fallback_batches = 0
        self.n_deadline_skips = 0
        self.n_bisections = 0
        self.n_real_failures = 0  # batches failed typed, never re-answered
        self._m_failures = self._m_fallback_batches = None
        self._m_deadline_skips = self._m_bisections = None
        if metrics is not None:
            self._m_failures = metrics.counter(
                "keto_device_engine_failures_total",
                "device engine batches that raised or returned invalid output",
            )
            self._m_fallback_batches = metrics.counter(
                "keto_device_fallback_batches_total",
                "check batches answered by the host oracle while the "
                "device circuit is open",
            )
            metrics.gauge(
                "keto_device_circuit_open",
                "1 while checks are served by the host fallback",
                fn=lambda: 0.0 if self._open_until is None else 1.0,
            )
            self._m_deadline_skips = metrics.counter(
                "keto_fallback_deadline_skips_total",
                "rows the host-oracle fallback did not re-answer because "
                "their caller deadline had already passed",
            )
            self._m_bisections = metrics.counter(
                "keto_device_oom_bisections_total",
                "encoded batches split in half and re-dispatched after a "
                "device out-of-memory",
            )
            metrics.gauge(
                "keto_compile_quarantine_size",
                "(bucket, snapshot-version) shapes quarantined to the host "
                "oracle after a shape-specific compile failure",
                fn=lambda: float(len(self._quarantine)),
            )

    # -- breaker bookkeeping ---------------------------------------------------

    def circuit_open(self) -> bool:
        with self._lock:
            return self._open_until is not None

    def force_probe(self) -> None:
        """Collapse the open window: the next batch becomes the half-open
        probe NOW. The device supervisor calls this after a successful
        teardown/re-init — waiting out a (possibly doubled) cooldown after
        the device is already back just burns oracle latency."""
        with self._lock:
            if self._open_until is not None:
                self._open_until = self._clock()

    def fallback_engine(self):
        """The host oracle, built on first need (the scrubber's replay
        oracle reads it too)."""
        if self._fallback is None:
            self._fallback = self._fallback_factory()
        return self._fallback

    def _use_primary(self) -> bool:
        """Route decision per batch; flips to half-open probe after the
        cooldown (exactly one concurrent probe — the rest keep falling
        back until the probe verdict lands)."""
        with self._lock:
            if self._open_until is None:
                return True
            if self._probing or self._clock() < self._open_until:
                return False
            self._probing = True
            return True

    def _record_failure(
        self,
        err: Optional[BaseException],
        force_open: bool = False,
        real: bool = False,
    ) -> None:
        """``force_open`` opens the circuit regardless of the consecutive
        threshold — a lost device fails every future batch, so waiting out
        the threshold just burns caller latency. A ``real`` failure takes
        readiness down at once, open circuit or not."""
        if self._m_failures is not None:
            self._m_failures.inc()
        with self._lock:
            self.n_failures += 1
            self._probing = False
            self._consecutive_failures += 1
            was_open = self._open_until is not None
            if was_open:
                # failed probe: re-open, back off harder
                self._cooldown_s = min(self._cooldown_s * 2, _COOLDOWN_CAP_S)
                tripped = False
            else:
                tripped = (
                    force_open
                    or self._consecutive_failures >= self.failure_threshold
                )
            if tripped or was_open:
                # jittered open window: a flapping device must not phase-
                # lock with the half-open probe cadence
                jitter = self._cooldown_s * self.jitter_frac * self._rng.random()
                self._open_until = self._clock() + self._cooldown_s + jitter
                self._open_real = real
            if real:
                self.n_real_failures += 1
                self._last_real_error = str(err)[-200:]
            take_health_down = (
                tripped or was_open or real
            ) and not self._degraded_health
            if take_health_down:
                self._degraded_health = True
            cooldown = self._cooldown_s
        if tripped or was_open:
            _log.warning(
                "device engine circuit OPEN; %s (error=%s, cooldown_s=%s)",
                "failing checks typed" if real
                else "serving checks from the host oracle",
                str(err) if err is not None else "invalid output", cooldown,
            )
        elif real:
            _log.warning("device batch failed: %s", err)
        if take_health_down and self.health is not None:
            self.health.set_serving(False)

    def _record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probing = False
            recovered = self._open_until is not None
            self._open_until = None
            self._open_real = False
            self._cooldown_s = self.base_cooldown_s
            restore = self._degraded_health
            if restore:
                self._degraded_health = False
        if recovered:
            _log.info("device engine circuit CLOSED; primary engine healthy")
        if restore and self.health is not None:
            self.health.set_serving(True)

    def _note_failure(self, err: Optional[BaseException]) -> None:
        """Typed failure bookkeeping for the non-launch seams. A real error
        fails the batch typed (raises); an injected one is recorded and the
        caller answers from the oracle: device-lost forces the circuit open
        and wakes the supervisor, everything else keeps the consecutive-
        threshold semantics."""
        if err is not None and not isinstance(err, FaultInjected):
            self._fail_real(err)
        if err is not None and classify_device_error(err) == "device_lost":
            self._record_failure(err, force_open=True)
            self._notify_device_lost(err)
        else:
            self._record_failure(err)

    def _fail_real(self, err: BaseException):
        """Fail the batch a real error hit: charge the breaker, take
        readiness down, wake the supervisor on a lost device, and raise
        :class:`DeviceKernelError`. A ``KetoError`` is re-raised as is."""
        if isinstance(err, KetoError):
            raise err
        kind = classify_device_error(err)
        lost = kind == "device_lost"
        self._record_failure(err, force_open=lost, real=True)
        if lost:
            self._notify_device_lost(err)
        raise DeviceKernelError(kind, err) from err

    def _refuse_open(self) -> None:
        """A batch routed away from the primary while the circuit is open:
        when real errors opened it, the batch fails typed here; otherwise
        the caller answers it from the oracle."""
        with self._lock:
            real, last = self._open_real, self._last_real_error
        if real:
            raise DeviceKernelError("circuit_open", last)

    def _notify_device_lost(self, err: BaseException) -> None:
        cb = self._on_device_lost
        if cb is None:
            return
        try:
            cb(err)
        except Exception:
            _log.exception("device supervisor notification failed")

    # -- compile quarantine ----------------------------------------------------

    def _quarantined(self, key: tuple) -> bool:
        with self._lock:
            return key in self._quarantine

    def _add_quarantine(self, key: tuple) -> None:
        with self._lock:
            self._quarantine[key] = self._clock()
            while len(self._quarantine) > _QUARANTINE_CAP:
                self._quarantine.pop(next(iter(self._quarantine)))

    def quarantine_snapshot(self) -> list[dict]:
        """The quarantined shapes, for /debug/device."""
        with self._lock:
            return [
                {"bucket": b, "snapshot_version": v, "since": t}
                for (b, v), t in self._quarantine.items()
            ]

    def breaker_snapshot(self) -> dict:
        """Breaker internals, for /debug/device: the reference's keys, the
        counts it exports as metrics (``failures``, ``fallback_batches``,
        ``deadline_skips``, ``oom_bisections``), and the port's real-error
        record (``real_failures``, ``open_real``, ``last_real_error``)."""
        with self._lock:
            return {
                "open": self._open_until is not None,
                "open_real": self._open_real,
                "real_failures": self.n_real_failures,
                "last_real_error": self._last_real_error,
                "consecutive_failures": self._consecutive_failures,
                "cooldown_s": self._cooldown_s,
                "probing": self._probing,
                "quarantine_size": len(self._quarantine),
                "failures": self.n_failures,
                "fallback_batches": self.n_fallback_batches,
                "deadline_skips": self.n_deadline_skips,
                "oom_bisections": self.n_bisections,
            }

    # -- check surface ---------------------------------------------------------

    def _primary_batch(self, name: str, *args):
        """One primary call through its array seam where it has one."""
        fn = getattr(self.primary, name + "_array", None)
        if fn is None:
            fn = getattr(self.primary, name)
        return fn(*args)

    #: ``batch_check`` takes a caller's ``deadline`` (the batcher's one
    #: capability check before it passes one)
    takes_deadline = True

    def batch_check(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
        deadline: Optional[float] = None,
    ) -> list:
        """The primary answers; when the host oracle must answer instead,
        an absolute ``time.monotonic()`` ``deadline`` bounds it row by row,
        and rows it has not reached by then come back None."""
        if not requests:
            return []
        deadlines = None if deadline is None else [deadline] * len(requests)
        if self._use_primary():
            try:
                results = self._primary_batch(
                    "batch_check", requests, max_depth, depths
                )
            except Exception as e:
                self._note_failure(e)
                return self._fallback_check(requests, max_depth, depths, deadlines)
            answers = _answers(results, len(requests))
            if answers is None:
                self._record_failure(None)
                return self._fallback_check(requests, max_depth, depths, deadlines)
            self._record_success()
            return answers
        self._refuse_open()
        return self._fallback_check(requests, max_depth, depths, deadlines)

    # -- pipelined surface (encode/launch/decode split) ------------------------
    #
    # The batcher's pipeline reaches the engine through these instead of
    # batch_check. Encode is host-side (vocab probes — a raise there is a
    # caller bug, not a sick card) and passes straight through; launch and
    # decode are the device seams, so they carry the breaker. The contract
    # the pipeline needs: NO in-flight batch is ever lost — a batch whose
    # launch or decode fails for real raises typed, and the batcher fails
    # exactly that batch's futures; one whose failure was injected is
    # re-answered exactly (host oracle), and once such a circuit trips every
    # later launch routes to the oracle immediately, so every future already
    # in the pipe still resolves.

    def pipeline_supported(self) -> bool:
        sup = getattr(self.primary, "pipeline_supported", None)
        if callable(sup):
            return sup()
        return callable(getattr(self.primary, "encode_batch", None))

    def encode_batch(self, requests, max_depth=0, depths=None):
        return self.primary.encode_batch(requests, max_depth, depths=depths)

    @staticmethod
    def _shape_key(enc) -> tuple:
        # tolerant of minimal engine stand-ins in tests: an unknown shape
        # (None, None) can be quarantined like any other
        return (getattr(enc, "b", None), getattr(enc, "version", None))

    def launch_encoded(self, enc):
        if self._quarantined(self._shape_key(enc)):
            # this (bucket, snapshot) shape cannot launch: route it to the
            # oracle without consulting (or charging) the breaker
            return self._answer_from_oracle(enc)
        if self._use_primary():
            try:
                return self.primary.launch_encoded(enc)
            except Exception as e:
                handled = self._handle_launch_error(enc, e)
                if handled is not None:
                    return handled
        else:
            # the caller (the batcher) releases the batch it fails
            self._refuse_open()
        # circuit open (or an injected fault killed the launch): answer this
        # batch from the host oracle NOW — its staging buffers go back to
        # the pool and decode becomes a no-op unwrap
        return self._answer_from_oracle(enc)

    def _answer_from_oracle(self, enc) -> _FallbackAnswered:
        requests, depths = enc.requests, enc.depths
        deadlines = getattr(enc, "deadlines", None)
        enc.release()
        return _FallbackAnswered(self._fallback_check(requests, 0, depths, deadlines))

    def _handle_launch_error(self, enc, err):
        """Typed recovery for a failed launch. Returns a ``_FallbackAnswered``
        when a policy absorbed the error (bisection answered exactly on the
        card, or an injected fault's shape went to quarantine); ``None``
        sends the caller down the breaker's host-oracle path, which only an
        injected fault reaches: a real error raises typed."""
        kind = classify_device_error(err)
        injected = isinstance(err, FaultInjected)
        if kind == "oom":
            results = self._bisect_oom(enc)
            if results is not None:
                # the batch was too big for the memory left, not a sick
                # card: the halves answered, the breaker stays closed
                self._record_success()
                return _FallbackAnswered(results)
        if not injected:
            self._fail_real(err)
        if kind == "oom":
            self._record_failure(err)
            return None
        if kind == "compile_fail":
            key = self._shape_key(enc)
            self._add_quarantine(key)
            _log.warning(
                "launch refused for one shape: quarantining bucket %s at "
                "snapshot %s to the host oracle (%s)", key[0], key[1], err,
            )
            return self._answer_from_oracle(enc)
        if kind == "device_lost":
            self._record_failure(err, force_open=True)
            self._notify_device_lost(err)
            return None
        self._record_failure(err)
        return None

    # -- OOM bisection ---------------------------------------------------------

    def _bisect_oom(self, enc) -> Optional[list[bool]]:
        """Split-and-retry for an OOM'd launch: snapshot the encoded ids,
        re-encode the halves against the parent batch's snapshot, dispatch
        each, merge in order. Returns the merged bool list (parity-exact
        with the unsplit answer — the kernels answer rows independently),
        or None when bisection can't help (single row, unsupported engine,
        a half failed for a non-OOM reason, depth exhausted)."""
        n = getattr(enc, "n", 0)
        if self.max_bisect_depth <= 0 or n <= 1:
            return None
        encode_at = getattr(self.primary, "encode_ids_at", None)
        if encode_at is None:
            return None
        try:
            start = enc.start[:n].copy()
            target = enc.target[:n].copy()
            depths = list(enc.depths) if enc.depths is not None else [0] * n
            results = self._bisect_ids(enc.snap, start, target, depths, 1)
        except Exception:
            return None
        if results is None:
            return None
        enc.release()
        _log.info("device OOM absorbed by batch bisection (%d rows)", n)
        return results

    def _bisect_ids(self, snap, start, target, depths, depth):
        with self._lock:
            self.n_bisections += 1
        if self._m_bisections is not None:
            self._m_bisections.inc()
        mid = len(start) // 2
        merged: list = []
        for lo, hi in ((0, mid), (mid, len(start))):
            sub = self._dispatch_ids(
                snap, start[lo:hi], target[lo:hi], depths[lo:hi], depth
            )
            if sub is None:
                return None
            merged.extend(sub)
        return merged

    def _dispatch_ids(self, snap, start, target, depths, depth):
        enc = self.primary.encode_ids_at(snap, start, target, depths)
        try:
            launched = self.primary.launch_encoded(enc)
        except Exception as e:
            # a raised launch leaves the half's staging buffers checked out
            enc.release()
            if (
                classify_device_error(e) == "oom"
                and len(start) > 1
                and depth < self.max_bisect_depth
            ):
                return self._bisect_ids(snap, start, target, depths, depth + 1)
            return None
        try:
            # the primary's decode releases the half in its finally
            results = self._primary_batch("decode_launched", launched)
        except Exception:
            return None
        return _answers(results, len(start))

    def decode_launched(self, launched) -> list:
        if isinstance(launched, _FallbackAnswered):
            return launched.results
        enc = launched.enc
        n = enc.n
        depths = enc.depths
        # Lazy materialization: per-tuple batches hold their requests and
        # columnar batches hold their columns, so the oracle's tuples are
        # built ONLY inside the failure branches below. Pure-id batches
        # (encode_ids) can only decode back to tuples while their staging
        # buffers are alive, and primary.decode_launched releases those, so
        # snap the materialization up front for that shape alone.
        requests = None
        if (
            getattr(enc, "_requests", 0) is None
            and getattr(enc, "_cols", 0) is None
        ):
            requests = enc.requests
        deadlines = getattr(enc, "deadlines", None)
        try:
            results = self._primary_batch("decode_launched", launched)
        except Exception as e:
            self._note_failure(e)
            return self._fallback_check(
                requests if requests is not None else enc.requests,
                0, depths, deadlines,
            )
        answers = _answers(results, n)
        if answers is None:
            self._record_failure(None)
            return self._fallback_check(
                requests if requests is not None else enc.requests,
                0, depths, deadlines,
            )
        self._record_success()
        return answers

    def batch_check_columns(self, cols, max_depth: int = 0, depths=None) -> list[bool]:
        """Columnar twin of batch_check: the primary answers straight from
        the columns; ``RelationTuple`` objects are built lazily ONLY when
        the host oracle must re-answer the batch (an injected fault, an
        invalid answer, or a circuit such a failure opened)."""
        n = len(cols)
        if not n:
            return []
        if getattr(self.primary, "batch_check_columns", None) is None:
            return self.batch_check(cols.materialize(), max_depth, depths)
        if self._use_primary():
            try:
                results = self._primary_batch(
                    "batch_check_columns", cols, max_depth, depths
                )
            except Exception as e:
                self._note_failure(e)
                return self._fallback_check(cols.materialize(), max_depth, depths)
            answers = _answers(results, n)
            if answers is None:
                self._record_failure(None)
                return self._fallback_check(cols.materialize(), max_depth, depths)
            self._record_success()
            return answers
        self._refuse_open()
        return self._fallback_check(cols.materialize(), max_depth, depths)

    def _fallback_check(self, requests, max_depth, depths, deadlines=None) -> list:
        with self._lock:
            self.n_fallback_batches += 1
        if self._m_fallback_batches is not None:
            self._m_fallback_batches.inc()
        if deadlines is None:
            return self._fallback_answer(requests, max_depth, depths)
        # The oracle is a host BFS per row and may take far longer than any
        # caller's deadline (minutes a row on a ten-million-tuple columnar
        # store), so the deadline is checked before EVERY row, not once per
        # batch, and inside the row where the oracle can (CheckEngine's
        # check_until reads the clock before each page it asks the store
        # for): a row whose deadline passes comes back None (the batcher
        # fails its caller typed; a None is never cached), and the batch
        # returns by its latest deadline plus one page (one row, for an
        # oracle without check_until). Every answered row is the oracle's
        # full answer. The clock is the batcher's (time.monotonic), not the
        # breaker's injectable one.
        engine = self.fallback_engine()
        until = getattr(engine, "check_until", None)
        out: list = [None] * len(requests)
        skipped = 0
        for i, request in enumerate(requests):
            dl = deadlines[i]
            if dl is not None and time.monotonic() >= dl:
                skipped += 1
                continue
            depth = max_depth if depths is None else depths[i]
            if dl is not None and until is not None:
                got = until(request, depth, dl)
                if got is None:
                    skipped += 1
                    continue
                out[i] = bool(got)
            else:
                out[i] = bool(engine.batch_check([request], depth)[0])
        if skipped:
            with self._lock:
                self.n_deadline_skips += skipped
            if self._m_deadline_skips is not None:
                self._m_deadline_skips.inc(skipped)
        return out

    def _fallback_answer(self, requests, max_depth, depths) -> list[bool]:
        if not requests:
            return []
        engine = self.fallback_engine()
        if depths is not None:
            # the host oracle has no per-request-depth batch entry point;
            # per-request evaluation is its native shape anyway
            return [
                bool(engine.subject_is_allowed(r, d))
                for r, d in zip(requests, depths)
            ]
        return [bool(v) for v in engine.batch_check(requests, max_depth)]

    def subject_is_allowed(self, requested: RelationTuple, max_depth: int = 0) -> bool:
        return self.batch_check([requested], max_depth)[0]

    # -- transparency ----------------------------------------------------------

    def __getattr__(self, name):
        # wait_for_version / answering_version / served_version / warmup /
        # host_queries / snapshots ... — everything else is the primary's
        return getattr(self.primary, name)
