"""Client-side retry: exponential backoff with jitter, deadline-honoring
(counterpart of ``keto_tpu/client/retry.py``, whole).

The server now sheds load (HTTP 429 / gRPC RESOURCE_EXHAUSTED when the
check queue is full) and may be briefly UNAVAILABLE around replica
restarts — both are explicit invitations to retry, and a client that
retries immediately just re-arrives in the same overloaded instant as
every other rejected caller. The policy here is the standard remedy:
exponential backoff with randomized jitter to decorrelate retry storms,
and a hard overall deadline so retrying never takes longer than the
caller was willing to wait for the original call.

Deadline accounting is end-to-end: each attempt is given the REMAINING
budget as its per-attempt timeout, and a backoff sleep that would
overshoot the deadline is not taken — the last error is raised instead.

Two pieces of overload discipline ride on top (the client half of the
``engine/overload.py`` plane):

- :class:`RetryBudget` — a token bucket shared across a client instance
  that caps retries at ~``ratio`` (default 10%) of request volume. Each
  first attempt earns ``ratio`` tokens (bounded by ``burst``); each
  retry spends one. When the bucket is dry the original error is raised
  instead of retrying — under a sustained overload the whole client's
  retry amplification converges to ``1 + ratio`` instead of
  ``max_attempts``x, which is what keeps a shed from becoming a storm.
- ``Retry-After`` honoring — a server shed carries an explicit backoff
  hint (HTTP header / gRPC trailing metadata, surfaced on the raised
  error as ``retry_after_s``); ``run_with_retry`` uses it as a FLOOR
  under the jittered exponential delay, so the client never re-arrives
  earlier than the server asked.

``sleep`` and ``rand`` are injectable so tests drive the schedule
deterministically.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

#: gRPC status codes worth retrying: the server was unreachable/restarting,
#: or explicitly shed this request before doing any work.
RETRYABLE_GRPC_CODES = ("UNAVAILABLE", "RESOURCE_EXHAUSTED")
#: The HTTP equivalents (api/rest.py maps the same error taxonomy).
RETRYABLE_HTTP_STATUS = (429, 503)


class RetryPolicy:
    """Backoff schedule: ``base * multiplier**attempt`` capped at ``max_delay``,
    scaled by ``1 - jitter + jitter*rand()`` (jitter=0.5 -> 50-100% of the
    nominal delay). ``max_attempts`` counts the first try."""

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay_s: float = 0.05,
        multiplier: float = 2.0,
        max_delay_s: float = 2.0,
        jitter: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rand: Callable[[], float] = random.random,
    ):
        self.max_attempts = max(1, max_attempts)
        self.base_delay_s = base_delay_s
        self.multiplier = multiplier
        self.max_delay_s = max_delay_s
        self.jitter = min(1.0, max(0.0, jitter))
        self.sleep = sleep
        self.rand = rand

    def delay_s(self, attempt: int) -> float:
        nominal = min(
            self.max_delay_s, self.base_delay_s * self.multiplier**attempt
        )
        return nominal * (1.0 - self.jitter + self.jitter * self.rand())


class RetryBudget:
    """Token bucket capping a client instance's retries at ~``ratio`` of
    its request volume (Google SRE book, "Handling Overload"): every
    first attempt deposits ``ratio`` tokens (clamped to ``burst``), every
    retry withdraws one. ``spend()`` failing means the budget is
    exhausted — raise the original error instead of retrying.

    Shared across all calls of a client instance (thread-safe), so a few
    failing requests can still retry while a total outage cannot multiply
    the offered load by ``max_attempts``."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0):
        self.ratio = max(0.0, float(ratio))
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst  # start full: cold clients may retry
        self._lock = threading.Lock()
        self.exhausted = 0  # retries refused because the bucket was dry

    def on_request(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.exhausted += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


def retry_after_hint_s(err: BaseException) -> Optional[float]:
    """The server's Retry-After hint off a raised error, if the transport
    attached one (``retry_after_s`` attribute), else None."""
    hint = getattr(err, "retry_after_s", None)
    if hint is None:
        return None
    try:
        return max(0.0, float(hint))
    except (TypeError, ValueError):
        return None


def run_with_retry(
    attempt_fn: Callable[[Optional[float]], object],
    policy: RetryPolicy,
    retryable: Callable[[BaseException], bool],
    timeout: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
    budget: Optional[RetryBudget] = None,
):
    """Run ``attempt_fn(remaining_s)`` until it succeeds, raises a
    non-retryable error, exhausts ``policy.max_attempts`` (or the shared
    ``budget``), or the overall ``timeout`` leaves no room for another
    attempt. A ``retry_after_s`` hint on the raised error floors the
    backoff delay — the server asked for at least that much quiet."""
    deadline = None if timeout is None else clock() + timeout
    attempt = 0
    if budget is not None:
        budget.on_request()
    while True:
        remaining = None if deadline is None else deadline - clock()
        if remaining is not None and remaining <= 0:
            remaining = 0.0  # let the transport raise its own deadline error
        try:
            return attempt_fn(remaining)
        except BaseException as e:
            if attempt + 1 >= policy.max_attempts or not retryable(e):
                raise
            if budget is not None and not budget.spend():
                # retry budget exhausted: amplifying a sustained overload
                # helps nobody — surface the server's answer as-is
                raise
            delay = policy.delay_s(attempt)
            hint = retry_after_hint_s(e)
            if hint is not None:
                delay = max(delay, hint)
            if deadline is not None and clock() + delay >= deadline:
                # sleeping would eat the whole remaining budget: the caller
                # is better served by the real error now than by a
                # guaranteed deadline failure later
                raise
            policy.sleep(delay)
            attempt += 1


def grpc_code_name(err: BaseException) -> str:
    """The status-code NAME of a grpc.RpcError ('' when unavailable) —
    structural, so tests can use lightweight fakes."""
    code = getattr(err, "code", None)
    if not callable(code):
        return ""
    try:
        return getattr(code(), "name", "") or ""
    except Exception:
        return ""


def grpc_retryable(err: BaseException) -> bool:
    return grpc_code_name(err) in RETRYABLE_GRPC_CODES
