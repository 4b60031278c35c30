"""W3C trace context for the client (counterpart of
``keto_tpu/telemetry/tracing.py``, trimmed to what the client stamps).

The reference's tracer builds spans over the serving stack and exports
them; this package has no spans yet (ROADMAP 14.5). What the client SDK
needs is the wire half: the ``traceparent`` header it stamps on every check
(minted here with random 128-bit trace ids, as in the reference, so ids
from many processes never collide) and the ``x-keto-hedge`` header that
marks a hedged duplicate.
"""

from __future__ import annotations

import os
from typing import Optional

# W3C Trace Context (https://www.w3.org/TR/trace-context/) wire names.
# TRACEPARENT_HEADER doubles as the gRPC metadata key (metadata keys are
# lowercase by spec, and the header name already is).
TRACEPARENT_HEADER = "traceparent"
# marks the duplicate request a Hedger fires so the server can tell it from
# the primary carrying the same trace id
HEDGE_HEADER = "x-keto-hedge"


class SpanContext:
    """Remote span identity parsed off a ``traceparent`` header."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


def format_traceparent(trace_id: int, span_id: int) -> str:
    """``00-<32 hex trace>-<16 hex span>-01`` (version 00, sampled)."""
    return f"00-{trace_id:032x}-{span_id:016x}-01"


def parse_traceparent(value) -> Optional[SpanContext]:
    """Parse a W3C traceparent header; None on anything malformed.
    Per spec, all-zero trace or span ids are invalid and ignored."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        trace_id = int(parts[1], 16)
        span_id = int(parts[2], 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return SpanContext(trace_id, span_id)


def mint_traceparent() -> str:
    """A fresh client-side traceparent: new root trace, new span id."""
    return format_traceparent(
        int.from_bytes(os.urandom(16), "big") or 1,
        int.from_bytes(os.urandom(8), "big") or 1,
    )


def current_traceparent() -> Optional[str]:
    """The traceparent of the active span. Always None: this package has
    no spans until ROADMAP 14.5 ports the tracer, so every client request
    starts a trace of its own."""
    return None
