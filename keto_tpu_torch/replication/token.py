"""Structured snaptokens, Zanzibar's "zookies" (counterpart of
``keto_tpu/replication/token.py``).

A write on a WAL'd store acks with::

    z<version>.<wal_segment_first_version>.<byte_offset>

- ``version`` — the store's monotonic write counter, the component every
  consistency decision uses (followers replay versions in order, so
  "replica caught up to token" is exactly ``replica.version >= version``).
- ``wal_segment``/``offset`` — where the ack's WAL frame landed (segment =
  the segment's first version, as in its file name; offset = the byte just
  past the frame): the durable bytes behind any acked token.

Tokens are opaque to clients. A bare integer (what stores without a WAL
mint) parses as ``SnapToken(version, 0, 0)``. Ordering is by version
alone; segment and offset are never consulted for freshness.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_TOKEN_RE = re.compile(r"^z(\d+)\.(\d+)\.(\d+)$")

#: min_version for ``latest: true``: far above any real store version. It
#: lives here so the follower's wait can recognize it without the API layer
LATEST_SENTINEL = 1 << 62


@dataclass(frozen=True)
class SnapToken:
    """One acked write's durable position."""

    version: int
    segment: int = 0  # first version of the WAL segment holding the frame
    offset: int = 0  # byte offset just past the frame in that segment

    def encode(self) -> str:
        return f"z{self.version}.{self.segment}.{self.offset}"

    def __str__(self) -> str:  # the registry's snaptoken returns str(token)
        return self.encode()


def encode_snaptoken(version: int, segment: int = 0, offset: int = 0) -> str:
    return SnapToken(int(version), int(segment), int(offset)).encode()


def parse_snaptoken(token: str) -> SnapToken:
    """Parse either spelling; ``ValueError`` on anything else (the API layer
    maps it to a 400)."""
    m = _TOKEN_RE.match(token)
    if m is not None:
        return SnapToken(
            version=int(m.group(1)), segment=int(m.group(2)), offset=int(m.group(3))
        )
    return SnapToken(version=int(token))
