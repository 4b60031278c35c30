"""The replicated read plane (counterpart of ``keto_tpu/replication``): WAL
shipping from a durable leader to follower replicas, and the snaptoken
machinery that makes consistency across replicas real.

- :mod:`.token` — the structured snaptoken ``z<version>.<segment>.<offset>``
  every WAL'd write acks with, and its parser (bare integers still parse).
- :mod:`.leader` — the leader's replication source: checkpoint seed and WAL
  tail, served on the write plane's router.
- :mod:`.follower` — the follower's replicator: checkpoint bootstrap, tail
  replay through the store's ordered delta feed, snaptoken waits, and
  shared-disk promotion.
- :mod:`.digest` — the anti-entropy digest the scrubber's replica kind and
  ``doctor`` compute.

``ReplicationSource`` and ``FollowerReplicator`` are exported lazily: the
REST plane imports the token module, and the leader imports the REST plane.
"""

from .digest import compute_digest, diff_digests
from .token import LATEST_SENTINEL, SnapToken, encode_snaptoken, parse_snaptoken

__all__ = [
    "FollowerReplicator",
    "LATEST_SENTINEL",
    "ReplicationSource",
    "SnapToken",
    "compute_digest",
    "diff_digests",
    "encode_snaptoken",
    "parse_snaptoken",
]


def __getattr__(name: str):
    if name == "ReplicationSource":
        from .leader import ReplicationSource

        return ReplicationSource
    if name == "FollowerReplicator":
        from .follower import FollowerReplicator

        return FollowerReplicator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
