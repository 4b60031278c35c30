"""The fleet's observability and election plane (counterpart of
``keto_tpu/cluster``). Followers push heartbeats to the leader over the
replication plane (:class:`ClusterHeartbeater`), the leader tracks liveness
per instance (:class:`ClusterMembership`), ``telemetry/federation.py``
scrapes each member's ``/metrics`` and ``/replication/status`` into
instance-labelled ``keto_cluster_*`` series and the ``/cluster/status``
rollup, and :mod:`.election` keeps one writer through lease-based failover.
"""

from .election import ElectionManager, LeaseStore, PromotedReplicationSource
from .heartbeat import ClusterHeartbeater
from .membership import ClusterMembership

__all__ = [
    "ClusterHeartbeater",
    "ClusterMembership",
    "ElectionManager",
    "LeaseStore",
    "PromotedReplicationSource",
]
