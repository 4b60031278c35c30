"""Replication (counterpart of ``keto_tpu/replication``): the anti-entropy
digest only, which ``doctor`` prints. The leader/follower fleet waits for
ROADMAP 14.6."""

from .digest import compute_digest, diff_digests

__all__ = ["compute_digest", "diff_digests"]
