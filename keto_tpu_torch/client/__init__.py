"""Client helpers (counterpart of ``keto_tpu/client``, the vocab cache of
the id-native wire tier only)."""

from .vocabcache import VocabCache, batch_check_encoded

__all__ = ["VocabCache", "batch_check_encoded"]
