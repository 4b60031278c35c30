"""The REST transport and its port serving (counterpart of ``keto_tpu/api``,
REST only)."""
