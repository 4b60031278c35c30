"""The keto_tpu_torch command line (counterpart of ``keto_tpu/cli``)."""
