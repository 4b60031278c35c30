"""Telemetry (counterpart of ``keto_tpu/telemetry/``): the device statistics
collector. Metrics, tracing, the flight recorder, SLOs and the profilers
wait for ROADMAP 14.5."""
