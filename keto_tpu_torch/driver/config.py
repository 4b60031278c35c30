"""Config provider (counterpart of ``keto_tpu/driver/config.py``, trimmed).

The same key tree as the reference — ``dsn``, ``serve.read.{host,port,
max-depth,max_freshness_wait_s,workers,wire_workers,list,encoded,
grpc-max-message-size,tls,cors,expose_backend_ports}``,
``serve.write.{host,port,grpc-max-message-size,tls,cors,
expose_backend_ports}``, ``log.{level,format}``, ``namespaces`` (an inline
array of ``{id, name}``, or a string URI: ``file://``, a bare path, a
directory, ``ws://``), the ``engine`` subtree,
``qos.{enabled,rate,burst,overrides}``, ``tracing.{provider,otlp}``, and the
``telemetry``, ``overload``, ``scrub``, ``debug``, ``replication``,
``cluster`` and ``autotune`` subtrees — from a JSON
or TOML file (YAML where PyYAML is installed) merged with ``values``. The
reference's schema is checked by hand, with its messages (no jsonschema):
the root object, ``serve``, ``engine`` and each of its ``mesh``,
``sharding``, ``memory`` and ``failover`` objects, ``qos``, ``autotune``
and each ``autotune.knobs.<name>``, the ``telemetry`` object and each of
its ``flight``, ``slo``, ``attribution`` and ``profiler`` objects,
``tracing.otlp``, and the ``overload``, ``scrub``, ``debug``,
``replication``, ``cluster``, ``cluster.health`` and ``cluster.election``
objects are closed, as there, so a misspelt key is an error. Of several
violations the one reported is jsonschema's ``best_match``: the shallowest,
and of siblings the one whose path sorts last. ``serve.read``,
``serve.write``, ``log`` and ``tracing`` stay open, as in the reference.
``version``, ``profiling`` and ``engine.compile_cache_dir`` (the
reference's JAX compilation cache; the port's kernel build cache is
``utils/kernels.py``) are declared and typed but not read.
``scrub.freeze_burn_rate`` is the scrubber's SLO freeze threshold (0 means
``telemetry.slo.alert_burn_rate``), and ``scrub.digest_chunk_size`` the
replica kind's chunk. ``replication`` and ``cluster`` reload as in the
reference: neither is frozen nor a hot knob, so a reload swaps their values
and a component that reads them per call (the write plane's read-only
gate reads ``replication.role``) follows. The
durable write plane's ``store.wal.{dir,sync,sync-interval-ms,segment-bytes}``
and ``checkpoint.{dir,interval-versions,interval-s,keep}`` are closed
objects too.

Lookup order, as in the reference: a flag override (``flag_overrides``,
``set_override``, ``set_hot``), then ``KETO_<KEY>``, then the unprefixed
``<KEY>`` in ``env`` (``os.environ`` unless given; ``serve.read.port`` ->
``SERVE_READ_PORT``: dots and dashes to underscores, uppercased; the value
parses as JSON, else stays a string, and is not validated), then the file
and values, then the defaults.

``reload()`` re-reads the file while serving (reference provider.go:58-104):
``dsn`` and ``serve`` stay frozen at their boot values, except the
``HOT_SERVE_KEYS`` carve-outs; a changed ``namespaces`` refreshes the
namespace manager in place; a file that fails validation raises and leaves
the previous config serving. ``HOT_ENGINE_KEYS`` are the knobs a live server
re-applies (``driver/registry.py``); ``set_hot`` is their validated write
path.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from ..namespace.definitions import MemoryNamespaceManager, Namespace, NamespaceManager
from ..utils.errors import ErrMalformedInput
from ..utils.fileformat import load_structured_file

KEY_DSN = "dsn"
KEY_READ_PORT = "serve.read.port"
KEY_READ_HOST = "serve.read.host"
KEY_WRITE_PORT = "serve.write.port"
KEY_WRITE_HOST = "serve.write.host"
KEY_READ_MAX_DEPTH = "serve.read.max-depth"  # reference provider.go:32
KEY_NAMESPACES = "namespaces"

_UNSET = object()  # sentinel so falsy explicit defaults (0/False/"") are honored

DEFAULTS = {
    "dsn": "memory",
    "serve.read.port": 4466,
    "serve.read.host": "",
    "serve.read.max-depth": 5,
    "serve.read.workers": 1,
    "serve.read.wire_workers": 1,
    "serve.read.max_freshness_wait_s": 30.0,
    "serve.read.list": True,
    "serve.read.encoded": True,
    "serve.read.grpc-max-message-size": 64 << 20,
    "serve.write.port": 4467,
    "serve.write.host": "",
    "serve.write.grpc-max-message-size": 64 << 20,
    "log.level": "info",
    "log.format": "text",
    "tracing.provider": "",
    "namespaces": [],
    "engine.mode": "closure",
    "engine.max_batch": 4096,
    "engine.max_queue": 0,
    "engine.interior_limit": 16384,
    "engine.query_mode": "auto",
    "engine.freshness": "auto",
    "engine.strong_freshness_edges": 1 << 21,
    "engine.rebuild_debounce_ms": 50,
    "engine.dense_threshold": 8192,
    "engine.batch_window_us": 200,
    "engine.mesh.data": 1,
    "engine.mesh.edge": 0,
    "engine.sharding.enabled": False,
    "engine.sharding.data": 1,
    "engine.sharding.edge": 0,
    "engine.sharding.edge_chunk": 0,
    "engine.sharding.escalation_budget": 0.05,
    "engine.reverse_index": True,
    "engine.closure_builder": "auto",
    "engine.closure_block_workers": 0,
    "engine.expand_page_size": 0,
    "engine.fallback_threshold": 3,
    "engine.fallback_cooldown_ms": 1000,
    "engine.cache_size": 65536,
    "engine.encoded_cache_size": 65536,
    "engine.pipeline_depth": 2,
    "engine.encode_workers": 2,
    "engine.fallback": True,
    "engine.memory.admission": True,
    "engine.memory.hbm_budget_frac": 0.8,
    "engine.memory.bytes_per_row": 4096,
    "engine.failover.enabled": True,
    "engine.failover.probe_mode": "child",
    "engine.failover.probe_timeout_s": 10.0,
    "engine.failover.probe_interval_s": 0.5,
    "engine.failover.max_backoff_s": 30.0,
    "engine.failover.allow_cpu": True,
    "qos.enabled": False,
    "qos.rate": 0.0,
    "qos.burst": 100.0,
    "qos.overrides": {},
    "overload.enabled": False,
    "overload.target_delay_ms": 100.0,
    "overload.interval_ms": 100.0,
    "overload.min_limit": 8,
    "overload.tolerance": 2.0,
    "overload.decrease": 0.9,
    "overload.additive": 1.0,
    "overload.hysteresis_ms": 1000.0,
    "overload.dwell_ms": 50.0,
    "overload.throttle_window_s": 30.0,
    "overload.throttle_k": 2.0,
    "overload.history": 256,
    "overload.default_criticality": "default",
    "autotune.enabled": False,
    "autotune.interval_s": 5.0,
    "autotune.min_requests": 32,
    "autotune.revert_threshold": 0.05,
    "autotune.freeze_burn_rate": 0.0,
    "autotune.backoff_ticks": 3,
    "autotune.history": 256,
    "autotune.knobs": {},
    "scrub.enabled": False,
    "scrub.interval_s": 5.0,
    "scrub.sample_rows": 64,
    "scrub.reservoir": 256,
    "scrub.replay_per_cycle": 32,
    "scrub.wal_segments_per_cycle": 4,
    "scrub.max_repairs_per_cycle": 2,
    "scrub.digest_chunk_size": 1024,
    "scrub.freeze_burn_rate": 0.0,
    "scrub.history": 256,
    "telemetry.flight.capacity": 512,
    "telemetry.flight.slow_ms": 250,
    "telemetry.flight.dir": "",
    "telemetry.flight.flush_interval_s": 2.0,
    "telemetry.slo.objective": 0.999,
    "telemetry.slo.latency_target_ms": 250,
    "telemetry.slo.fast_window_s": 300,
    "telemetry.slo.slow_window_s": 3600,
    "telemetry.slo.alert_burn_rate": 2.0,
    "telemetry.slo.alert_cooldown_s": 300,
    "telemetry.attribution.enabled": True,
    "telemetry.profiler.enabled": False,
    # 67 Hz: off-round so sampling never phase-locks with 10 ms-periodic
    # work (batch windows, flush timers) and under-counts it
    "telemetry.profiler.hz": 67.0,
    "telemetry.profiler.max_stacks": 10000,
    "debug.enabled": True,
    "debug.token": "",
    "debug.profile_max_s": 30,
    "store.wal.dir": "",
    "store.wal.sync": "always",
    "store.wal.sync-interval-ms": 50,
    "store.wal.segment-bytes": 16 << 20,
    "checkpoint.dir": "",
    "checkpoint.interval-versions": 10000,
    "checkpoint.interval-s": 300,
    "checkpoint.keep": 2,
    "replication.role": "",
    "replication.upstream": "",
    "replication.dir": "",
    "replication.poll_interval_ms": 50,
    "replication.max_records_per_poll": 512,
    "cluster.enabled": False,
    "cluster.instance_id": "",
    "cluster.advertise_url": "",
    "cluster.advertise_write_url": "",
    "cluster.heartbeat_interval_ms": 1000,
    "cluster.scrape_interval_ms": 2000,
    "cluster.member_timeout_s": 10.0,
    "cluster.health.lag_versions_yellow": 100,
    "cluster.health.lag_versions_red": 10000,
    "cluster.health.lag_seconds_yellow": 5.0,
    "cluster.health.lag_seconds_red": 30.0,
    "cluster.health.staleness_yellow_s": 10.0,
    "cluster.health.staleness_red_s": 60.0,
    "cluster.health.burn_yellow": 1.0,
    "cluster.health.burn_red": 2.0,
    "cluster.election.enabled": False,
    "cluster.election.lease_ttl_s": 3.0,
    "cluster.election.heartbeat_interval_ms": 500,
    "cluster.election.priority": 0,
    "cluster.election.wal_dir": "",
}

_ENGINE_MODES = [
    "device", "host", "auto", "dense", "scatter", "packed", "closure", "sharded",
]

# dotted key -> (type, constraint): "enum" with its values, a minimum, or
# ("exclusive", bound) for an exclusive minimum; "array" holds strings
_PLANE_RULES: dict[str, tuple[str, Any]] = {
    "tls": ("object", None),
    "tls.cert": ("object", None),
    "tls.cert.path": ("string", None),
    "tls.key": ("object", None),
    "tls.key.path": ("string", None),
    "cors": ("object", None),
    "cors.enabled": ("boolean", None),
    "cors.allowed_origins": ("array", None),
    "cors.allowed_methods": ("array", None),
    "cors.allowed_headers": ("array", None),
    "expose_backend_ports": ("boolean", None),
}

_RULES: dict[str, tuple[str, Any]] = {
    "version": ("string", None),
    "dsn": ("string", None),
    "profiling": ("string", None),
    "serve": ("object", None),
    "serve.read.port": ("integer", None),
    "serve.read.host": ("string", None),
    "serve.read.max-depth": ("integer", 1),
    "serve.read.workers": ("integer", 1),
    "serve.read.wire_workers": ("integer", 1),
    "serve.read.max_freshness_wait_s": ("number", 0),
    "serve.read.list": ("boolean", None),
    "serve.read.encoded": ("boolean", None),
    "serve.read.grpc-max-message-size": ("integer", 0),
    "serve.write.port": ("integer", None),
    "serve.write.host": ("string", None),
    "serve.write.grpc-max-message-size": ("integer", 0),
    **{
        f"serve.{plane}.{key}": rule
        for plane in ("read", "write")
        for key, rule in _PLANE_RULES.items()
    },
    "log": ("object", None),
    "log.level": ("enum", ["trace", "debug", "info", "warn", "error", "fatal"]),
    "log.format": ("enum", ["json", "text"]),
    "engine": ("object", None),
    "engine.mode": ("enum", _ENGINE_MODES),
    "engine.dense_threshold": ("integer", 2),
    "engine.max_batch": ("integer", 1),
    "engine.batch_window_us": ("number", 0),
    "engine.max_queue": ("integer", 0),
    "engine.interior_limit": ("integer", 2),
    "engine.query_mode": ("enum", ["auto", "host", "device"]),
    "engine.freshness": ("enum", ["auto", "strong", "bounded"]),
    "engine.strong_freshness_edges": ("integer", 0),
    "engine.rebuild_debounce_ms": ("number", 0),
    "engine.mesh": ("object", None),
    "engine.mesh.data": ("integer", 1),
    "engine.mesh.edge": ("integer", 0),
    "engine.sharding": ("object", None),
    "engine.sharding.enabled": ("boolean", None),
    "engine.sharding.data": ("integer", 1),
    "engine.sharding.edge": ("integer", 0),
    "engine.sharding.edge_chunk": ("integer", 0),
    "engine.sharding.escalation_budget": ("number", 0),
    "engine.reverse_index": ("boolean", None),
    "engine.closure_builder": ("enum", ["auto", "matmul", "semiring"]),
    "engine.closure_block_workers": ("integer", 0),
    "engine.expand_page_size": ("integer", 0),
    "engine.compile_cache_dir": ("string", None),
    "engine.fallback_threshold": ("integer", 1),
    "engine.fallback_cooldown_ms": ("number", 0),
    "engine.cache_size": ("integer", 0),
    "engine.encoded_cache_size": ("integer", 0),
    "engine.pipeline_depth": ("integer", 0),
    "engine.encode_workers": ("integer", 1),
    "engine.fallback": ("boolean", None),
    "engine.memory.admission": ("boolean", None),
    "engine.memory.hbm_budget_frac": ("number", ("exclusive", 0)),
    "engine.memory.bytes_per_row": ("integer", 1),
    "engine.failover.enabled": ("boolean", None),
    "engine.failover.probe_mode": ("enum", ["child", "inproc"]),
    "engine.failover.probe_timeout_s": ("number", ("exclusive", 0)),
    "engine.failover.probe_interval_s": ("number", ("exclusive", 0)),
    "engine.failover.max_backoff_s": ("number", 0),
    "engine.failover.allow_cpu": ("boolean", None),
    "qos": ("object", None),
    "qos.enabled": ("boolean", None),
    "qos.rate": ("number", None),
    "qos.burst": ("number", 1),
    "qos.overrides": ("object", None),
    "overload.enabled": ("boolean", None),
    "overload.target_delay_ms": ("number", ("exclusive", 0)),
    "overload.interval_ms": ("number", ("exclusive", 0)),
    "overload.min_limit": ("integer", 1),
    "overload.tolerance": ("number", 1),
    "overload.decrease": ("number", ("exclusive", 0)),
    "overload.additive": ("number", ("exclusive", 0)),
    "overload.hysteresis_ms": ("number", ("exclusive", 0)),
    "overload.dwell_ms": ("number", 0),
    "overload.throttle_window_s": ("number", ("exclusive", 0)),
    "overload.throttle_k": ("number", 1),
    "overload.history": ("integer", 1),
    "overload.default_criticality": ("enum", ["default", "sheddable"]),
    "autotune": ("object", None),
    "autotune.enabled": ("boolean", None),
    "autotune.interval_s": ("number", ("exclusive", 0)),
    "autotune.min_requests": ("integer", 1),
    "autotune.revert_threshold": ("number", 0),
    "autotune.freeze_burn_rate": ("number", 0),
    "autotune.backoff_ticks": ("integer", 0),
    "autotune.history": ("integer", 1),
    "autotune.knobs": ("object", None),
    "scrub.enabled": ("boolean", None),
    "scrub.interval_s": ("number", ("exclusive", 0)),
    "scrub.sample_rows": ("integer", 1),
    "scrub.reservoir": ("integer", 1),
    "scrub.replay_per_cycle": ("integer", 0),
    "scrub.wal_segments_per_cycle": ("integer", 0),
    "scrub.max_repairs_per_cycle": ("integer", 0),
    "scrub.digest_chunk_size": ("integer", 1),
    "scrub.freeze_burn_rate": ("number", 0),
    "scrub.history": ("integer", 1),
    "tracing": ("object", None),
    "tracing.provider": ("enum", ["", "log", "otlp"]),
    "tracing.otlp": ("object", None),
    "tracing.otlp.endpoint": ("string", None),
    "tracing.otlp.service_name": ("string", None),
    "telemetry": ("object", None),
    "telemetry.flight.capacity": ("integer", 1),
    "telemetry.flight.slow_ms": ("number", 0),
    "telemetry.flight.dir": ("string", None),
    "telemetry.flight.flush_interval_s": ("number", 0.1),
    "telemetry.slo.objective": ("number", ("exclusive", 0)),
    "telemetry.slo.latency_target_ms": ("number", 0),
    "telemetry.slo.fast_window_s": ("number", 1),
    "telemetry.slo.slow_window_s": ("number", 1),
    "telemetry.slo.alert_burn_rate": ("number", 0),
    "telemetry.slo.alert_cooldown_s": ("number", 0),
    "telemetry.attribution.enabled": ("boolean", None),
    "telemetry.profiler.enabled": ("boolean", None),
    "telemetry.profiler.hz": ("number", ("exclusive", 0)),
    "telemetry.profiler.max_stacks": ("integer", 1),
    "debug.enabled": ("boolean", None),
    "debug.token": ("string", None),
    "debug.profile_max_s": ("number", 0.1),
    "store.wal.dir": ("string", None),
    "store.wal.sync": ("enum", ["always", "interval", "off"]),
    "store.wal.sync-interval-ms": ("number", 0),
    "store.wal.segment-bytes": ("integer", 4096),
    "checkpoint.dir": ("string", None),
    "checkpoint.interval-versions": ("integer", 1),
    "checkpoint.interval-s": ("number", 0),
    "checkpoint.keep": ("integer", 1),
    "replication": ("object", None),
    "replication.role": ("enum", ["", "leader", "follower"]),
    "replication.upstream": ("string", None),
    "replication.dir": ("string", None),
    "replication.poll_interval_ms": ("number", 1),
    "replication.max_records_per_poll": ("integer", 1),
    "cluster": ("object", None),
    "cluster.enabled": ("boolean", None),
    "cluster.instance_id": ("string", None),
    "cluster.advertise_url": ("string", None),
    "cluster.advertise_write_url": ("string", None),
    "cluster.heartbeat_interval_ms": ("number", 10),
    "cluster.scrape_interval_ms": ("number", 10),
    "cluster.member_timeout_s": ("number", 0.1),
    "cluster.health": ("object", None),
    "cluster.health.lag_versions_yellow": ("integer", 0),
    "cluster.health.lag_versions_red": ("integer", 0),
    "cluster.health.lag_seconds_yellow": ("number", 0),
    "cluster.health.lag_seconds_red": ("number", 0),
    "cluster.health.staleness_yellow_s": ("number", 0),
    "cluster.health.staleness_red_s": ("number", 0),
    "cluster.health.burn_yellow": ("number", 0),
    "cluster.health.burn_red": ("number", 0),
    "cluster.election": ("object", None),
    "cluster.election.enabled": ("boolean", None),
    "cluster.election.lease_ttl_s": ("number", 0.1),
    "cluster.election.heartbeat_interval_ms": ("number", 10),
    "cluster.election.priority": ("integer", None),
    "cluster.election.wal_dir": ("string", None),
}

# upper bounds, checked after the lower ones (the reference's keyword
# order); ("exclusive", m) is an exclusiveMaximum
_MAXIMA = {
    "overload.decrease": 1,
    "engine.memory.hbm_budget_frac": 1,
    "engine.sharding.escalation_budget": 1,
    "telemetry.slo.objective": ("exclusive", 1),
    "telemetry.profiler.hz": 1000,
}

# objects whose schema admits no other property ("" is the root)
_CLOSED = {
    obj: {
        key[len(obj) + 1:].split(".")[0] for key in _RULES if key.startswith(obj + ".")
    }
    for obj in (
        "serve", "engine", "engine.mesh", "engine.sharding", "qos", "autotune",
        "overload", "engine.memory", "engine.failover", "scrub", "debug",
        "store", "store.wal", "checkpoint", "tracing.otlp", "telemetry",
        "telemetry.flight", "telemetry.slo", "telemetry.attribution",
        "telemetry.profiler", "replication", "cluster", "cluster.health",
        "cluster.election",
    )
}
_CLOSED[""] = {key.split(".")[0] for key in _RULES} | {KEY_NAMESPACES}

# the closed objects each entry of a map may be: a per-namespace qos
# override, and a per-knob autotune override
_ENTRY_RULES = {
    "qos.overrides": {"rate": ("number", None), "burst": ("number", 1)},
    "autotune.knobs": {
        "enabled": ("boolean", None),
        "min": ("number", None),
        "max": ("number", None),
        "step": ("number", None),
    },
}

_MISSING = object()


def _is_type(value: Any, kind: str) -> bool:
    if kind == "string":
        return isinstance(value, str)
    if kind == "boolean":
        return isinstance(value, bool)
    if kind == "object":
        return isinstance(value, dict)
    if kind == "array":
        return isinstance(value, list)
    if isinstance(value, bool):
        return False  # JSON Schema: a boolean is neither integer nor number
    if kind == "integer":
        return isinstance(value, int)
    return isinstance(value, (int, float))  # number


def _invalid(message: str, path: str) -> ErrMalformedInput:
    return ErrMalformedInput(f"invalid configuration: {message} (at {path})")


def _dig(data: dict, key: str) -> Any:
    node: Any = data
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return _MISSING
        node = node[part]
    return node


def _violation(key: str, value: Any) -> Optional[tuple[str, str]]:
    """The reference's jsonschema message and its path suffix for ``value``
    under ``key``'s rule, or None when it passes."""
    kind, rule = _RULES[key]
    return _check(kind, rule, _MAXIMA.get(key), value)


def _check(kind: str, rule: Any, top: Any, value: Any) -> Optional[tuple[str, str]]:
    if kind == "enum":
        return None if value in rule else (f"{value!r} is not one of {rule!r}", "")
    if not _is_type(value, kind):
        return f"{value!r} is not of type {kind!r}", ""
    if kind == "array":
        for i, item in enumerate(value):
            if not isinstance(item, str):
                return f"{item!r} is not of type 'string'", f"/{i}"
        return None
    if isinstance(rule, tuple):
        if value <= rule[1]:
            return f"{value!r} is less than or equal to the minimum of {rule[1]!r}", ""
    elif rule is not None and value < rule:
        return f"{value!r} is less than the minimum of {rule!r}", ""
    if isinstance(top, tuple):
        if value >= top[1]:
            return f"{value!r} is greater than or equal to the maximum of {top[1]!r}", ""
    elif top is not None and value > top:
        return f"{value!r} is greater than the maximum of {top!r}", ""
    return None


def validate(data: dict) -> None:
    """Check the reference's schema; raise ErrMalformedInput with its
    jsonschema wording for the violation its ``best_match`` reports: the
    shallowest, and of siblings the one whose path sorts last."""
    if not isinstance(data, dict):
        raise _invalid(f"{data!r} is not of type 'object'", "")
    worst = None
    for rank, message, path in _violations(data):
        if worst is None or rank > worst[0]:
            worst = (rank, message, path)
    if worst is not None:
        raise _invalid(worst[1], worst[2])


def _rank(parts: list) -> tuple:
    return (-len(parts), tuple(parts))


def _violations(data: dict):
    """(rank, message, path) of every violation, in the schema's order."""
    for key in _RULES:
        value = _dig(data, key)
        if value is _MISSING:
            continue
        bad = _violation(key, value)
        if bad is not None:
            parts = key.split(".") + ([int(bad[1][1:])] if bad[1] else [])
            yield _rank(parts), bad[0], key.replace(".", "/") + bad[1]
    for key, allowed in _CLOSED.items():
        node = data if key == "" else _dig(data, key)
        if isinstance(node, dict):
            extra = _extra(node, allowed)
            if extra is not None:
                yield _rank(key.split(".") if key else []), extra, key.replace(".", "/")
    for key, rules in _ENTRY_RULES.items():
        entries = _dig(data, key)
        if isinstance(entries, dict):  # absent, or already refused as not an object
            for name, entry in entries.items():
                yield from _entry_violations(key.split(".") + [name], entry, rules)
    bad = _namespaces_violation(data.get(KEY_NAMESPACES, _MISSING))
    if bad is not None:
        # the reference's error is its oneOf's, at ``namespaces``, worded
        # by the failing branch relative to the array
        yield _rank([KEY_NAMESPACES]), bad[0], bad[1]


def _entry_violations(parts: list, entry: Any, rules: dict):
    """One entry of a map of closed objects (``qos.overrides.<ns>``,
    ``autotune.knobs.<name>``)."""
    path = "/".join(parts)
    if not isinstance(entry, dict):
        yield _rank(parts), f"{entry!r} is not of type 'object'", path
        return
    extra = _extra(entry, rules)
    if extra is not None:
        yield _rank(parts), extra, path
    for key, (kind, rule) in rules.items():
        if key in entry:
            bad = _check(kind, rule, None, entry[key])
            if bad is not None:
                yield _rank(parts + [key]), bad[0], f"{path}/{key}"


def _namespaces_violation(spec) -> Optional[tuple[str, str]]:
    if spec is _MISSING or isinstance(spec, str):
        return None  # a string is a file, directory or ws:// URI
    if not isinstance(spec, list):
        return f"{spec!r} is not valid under any of the given schemas", "namespaces"
    for i, ns in enumerate(spec):
        # the reference reports namespace errors relative to the array
        # (the failing branch of its oneOf), so the path starts at the index
        path = str(i)
        if not isinstance(ns, dict):
            return f"{ns!r} is not of type 'object'", path
        if "name" not in ns:
            return "'name' is a required property", path
        if not isinstance(ns["name"], str):
            return f"{ns['name']!r} is not of type 'string'", path + "/name"
        if "id" in ns and not _is_type(ns["id"], "integer"):
            return f"{ns['id']!r} is not of type 'integer'", path + "/id"
    return None


def _extra(obj: dict, allowed) -> Optional[str]:
    """jsonschema's ``additionalProperties: false`` message, or None."""
    extra = sorted(k for k in obj if k not in allowed)
    if not extra:
        return None
    names = ", ".join(repr(k) for k in extra)
    verb = "was" if len(extra) == 1 else "were"
    return f"Additional properties are not allowed ({names} {verb} unexpected)"


def load_config_file(path: str) -> dict:
    data = load_structured_file(path)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ErrMalformedInput(f"config root must be a mapping: {path}")
    return data


def _flatten_env_key(key: str) -> str:
    return key.replace(".", "_").replace("-", "_").upper()


def _parse_env_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


# keys frozen after boot: a changed DSN or serve block on reload is ignored
# with a warning (reference provider.go:70 immutable settings)
IMMUTABLE_KEYS = ("dsn", "serve")

# carve-outs from the frozen ``serve`` block: knobs safe to change on a live
# server (no socket rebinds); reload() grafts their fresh values in
HOT_SERVE_KEYS = ("serve.read.max_freshness_wait_s",)

# the registered hot knobs: each may change on a live server (a file reload,
# an operator's set_hot or the autotuner) and is re-applied through a
# component seam (driver/registry.py's appliers; the escalation budget's
# exists while the sharded serving tier serves)
HOT_ENGINE_KEYS = (
    "engine.pipeline_depth",
    "engine.encode_workers",
    "engine.encoded_cache_size",
    "engine.expand_page_size",
    "engine.sharding.escalation_budget",
    "engine.memory.hbm_budget_frac",
)
HOT_KNOB_KEYS = HOT_SERVE_KEYS + HOT_ENGINE_KEYS


def knob_schema(key: str) -> Optional[dict]:
    """A key's rule as the reference's JSON-schema fragment (None when the
    key has no rule)."""
    if key not in _RULES:
        return None
    kind, rule = _RULES[key]
    if kind == "enum":
        return {"enum": list(rule)}
    out: dict = {"type": kind}
    if isinstance(rule, tuple):
        out["exclusiveMinimum"] = rule[1]
    elif rule is not None:
        out["minimum"] = rule
    if key in _MAXIMA:
        out["maximum"] = _MAXIMA[key]
    return out


def validate_knob(key: str, value: Any) -> None:
    """Validate one hot-knob value against its bounds before it is grafted
    or applied anywhere: ErrMalformedInput for an unregistered key or an
    out-of-range value, with the reference's messages."""
    if key not in HOT_KNOB_KEYS:
        raise ErrMalformedInput(
            f"{key} is not a registered hot knob "
            f"(HOT_KNOB_KEYS: {', '.join(HOT_KNOB_KEYS)})"
        )
    if key not in _RULES:
        raise ErrMalformedInput(f"hot knob {key} has no schema entry")
    bad = _violation(key, value)
    if bad is not None:
        raise ErrMalformedInput(f"invalid value for hot knob {key}: {bad[0]}")


def _graft(data: dict, parts: list[str], value: Any) -> None:
    """Set (or, for _MISSING, remove) one nested key, copying each dict on
    the way: the boot subtree is shared and must not change."""
    cur = data
    for p in parts[:-1]:
        nxt = cur.get(p)
        nxt = dict(nxt) if isinstance(nxt, dict) else {}
        cur[p] = nxt
        cur = nxt
    if value is _MISSING:
        cur.pop(parts[-1], None)
    else:
        cur[parts[-1]] = value


def _strip_hot(block: Any, prefix: str) -> Any:
    """A top-level block without its HOT_SERVE_KEYS, for comparison: a serve
    diff confined to hot knobs must not trip the immutability warning."""
    if not isinstance(block, dict):
        return block
    out = json.loads(json.dumps(block))  # deep copy; config is plain JSON
    for dotted in HOT_SERVE_KEYS:
        top, _, rest = dotted.partition(".")
        if top == prefix:
            _graft(out, rest.split("."), _MISSING)
    return out


def _warn(message: str, **fields) -> None:
    from ..telemetry.logging import get_logger

    get_logger("config").warn(message, **fields)


class Config:
    def __init__(
        self,
        values: Optional[dict] = None,
        config_file: Optional[str] = None,
        env: Optional[dict] = None,
        flag_overrides: Optional[dict[str, Any]] = None,
    ):
        data: dict = {}
        if config_file:
            data = load_config_file(config_file)
        if values:
            data = _deep_merge(data, values)
        validate(data)
        self._data = data
        self.config_file = config_file
        self._values = dict(values or {})
        self._env = dict(env if env is not None else os.environ)
        self._overrides: dict[str, Any] = dict(flag_overrides or {})
        self._namespace_manager: Optional[_SwappableNamespaceManager] = None

    def reload(self) -> list[str]:
        """Re-read the config file; returns the sorted changed keys that
        were APPLIED (top-level keys, and each HOT_SERVE_KEYS entry).
        ``dsn`` and ``serve`` keep their boot values, with a warning; a
        changed ``namespaces`` refreshes the namespace manager in place.
        Raises ErrMalformedInput when the file fails validation, and the
        previous config keeps serving."""
        if not self.config_file:
            return []
        fresh = load_config_file(self.config_file)
        if self._values:
            fresh = _deep_merge(fresh, self._values)
        validate(fresh)
        old = self._data
        applied = []
        for key in set(old) | set(fresh):
            if old.get(key) == fresh.get(key):
                continue
            if key in IMMUTABLE_KEYS:
                if _strip_hot(old.get(key), key) != _strip_hot(fresh.get(key), key):
                    # say so, or the operator believes the new DSN or ports
                    # are live
                    _warn(
                        "config key is immutable after boot; keeping the boot "
                        "value (restart to apply)",
                        key=key,
                    )
                continue
            applied.append(key)
        merged = dict(fresh)
        for key in IMMUTABLE_KEYS:
            if key in old:
                merged[key] = old[key]
            else:
                merged.pop(key, None)
        # the hot carve-outs: graft each changed value into the frozen boot
        # subtree, validated again as set_hot would
        for dotted in HOT_SERVE_KEYS:
            new_v = _dig(fresh, dotted)
            if new_v == _dig(old, dotted):
                continue
            if new_v is not _MISSING:
                try:
                    validate_knob(dotted, new_v)
                except ErrMalformedInput as e:
                    _warn(
                        "hot knob reload value rejected; keeping the previous "
                        "value",
                        key=dotted,
                        error=str(e),
                    )
                    continue
            _graft(merged, dotted.split("."), new_v)
            applied.append(dotted)
        self._data = merged
        if "namespaces" in applied:
            self._refresh_namespace_manager()
        return sorted(applied)

    def _refresh_namespace_manager(self) -> None:
        wrapper = self._namespace_manager
        if wrapper is None:
            return  # nothing built yet: the first namespace_manager() reads fresh
        from ..namespace.watcher import NamespaceWatcher, uri_to_path

        inner = wrapper.inner
        spec = self.get(KEY_NAMESPACES)
        if isinstance(inner, MemoryNamespaceManager) and isinstance(spec, list):
            inner.replace_all(_inline_namespaces(spec))
        elif (
            isinstance(inner, NamespaceWatcher)
            and isinstance(spec, str)
            and uri_to_path(spec) == inner.path
        ):
            pass  # the same URI: the watcher's own poll picks up content
        else:
            # an inline <-> URI flip, or a new URI: swap the wrapped manager;
            # stores hold the stable wrapper, so they see the new set
            if hasattr(inner, "close"):
                inner.close()
            wrapper.inner = self._build_namespace_manager()

    def get(self, key: str, default: Any = _UNSET) -> Any:
        if key in self._overrides:
            return self._overrides[key]
        env_val = self._env.get("KETO_" + _flatten_env_key(key))
        if env_val is None:
            env_val = self._env.get(_flatten_env_key(key))
        if env_val is not None:
            return _parse_env_value(env_val)
        value = _dig(self._data, key)
        if value is not _MISSING:
            return value
        # a caller-provided default wins even when falsy (0/False/"")
        if default is not _UNSET:
            return default
        return DEFAULTS.get(key)

    def is_set(self, key: str) -> bool:
        """Whether an override, the environment, the file or the values
        name ``key`` (a default does not)."""
        flat = _flatten_env_key(key)
        return (
            key in self._overrides
            or "KETO_" + flat in self._env
            or flat in self._env
            or _dig(self._data, key) is not _MISSING
        )

    def set_override(self, key: str, value: Any) -> None:
        self._overrides[key] = value

    def file_value(self, key: str) -> Any:
        """The file's (and values') value for ``key``, else its default,
        ignoring the override layer: how the reload watcher tells an
        operator's edit of a hot knob from a set_hot override."""
        value = _dig(self._data, key)
        return DEFAULTS.get(key) if value is _MISSING else value

    def set_hot(self, key: str, value: Any) -> None:
        """Validated live write to a registered hot knob: the value lands in
        the override layer, so a later reload of other keys keeps it."""
        validate_knob(key, value)
        self._overrides[key] = value

    def clear_hot(self, key: str) -> None:
        """Drop a hot-knob override: the key returns to its file value."""
        self._overrides.pop(key, None)

    # -- typed accessors (reference provider.go) ------------------------------

    def dsn(self) -> str:
        return self.get(KEY_DSN)

    def read_api_host(self) -> str:
        return self.get(KEY_READ_HOST) or "0.0.0.0"

    def read_api_port(self) -> int:
        return int(self.get(KEY_READ_PORT))

    def write_api_host(self) -> str:
        return self.get(KEY_WRITE_HOST) or "0.0.0.0"

    def write_api_port(self) -> int:
        return int(self.get(KEY_WRITE_PORT))

    def read_api_max_depth(self) -> int:
        return int(self.get(KEY_READ_MAX_DEPTH))

    def cors(self, plane: str) -> Optional[dict]:
        return self.get(f"serve.{plane}.cors", default={}) or None

    def engine_mode(self) -> str:
        return self.get("engine.mode")

    def namespace_manager(self) -> NamespaceManager:
        """An inline array -> a memory manager; a string URI -> a file or
        directory watcher, or a ws:// watcher (reference provider.go:190-218).
        Behind a stable wrapper, so a reload can swap the manager under the
        stores that hold it."""
        if self._namespace_manager is None:
            self._namespace_manager = _SwappableNamespaceManager(
                self._build_namespace_manager()
            )
        return self._namespace_manager

    def _build_namespace_manager(self) -> NamespaceManager:
        spec = self.get(KEY_NAMESPACES)
        if isinstance(spec, str):
            from ..namespace.watcher import NamespaceWatcher, WsNamespaceWatcher

            if spec.startswith("ws://"):
                return WsNamespaceWatcher(spec)
            return NamespaceWatcher(spec)
        return MemoryNamespaceManager(*_inline_namespaces(spec or []))


def _inline_namespaces(spec: list) -> list[Namespace]:
    return [
        Namespace(name=n["name"], id=int(n.get("id", 0)), config=n.get("config", {}) or {})
        for n in spec
    ]


class _SwappableNamespaceManager(NamespaceManager):
    """Stable handle over a replaceable NamespaceManager: a reload swaps
    ``inner``; stores and engines keep this wrapper."""

    def __init__(self, inner: NamespaceManager):
        self.inner = inner

    def get_namespace_by_name(self, name: str) -> Namespace:
        return self.inner.get_namespace_by_name(name)

    def namespaces(self) -> list[Namespace]:
        return self.inner.namespaces()

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
