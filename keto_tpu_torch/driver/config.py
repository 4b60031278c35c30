"""Config provider (counterpart of ``keto_tpu/driver/config.py``, trimmed).

The same key tree as the reference — ``dsn``, ``serve.read.{host,port,
max-depth,max_freshness_wait_s,workers,wire_workers,list,encoded,
grpc-max-message-size}``,
``serve.write.{host,port,grpc-max-message-size}``, ``namespaces`` (an
inline array of ``{id, name}``), the ``engine`` subtree,
``qos.{enabled,rate,burst,overrides}``, and the ``overload``, ``scrub`` and
``debug`` subtrees — from a JSON or TOML file (YAML where PyYAML is
installed) merged with ``values``. Only the keys this package reads are
validated, by hand and with the reference's messages (no jsonschema); the
``overload``, ``engine.memory``, ``engine.failover``, ``scrub`` and
``debug`` objects are closed, as in the reference's schema, so a misspelt
key is an error; other keys are carried and ignored. ``scrub.freeze_burn_rate``
is validated and carried for the SLO freeze (ROADMAP 14.5), and
``scrub.digest_chunk_size`` for the scrubber's replica kind (14.6). The
durable write plane's ``store.wal.{dir,sync,sync-interval-ms,segment-bytes}``
and ``checkpoint.{dir,interval-versions,interval-s,keep}`` are closed
objects too. Environment overrides, hot reload and
namespace file watchers are not ported yet (ROADMAP 14.4).
"""

from __future__ import annotations

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
    "namespaces": [],
    "engine.mode": "closure",
    "engine.max_batch": 4096,
    "engine.max_queue": 0,
    "engine.interior_limit": 16384,
    "engine.query_mode": "auto",
    "engine.freshness": "auto",
    "engine.strong_freshness_edges": 1 << 21,
    "engine.rebuild_debounce_ms": 50,
    "engine.sharding.enabled": False,
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
}

_ENGINE_MODES = [
    "device", "host", "auto", "dense", "scatter", "packed", "closure", "sharded",
]

# dotted key -> (type, constraint): "enum" with its values, a minimum, or
# ("exclusive", bound) for an exclusive minimum
_RULES: dict[str, tuple[str, Any]] = {
    "dsn": ("string", None),
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
    "engine.mode": ("enum", _ENGINE_MODES),
    "engine.max_batch": ("integer", 1),
    "engine.max_queue": ("integer", 0),
    "engine.interior_limit": ("integer", 2),
    "engine.query_mode": ("enum", ["auto", "host", "device"]),
    "engine.freshness": ("enum", ["auto", "strong", "bounded"]),
    "engine.strong_freshness_edges": ("integer", 0),
    "engine.rebuild_debounce_ms": ("number", 0),
    "engine.sharding.enabled": ("boolean", None),
    "engine.reverse_index": ("boolean", None),
    "engine.closure_builder": ("enum", ["auto", "matmul", "semiring"]),
    "engine.closure_block_workers": ("integer", 0),
    "engine.expand_page_size": ("integer", 0),
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
}

# upper bounds, checked after the lower ones (the reference's keyword order)
_MAXIMA = {"overload.decrease": 1, "engine.memory.hbm_budget_frac": 1}

# objects whose schema admits no other property
_CLOSED = {
    obj: {
        key[len(obj) + 1:].split(".")[0] for key in _RULES if key.startswith(obj + ".")
    }
    for obj in (
        "overload", "engine.memory", "engine.failover", "scrub", "debug",
        "store", "store.wal", "checkpoint",
    )
}

# the properties each per-namespace qos override may carry
_QOS_OVERRIDE_RULES = {"rate": None, "burst": 1}

_MISSING = object()


def _is_type(value: Any, kind: str) -> bool:
    if kind == "string":
        return isinstance(value, str)
    if kind == "boolean":
        return isinstance(value, bool)
    if kind == "object":
        return isinstance(value, dict)
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


def validate(data: dict) -> None:
    """Check the keys this package reads; raise ErrMalformedInput with the
    reference's jsonschema wording on the first violation."""
    if not isinstance(data, dict):
        raise _invalid(f"{data!r} is not of type 'object'", "")
    for key, (kind, rule) in _RULES.items():
        value = _dig(data, key)
        if value is _MISSING:
            continue
        path = key.replace(".", "/")
        if kind == "enum":
            if value not in rule:
                raise _invalid(f"{value!r} is not one of {rule!r}", path)
            continue
        if not _is_type(value, kind):
            raise _invalid(f"{value!r} is not of type {kind!r}", path)
        if isinstance(rule, tuple):
            if value <= rule[1]:
                raise _invalid(
                    f"{value!r} is less than or equal to the minimum of {rule[1]!r}",
                    path,
                )
        elif rule is not None and value < rule:
            raise _invalid(f"{value!r} is less than the minimum of {rule!r}", path)
        if key in _MAXIMA and value > _MAXIMA[key]:
            raise _invalid(
                f"{value!r} is greater than the maximum of {_MAXIMA[key]!r}", path
            )
    for key, allowed in _CLOSED.items():
        node = _dig(data, key)
        if isinstance(node, dict):
            _no_extra(node, allowed, key.replace(".", "/"))
    _validate_qos_overrides(_dig(data, "qos.overrides"))
    spec = data.get(KEY_NAMESPACES, _MISSING)
    if spec is _MISSING:
        return
    if not isinstance(spec, list):
        raise _invalid(f"{spec!r} is not of type 'array'", "namespaces")
    for i, ns in enumerate(spec):
        # the reference reports namespace errors relative to the array
        # (the failing branch of its oneOf), so the path starts at the index
        path = str(i)
        if not isinstance(ns, dict):
            raise _invalid(f"{ns!r} is not of type 'object'", path)
        if "name" not in ns:
            raise _invalid("'name' is a required property", path)
        if not isinstance(ns["name"], str):
            raise _invalid(f"{ns['name']!r} is not of type 'string'", path + "/name")
        if "id" in ns and not _is_type(ns["id"], "integer"):
            raise _invalid(f"{ns['id']!r} is not of type 'integer'", path + "/id")


def _validate_qos_overrides(overrides) -> None:
    """``qos.overrides``: namespace -> {"rate": number, "burst": number >=
    1}, nothing else (the reference's schema)."""
    if not isinstance(overrides, dict):
        return  # absent, or already rejected as not an object
    for ns, o in overrides.items():
        path = f"qos/overrides/{ns}"
        if not isinstance(o, dict):
            raise _invalid(f"{o!r} is not of type 'object'", path)
        _no_extra(o, _QOS_OVERRIDE_RULES, path)
        for key, minimum in _QOS_OVERRIDE_RULES.items():
            if key not in o:
                continue
            value = o[key]
            if not _is_type(value, "number"):
                raise _invalid(f"{value!r} is not of type 'number'", f"{path}/{key}")
            if minimum is not None and value < minimum:
                raise _invalid(
                    f"{value!r} is less than the minimum of {minimum!r}",
                    f"{path}/{key}",
                )


def _no_extra(obj: dict, allowed, path: str) -> None:
    """jsonschema's ``additionalProperties: false``, with its message."""
    extra = [k for k in obj if k not in allowed]
    if extra:
        names = ", ".join(repr(k) for k in extra)
        verb = "was" if len(extra) == 1 else "were"
        raise _invalid(
            f"Additional properties are not allowed ({names} {verb} unexpected)",
            path,
        )


def load_config_file(path: str) -> dict:
    data = load_structured_file(path)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ErrMalformedInput(f"config root must be a mapping: {path}")
    return data


class Config:
    def __init__(
        self,
        values: Optional[dict] = None,
        config_file: Optional[str] = None,
    ):
        data: dict = {}
        if config_file:
            data = load_config_file(config_file)
        if values:
            data = _deep_merge(data, values)
        validate(data)
        self._data = data
        self.config_file = config_file
        self._namespace_manager: Optional[NamespaceManager] = None

    def get(self, key: str, default: Any = _UNSET) -> Any:
        value = _dig(self._data, key)
        if value is not _MISSING:
            return value
        # a caller-provided default wins even when falsy (0/False/"")
        if default is not _UNSET:
            return default
        return DEFAULTS.get(key)

    def is_set(self, key: str) -> bool:
        """Whether the file or the values name ``key`` (a default does not)."""
        return _dig(self._data, key) is not _MISSING

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

    def engine_mode(self) -> str:
        return self.get("engine.mode")

    def namespace_manager(self) -> NamespaceManager:
        """The inline ``namespaces`` array as a memory manager."""
        if self._namespace_manager is None:
            self._namespace_manager = MemoryNamespaceManager(
                *(
                    Namespace(name=n["name"], id=int(n.get("id", 0)))
                    for n in self.get(KEY_NAMESPACES) or []
                )
            )
        return self._namespace_manager


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
