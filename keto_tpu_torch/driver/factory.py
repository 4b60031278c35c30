"""Registry factories (counterpart of ``keto_tpu/driver/factory.py``;
reference internal/driver/registry_factory.go).

``new_registry`` builds a Registry from a config file with flag overrides
(the config's override layer, above the environment and the file); the
``*_test_registry`` constructors build pre-wired registries on ephemeral
stores with quiet logging and free loopback ports, for tests and embedding,
with no environment. Overrides are dotted keys (``serve.read.workers=3``),
as ``Config.set_override`` takes them. ``device`` passes through to the
Registry: the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

from .config import Config, _deep_merge
from .registry import Registry


def new_registry(
    config_file: Optional[str] = None,
    flag_overrides: Optional[dict[str, Any]] = None,
    device=None,
) -> Registry:
    """The production constructor: file + env + flag overrides, validated."""
    return Registry(
        Config(config_file=config_file, flag_overrides=flag_overrides), device=device
    )


def _test_config(values: Optional[dict] = None, **overrides) -> Config:
    base: dict = {
        # free ports on loopback; error-level logs so test output stays
        # readable (the reference's test registries silence logging too)
        "serve": {
            "read": {"port": 0, "host": "127.0.0.1"},
            "write": {"port": 0, "host": "127.0.0.1"},
        },
        "log": {"level": "error"},
    }
    return Config(
        values=_deep_merge(base, values or {}), env={}, flag_overrides=overrides
    )


def _namespaces(values: Optional[dict], namespaces: tuple[str, ...]) -> dict:
    vals = dict(values or {})
    vals.setdefault(
        "namespaces", [{"id": i, "name": n} for i, n in enumerate(namespaces, 1)]
    )
    return vals


def new_test_registry(
    namespaces: tuple[str, ...] = ("videos",),
    values: Optional[dict] = None,
    device=None,
    **overrides,
) -> Registry:
    """In-memory test registry (reference NewTestRegistry): named
    namespaces with sequential ids, memory DSN."""
    return Registry(
        _test_config(_namespaces(values, namespaces), **overrides), device=device
    )


def new_sqlite_test_registry(
    path: str,
    namespaces: tuple[str, ...] = ("videos",),
    values: Optional[dict] = None,
    device=None,
    **overrides,
) -> Registry:
    """Sqlite-backed test registry with automigration (reference
    NewSqliteTestRegistry): pass a temporary file path; the schema is
    applied on first store construction."""
    vals = _namespaces(values, namespaces)
    vals["dsn"] = f"sqlite://{path}"
    return Registry(_test_config(vals, **overrides), device=device)
