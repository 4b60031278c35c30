"""Structured logging (counterpart of ``keto_tpu/telemetry/logging.py``;
reference logrusx, registry_default.go:131-136).

stdlib logging under the hood: one package logger ``keto_tpu_torch`` with
either a JSON formatter (``log.format: json``) or a human text formatter,
level from ``log.level``. The handler writes to stderr so stdout stays
clean for CLI output.

Loggers accept structured fields as kwargs: ``log.info("served", rps=123)``;
fields ride in ``record.fields`` and serialize into the JSON line or append
as ``key=value`` pairs in text mode.

One difference from the reference, so the package embeds cleanly: the
package logger keeps propagating, and where an application has configured
the Python root logger (``logging.basicConfig``, a test runner), the
package logger also passes on the records at the root's level, so the
application's own handlers still see what they asked for. ``log.level``
then governs this module's stderr handler, and the package logger's level
is the lower of the two.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

_ROOT = "keto_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "time": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            doc.update(fields)
        if record.exc_info and record.exc_info[0] is not None:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        base = f"{ts} {record.levelname:<5} {record.name}: {record.getMessage()}"
        fields = getattr(record, "fields", None)
        if fields:
            base += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        if record.exc_info and record.exc_info[0] is not None:
            base += "\n" + self.formatException(record.exc_info)
        return base


class StructuredAdapter(logging.LoggerAdapter):
    """kwargs -> record.fields (reserved logging kwargs pass through)."""

    _PASS = {"exc_info", "stack_info", "stacklevel"}

    def _split(self, kwargs: dict[str, Any]):
        fields = {k: v for k, v in kwargs.items() if k not in self._PASS}
        passthrough = {k: v for k, v in kwargs.items() if k in self._PASS}
        merged = dict(self.extra or {})
        merged.update(fields)
        passthrough["extra"] = {"fields": merged}
        return passthrough

    def debug(self, msg, *args, **kw):
        self.logger.debug(msg, *args, **self._split(kw))

    def info(self, msg, *args, **kw):
        self.logger.info(msg, *args, **self._split(kw))

    def warning(self, msg, *args, **kw):
        self.logger.warning(msg, *args, **self._split(kw))

    warn = warning

    def error(self, msg, *args, **kw):
        self.logger.error(msg, *args, **self._split(kw))


class _DynamicStderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time, not construction time: stderr may
    be redirected (test capture, daemonization)."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def configure_logging(level: str = "info", format: str = "text") -> None:
    """Configure the package logger from the ``log.*`` config keys; called
    again on every reload of ``log``, it replaces its own handler and keeps
    any other."""
    root = logging.getLogger(_ROOT)
    lvl = _LEVELS.get(level, logging.INFO)
    app = logging.getLogger()
    root.setLevel(min(lvl, app.getEffectiveLevel()) if app.handlers else lvl)
    handler = _DynamicStderrHandler()
    handler.setLevel(lvl)
    handler.setFormatter(_JsonFormatter() if format == "json" else _TextFormatter())
    handler._keto_config = True
    root.handlers[:] = [
        h for h in root.handlers if not getattr(h, "_keto_config", False)
    ] + [handler]


def get_logger(name: str = "", **fields) -> StructuredAdapter:
    logger = logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
    return StructuredAdapter(logger, fields or {})
