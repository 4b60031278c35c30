"""Namespace sources that change while serving (counterpart of
``keto_tpu/namespace/watcher.py``; reference internal/driver/config/
namespace_watcher.go).

- ``NamespaceWatcher``: a file or directory URI (``file:///etc/keto/
  namespaces.json``, a bare path, or a directory of per-namespace files),
  parsed by extension (json, toml, and yaml/yml where PyYAML is installed,
  through ``utils/fileformat.py``). An mtime-polling thread picks up
  changes (no inotify binding is assumed); a parse error on reload keeps
  serving the last good set (the reference's rollback-to-last-good loop,
  namespace_watcher.go:91-143).
- ``WsNamespaceWatcher``: a ``ws://`` source. A remote config service
  pushes namespace documents over a websocket (``utils/ws.py``); a
  malformed frame keeps the last good set, the reader reconnects with
  capped exponential backoff and pings an idle peer.

Both re-arm their thread in a forked read replica (``restart_after_fork``).
"""

from __future__ import annotations

import json
import os
import threading
from urllib.parse import urlparse

from ..utils.errors import ErrMalformedInput
from ..utils.fileformat import load_structured_file
from .definitions import MemoryNamespaceManager, Namespace, NamespaceManager

_POLL_INTERVAL_S = 1.0
_EXTENSIONS = (".yaml", ".yml", ".json", ".toml")


def _namespaces_of(data, where: str) -> list[Namespace]:
    """A single namespace object, a list of them, or ``{"namespaces":
    [...]}``; ``where`` ends each error message (": <path>" or "")."""
    if data is None:
        return []
    if isinstance(data, dict):
        if "namespaces" in data and isinstance(data["namespaces"], list):
            items = data["namespaces"]
        else:
            items = [data]
    elif isinstance(data, list):
        items = data
    else:
        raise ErrMalformedInput(
            f"malformed namespace file{where}" if where else "malformed namespace document"
        )
    out = []
    for item in items:
        if not isinstance(item, dict) or "name" not in item:
            raise ErrMalformedInput(f"namespace entries need a 'name' field{where}")
        out.append(
            Namespace(
                name=item["name"],
                id=int(item.get("id", 0)),
                config=item.get("config", {}) or {},
            )
        )
    return out


def parse_namespace_file(path: str) -> list[Namespace]:
    """One file may hold a single namespace object or a list of them."""
    return _namespaces_of(load_structured_file(path), f": {path}")


def parse_namespace_doc(data) -> list[Namespace]:
    """Namespaces from an already-parsed document (a ws:// frame): the
    shapes ``parse_namespace_file`` accepts."""
    return _namespaces_of(data, "")


def uri_to_path(uri: str) -> str:
    if uri.startswith("file://"):
        return urlparse(uri).path
    return uri


class NamespaceWatcher(NamespaceManager):
    def __init__(self, uri: str, poll_interval_s: float = _POLL_INTERVAL_S):
        self.path = uri_to_path(uri)
        self.poll_interval_s = poll_interval_s
        self._inner = MemoryNamespaceManager()
        self._mtimes: dict[str, float] = {}
        self._lock = threading.Lock()
        self._load(initial=True)
        self._start()

    def _start(self) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch_loop, name="namespace-watcher", daemon=True
        )
        self._thread.start()

    # -- NamespaceManager ------------------------------------------------------

    def get_namespace_by_name(self, name: str) -> Namespace:
        return self._inner.get_namespace_by_name(name)

    def namespaces(self) -> list[Namespace]:
        return self._inner.namespaces()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def restart_after_fork(self) -> None:
        """A forked replica inherits this object but not its poll thread
        (fork clones only the calling thread): re-arm the lock and start a
        fresh poller, so the replica keeps tracking namespace changes."""
        self._lock = threading.Lock()
        self._inner._lock = threading.RLock()
        self._start()

    # -- loading ---------------------------------------------------------------

    def _files(self) -> list[str]:
        if os.path.isdir(self.path):
            return sorted(
                os.path.join(self.path, f)
                for f in os.listdir(self.path)
                if f.endswith(_EXTENSIONS)
            )
        return [self.path]

    def _load(self, initial: bool = False) -> None:
        try:
            files = self._files()
            nss: list[Namespace] = []
            mtimes = {}
            for f in files:
                mtimes[f] = os.stat(f).st_mtime
                nss.extend(parse_namespace_file(f))
            with self._lock:
                self._inner.replace_all(nss)
                self._mtimes = mtimes
        except (OSError, ErrMalformedInput):
            # keep serving the last good set; at boot an unreadable source
            # is an empty set, like the reference before its first event
            if initial:
                with self._lock:
                    self._inner.replace_all([])

    def _changed(self) -> bool:
        try:
            files = self._files()
        except OSError:
            return False
        if set(files) != set(self._mtimes):
            return True
        try:
            return any(os.stat(f).st_mtime != self._mtimes[f] for f in files)
        except OSError:
            return True

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            if self._changed():
                self._load()


class WsNamespaceWatcher(NamespaceManager):
    """``ws://`` namespace source (reference watcherx ws URIs,
    namespace_watcher.go:48-89). Each text frame is a JSON namespace
    document; any malformed frame keeps the last good set."""

    KEEPALIVE_S = 30.0

    def __init__(self, uri: str, connect_timeout_s: float = 10.0):
        self.uri = uri
        self.connect_timeout_s = connect_timeout_s
        self._inner = MemoryNamespaceManager()
        self._conn = None
        self._start()

    def _start(self) -> None:
        self._stop = threading.Event()
        self._connected = threading.Event()
        self._thread = threading.Thread(
            target=self._read_loop, name="namespace-ws-watcher", daemon=True
        )
        self._thread.start()

    # -- NamespaceManager ------------------------------------------------------

    def get_namespace_by_name(self, name: str) -> Namespace:
        return self._inner.get_namespace_by_name(name)

    def namespaces(self) -> list[Namespace]:
        return self._inner.namespaces()

    def wait_connected(self, timeout_s: float = 10.0) -> bool:
        """Block until the first successful connect (boot and test sync)."""
        return self._connected.wait(timeout_s)

    def restart_after_fork(self) -> None:
        """A forked replica inherits this object but not its reader thread:
        drop the inherited descriptor without a close frame (that would tear
        down the parent's live connection) and connect afresh."""
        conn = self._conn
        if conn is not None:
            try:
                conn._sock.close()
            except OSError:
                pass
        self._conn = None
        self._inner._lock = threading.RLock()
        self._start()

    def close(self) -> None:
        self._stop.set()
        conn = self._conn
        if conn is not None:
            try:
                conn.close()  # unblocks the reader
            except OSError:
                pass
        self._thread.join(timeout=5)

    # -- reader ----------------------------------------------------------------

    def _read_loop(self) -> None:
        from ..utils import ws

        backoff = 0.2
        while not self._stop.is_set():
            try:
                conn = ws.connect(self.uri, timeout=self.connect_timeout_s)
            except (OSError, ws.WSError):
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 10.0)
                continue
            self._conn = conn
            self._connected.set()
            backoff = 0.2
            try:
                while not self._stop.is_set():
                    try:
                        text = conn.recv_text(timeout=self.KEEPALIVE_S)
                    except TimeoutError:
                        # idle: probe the peer, so a half-open connection
                        # reconnects instead of stalling updates for good
                        conn.ping()
                        continue
                    if text is None:
                        break  # clean close: reconnect
                    try:
                        self._inner.replace_all(parse_namespace_doc(json.loads(text)))
                    except Exception:
                        # bad JSON, bad types, null ids: keep the last good
                        # set; a frame must never kill the reader
                        pass
            except (OSError, ws.WSError):
                pass
            finally:
                self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
