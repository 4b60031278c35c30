"""Namespace model (counterpart of ``keto_tpu/namespace/definitions.py``;
reference internal/namespace/definitions.go:8-23).

A namespace is ``{id: int32, name: str}``, plus the ``config`` document a
namespace file may carry (kept, never compared); tuples may only be written
into known namespaces (unknown namespace -> NotFound, reference
manager_requirements.go:58-66).
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field

from ..utils.errors import ErrNamespaceNotFound


@dataclass(frozen=True)
class Namespace:
    name: str
    id: int = 0
    config: dict = field(default_factory=dict, compare=False, hash=False)


class NamespaceManager(abc.ABC):
    @abc.abstractmethod
    def get_namespace_by_name(self, name: str) -> Namespace:
        """Raises ErrNamespaceNotFound for unknown names."""

    @abc.abstractmethod
    def namespaces(self) -> list[Namespace]: ...


class MemoryNamespaceManager(NamespaceManager):
    """In-memory, thread-safe namespace registry; ``replace_all`` swaps the
    whole set (a config reload, a namespace watcher)."""

    def __init__(self, *namespaces: Namespace):
        self._lock = threading.RLock()
        self._by_name: dict[str, Namespace] = {}
        for ns in namespaces:
            self.add(ns)

    def add(self, ns: Namespace | str) -> Namespace:
        if isinstance(ns, str):
            ns = Namespace(name=ns)
        with self._lock:
            if ns.id == 0 and ns.name not in self._by_name:
                used = {n.id for n in self._by_name.values()}
                nid = 1
                while nid in used:
                    nid += 1
                ns = Namespace(name=ns.name, id=nid, config=ns.config)
            self._by_name[ns.name] = ns
        return ns

    def replace_all(self, namespaces: list[Namespace]) -> None:
        with self._lock:
            self._by_name = {}
            for ns in namespaces:
                self.add(ns)

    def get_namespace_by_name(self, name: str) -> Namespace:
        with self._lock:
            try:
                return self._by_name[name]
            except KeyError:
                raise ErrNamespaceNotFound(name) from None

    def namespaces(self) -> list[Namespace]:
        with self._lock:
            return list(self._by_name.values())
