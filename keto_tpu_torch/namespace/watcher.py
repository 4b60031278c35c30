"""Namespace files (counterpart of ``keto_tpu/namespace/watcher.py``,
trimmed to ``parse_namespace_file``, which ``namespace validate`` runs).

The reference's watcher reloads a namespace file or directory on change;
it waits for ROADMAP 14.4. Files are parsed by extension (json, toml, and
yaml/yml where PyYAML is installed) through ``utils/fileformat.py``.
"""

from __future__ import annotations

from ..utils.errors import ErrMalformedInput
from ..utils.fileformat import load_structured_file
from .definitions import Namespace


def parse_namespace_file(path: str) -> list[Namespace]:
    """One file may hold a single namespace object or a list of them."""
    data = load_structured_file(path)
    if data is None:
        return []
    if isinstance(data, dict):
        # either a single namespace or {"namespaces": [...]}
        if "namespaces" in data and isinstance(data["namespaces"], list):
            items = data["namespaces"]
        else:
            items = [data]
    elif isinstance(data, list):
        items = data
    else:
        raise ErrMalformedInput(f"malformed namespace file: {path}")
    out = []
    for item in items:
        if not isinstance(item, dict) or "name" not in item:
            raise ErrMalformedInput(f"namespace entries need a 'name' field: {path}")
        out.append(Namespace(name=item["name"], id=int(item.get("id", 0))))
    return out
