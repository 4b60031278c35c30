"""Structured-file loading for the config (counterpart of
``keto_tpu/utils/fileformat.py``): dispatch by extension — json, toml
(``tomllib``), and yaml/yml only where PyYAML is installed.
"""

from __future__ import annotations

import json
import tomllib

from .errors import ErrMalformedInput


def _load_yaml(path: str, text: str):
    try:
        import yaml
    except ImportError as e:
        raise ErrMalformedInput(
            f"cannot parse {path}: YAML support requires PyYAML; "
            "use a .json or .toml file"
        ) from e
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise ErrMalformedInput(f"cannot parse {path}: {e}") from e


def load_structured_file(path: str):
    """Every parser failure surfaces as ErrMalformedInput so callers handle
    one exception type regardless of format."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".toml"):
        try:
            return tomllib.loads(text)
        except tomllib.TOMLDecodeError as e:
            raise ErrMalformedInput(f"cannot parse {path}: {e}") from e
    if path.endswith(".json"):
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ErrMalformedInput(f"cannot parse {path}: {e}") from e
    # yaml/yml, and extensionless files (YAML is a JSON superset)
    return _load_yaml(path, text)
