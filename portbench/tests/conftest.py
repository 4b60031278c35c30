"""Small sizes of the benchmark's configurations and mixes, for the CPU.

``pytest portbench/tests`` from the repository's root. Tests that need a
CUDA card are marked ``cuda`` and look for the card inside the test."""

import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent


def load(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def small_config(name: str, scale: float) -> dict:
    """A configuration file at ``scale`` of its tuples and pools."""
    cfg = copy.deepcopy(load(f"configs/{name}.json"))
    cfg["tuples"] = int(cfg["tuples"] * scale)
    for p in cfg["pools"]:
        p["count"] = max(5, int(p["count"] * scale))
    for e in cfg["edges"]:
        if "cap" in e:
            e["cap"] = max(10, int(e["cap"] * scale * scale))
    return cfg


@pytest.fixture
def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())
