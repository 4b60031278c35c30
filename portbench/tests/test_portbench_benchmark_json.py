"""BENCHMARK.json keeps to the names, units and keys its format allows,
and every file it names is where it says."""

import re

from portbench.tests.conftest import REPO, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_units(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["portbench"]
    assert all(_one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    names = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports the layer metric reports what it moves
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for w in cells:  # every cell: setup_s, another end-to-end metric, a layer metric
        assert sum(w in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
