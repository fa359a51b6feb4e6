"""BENCHMARK.json keeps the contract's form, and every name it gives
resolves to the benchmark's own files."""

import json
import os
import re

import pytest

from benchmark import compare, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 \
        and "\n" not in s and "\t" not in s


def test_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) for w in man["command"])
    assert os.path.join(*man["command"][1].split("/")).startswith(
        man["paths"][0])
    assert isinstance(man["run_seconds"], int) \
        and 1 <= man["run_seconds"] <= 51


def test_names_and_units(man):
    names = [c["name"] for c in man["configs"]] \
        + [w["name"] for w in man["workloads"]] \
        + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["config"] for w in man["workloads"]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(man["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_workloads(man):
    cells = man["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = harness.load_cell(w["name"])
        assert set(cell.limits) == set(compare.NAMES)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_metrics(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(harness.metric_reader(m["name"]))
    layers = set()
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]))
        layers.add(m["layer"])
    assert {"batch API", "host recompute", "batch step", "tables",
            "device"} <= layers
