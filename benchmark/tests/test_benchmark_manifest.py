"""BENCHMARK.json and every file it names load, and keep to the contract's
rules of names, units, lengths and cross-references."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from .conftest import REPO, load

MANIFEST = load(REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BASE = REPO / "benchmark"
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def applies(metric: dict, cell: str) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if metric in MANIFEST["end_to_end"]:
        return True
    return any(m["name"] == metric["moves"] and applies(m, cell) for m in MANIFEST["end_to_end"])


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert all(line(w) for w in MANIFEST["command"]) and len(MANIFEST["command"]) <= 32
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for c in MANIFEST["configs"]:
        assert set(c) == KEYS["config"]
    for w in MANIFEST["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert KEYS[kind] <= set(m) <= KEYS[kind] | {"workloads"}


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert line(c["why"]) and line(c["source"]) and c["source"].startswith("https://")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "layer" in m:
            assert line(m["layer"])
    names += [w["name"] for w in MANIFEST["workloads"]] + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in MANIFEST[kind]}) == len(MANIFEST[kind])
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_every_file_loads_and_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = load(REPO / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in MANIFEST["workloads"]:
        traffic = load(BASE / "traffic" / f"{w['traffic']}.json")
        entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
        assert all(hasattr(entry, a) for a in ("CAPTURE", "Session", "readings", "verify"))
        cell = load(BASE / "cells" / f"{w['name']}.json")
        assert set(cell["limits"]) == set(entry.COMPARED)
        assert cell["checked_calls"] >= 1
    for path in BASE.glob("*/*.json"):
        assert NAME.match(path.stem), path
        load(path)


def test_every_metric_has_a_reader():
    from benchmark import harness

    for m in METRICS:
        reader = harness.reader(m["name"])
        assert callable(reader.read) and isinstance(reader.SPANS, dict)


def test_sources_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
    for m in METRICS:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".", 1)[0].endswith("_roofline")


def test_layers_name_one_metric_they_move():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = [m for m in MANIFEST["end_to_end"] if applies(m, cell)]
    layer = [m for m in MANIFEST["per_layer"] if applies(m, cell)]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])


def test_at_most_one_cell_on_four_chips():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
    assert len(four) <= 1
