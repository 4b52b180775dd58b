"""BENCHMARK.json against the contract's shape: names, units, files found
by name, and every metric's cells reporting what it moves."""

import json
import re

import pytest
from sqlbench_testkit import ROOT

from sqlbench.harness import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_pieces_found_by_name(bench):
    assert bench["command"] == ["python3", "sqlbench/run.py"] and bench["paths"] == ["sqlbench"]
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("sqlbench/")
        cfg = spec.config(bench, c["name"])
        assert 1 <= len(cfg["source"]) <= 200
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in ("tables", "guarantees", "session_variables", "assumed", "peers", "read_policy"):
            assert cfg[key], key
        spec.generator(cfg["generator"])
    for w in bench["workloads"]:
        assert any(c["name"] == w["config"] for c in bench["configs"])
        mix = spec.traffic(w["traffic"])
        for t in mix["templates"]:
            spec.reference(t["reference"])
    for m in bench["per_layer"]:
        spec.metric_reader(m["name"])


def test_moves_are_reported(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for cell in cells:
        assert len(spec.cell_metrics(bench, cell, "end_to_end")) >= 2
        assert spec.cell_metrics(bench, cell, "per_layer")


def test_layers_named_alike(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(k) <= 200 and "\n" not in k for k in layers)
    text = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in text, layer


def test_config_json_is_whole():
    for path in (ROOT / "sqlbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        assert cfg["name"] == path.stem
