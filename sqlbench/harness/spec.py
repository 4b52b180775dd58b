"""Finding the benchmark's pieces by name: BENCHMARK.json's entries, each
configuration's file, each traffic mix's file, each per-layer metric's
reader and each template's reference."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = Path(__file__).resolve().parents[1]  # sqlbench/


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The end_to_end or per_layer entries that the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str):
    """sqlbench/metrics/<name>.py's read(ctx) -> float | None ('.' in a
    metric's name is '_' in its file's)."""
    return importlib.import_module(f"sqlbench.metrics.{name.replace('.', '_')}").read


def generator(name: str):
    return importlib.import_module(f"sqlbench.datagen.{name}").generate


def reference(name: str):
    """sqlbench/reference/<name>.py: answer(tables, params, precision,
    scratch) -> rows, and optionally compare(got, want) -> bool."""
    return importlib.import_module(f"sqlbench.reference.{name}")
