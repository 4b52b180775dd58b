"""Shared helpers of the benchmark's CPU tests: the checkout on the path,
a tiny run of a cell through run.main on the CPU, tiny tables, and the
mixes kept for a later cell."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"scale_factor": 0.004, "region_split_bytes": 1 << 20}  # about 24k fact rows in 4 regions

# mixes and configurations kept for a later cell (PERF.md, Open questions):
# the tests hold them to the reference as they do the cells
KEPT_CELLS = [
    {"name": "tpch_sf05.join", "config": "tpch_sf05_join", "traffic": "tpch_join", "chips": 1, "why": "-"},
    {"name": "ssb_sf05.flight1", "config": "ssb_sf05", "traffic": "ssb_flight1", "chips": 1, "why": "-"},
]
KEPT_CONFIGS = [
    {"name": "tpch_sf05_join", "source": "-", "file": "sqlbench/configs/tpch_sf05_join.json",
     "reduced": ["scale_factor", "tables"], "why": "-"},
    {"name": "ssb_sf05", "source": "-", "file": "sqlbench/configs/ssb_sf05.json",
     "reduced": ["scale_factor", "tables"], "why": "-"},
]


def with_kept(bench: dict) -> dict:
    """BENCHMARK.json's contents with the kept cells and configurations added."""
    names = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    return {**bench, "workloads": bench["workloads"] + [w for w in KEPT_CELLS if w["name"] not in names],
            "configs": bench["configs"] + [c for c in KEPT_CONFIGS if c["name"] not in configs]}


def run_module():
    spec = importlib.util.spec_from_file_location("sqlbench_run", ROOT / "sqlbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_run(cell: str, seed: int = 2**31 + 11, seconds: float = 1.5, trace: int = 0, device: str = "cpu",
             overrides: dict | None = None) -> tuple[int, dict | None, str]:
    """(exit code, the result line or None, standard error) of one run of
    `cell` at the tiny size."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_module().main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                                "--trace", str(trace)], device=device, config_overrides={**TINY, **(overrides or {})})
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def tiny_tables(config: str, seed: int = 5, sf: float = 0.004) -> tuple[dict, dict]:
    """The configuration sqlbench/configs/<config>.json at scale `sf`, and
    its tables."""
    from sqlbench.harness import spec

    cfg = {**json.loads((ROOT / "sqlbench" / "configs" / f"{config}.json").read_text()), "scale_factor": sf}
    return cfg, spec.generator(cfg["generator"])(cfg, seed)
