"""One run of one cell of the benchmark of tidb_tpu_torch.

    python3 sqlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the cell's deployment from the
seed (tables generated, encoded, loaded into regions, statistics loaded),
opens the sessions and runs each template once; then the sessions run
their statement streams in a closed loop for --seconds; then every
statement's rows are held against the plain reference. The last line of
standard output is one JSON object: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics from the port's spans,
counters and the profiler's device timeline. No card, no result: the run
exits 2.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tidb_tpu")  # top-level module names the run may not load
TOP_OPS = 10  # entries of each breakdown list
PROBE_STEPS = 3_000_000  # steps of the host probe's loop


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def look_for_cards(chips: int) -> str:
    """The device to run on; exits 2 where the cell's cards are missing."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"sqlbench: the cell needs {chips} CUDA device(s); this machine has {n}. No result.")
        raise SystemExit(2)
    return "cuda"


def host_probe() -> float:
    """Seconds that a fixed loop of Python takes: the host's speed at the
    moment, logged beside the run's numbers (not a metric)."""
    t0 = time.perf_counter()
    d = {}
    for i in range(PROBE_STEPS):
        d[i & 4095] = (i, i)
    return time.perf_counter() - t0


def load(cfg: dict, seed: int, device: str):
    """The deployment, built with the cyclic collector off: the load makes
    some millions of long-lived containers (the store's rows), which every
    full collection would walk again. After the load they move to the
    permanent generation (gc.freeze), as a server does after preloading."""
    from sqlbench.harness import deploy

    gc.disable()
    try:
        return deploy.build(cfg, seed, device)
    finally:
        gc.freeze()
        gc.enable()


def build_kernels(names: list, device: str) -> tuple[float, dict]:
    """The port's hand kernels that the mix launches, built in a step of
    their own (nvcc runs in a checkout's first run only): the seconds, and
    the seconds of each kernel compiled now. They count in set-up."""
    if device != "cuda" or not names:
        return 0.0, {}
    from tidb_tpu_torch import kernels

    t0 = time.perf_counter()
    compiled = {k: v for k, v in kernels.build(names).items() if v > 0}
    return time.perf_counter() - t0, compiled


def main(argv=None, device: str | None = None, config_overrides: dict | None = None) -> int:
    """A run. `device` given skips the look for a card, and
    `config_overrides` replaces keys of the configuration (CPU tests only)."""
    args = parse(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        log("sqlbench: no BENCHMARK.json beside the benchmark. No result.")
        return 2
    from sqlbench.harness import check, loop, spec, traffic

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    dev = device or look_for_cards(int(cell["chips"]))
    import torch

    cfg = {**spec.config(bench, cell["config"]), **(config_overrides or {})}
    mix = spec.traffic(cell["traffic"])
    build_s, compiled = build_kernels(mix.get("kernels", []), dev)
    dep = load(cfg, args.seed, dev)
    sess = loop.sessions(dep, cfg, int(mix["sessions"]), dev)
    warm = [loop.execute(sess[0], dep.store, st, 0, False) for st in traffic.warm_statements(mix, args.seed)]
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS
    log(f"sqlbench {args.workload} seed {args.seed}: set-up {setup_s:.3f} s, build_s {build_s:.3f} (compiled {compiled})"
        f" {dep.timings}, regions {dep.regions}, encoder check {dep.checked_rows} rows")

    from sqlbench.harness import layers

    before = layers.counters(dep.store)
    if args.trace:
        from contextlib import nullcontext

        from sqlbench.harness.kernels import CallWork
        from sqlbench.harness.trace import Profiler

        with Profiler() if dev == "cuda" else nullcontext() as prof, \
                CallWork() if dev == "cuda" else nullcontext() as work:
            win = loop.Window(sess, dep.store, mix, args.seed, args.seconds, traced=True).run()
        after = layers.counters(dep.store)
        timeline = prof.timeline() if prof is not None else None
    else:
        win = loop.Window(sess, dep.store, mix, args.seed, args.seconds, traced=False).run()
        after = layers.counters(dep.store)
        timeline = work = None
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    del sess
    probe_s = host_probe()

    checker = check.Checker(mix, dep.tables)
    verdict = check.judge(warm + win.records, checker)
    done = win.in_window()
    bad = {id(r) for r in done if r.error is not None or not checker.same(r.stmt, r.rows)}
    completed = [r for r in done if id(r) not in bad]
    result = {
        "correct": verdict["wrong"] == 0 and verdict["errors"] == 0 and bool(completed),
        "attempted": len(win.records),
        "failed": sum(1 for r in win.records if r.error is not None or not checker.same(r.stmt, r.rows)),
    }
    cell_name = cell["name"]
    if args.trace:
        ctx = layers.Context(win, completed, before, after, timeline, work)
        metrics = {}
        for m in spec.cell_metrics(bench, cell_name, "per_layer"):
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat_ms = [(r.end - r.start) * 1e3 for r in done]
        e2e = {
            "stmt_per_s": len(completed) / win.seconds,
            "p95_ms": float(statistics.quantiles(lat_ms, n=20, method="inclusive")[18]) if len(lat_ms) > 1 else None,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.cell_metrics(bench, cell_name, "end_to_end") if e2e.get(m["name"]) is not None}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev == "cuda" else dev,
        "kind": torch.cuda.get_device_name(0) if dev == "cuda" else dev,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if args.trace and timeline is not None:
        lo, hi = int(win.start * 1e9), int(win.deadline * 1e9)
        result["device"]["busy_s"] = timeline.busy_ns(lo, hi) / 1e9
        result["device"]["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = layers.breakdown(win, timeline, lo, hi, TOP_OPS)
    checks = {
        "wrong_answers": {"value": verdict["wrong"], "limit": 0},
        "failed_statements": {"value": verdict["errors"], "limit": 0},
        "checked_statements": {"value": verdict["checked"], "limit": 1},
    }
    result["checks"] = checks
    forbidden = loaded_forbidden()
    if forbidden:
        log(f"sqlbench: the run loaded {forbidden}, which the port's benchmark may not. No result.")
        return 3
    log(f"sqlbench {cell_name}: counters over the window {{{', '.join(f'{k}: {after[k] - before[k]}' for k in after)}}};"
        f" warm-up ms {[round((r.end - r.start) * 1e3, 1) for r in warm]}")
    log(f"sqlbench {cell_name}: {len(win.records)} statements, {len(done)} ended in the window;"
        f" reference {checker.seconds:.3f} s over {len(checker.memo)} distinct statements;"
        f" host probe {probe_s:.4f} s")
    by_tmpl = {}
    for r in done:
        by_tmpl.setdefault(r.stmt.template, []).append((r.end - r.start) * 1e3)
    lat = sorted(x for v in by_tmpl.values() for x in v)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else None
    log(f"sqlbench {cell_name}: latency ms by template (count, median, max) "
        f"{ {k: (len(v), round(statistics.median(v), 1), round(max(v), 1)) for k, v in sorted(by_tmpl.items())} },"
        f" p95 of all {p95}")
    if verdict["first"]:
        log(f"sqlbench: first fault: {verdict['first']}")
    for name, c in checks.items():
        cmp = ">=" if name == "checked_statements" else "<="
        log(f"check {name}: {c['value']} (must be {cmp} {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
