"""The control of `correct`: the reference put in the program's place,
computed one precision below what the configuration states, held to the
exact reference by the run's own comparison. It has to come out not
correct. The traffic file names the precision (`control_precision`):
float64 for TPC-H's exact DECIMAL arithmetic, float32 where float64 cannot
be told from it (Q3's sums of at most 7 lines), 32-bit integer sums for
SSB's 64-bit ones.

    python3 sqlbench/control.py --workload <cell> --seeds 1 2 3 [--statements 60] [--scale 0.5]

For each seed it draws the statements a run checks (one of each template,
then each session's stream) and prints, as a JSON line, how many of them
the control answers wrongly. Numpy only: no card is needed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def readings(cell: str, seed: int, statements: int, scale: float | None = None) -> dict:
    from sqlbench.harness import check, spec, traffic

    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    if scale is not None:
        cfg = {**cfg, "scale_factor": scale}
    mix = spec.traffic(w["traffic"])
    tables = spec.generator(cfg["generator"])(cfg, seed)
    stmts = traffic.warm_statements(mix, seed)
    streams = [traffic.Stream(mix, seed, i) for i in range(int(mix["sessions"]))]
    while len(stmts) < statements:
        stmts.append(streams[len(stmts) % len(streams)].next())
    exact = check.Checker(mix, tables)
    control = check.Checker(mix, tables, precision=mix["control_precision"])
    t0 = time.perf_counter()
    wrong = sum(1 for st in stmts if not exact.same(st, control.want(st)))
    return {"workload": cell, "seed": seed, "precision": control.precision, "statements": len(stmts),
            "wrong_answers": wrong, "limit": 0, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--statements", type=int, default=60)
    p.add_argument("--scale", type=float, default=None, help="scale factor in place of the configuration's")
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.statements, args.scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
