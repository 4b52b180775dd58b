#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tidb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which exits non-zero on failure (nothing is caught):
  1. the device, and its name and power limit from nvidia-smi;
  2. build every CUDA kernel from csrc/ with nvcc (one process per source,
     in parallel) and report the build seconds;
  3. hold the one-pass GROUP BY kernel (ops/dense_agg.py) against its plain
     torch version on the card, bit for bit, at TPC-H Q1's shape (2^22
     rows, G = 16), with string keys carrying NULLs, with more than G keys
     (overflow), and with a forced primary-hash collision (overflow);
  4. drive the coprocessor program end to end — Q6 and Q1 (small-G hint 16)
     at 2^22 rows through exec.executor.drive_program_info on `cuda` — with
     every launch counter zeroed just before each path and read just after,
     and check both results against an exact numpy ground truth;
  5. time the kernel, its plain version, and Q6/Q1 end to end (median of
     >= 10 runs) beside the kernel's bound; with --profile, also one
     torch.profiler run of each path: device time by kernel and the
     device's busy share of the path's wall time.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_ROWS = 1 << 22
G = 16
REPS = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SIMT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median over `reps` runs of fn, each timed with CUDA events after a
    synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_ms(fn, reps: int = REPS, warmup: int = 1) -> float:
    """Median host-clock time of fn() ending in a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def q1_agg_inputs(dag, fts, batch):
    """The Q1 aggregation's inputs as the main path builds them: the
    selection mask, the group-key CompVals and the (AggDesc, args) pairs."""
    from tidb_tpu_torch.exec.dag import Aggregation, Selection
    from tidb_tpu_torch.expr.compile import ExprCompiler
    from tidb_tpu_torch.ops.selection import apply_selection

    sel = next(e for e in dag.executors if isinstance(e, Selection))
    agg = next(e for e in dag.executors if isinstance(e, Aggregation))
    comp = ExprCompiler(fts, device=batch.device)
    valid = apply_selection(batch.row_valid, comp.run(list(sel.conditions), batch.cols))
    gvals = comp.run(list(agg.group_by), batch.cols)
    avals = comp.run([a for d in agg.aggs for a in d.args], batch.cols)
    aggs, k = [], 0
    for d in agg.aggs:
        aggs.append((d, avals[k: k + len(d.args)]))
        k += len(d.args)
    return valid, gvals, aggs


def compare_kernel(name, lanes, want_overflow: bool):
    """Kernel vs plain version on the same CUDA tensors, bit for bit.
    Returns the largest absolute difference over the integer outputs."""
    import torch

    from tidb_tpu_torch.ops import dense_agg as K1

    got = K1.dense_agg(*lanes)
    torch.cuda.synchronize()
    want = K1._dense_agg_plain(*lanes)
    names = ("group_rep", "n_groups", "overflow", "counts", "sums", "nns")
    err = 0
    for nm, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            raise SystemExit(f"K1 {name}: {nm} differs: kernel {a.tolist()} plain {b.tolist()}")
        if a.dtype != torch.bool and a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    if bool(got[2]) != want_overflow:
        raise SystemExit(f"K1 {name}: overflow {bool(got[2])}, expected {want_overflow}")
    log(f"phase 3 K1 {name}: kernel == plain (n_groups={int(got[1])}, overflow={bool(got[2])})")
    return err


def numpy_q6(t, T):
    import numpy as np

    lo = T.MyTime.parse("1994-01-01", 0).packed
    hi = T.MyTime.parse("1995-01-01", 0).packed
    m = (t["shipdate"] >= lo) & (t["shipdate"] < hi) & (t["disc"] >= 5) & (t["disc"] <= 7) & (t["qty"] < 2400)
    return int((t["price"][m] * t["disc"][m]).sum()), int(m.sum())


def round_div(num: int, den: int) -> int:
    q = (2 * abs(num) + abs(den)) // (2 * abs(den))
    return -q if (num < 0) != (den < 0) else q


def numpy_q1(t, T, avg_shift: int):
    """{(rflag, lstat): [sum qty, sum price, sum disc_price, avg qty,
    avg disc, count]} as scaled integers, from the generated columns."""
    import numpy as np

    m = t["shipdate"] <= T.MyTime.parse("1998-09-02", 0).packed
    gid = (t["rflag"].astype(np.int64) * 2 + t["lstat"].astype(np.int64))[m]
    qty, price, disc = t["qty"][m], t["price"][m], t["disc"][m]
    out = {}
    for g in np.unique(gid):
        s = gid == g
        cnt = int(s.sum())
        sq, sp, sd = int(qty[s].sum()), int(price[s].sum()), int(disc[s].sum())
        sdp = int((price[s] * (100 - disc[s])).sum())
        key = ("ANR"[g // 2], "OF"[g % 2])
        out[key] = [sq, sp, sdp, round_div(sq * 10 ** avg_shift, cnt), round_div(sd * 10 ** avg_shift, cnt), cnt]
    return out


def decoded_q1(chunk):
    out = {}
    for j in range(chunk.num_rows()):
        key = (chunk.columns[6].get_bytes(j).decode(), chunk.columns[7].get_bytes(j).decode())
        out[key] = [int(chunk.columns[i].data[j]) for i in range(6)]
    return out


def profile_path(name, fn, wall_ms: float, top: int = 12):
    """One profiled run of fn: device time by kernel (torch.profiler) and
    the device's busy share of the path's median wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        us = ev.self_device_time_total
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile {name}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}% busy), {sum(r[1] for r in rows)} kernel launches")
    for us, count, key in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X
    import tidb_tpu_torch.types as T
    from tidb_tpu_torch import kernels, workloads as W
    from tidb_tpu_torch.exec.builder import ProgramCache
    from tidb_tpu_torch.exec.executor import drive_program_info
    from tidb_tpu_torch.expr.compile import CompVal
    from tidb_tpu_torch.interop import device_batch_from_numpy
    from tidb_tpu_torch.ops import dense_agg as K1

    dev = torch.device("cuda")
    # phase 1: the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")

    # phase 2: build every kernel from the checkout's sources
    secs = kernels.build()
    for name, s in secs.items():
        log(f"phase 2 built {name} in {s:.2f}s")
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")

    # phase 3: K1 against its plain version at Q1's shape
    n = N_ROWS
    t = W.make_tables(n, seed=0)
    q1_dag, q1_fts = W.q1_dag(E, X, T)
    q1_batch = device_batch_from_numpy(W.q1_columns(t), np.ones(n, bool), n, q1_fts, device=dev)
    valid, gvals, aggs = q1_agg_inputs(q1_dag, q1_fts, q1_batch)
    q1_lanes = K1.dense_agg_lanes(gvals, aggs, valid, G)[:5]
    err = compare_kernel("q1", (*q1_lanes, G), want_overflow=False)

    gen = torch.Generator(device=dev).manual_seed(1)
    null_mask = torch.rand(n, generator=gen, device=dev) < 0.1
    rflag_nulls = CompVal(gvals[0].value, gvals[0].null | null_mask, gvals[0].ft, raw=gvals[0].raw)
    lanes = K1.dense_agg_lanes([rflag_nulls, gvals[1]], aggs, valid, G)[:5]
    err = max(err, compare_kernel("string keys with NULLs", (*lanes, G), want_overflow=False))

    wide = torch.randint(0, 40, (n,), generator=gen, device=dev, dtype=torch.int64)
    wide_key = CompVal(wide, torch.zeros(n, dtype=torch.bool, device=dev), T.new_longlong())
    lanes = K1.dense_agg_lanes([wide_key], aggs, valid, G)[:5]
    err = max(err, compare_kernel("40 keys > G", (*lanes, G), want_overflow=True))

    hp_rflag_only = K1.dense_agg_lanes([gvals[0]], aggs, valid, G)[0]
    lanes = (hp_rflag_only,) + tuple(q1_lanes[1:])
    err = max(err, compare_kernel("forced hp collision", (*lanes, G), want_overflow=True))

    # phase 4: the main path, end to end
    q6_dag, q6_fts = W.q6_dag(E, X, T)
    q6_batch = device_batch_from_numpy(W.q6_columns(t), np.ones(n, bool), n, q6_fts, device=dev)
    cache = ProgramCache()

    K1.dense_agg.launches = 0
    q6_chunk, _, _ = drive_program_info(cache, q6_dag, q6_batch, 64)
    q6_launches = K1.dense_agg.launches
    got = (int(q6_chunk.columns[0].data[0]), int(q6_chunk.columns[1].data[0]))
    want = numpy_q6(t, T)
    if got != want:
        raise SystemExit(f"Q6 mismatch: port {got}, numpy {want}")
    log(f"phase 4 Q6 at {n} rows: revenue(scaled 1e4)={got[0]} count={got[1]} == numpy; K1 launches {q6_launches}")

    K1.dense_agg.launches = 0
    q1_chunk, _, _ = drive_program_info(cache, q1_dag, q1_batch, 64, small_groups=G)
    q1_launches = K1.dense_agg.launches
    if q1_launches < 1:
        raise SystemExit("Q1 did not launch the dense_agg kernel")
    avg_agg = next(e for e in q1_dag.executors if isinstance(e, E.Aggregation)).aggs[3]
    shift = avg_agg.ft.decimal - avg_agg.partial_fts()[1].decimal
    got = decoded_q1(q1_chunk)
    want = numpy_q1(t, T, shift)
    if got != want:
        raise SystemExit(f"Q1 mismatch:\n port  {got}\n numpy {want}")
    log(f"phase 4 Q1 at {n} rows: {len(got)} groups == numpy; K1 launches {q1_launches}")

    # phase 5: times
    nc = len(q1_lanes[3])
    launches_saved = K1.dense_agg.launches
    k_ms = median_ms(lambda: K1.dense_agg(*q1_lanes, G))
    p_ms = median_ms(lambda: K1._dense_agg_plain(*q1_lanes, G))
    K1.dense_agg.launches = launches_saved  # timing launches are not the main path's
    in_bytes = n * (8 + 8 + 1) + nc * n * (8 + 1)
    out_bytes = G * (4 + 8 * (1 + 2 * nc)) + 8
    ops = n * (1 + 2 * nc)  # one int64 add per accumulator per row
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    q6_ms = host_median_ms(lambda: drive_program_info(cache, q6_dag, q6_batch, 64))
    q1_ms = host_median_ms(lambda: drive_program_info(cache, q1_dag, q1_batch, 64, small_groups=G))
    log(f"phase 5 K1 dense_agg: {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes: "
        f"{in_bytes + out_bytes} B), {n} rows, NC={nc}, G={G}")
    log(f"phase 5 Q6 end to end: {q6_ms:.3f} ms ({n / q6_ms / 1e3:.1f} Mrows/s); "
        f"Q1 end to end: {q1_ms:.3f} ms ({n / q1_ms / 1e3:.1f} Mrows/s)")
    if "--profile" in sys.argv[1:]:
        profile_path("q6", lambda: drive_program_info(cache, q6_dag, q6_batch, 64), q6_ms)
        profile_path("q1", lambda: drive_program_info(cache, q1_dag, q1_batch, 64, small_groups=G), q1_ms)
        K1.dense_agg.launches = launches_saved

    record = {"kernels": [{
        "name": "dense_agg", "route": "cuda", "source": "tidb_tpu_torch/csrc/dense_agg.cu",
        "replaces": "tidb_tpu/ops/dense_pallas.py:223", "launches": q1_launches,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
