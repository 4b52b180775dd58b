#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tidb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which exits non-zero on failure (nothing is caught):
  1. the device, and its name and power limit from nvidia-smi;
  2. build every CUDA kernel from csrc/ with nvcc (one process per source,
     in parallel), report the build seconds and ptxas's register lines;
  3. hold every kernel against its plain torch version on the card, bit
     for bit, at the shapes the main paths give it:
       K1 dense_agg (ops/dense_agg.py) at TPC-H Q1's shape (2^22 rows,
          G = 16), with string keys carrying NULLs, with more than G keys
          (overflow), and with a forced primary-hash collision (overflow);
          its one-pass edges: n = 2^22 - 37, 1000, 129, 127, 1, no valid
          row, G = 1 and 32, NC = 0 and 6, sums that wrap near +-2^63,
          lanes at a 1-element offset, two calls in a row, a small call
          after a large one, a call after an overflow call, a second
          stream; and more than 64 keys (the flag alone: rows of keys that
          found no slot are dropped, and the executor keeps only the flag);
       K2 postsort_segscan and K3 membership_segscan (ops/joinscan.py) on
          Q3's own inputs at 2^22 lineitem rows, then a nullable two-lane
          case, a duplicate hay key (overflow), every row usable (the last
          run's emission) and duplicate inner keys (K3 overflow); K2's
          look-back edges: runs over 9 and 12 whole tiles, runs ending on
          tile boundaries, n = 1, TILE - 1, TILE, TILE + 1, no value lane,
          a small call whose sums look like the next call's tile status
          words then a large call on the same scratch, and two calls in a
          row (its scratch is reused) equal; K3's tile edges at its own
          tile size: real outer runs over two tile boundaries (headed by an
          inner row and not), runs starting at a tile's last row, leading
          runs of 40 rows and of 5 whole tiles (the 32-ary search), a
          duplicate inner key straddling a boundary, an INT32_MIN inner row
          at element 0 before INT32_MIN + 1 outer rows, all rows pinned,
          n = 1, TILE - 1, TILE, TILE + 1, a bad bit only on the last row,
          views at a 1-element offset, two calls in a row after an
          overflow (its scratch resets) and a second stream;
       K4 probe_tables (ops/join_probe.py) at the 1:32 radix join's plan
          (4096 partitions x 128 build x 2048 probe slots), then NULL keys,
          unmatched keys, a duplicate build key (dup flag), unsigned keys
          and INT64 extremes; its hash-table edges: every build slot usable
          with distinct keys (the table's highest load factor), build keys
          that all share one home entry of the kernel's table hash (one
          chain, wrapping past the table's end), duplicates spread over
          warps (a later slot may be found first; the smallest must win),
          part_cap 256, part_cap 100 with probe_cap 1001 and 1 (the
          scalar-load copy), tables at a 1-element offset, two calls in a
          row after a dup (its scratch resets) and a second stream;
  4. drive the main paths end to end through exec.executor.
     drive_program_info on `cuda`, every launch counter zeroed just before
     each path and read just after, each result checked against an exact
     numpy ground truth: Q6 and Q1 (small-G hint 16) at 2^22 rows; Q3 at
     2^22 lineitem rows (K2 and K3 must launch); the join bench at 1:32
     (2^22 probe rows, 2^17 build rows) uniform scalar, uniform grouped by
     the build payload (700 groups) and skewed (40% on one key: the escape
     hatch and one ladder retry) — K4 must launch on the uniform cases;
     then the order-dependent executors, each against an exact numpy
     order: TopN (ORDER BY price DESC, shipdate LIMIT 100, BASELINE config
     4) at 2^22 rows, one program on the sampled fast path, and at 2^26
     rows; a TopN whose prices are all equal (the sampled threshold
     misses, drive_program_info rebuilds the program as the full sort: two
     compiles); LIMIT 4096 (above FAST_K_LIMIT: the direct full sort);
     the full Sort of 2^22 rows; and the window DAG (PARTITION BY
     l_orderkey ORDER BY price DESC, shipdate: row_number, rank,
     dense_rank, sum, count, max, lag, first_value) at 2^22 lineitem rows;
  5. time each kernel beside its bound — its device time per call from
     torch.profiler over 10 calls, the median CUDA-event time of a
     wrapper call (>= 10 runs) and its host time (100 calls back to
     back, no synchronisation between them); K1's, K3's and K4's calls
     must run their one kernel and no other device operation — and its
     plain version (for K4, a device copy that moves as many bytes; for
     K3, the floor under a kernel that small: a one-element fill and a
     device copy that moves K3's bytes, timed as K3 is), and
     each path end to end (host clock around a synchronised run); with
     --profile, also one torch.profiler run of each path: device time by
     kernel and the device's busy share;
  6. the store's coprocessor endpoint (tidb_tpu_torch/store): load 2^21
     rows of a 7-column lineitem table into a TPUStore on `cuda` (the
     Python row encoder in 8 processes), split two 2^20-row regions,
     require the native row decoder, and per region send Q6, Q1 (small-G
     hint 16, K1 must launch), TopN, Q3 (orders and customer as aux
     chunks; K2 and K3 must launch) and the join bench (orders as an aux
     chunk) as wire bytes through coprocessor_bytes, each answer decoded
     and held against numpy over the region's rows, with no oracle
     fallback and no other_error; a paged Selection followed through its
     cursors; a stale epoch (region_error); then time each DAG per region
     cold (native decode, H2D and program build printed apart), warm
     through coprocessor(req), warm through coprocessor_bytes (its build
     sides decoded and uploaded again each call) and as a result-cache
     hit; with --profile, also a profile of Q1 and Q3 through
     coprocessor_bytes with the bytes copied each way;
  5b. (with phase 5) each kernel's region-batched launch over 4 different
     lanes, bit-equal to its plain version lane by lane, one launch, its
     device time beside the same lanes as single calls;
  7. the batch endpoint: phase 6's table split into seven regions of 2^18
     rows and two of 2^17, each DAG as ONE batch_coprocessor_bytes frame
     over the nine regions plus a stale epoch, every region against numpy,
     K1 / K2 / K3 once per capacity bucket, no oracle fallback,
     other_error, bucket fallback or lane-by-lane vmap op; the warm batch
     timed beside the nine single requests;
  8. the statement's root half on phase 7's regions: each statement of
     workloads.store_statements (Q1, Q6, BIT_AND/OR/XOR, DISTINCT grouped
     and scalar, GROUP BY l_orderkey, and that merge forced to spill at
     group capacity 2^18 with no retry) split by distsql/root.py
     split_dag, its push half as one batch frame over the nine regions,
     the answers concatenated in region order, the root DAG through
     run_dag_on_chunks(device="cuda", oracle_fallback=False); every answer
     against numpy (the spilled merge also against the unspilled one), K1
     once per bucket in Q1's push half, SPILL_PARTITIONS +1 in the forced
     spill and +0 elsewhere, no oracle fallback, other_error, bucket
     fallback or lane-by-lane vmap op; then the median ms of the push
     frame, the root merge alone and the whole statement;
  9. the dispatch loop on phase 7's regions: each statement of phase 8,
     Q3 (orders and customer as aux chunks, a root TopN 10 by revenue) and
     the store TopN through distsql execute_root in the pool tier (4
     threads, the session's default), the batch tier and the single tier,
     every answer against numpy; K1 once per region (pool, single) or per
     capacity bucket (batch) in Q1, K2 and K3 likewise in Q3; no oracle
     fallback, other_error or bucket fallback in the store, no lane-by-lane
     vmap op, and no call of the root's row oracle (run_dag_reference is
     wrapped and counted); Q1's push half through select(use_wire=True) in
     the single and batch tiers; low_memory=True (the Partial2 fold over
     select_stream) for Q1 and GROUP BY l_orderkey; the median ms of
     execute_root per statement in each tier beside phase 8's hand-joined
     whole (with --profile, a device profile of Q1 and Q3 in the pool tier,
     and Q1 and BIT_* in the pool tier again at a 0.1 ms interpreter
     switch interval and with one intra-op CPU thread, and their CUDA
     runtime calls in the pool and single tiers); and last, a region split by
     the distsql.before_task
     failpoint on its first evaluation, in the pool and batch tiers: the
     stale task answers epoch_not_match, is re-split and retried,
     REGION_ERRORS{kind="epoch_not_match"} rises by one, and Q1 still
     equals numpy;
 10. the expression families: a TPC-H customer table of 2^20 rows in four
     regions loaded into the same store (the Python row encoder in 8
     processes, the native decoder required); every op of the math, bit,
     string and date families, string -> number and string truthiness in
     WHERE over 2^20 rows on the card and on the CPU through
     decode_outputs (equal; exp, ln, log and pow within 2 ulp; the card's
     sqrt bit-equal to np.sqrt); then workloads.store_expr_statements
     (q22_cntry and year with the small-groups hint 7, text, numeric)
     through execute_root in the single and batch tiers against numpy,
     K1 once a region or a bucket in q22_cntry and year, no oracle
     fallback, other_error, bucket fallback, lane-by-lane vmap op or call
     of the root's row oracle; the median ms per statement and tier, and
     the device operations of one `text` region request split into
     parse_f64_prefix's and the rest (with --profile, a host and a device
     profile of the text statement in both tiers and q22_cntry's batch);
 11. the SQL session: a tidb_tpu_torch.sql.Session on `cuda` over its own
     store; CREATE TABLE lineitem (phase 6's seven columns under their
     TPC-H names and types), orders and customer (phase 10's columns)
     through SQL; lineitem's 2^21 rows and customer's 2^20 copied from
     phase 10's store under the catalog's table ids (a row's value bytes
     depend only on its column ids and types), orders' 2^19 rows encoded
     in 8 processes, each table split into its own regions (lineitem as
     phase 9 left it); a CSV through LOAD DATA and ANALYZE of that table;
     lineitem's column stats through LOAD STATS of a JSON of numpy NDVs;
     then TPC-H Q1 without its ORDER BY (the small-groups hint 16: K1 once
     a region in the pool tier, once a bucket in the batch tier), Q1 with
     it (no hint: the sort path), Q6, a Q3-shaped join of lineitem and
     orders grouped by l_orderkey, ORDER BY revenue DESC LIMIT 10 (the
     packed join: K2 once a region or a bucket), the TopN and phase 10's
     q22_cntry, each in the session's default tier (the pool of 4), after
     SET tidb_allow_batch_cop = 1 and through PREPARE / EXECUTE (the second
     EXECUTE a plan-cache hit), every answer against numpy, no oracle
     answer, other_error or bucket fallback; the median host ms of
     Session.execute over 3 runs with the result cache cleared, a
     plan-cache miss (the plan cache cleared) beside a hit, each split
     into parse, plan and execute_root; the plan of TPC-H Q3's three-table
     join printed (left-deep: K3's membership chain is not reached from
     SQL); then transactions on a fresh table: BEGIN / INSERT / UPDATE /
     DELETE / COMMIT read back through the coprocessor after the result
     cache was warm, a second session's earlier snapshot blind to the
     commit until its own BEGIN, SQLError on a write conflict and on a
     held lock (with --profile, a host profile of q22_cntry's batch);
 12. the device mesh: a TPUStore(mesh_devices=["cuda:0"] * 4) (four
     shards of one card) holding phase 11's lineitem and orders (their
     encoded pairs through bulk_ingest, lineitem in phase 9's regions);
     through execute_root on its mesh tier Q6 (a sum across shards), Q1
     (hint 16: K1 once a shard), BIT_AND / OR / XOR with an unsigned MIN /
     MAX (the gather and sign-flip merges), phase 9's Q3 (K2 and K3 once a
     shard) and the TopN, each equal to numpy and to the batch tier, the
     push half's batch_stats one mesh batch over every region, no mesh
     fallback; then a Session over that store: TPC-H Q1's GROUP BY, GROUP
     BY l_orderkey (514,729 groups), a grouped COUNT(DISTINCT) (the raw-row
     exchange) and lineitem JOIN orders grouped by o_orderdate (the shuffle
     join) on its MPP tier (mpp/dispatch.py try_mpp_select: the fragment
     plan through the wire frames, the probe scan through select, the
     exchange program; MPP_SELECTS +1, MPP_FALLBACKS +0 a statement), on
     the mesh select (SET tidb_allow_mpp = OFF) and on the batch tier, each
     equal to numpy and the two exchange tiers to each other; the fragment
     frame's bytes, MPP_FRAGMENTS, MPP_TASKS, MPP_EXCHANGED_BYTES, the
     ladder's rung and the exchange's bytes and bucket capacities printed;
     Q1's GROUP BY once with each of mpp/dispatch-lost and
     mpp/exchange-stall armed (one MPP_FALLBACKS each, the mesh select
     answers) and cop-region-error armed for one hit (DISTSQL_RETRIES +1,
     MPP still serves); and the join 1:32 (a 2^16-row build, 700 groups)
     through parallel.sql.try_mesh_select with its radix plan and K4's
     launches; median host ms of 3 runs a path (GROUP BY l_orderkey: one)
     (with --profile, the device busy share of the mesh Q1 and the
     session join on the MPP tier);
 13. the control plane on phase 11's session and store: three logical
     placement stores (three peers a region), TiKV's split thresholds and
     one PD tick, SHOW PLACEMENT; follower reads (SET tidb_replica_read =
     'follower') of TPC-H Q1 (K1), Q6 and the Q3-shaped join (K2) in the
     pool and batch tiers, each equal to numpy and to the leader read,
     REPLICA_READS{follower} growing, median host ms of 3 runs beside the
     leader read; failover: the leader store of lineitem's first region
     down, Q1 and Q6 equal to numpy, PD_FAILOVERS and PD_TRANSFER_LEADER
     up with no placement move, then set_up, a tick and every breaker
     closed; the safe_ts gate: replica/apply-lag armed for the store the
     follower router picks next, an UPDATE of the lineitem rows with
     l_orderkey < 64 (l_quantity + 1) committed as one transaction of its
     rows through the store's Percolator engine, a follower read at the new
     snapshot that takes
     DataIsNotReady on that store's peers, retries and equals numpy on the
     updated rows, then disarm, a tick, no safe_ts lag and that store
     serving follower reads again; and a split storm: the PD timer every
     0.05 s at a 2^17-key limit while Q1 and Q6 run in the pool tier, until
     no region holds more than 2^17 keys, every answer equal to numpy, the
     regions and operators printed. Phases 6, 10, 11 and 12 print the time
     their loads spent in the store's write hooks (the quorum gate, the
     flow record and the replication proposals);
 14. change data capture and the columnar replica: a Session(mesh_devices=
     ["cuda:0"] * 4) over its own store holding lineitem_r (the first
     2^18 rows of phase 11's lineitem, as they stood before phase 13's
     UPDATE, in four regions) and orders, LOAD STATS of lineitem_r's
     NDVs; ALTER TABLE lineitem_r SET COLUMNAR REPLICA 1 and one PD tick
     (the changefeed's birth scan, mount and apply in pd.cdc, the
     compaction and the upload of the stable batch to the card in
     pd.columnar, each timed), SHOW COLUMNAR TABLES 2^18 stable rows, the
     batch on `cuda`; with tidb_isolation_read_engines = 'tpu,columnar'
     (the MPP tier and the mesh off) TPC-H Q1 without ORDER BY (K1 once),
     Q6, the Q3-shaped join (K2 once a program run) and the TopN served
     from the stable batch (COLUMNAR_SCANS +1, no fallback,
     run_dag_on_chunks not called), each equal to numpy and to the row
     store, median host ms of 3 runs beside the row store's pool tier;
     the MPP tier on: Q1's GROUP BY stays with engine routing, and
     lineitem_r JOIN orders grouped by o_orderdate rides the MPP tier with
     its probe scan from the replica (replica_served on the mpp.dispatch
     span), equal to numpy and to the MPP tier over the row store; a file
     changefeed (build/cdc_phase) from the store's current ts, then one
     transaction through the store's Percolator engine (an UPDATE of the
     rows with l_orderkey < 64, an INSERT of 16 rows and a DELETE of 16):
     a routed Q1 before any tick (one data_not_ready wait, one counted
     fallback to the row store), after store.cdc.tick() (the delta
     overlay, run_dag_on_chunks once) and after a PD tick (the compacted
     stable batch, K1 once), each equal to numpy; the file feed's records
     exactly the transaction's changes at its commit ts, SHOW CHANGEFEEDS,
     DROP CHANGEFEED; and columnar/apply-stall armed over one more UPDATE:
     the replica's feed parks in error, a routed Q1 falls back once, then
     the disarm, RESUME and a PD tick serve it again, equal to numpy with
     an empty error in the view. No oracle answer, other_error or bucket
     fallback, and no COLUMNAR_FALLBACKS but the two provoked (with
     --profile, a host profile of the overlay read);
 15. the front door over phase 11's store and catalog (as phase 13 left
     them): a MySQLServer(store=..., catalog=..., device="cuda") on
     127.0.0.1, port 0; through MiniClient TPC-H Q1 without ORDER BY (K1),
     Q6 and the Q3-shaped join (K2), each result set equal, value for
     value as text, to the same statement through an in-process
     Session.execute on the same store and to numpy, K1 and K2 launched
     as many times as in process, the median host ms of 3 runs over the
     wire beside in process; 32 connections with tidb_tpu_enable_coalesce
     ON each running 64 PREPARE / EXECUTE point gets of orders by seeded
     o_orderkey (plan-cache hits), every answer equal to the same
     connections' with coalescing OFF, COALESCE_BATCHES and
     COALESCE_LAUNCHES_SAVED > 0, no COALESCE_FALLBACKS, the median and
     p99 ms of a point get either way and the lanes per batch; 32
     connections each running 32 autocommit single-row INSERTs into a new
     table with a primary key, every row read back, COALESCE_GROUP_COMMITS
     and COALESCE_GROUP_PROPOSALS_SAVED > 0; and a StatusServer: /status,
     the lineitem schema route, /metrics (every sample line parses, the
     coalescer's families there), /pd/api/v1/regions,
     /cdc/api/v1/changefeeds and /columnar/api/v1/tables answer 200 and
     match the catalog, the PD, the hub and the replica;
 16. BR and point-in-time recovery over phase 14's session: BACKUP
     DATABASE * TO a directory (build/br_phase) and BACKUP LOG TO
     'file://' the same directory, a PD tick, a cut, a transaction shaped
     like phase 14's (UPDATE of the rows with l_orderkey < 64, INSERT of
     16 rows, DELETE of 16) and a second cut; at each cut RESTORE DATABASE
     * FROM it UNTIL TS into a fresh Session(device="cuda"), LOAD STATS of
     lineitem_r's NDVs, then TPC-H Q1 without ORDER BY (K1) and the
     Q3-shaped join (K2) on the card, each equal to numpy at the cut and
     to the source session read at the cut (tidb_snapshot), no oracle
     answer and no other_error; the backup's, the restores' and the
     replays' seconds, the bytes written and the segment counts printed;
     /cdc/api/v1/changefeeds over the source shows the log backup's feed;
 17. the seeded chaos storms of tidb_tpu_torch/tools/chaos.py on the card:
     (a) run_chaos(seed=11, statements=40, device="cuda") (the reference's
     short run: its own tables, a single-region oracle session, the
     default schedule of an apply-lag wedge, two store outages with
     leader reads, a server-busy storm, a PD heartbeat blackout, not-leader
     flaps and an operator-timeout window) inside
     tidb_tpu_torch.analysis.lockwatch.watching(): no wrong result, no
     untyped error, every breaker closed, failovers >= 1 and all of them
     leader transfers, follower reads > 0, ok + typed == 40, no lock-order
     cycle and no unguarded annotated access, the edge count and the
     statements' p50 / p99 ms printed; (b) the same storm loop
     (chaos.storm) and default_schedule(30) over phase 11's store and
     catalog as phases 13-15 leave them, set to four stores and scattered,
     with the storm cluster's settings (batch cop, backoff weight 1,
     follower reads), after one run of each statement (the cold decode
     that phase 15's writes force, timed apart): TPC-H Q1 without ORDER
     BY (K1), Q6 and the Q3-shaped join (K2) in turn, each answer equal
     to numpy over the
     tables as phase 13 left them or a typed SQLError, no untyped error,
     every breaker closed after the convergence tail, failovers, breaker
     trips and leader transfers >= 1 with no placement move, follower
     reads > 0, K1 and K2 launched; each statement's median and p99 ms
     printed beside phase 15's in-process median.

The line before the last is the kernels' JSON record (launches summed over
the main paths of phases 4 and 6-17); the last line is {"ok": true,
"device": {...}}. Without CUDA the script exits 2 and prints no result.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import threading
import time

N_ROWS = 1 << 22
TOPN_BIG_ROWS = 1 << 26        # BASELINE's "100M rows", the power of two below it
TOPN_K = 100
G = 16
REPS = 10
JOIN_RATIO = 32
JOIN_GROUPS = 700
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SIMT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
I64_MAX = (1 << 63) - 1
HAND_KERNELS = ("k1_kernel", "k2_scan", "k3_kernel", "probe_kernel")  # CUDA names of K1-K4
# phase 6, the store: one lineitem table of STORE_ROWS rows in two regions
# split at handle STORE_SPLIT (2^20 rows a region, TiKV's split size for
# this schema); Q3's orders / customers and the join's orders as aux chunks
STORE_ROWS = 1 << 21
STORE_SPLIT = 1 << 20
STORE_ORDERS = 1 << 19
STORE_CUSTOMERS = 1 << 17
STORE_JOIN_ORDERS = 1 << 17
STORE_PAGE = 8192
STORE_PAGED_ROWS = 1 << 16     # the paged request covers each region's first 2^16 rows
STORE_LOAD_CHUNK = 1 << 18     # rows a load worker encodes at a time
LOAD_WORKERS = 8
COLD_REPS = 3                  # 5 before phase 11 joined the run
# K3's operations a row for its bound, whatever the design: the key-run
# test, inner, real, the duplicate test, the bad byte, the head and ok
K3_OPS_PER_ROW = 8
# phase 5b: the kernels' region-batched launches over this many lanes
BATCH_LANES = 4
# phase 7, the batch endpoint: phase 6's table split further into seven
# regions of 2^18 rows and two of 2^17 (two capacity buckets, the first
# padded from 7 to 8 lanes)
BATCH_REGION = 1 << 18
BATCH_SPLITS = tuple(k * BATCH_REGION for k in (1, 2, 3, 5, 6, 7)) + (7 * BATCH_REGION + BATCH_REGION // 2,)
# phase 8, the statement's root half: the GROUP BY l_orderkey merge forced
# to spill at this group capacity with no capacity retry
ROOT_SPILL_CAPACITY = 1 << 18
# phase 9, the dispatch loop: execute_root's keyword arguments for each tier
# (the pool tier is the session's default: tidb_distsql_scan_concurrency 4,
# tidb_allow_batch_cop off), the timed runs a statement (DISTINCT grouped
# takes 4-5 s a run), and the handles the failpoint splits at (inside phase
# 7's fourth and sixth regions)
DISPATCH_TIERS = {"pool": {"concurrency": 4, "batch_cop": False}, "batch": {"batch_cop": True},
                  "single": {"concurrency": 1}}
DISPATCH_REPS = 5
DISPATCH_DISTINCT_REPS = 3
DISPATCH_SPLITS = (5 * BATCH_REGION // 2, 11 * BATCH_REGION // 2)
# phase 10, the expression families: the customer table (TPC-H SF ~7) in
# four regions, the op check's rows, the small-groups hint of q22_cntry and
# year (seven groups each), the timed runs per statement and tier, and the
# ulp bound of exp, ln, log and pow between the card and the CPU
EXPR_ROWS = 1 << 20
EXPR_REGION = 1 << 18
EXPR_HINT = 7
EXPR_REPS = 3
ULP_TOL = 2


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


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host time of one call of fn, from `calls` back-to-back calls with no
    synchronisation between them: the wrapper's own work and its launch
    (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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


def device_ms(fn, kernel_names, reps: int = REPS, tries: int = 3, launches: int = 1):
    """(ms, ops): the device time per call of the hand kernels named in
    `kernel_names` (substrings of their CUDA function names), from
    torch.profiler over `reps` calls of fn: the kernels alone, without the
    wrapper's host work and small torch ops that the CUDA-event time of a
    call includes; and the device operations (kernels, fills, copies) a
    call runs in all. A call of fn launches the kernels `launches` times;
    a profile that recorded fewer launches (the profiler dropped a record)
    is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_events = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
        mine = [ev for ev in dev_events if any(k in ev.key for k in kernel_names)]
        if sum(ev.count for ev in mine) >= reps * launches:
            break
    else:
        raise SystemExit(f"the profiler saw fewer than {reps * launches} launches of {kernel_names} in {tries} tries")
    us = sum(ev.self_device_time_total for ev in mine)
    if us <= 0:
        raise SystemExit(f"the profiler saw no device time for {kernel_names}")
    return us / 1e3 / reps, sum(ev.count for ev in dev_events) / reps


def require_launches(what: str, got: int, want: int) -> None:
    """A kernel's launch count on a path, held to what the path must give."""
    if got != want:
        raise SystemExit(f"{what}: {got} launches, not {want}")


def vmap_fallbacks(fn):
    """(fn(), the ops that torch.func.vmap ran lane by lane inside it):
    torch warns "There is a performance drop because we have not yet
    implemented the batching rule for <op>" for each such op."""
    import re
    import warnings

    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out = fn()
    names = set()
    for w in ws:
        m = re.search(r"batching rule for (\S+)\.", str(w.message))
        if m:
            names.add(m.group(1))
    return out, sorted(names)


def bound(in_bytes: int, out_bytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the 32-bit rate."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _flat(outs):
    for o in outs:
        if isinstance(o, (list, tuple)):
            yield from o
        else:
            yield o


def compare(kernel: str, case: str, got, want, names) -> int:
    """Kernel vs plain version on the same CUDA tensors, bit for bit.
    Returns the largest absolute difference over the integer outputs."""
    import torch

    err = 0
    got, want = list(_flat(got)), list(_flat(want))
    if len(got) != len(want):
        raise SystemExit(f"{kernel} {case}: {len(got)} outputs, plain gives {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        nm = names[i] if i < len(names) else f"out{i}"
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].flatten().tolist() if a.shape == b.shape else "shape"
            raise SystemExit(f"{kernel} {case}: {nm} differs (kernel {a.dtype}{tuple(a.shape)}, "
                             f"plain {b.dtype}{tuple(b.shape)}, first at {bad})")
        if a.dtype != torch.bool and a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def k2_runs(n: int, seed: int, dev, fixed=(), lanes: int = 2):
    """K2 inputs over n sorted rows made of key runs: the `fixed` runs
    first, each (headed by a hay row, rows), then random runs of 1-16 rows,
    3 in 4 headed by a hay row, cut at n; the last rows pinned (unusable
    hay, then probe rows). `lanes` int32 value lanes over the whole int32
    range, the second nullable (bit 0 of a random null word)."""
    import torch

    from tidb_tpu_torch.ops.joinagg import _PIN_HAY, _PIN_PROBE

    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 17, (n,), generator=g)
    heads = torch.rand(n, generator=g) < 0.75
    if fixed:
        lens = torch.cat([torch.tensor([r for _h, r in fixed]), lens])
        heads = torch.cat([torch.tensor([h for h, _r in fixed]), heads])
    run = torch.repeat_interleave(torch.arange(lens.numel()), lens)[:n]
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = run[1:] != run[:-1]
    pk = 2 * (run + 1) + 1 - (first & heads[run]).to(torch.int64)
    pins = min(4, n // 4)
    pk[n - pins:n - pins // 2] = _PIN_HAY
    pk[n - pins // 2:] = _PIN_PROBE
    vals = [torch.randint(-(1 << 31), 1 << 31, (n,), generator=g).to(torch.int32) for _ in range(lanes)]
    nw = torch.randint(0, 256, (n,), generator=g).to(torch.uint8)
    bits = [-1, 0][:lanes]
    return (pk.to(torch.int32).to(dev), [v.to(dev) for v in vals], torch.zeros(n, dtype=torch.bool, device=dev),
            nw.to(dev) if lanes > 1 else None, bits)


def table_bits(part_cap: int) -> int:
    """log2 of K4's shared hash table size, 2 * pow2(part_cap), as
    csrc/join_probe.cu's launcher computes it."""
    bits = 1
    while (1 << bits) < 2 * part_cap:
        bits += 1
    return bits


def table_home(keys, part_cap: int):
    """numpy copy of csrc/join_probe.cu table_home: the home entry of each
    int64 key in K4's table for part_cap."""
    import numpy as np

    x = keys.astype(np.int64).view(np.uint64)
    x = x ^ (x >> np.uint64(32))
    x = x * np.uint64(0x9E3779B97F4A7C15)
    return (x >> np.uint64(64 - table_bits(part_cap))).astype(np.int64)


def agg_inputs(dag_exec, fts, batch):
    """An aggregation's inputs as the main path builds them: the group-key
    CompVals and the (AggDesc, args) pairs."""
    from tidb_tpu_torch.expr.compile import ExprCompiler

    comp = ExprCompiler(fts, device=batch.row_valid.device)
    gvals = comp.run(list(dag_exec.group_by), batch.cols)
    avals = comp.run([a for d in dag_exec.aggs for a in d.args], batch.cols)
    aggs, k = [], 0
    for d in dag_exec.aggs:
        aggs.append((d, avals[k: k + len(d.args)]))
        k += len(d.args)
    return gvals, aggs


def selected(batch, fts, sel):
    from tidb_tpu_torch.expr.compile import ExprCompiler
    from tidb_tpu_torch.ops.selection import apply_selection

    comp = ExprCompiler(fts, device=batch.row_valid.device)
    return apply_selection(batch.row_valid, comp.run(list(sel.conditions), batch.cols))


def q1_agg_inputs(dag, fts, batch):
    """The Q1 aggregation's inputs: the selection mask, the group-key
    CompVals and the (AggDesc, args) pairs."""
    from tidb_tpu_torch.exec.dag import Aggregation, Selection

    sel = next(e for e in dag.executors if isinstance(e, Selection))
    agg = next(e for e in dag.executors if isinstance(e, Aggregation))
    gvals, aggs = agg_inputs(agg, fts, batch)
    return selected(batch, fts, sel), gvals, aggs


def q3_kernel_inputs(dag, fts, batches):
    """K3's and K2's inputs as Q3's packed chain builds them (builder.py
    _trace_packed_chain): ((spk, spay, wbad), (spk, lanes_s, bad_all, nw_s,
    nn_bits, combo keys), and the K2 argument pieces (hay_key, hay_ok, pkv,
    probe_ok, aggs) for the variants)."""
    from tidb_tpu_torch.expr.compile import ExprCompiler
    from tidb_tpu_torch.ops.joinagg import membership_chain, membership_lanes, packed_groupsum_lanes

    _ls, lsel, outer, agg = dag.executors
    _os, odate_sel, inner = outer.build
    _cs, cust_sel = inner.build
    (lf, of, cf), (lb, ob, cb) = fts, batches
    dev = lb.row_valid.device
    lvalid, ovalid, cvalid = selected(lb, lf, lsel), selected(ob, of, odate_sel), selected(cb, cf, cust_sel)
    ocomp = ExprCompiler(of, device=dev)
    okey = ocomp.run([inner.probe_keys[0]], ob.cols)[0]
    payload = ocomp.run([outer.build_keys[0]], ob.cols)[0]
    ckey = ExprCompiler(cf, device=dev).run([inner.build_keys[0]], cb.cols)[0]
    o_ok = ovalid & ~okey.null & ~payload.null
    i_ok = cvalid & ~ckey.null
    k3 = membership_lanes(okey.value, o_ok, ckey.value, i_ok, payload.value)
    hay_key, hay_ok, _ = membership_chain(okey.value, o_ok, ckey.value, i_ok, payload.value)
    lcomp = ExprCompiler(lf, device=dev)
    avals = lcomp.run([a for d in agg.aggs for a in d.args], lb.cols)
    pkv = lcomp.run([outer.probe_keys[0]], lb.cols)[0]
    aggs = [(agg.aggs[0], avals)]
    probe_ok = lvalid & ~pkv.null
    k2 = packed_groupsum_lanes(hay_key, hay_ok, pkv, probe_ok, aggs)
    return k3, k2, (hay_key, hay_ok, pkv, probe_ok, aggs)


def join_kernel_inputs(dag, fts, batches, join_capacity: int):
    """K4's inputs as the radix join builds them at the join bench's plan:
    (plan, (b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok))."""
    from tidb_tpu_torch.expr.compile import ExprCompiler
    from tidb_tpu_torch.ops.join import _key_matrix
    from tidb_tpu_torch.ops.radix_join import probe_kernel_inputs, radix_plan

    join = dag.executors[1]
    (lf, of), (lb, ob) = fts, batches
    dev = lb.row_valid.device
    pk = ExprCompiler(lf, device=dev).run(list(join.probe_keys), lb.cols)
    bk = ExprCompiler(of, device=dev).run(list(join.build_keys), ob.cols)
    (bw,), bu = _key_matrix(bk, ob.row_valid)
    (pw,), pu = _key_matrix(pk, lb.row_valid)
    plan = radix_plan(bw.shape[0], pw.shape[0], join_capacity)
    return plan, probe_kernel_inputs(bw, bu, pw, pu, plan, join_capacity)


# ---------------------------------------------------------------------------
# numpy ground truths
# ---------------------------------------------------------------------------

def numpy_q6(t, T):
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


def _sum_by(keys, vals):
    """{key: (int sum of vals, count)} in exact int64."""
    import numpy as np

    uniq, inv = np.unique(keys, return_inverse=True)
    s = np.zeros(len(uniq), np.int64)
    np.add.at(s, inv, vals)
    c = np.bincount(inv, minlength=len(uniq))
    return {int(k): (int(a), int(b)) for k, a, b in zip(uniq, s, c)}


def numpy_q3(cols, T):
    """{l_orderkey: revenue scaled 1e4} over lineitems shipped after
    1995-03-15 whose order is dated before it and whose customer is in
    segment 'B' (orders and customers are keyed 0..n-1)."""
    (okey, price, disc, lship), (_ok, o_cust, o_date), (_ck, seg) = ([c[0] for c in s] for s in cols)
    cut = T.MyTime.parse("1995-03-15", 0).packed
    c_ok = seg[:, 0] == ord("B")
    o_ok = (o_date < cut) & c_ok[o_cust]
    l_ok = (lship > cut) & o_ok[okey]
    return {k: s for k, (s, _c) in _sum_by(okey[l_ok], price[l_ok] * (100 - disc[l_ok])).items()}


def decoded_q3(chunk):
    return {int(chunk.columns[1].data[j]): int(chunk.columns[0].data[j]) for j in range(chunk.num_rows())}


def numpy_join(cols, grouped: bool):
    """sum(v), count(*) of lineitem JOIN orders (orders keyed 0..nb-1),
    overall or per build payload: {payload | None: (sum, count)}."""
    (okey, v), (o_okey, payload) = ([c[0] for c in s] for s in cols)
    m = (okey >= 0) & (okey < len(o_okey))
    if grouped:
        return _sum_by(payload[okey[m]], v[m])
    return {None: (int(v[m].sum()), int(m.sum()))}


def decoded_join(chunk, grouped: bool):
    cols = chunk.columns
    if grouped:
        return {int(cols[2].data[j]): (int(cols[0].data[j]), int(cols[1].data[j])) for j in range(chunk.num_rows())}
    return {None: (int(cols[0].data[0]), int(cols[1].data[0]))}


def numpy_order(price, ship, k=None):
    """Row indices in ORDER BY price DESC, shipdate order, ties by row
    index (np.lexsort is stable); with k, the first k, from the rows at or
    above the k-th largest price (no full sort of every row)."""
    import numpy as np

    if k is None:
        return np.lexsort((ship, -price))
    k = min(k, len(price))
    thr = np.partition(price, len(price) - k)[len(price) - k]
    cand = np.nonzero(price >= thr)[0]
    return cand[np.lexsort((ship[cand], -price[cand]))][:k]


def check_rows(name, chunk, want_idx, price, ship):
    """The decoded (price, shipdate) rows equal the numpy order's, row for
    row."""
    import numpy as np

    if chunk.num_rows() != len(want_idx):
        raise SystemExit(f"{name}: {chunk.num_rows()} rows, numpy {len(want_idx)}")
    got_p, got_s = chunk.columns[0], chunk.columns[1]
    if got_p.null.any() or got_s.null.any():
        raise SystemExit(f"{name}: NULLs in a NOT NULL result")
    bad = np.nonzero((got_p.data != price[want_idx]) | (got_s.data.view(np.int64) != ship[want_idx]))[0]
    if len(bad):
        raise SystemExit(f"{name}: row {bad[0]} differs from numpy (port price {got_p.data[bad[0]]}, "
                         f"numpy {price[want_idx[bad[0]]]})")


def numpy_window(cols):
    """The window DAG's eight columns in input row order: PARTITION BY okey
    ORDER BY price DESC, shipdate (ties by row index) with row_number,
    rank, dense_rank, sum(price), count(*), max(disc), lag(price, 1) and
    first_value(price) over MySQL's default frame (up to the last peer).
    Returns ([values], [null masks])."""
    import numpy as np

    okey, price, disc, ship = (c[0] for c in cols)
    n = len(okey)
    order = np.lexsort((np.arange(n), ship, -price, okey))
    ok, p, d, s = okey[order], price[order], disc[order], ship[order]
    ar = np.arange(n)
    new_part = np.ones(n, bool)
    new_part[1:] = ok[1:] != ok[:-1]
    new_peer = new_part.copy()
    new_peer[1:] |= (p[1:] != p[:-1]) | (s[1:] != s[:-1])

    def first_of(flags):
        return np.maximum.accumulate(np.where(flags, ar, 0))

    def last_of(flags):
        is_last = np.ones(n, bool)
        is_last[:-1] = flags[1:]
        return np.minimum.accumulate(np.where(is_last, ar, n)[::-1])[::-1]

    start, peer_start, peer_end = first_of(new_part), first_of(new_peer), last_of(new_peer)
    dense = np.cumsum(new_peer)
    csum = np.cumsum(p)
    run_sum = csum[peer_end] - (csum[start] - p[start])
    part_id = np.cumsum(new_part)
    run_max = np.maximum.accumulate(part_id * 64 + d) - part_id * 64  # disc is 0..10
    sorted_vals = [ar - start + 1, peer_start - start + 1, dense - dense[start] + 1, run_sum,
                   peer_end - start + 1, run_max[peer_end], np.where(new_part, 0, np.roll(p, 1)), p[start]]
    sorted_nulls = [np.zeros(n, bool)] * 6 + [new_part, np.zeros(n, bool)]
    vals, nulls = [], []
    for v, nl in zip(sorted_vals, sorted_nulls):
        out_v, out_n = np.empty(n, np.int64), np.empty(n, bool)
        out_v[order], out_n[order] = v, nl
        vals.append(out_v)
        nulls.append(out_n)
    return vals, nulls


def copy_bytes(prof) -> dict:
    """{"HtoD": bytes, "DtoH": bytes} over the memcpy records of a profile
    (the trace's `bytes` argument); None for a direction the trace carries
    no byte count for."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for ev in events:
        nm = ev.get("name", "")
        for way in ("HtoD", "DtoH"):
            if nm.startswith("Memcpy " + way):
                b = (ev.get("args") or {}).get("bytes")
                out[way] = None if b is None or out.get(way, 0) is None else out.get(way, 0) + int(b)
    return out


class CountedCopies:
    """Bytes a run moves between host and card, counted where the port
    moves them: every DeviceBatch that `to_device_batch` uploads for the
    store (H2D), and every card tensor that `decode_outputs` and the
    executor's counts fetch through `exec.executor._np` (D2H). The
    profiler's memcpy records can miss copies, so these are the counts."""

    def __enter__(self):
        import torch

        import tidb_tpu_torch.exec.executor as X
        import tidb_tpu_torch.store.store as S

        self.moved = {"H2D": 0, "D2H": 0}
        self._up, self._down = S.to_device_batch, X._np

        def up(*a, **k):
            b = self._up(*a, **k)
            tensors = [b.row_valid, b.n_rows] + [x for c in b.cols for x in (c.data, c.null, c.length) if x is not None]
            self.moved["H2D"] += sum(x.nbytes for x in tensors)
            return b

        def down(x):
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                self.moved["D2H"] += x.nbytes
            return self._down(x)

        S.to_device_batch, X._np = up, down
        return self.moved

    def __exit__(self, *exc):
        import tidb_tpu_torch.exec.executor as X
        import tidb_tpu_torch.store.store as S

        S.to_device_batch, X._np = self._up, self._down
        return False


def profile_path(name, fn, wall_ms: float, top: int = 12, copies: bool = False):
    """One profiled run of fn: device time by kernel (torch.profiler), the
    `top` longest and every hand kernel, and the device's busy share of the
    path's median wall time; with `copies`, the bytes copied each way."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with CountedCopies() as moved, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                           acc_events=True) as prof:
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
    hand = [r for r in rows[top:] if any(k in r[2] for k in HAND_KERNELS)]
    for us, count, key in rows[:top] + hand:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    if copies:
        cb = copy_bytes(prof)
        log(f"  copies: H2D {moved['H2D']} B, D2H {moved['D2H']} B counted at the source; the trace's memcpy "
            f"records hold H2D {cb.get('HtoD', 0)} B, D2H {cb.get('DtoH', 0)} B")
    return busy_ms, sum(r[1] for r in rows)


def host_profile(name, fn, top: int = 10):
    """One run of fn under cProfile: the `top` functions by their own host
    time, the host side of a path the device profile cannot see."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{os.path.basename(fl)}:{ln} {fn_}") for (fl, ln, fn_), (_cc, nc, tt, _ct, _c)
                   in stats.items()), reverse=True)[:top]
    log(f"host profile {name}: {wall:.1f} ms under cProfile, by own time:")
    for tt, nc, where in rows:
        log(f"  {tt * 1e3:9.1f} ms  x{nc:<8d} {where}")


def runtime_calls(name, fn, top: int = 6):
    """One torch.profiler run of fn: the CUDA runtime calls of every thread
    (CUPTI traces them process-wide; torch ops are recorded only on the
    profiling thread), the `top` by their own CPU time and their total, the
    host side of a path that runs on several threads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_cpu_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU and ev.key.startswith("cuda")), reverse=True)
    log(f"runtime calls {name}: {wall:.1f} ms wall under the profiler, {sum(r[0] for r in rows) / 1e3:.3f} ms in "
        f"{sum(r[1] for r in rows)} CUDA runtime calls over every thread:")
    for us, count, key in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<6d} {key[:80]}")


class Counters:
    """The kernels' launch counters: zeroed just before a main path runs,
    read just after; timing and comparison launches are not counted."""

    def __init__(self):
        from tidb_tpu_torch.ops import dense_agg, join_probe, joinscan

        self.fns = {"dense_agg": dense_agg.dense_agg, "postsort_segscan": joinscan.postsort_segscan,
                    "membership_segscan": joinscan.membership_segscan, "probe_tables": join_probe.probe_tables}
        self.main = {k: 0 for k in self.fns}
        self.last = {}  # the counts of the last path

    def zero(self):
        for f in self.fns.values():
            f.launches = 0

    def read(self) -> dict:
        return {k: f.launches for k, f in self.fns.items()}

    def path(self, name, fn, need=(), phase: int = 4):
        """Run one main path with the counters zeroed; require a launch of
        each kernel in `need`; keep the counts for the record."""
        self.zero()
        out = fn()
        got = self.read()
        for k in need:
            if got[k] < 1:
                raise SystemExit(f"{name} did not launch the {k} kernel (launches {got})")
        for k, v in got.items():
            self.main[k] += v
        self.zero()
        self.last = got
        log(f"phase {phase} {name}: launches {got}")
        return out


# ---------------------------------------------------------------------------
# phase 6: the store
# ---------------------------------------------------------------------------

_LOAD_TABLE = None


def _load_init(n: int, n_orders: int):
    """A load worker's copy of the table (the same seeded draws)."""
    global _LOAD_TABLE
    from tidb_tpu_torch import workloads as W

    _LOAD_TABLE = W.store_lineitem(n, n_orders)


def _load_encode(span):
    """Rows lo..hi of the table as (row key, rowcodec value) pairs."""
    from tidb_tpu_torch import codec, types, workloads as W

    lo, hi = span
    return W.store_items(codec, W.store_rows(types, _LOAD_TABLE, lo, hi))


def _customer_init(n: int):
    """A load worker's copy of the customer table (the same seeded draws)."""
    global _LOAD_TABLE
    from tidb_tpu_torch import workloads as W

    _LOAD_TABLE = W.store_customer(n)


def _customer_encode(span):
    """Customer rows lo..hi as (row key, rowcodec value) pairs."""
    from tidb_tpu_torch import codec, types, workloads as W

    lo, hi = span
    return W.customer_items(codec, W.customer_rows(types, _LOAD_TABLE, lo, hi))


def hook_seconds(store) -> float:
    """Seconds the store's bulk-write hooks have taken so far: the
    write-quorum gate before each bulk apply (TxnEngine's pre_apply) and the
    PD flow record and replication proposals after it (on_apply). Timing
    wrappers go onto the store's transaction engine at the first call."""
    clock = getattr(store.txn, "_hook_clock", None)
    if clock is None:
        clock = store.txn._hook_clock = [0.0]
        for attr in ("_pre_apply", "_on_apply"):
            def timed(*a, _real=getattr(store.txn, attr), **k):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    clock[0] += time.perf_counter() - t0

            setattr(store.txn, attr, timed)
    return clock[0]


def load_store(store, n: int, n_orders: int, init=_load_init, initargs=None, encode=_load_encode, chunk=None):
    """Encode the table's rows with the port's Python row encoder in
    LOAD_WORKERS processes, `chunk` rows at a time (STORE_LOAD_CHUNK by
    default), and bulk-ingest them at one commit ts; returns (seconds,
    bytes of keys and values). The lineitem table by default; `init`,
    `initargs` and `encode` name another table's workers."""
    import multiprocessing as mp

    chunk = chunk or STORE_LOAD_CHUNK
    spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    ts = store.next_ts()
    nbytes = 0
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(min(LOAD_WORKERS, len(spans)), initializer=init,
                                      initargs=(n, n_orders) if initargs is None else initargs) as pool:
        for items in pool.imap(encode, spans):
            nbytes += sum(len(k) + len(v) for k, v in items)
            store.bulk_ingest(items, ts)
    return time.perf_counter() - t0, nbytes


def store_phase(E, X, T, W, counters, dev, profile: bool) -> None:
    """Phase 6: the port's TPUStore on the card. Load the lineitem table,
    split it into two regions, answer each region's Q6, Q1 (small-G hint),
    TopN, Q3 (orders and customer as aux chunks) and join-bench request as
    wire bytes through coprocessor_bytes against numpy over the region's
    rows, follow a paged Selection's cursor, check a stale epoch, then time
    each DAG per region cold, warm through coprocessor(req), warm through
    coprocessor_bytes, and as a result-cache hit."""
    import numpy as np
    import torch

    import tidb_tpu_torch.chunk as C
    from tidb_tpu_torch import codec, native
    from tidb_tpu_torch.codec import wire
    from tidb_tpu_torch.exec.builder import ProgramCache
    from tidb_tpu_torch.exec.ladder import rung_for
    from tidb_tpu_torch.ops.radix_join import probe_strategy, radix_plan
    from tidb_tpu_torch.store import CopRequest, KeyRange, TPUStore

    if not native.available():
        raise SystemExit("phase 6: the native row decoder did not build")
    n, tid = STORE_ROWS, W.LINEITEM_TABLE_ID
    store = TPUStore(device=dev)
    h0 = hook_seconds(store)
    secs, nbytes = load_store(store, n, STORE_ORDERS)
    log(f"phase 6 load: {n} rows ({nbytes} B of keys and rowcodec values, {nbytes / n:.1f} B a row) "
        f"in {secs:.2f} s ({n / secs:.0f} rows/s, {LOAD_WORKERS} encoder processes; the store's write hooks"
        f" {hook_seconds(store) - h0:.2f} s of it)")
    store.cluster.split(codec.encode_row_key(tid, STORE_SPLIT))
    t = W.store_lineitem(n, STORE_ORDERS)
    regions = [(r, lo, hi) for r, (lo, hi) in zip(store.cluster.regions(), [(0, STORE_SPLIT), (STORE_SPLIT, n)])]
    table = [KeyRange(codec.record_prefix(tid), codec.record_prefix(tid + 1))]
    dags = W.store_dags(E, X, T)
    q3_build = W.store_q3_build_columns(STORE_ORDERS, STORE_CUSTOMERS)
    join_build = W.store_join_build_columns(STORE_JOIN_ORDERS)
    aux = {
        "q3": [W.make_chunk(C, f, c) for c, f in zip(q3_build, dags["q3"][1])],
        "join": [W.make_chunk(C, f, c) for c, f in zip(join_build, dags["join"][1])],
    }
    names = ("q6", "q1", "topn", "q3", "join")
    need = {"q1": ("dense_agg",), "q3": ("postsort_segscan", "membership_segscan")}
    avg_agg = next(e for e in dags["q1"][0].executors if isinstance(e, E.Aggregation)).aggs[3]
    q1_shift = avg_agg.ft.decimal - avg_agg.partial_fts()[1].decimal
    plan = radix_plan(STORE_JOIN_ORDERS, STORE_SPLIT, rung_for(STORE_SPLIT))
    log(f"phase 6 join plan at a {STORE_SPLIT}-row region: {plan} (partitions, part_cap, probe_cap, esc_cap), "
        f"strategy {probe_strategy(*plan[:3])}")

    def request(name, region, ts, **kw):
        return CopRequest(dags[name][0], table, ts, region.region_id, region.epoch, aux.get(name, []),
                          small_groups=G if name == "q1" else None, **kw)

    def over_wire(req):
        return wire.decode_cop_response(store.coprocessor_bytes(wire.encode_cop_request(req)))

    def check(name, resp, lo, hi):
        if resp.other_error is not None or resp.region_error is not None:
            raise SystemExit(f"phase 6 {name}: other_error {resp.other_error!r}, region_error {resp.region_error!r}")
        tr = {k: v[lo:hi] for k, v in t.items()}
        ch = resp.chunk
        if name == "q6":
            got, want = (int(ch.columns[0].data[0]), int(ch.columns[1].data[0])), numpy_q6(tr, T)
        elif name == "q1":
            got, want = decoded_q1(ch), numpy_q1(tr, T, q1_shift)
        elif name == "topn":
            check_rows(f"phase 6 {name}", ch, numpy_order(tr["price"], tr["shipdate"], TOPN_K), tr["price"], tr["shipdate"])
            return f"the first {TOPN_K} rows"
        elif name == "q3":
            lcols = [W.fixed_col(tr[k]) for k in ("okey", "price", "disc", "shipdate")]
            got, want = decoded_q3(ch), numpy_q3([lcols] + q3_build, T)
        else:
            got = decoded_join(ch, False)
            want = numpy_join([[W.fixed_col(tr["okey"]), W.fixed_col(tr["price"])]] + join_build, False)
        if got != want:
            raise SystemExit(f"phase 6 {name} rows {lo}..{hi} mismatch: port {len(got)} rows, numpy {len(want)}")
        return f"{len(got)} rows" if isinstance(got, dict) else f"{got}"

    fallbacks = store.stats()["oracle_fallbacks"]
    ts = store.next_ts()
    per_request = {}
    for region, lo, hi in regions:
        for name in names:
            resp = counters.path(f"store {name} region {region.region_id}",
                                 lambda: over_wire(request(name, region, ts)), need=need.get(name, ()), phase=6)
            per_request[(name, region.region_id)] = dict(counters.last)
            what = check(name, resp, lo, hi)
            extra = ""
            if name == "join":
                s = resp.exec_summaries[2]
                extra = f"; radix partitions {s.radix_partitions}, rung {s.radix_rung}, escapes {s.radix_escapes}"
            log(f"phase 6 {name} region {region.region_id} (rows {lo}..{hi}): {what} == numpy{extra}")
        # the paged row-local request over the region's first rows, its
        # cursor followed to the end
        sel = W.store_selection_dag(E, X, T)
        rng = [KeyRange(codec.encode_row_key(tid, lo), codec.encode_row_key(tid, lo + STORE_PAGED_ROWS))]
        got, pages = [], 0
        while rng is not None:
            resp = over_wire(CopRequest(sel, rng, ts, region.region_id, region.epoch, paging_size=STORE_PAGE))
            if resp.other_error is not None or resp.region_error is not None:
                raise SystemExit(f"phase 6 paged: {resp.other_error!r} {resp.region_error!r}")
            got.append(np.stack([resp.chunk.columns[0].data, resp.chunk.columns[1].data,
                                 resp.chunk.columns[2].data.view(np.int64)], axis=1))
            rng = resp.last_range
            pages += 1
        cut = T.MyTime.parse("1995-03-15", 0).packed
        s = slice(lo, lo + STORE_PAGED_ROWS)
        m = (t["shipdate"][s] > cut) & (t["disc"][s] >= 5)
        want = np.stack([t["okey"][s][m], t["price"][s][m], t["shipdate"][s][m]], axis=1)
        if not np.array_equal(np.concatenate(got), want):
            raise SystemExit(f"phase 6 paged Selection region {region.region_id}: the pages differ from numpy")
        log(f"phase 6 paged Selection region {region.region_id}: {pages} pages of <= {STORE_PAGE} rows, "
            f"{len(want)} rows == numpy")
        stale = over_wire(CopRequest(dags["q6"][0], table, ts, region.region_id, region.epoch - 1))
        if stale.region_error is None or not stale.region_error.startswith("epoch_not_match"):
            raise SystemExit(f"phase 6 stale epoch: {stale.region_error!r}")
        log(f"phase 6 stale epoch region {region.region_id}: region_error {stale.region_error!r}")
    if store.stats()["oracle_fallbacks"] != fallbacks:
        raise SystemExit(f"phase 6: the oracle served a main-path request ({store.stats()})")
    for name in names:
        per = [per_request[(name, r.region_id)] for r, _lo, _hi in regions]
        log(f"phase 6 launches per {name} cop request: " + ", ".join(
            f"region {r.region_id} {p}" for (r, _lo, _hi), p in zip(regions, per)))

    # times: cold, then warm (object), warm (wire) and a result-cache hit in
    # turns; every run ends in a synchronise
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    med = statistics.median
    for region, lo, hi in regions:
        rows = hi - lo
        for name in names:
            req = request(name, region, ts)
            cold = {"decode": [], "h2d": [], "request": [], "build": [], "total": []}
            for _ in range(COLD_REPS):
                store.evict_caches()
                store.programs = ProgramCache()
                d_ms, _ = timed(lambda: store.region_chunk(region, table, req.dag, ts))
                h_ms, _ = timed(lambda: store.region_device_batch(region, table, req.dag, ts))
                r_ms, resp = timed(lambda: store.coprocessor(req))
                cold["decode"].append(d_ms)
                cold["h2d"].append(h_ms)
                cold["request"].append(r_ms)
                cold["build"].append(resp.exec_summaries[0].time_compile_ns / 1e6)
                cold["total"].append(d_ms + h_ms + r_ms)
            req_bytes = wire.encode_cop_request(req)
            cacheable = not req.aux_chunks
            warm = {"object": [], "wire": [], "hit": [], "hit wire": []}
            for i in range(REPS + 1):
                store.clear_result_cache()
                o_ms, _ = timed(lambda: store.coprocessor(req))
                store.clear_result_cache()
                w_ms, _ = timed(lambda: wire.decode_cop_response(store.coprocessor_bytes(req_bytes)))
                if i == 0:
                    continue  # warm-up
                warm["object"].append(o_ms)
                warm["wire"].append(w_ms)
                if cacheable:
                    hits = store.stats()["result_cache_hits"]
                    warm["hit"].append(timed(lambda: store.coprocessor(req))[0])
                    warm["hit wire"].append(timed(lambda: wire.decode_cop_response(store.coprocessor_bytes(req_bytes)))[0])
                    if store.stats()["result_cache_hits"] != hits + 2:
                        raise SystemExit(f"phase 6 {name}: the repeat missed the result cache")
            cm = {k: med(v) for k, v in cold.items()}
            log(f"phase 6 {name} region {region.region_id} cold ({COLD_REPS} runs): {cm['total']:.3f} ms = native decode "
                f"{cm['decode']:.3f} + H2D {cm['h2d']:.3f} + request {cm['request']:.3f} (program build "
                f"{cm['build']:.3f} of it); {rows / cm['total'] / 1e3:.2f} Mrows/s")
            hit = (f"result-cache hit {med(warm['hit']):.4f} ms (wire {med(warm['hit wire']):.4f} ms)"
                   if cacheable else "no result-cache hit (aux chunks are not cacheable)")
            log(f"phase 6 {name} region {region.region_id} warm ({REPS} paired runs): coprocessor(req) "
                f"{med(warm['object']):.3f} ms ({rows / med(warm['object']) / 1e3:.1f} Mrows/s), coprocessor_bytes "
                f"{med(warm['wire']):.3f} ms ({rows / med(warm['wire']) / 1e3:.1f} Mrows/s), {hit}")
            if profile and region is regions[0][0] and name in ("q1", "q3"):
                store.clear_result_cache()
                profile_path(f"phase 6 {name} through coprocessor_bytes",
                             lambda: wire.decode_cop_response(store.coprocessor_bytes(req_bytes)),
                             med(warm["wire"]), copies=True)
    if store.stats()["oracle_fallbacks"] != fallbacks or store.stats()["other_errors"]:
        raise SystemExit(f"phase 6: an oracle fallback or an other_error while timing ({store.stats()})")
    log(f"phase 6 store counts: {store.stats()}")
    batch_store_phase(store, W, names, request, check, counters, profile)
    return store


def batch_store_phase(store, W, names, request, check, counters, profile: bool) -> None:
    """Phase 7: the batch endpoint on phase 6's store. Split the table into
    seven regions of 2^18 rows and two of 2^17, send each DAG as one
    batch_coprocessor_bytes frame over all nine regions plus a stale
    epoch, hold every region's answer against numpy (no oracle fallback, no
    other_error), require K1 / K2 / K3 to launch once per capacity bucket,
    then time the warm batch beside the sum of coprocessor(req) over the
    same regions, paired."""
    import torch

    from tidb_tpu_torch import codec
    from tidb_tpu_torch.codec import wire
    from tidb_tpu_torch.store import CopRequest

    tid = W.LINEITEM_TABLE_ID
    for h in BATCH_SPLITS:
        store.cluster.split(codec.encode_row_key(tid, h))
    bounds = sorted(set(BATCH_SPLITS) | {0, STORE_SPLIT, STORE_ROWS})
    regions = list(zip(store.cluster.regions(), bounds[:-1], bounds[1:]))
    sizes = [hi - lo for _r, lo, hi in regions]
    if sizes != [BATCH_REGION] * 7 + [BATCH_REGION // 2] * 2:
        raise SystemExit(f"phase 7: regions of {sizes} rows")
    buckets = 2
    per_bucket = {"q1": ("dense_agg",), "q3": ("postsort_segscan", "membership_segscan")}
    fallbacks, others = store.stats()["oracle_fallbacks"], store.stats()["other_errors"]
    ts = store.next_ts()
    stale_region = regions[3][0]

    def frame_of(name):
        reqs = [request(name, r, ts) for r, _lo, _hi in regions]
        stale = CopRequest(reqs[3].dag, reqs[3].ranges, ts, stale_region.region_id, stale_region.epoch - 1,
                           reqs[3].aux_chunks, small_groups=reqs[3].small_groups)
        return reqs, wire.encode_batch_cop_request(reqs + [stale])

    for name in names:
        reqs, frame = frame_of(name)
        b0 = store.stats()
        t0 = time.perf_counter()
        resps, fallback = vmap_fallbacks(lambda: counters.path(
            f"store batch {name}, {len(regions)} regions",
            lambda: wire.decode_batch_cop_response(store.batch_coprocessor_bytes(frame)),
            need=per_bucket.get(name, ()), phase=7))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        for k in per_bucket.get(name, ()):
            require_launches(f"phase 7 {name} {k}, once per bucket", counters.last[k], buckets)
        for resp, (region, lo, hi) in zip(resps, regions):
            what = check(name, resp, lo, hi)
            if resp.batched not in (1, 2):
                raise SystemExit(f"phase 7 {name} region {region.region_id}: not served by a bucket (batched={resp.batched})")
        if len(resps) != len(regions) + 1 or not (resps[-1].region_error or "").startswith("epoch_not_match"):
            raise SystemExit(f"phase 7 {name}: the stale lane answered {resps[-1].region_error!r}")
        b1 = store.stats()
        log(f"phase 7 {name}: {len(regions)} regions in one frame == numpy region by region (last: {what}); "
            f"stale lane {resps[-1].region_error!r}; buckets {sorted({r.batched for r in resps[:-1]})}; "
            f"first frame {first_ms:.1f} ms (its regions decoded); batch counts "
            f"{ {k: b1[k] - b0[k] for k in ('batch_batches', 'batch_regions', 'batch_launches_saved')} }; "
            f"vmap ran lane by lane: {fallback or 'no op'}")
    st = store.stats()
    if st["oracle_fallbacks"] != fallbacks or st["other_errors"] != others or st["batch_fallbacks"]:
        raise SystemExit(f"phase 7: an oracle fallback, an other_error or a bucket's fallback ({st})")

    # warm times, paired: the batch over the nine regions, then the nine
    # single requests one after another; every run ends in a synchronise
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    from tidb_tpu_torch.chunk import Chunk, to_stacked_device_batch

    def stack_buckets(reqs):
        """What the batch pays before its programs run: each bucket's lanes
        stacked on the host (padded to a power of two) and uploaded."""
        chunks = [store.region_chunk(r, q.ranges, q.dag, q.start_ts) for q, (r, _lo, _hi) in zip(reqs, regions)]
        out = []
        for cap in sorted({1 << (c.num_rows() - 1).bit_length() for c in chunks}):
            lanes = [c for c in chunks if 1 << (c.num_rows() - 1).bit_length() == cap]
            pad = (1 << (len(lanes) - 1).bit_length()) - len(lanes)
            out.append(to_stacked_device_batch(lanes + [Chunk.empty(lanes[0].field_types())] * pad, cap,
                                               device=store.device))
        return out

    def served(resps, what):
        """Every region answered by a bucket: a bucket that fell back to the
        single path (any error of the batched program) fails the run."""
        if any(r.batched not in (1, 2) for r in resps[:len(regions)]):
            raise SystemExit(f"phase 7 {what}: regions not served by a bucket: {[r.batched for r in resps]}")
        return resps

    med = statistics.median
    rows = STORE_ROWS
    for name in names:
        reqs, frame = frame_of(name)
        batch_t, single_t, wire_t, stack_t = [], [], [], []
        for i in range(REPS + 1):
            store.clear_result_cache()
            b_ms, resps = timed(lambda: store.batch_coprocessor(reqs))
            served(resps, f"{name} timing")
            store.clear_result_cache()
            w_ms, resps = timed(lambda: wire.decode_batch_cop_response(store.batch_coprocessor_bytes(frame)))
            served(resps, f"{name} timing over the wire")
            store.clear_result_cache()
            s_ms, _ = timed(lambda: [store.coprocessor(r) for r in reqs])
            k_ms, _ = timed(lambda: stack_buckets(reqs))
            if i:
                batch_t.append(b_ms)
                wire_t.append(w_ms)
                single_t.append(s_ms)
                stack_t.append(k_ms)
        log(f"phase 7 {name} warm ({REPS} paired runs, {len(regions)} regions, {rows} rows): batch_coprocessor "
            f"{med(batch_t):.3f} ms ({rows / med(batch_t) / 1e3:.1f} Mrows/s), batch_coprocessor_bytes "
            f"{med(wire_t):.3f} ms, the sum of {len(regions)} coprocessor(req) {med(single_t):.3f} ms "
            f"({rows / med(single_t) / 1e3:.1f} Mrows/s); batch / singles {med(batch_t) / med(single_t):.3f}; "
            f"stacking and uploading the buckets' lanes alone {med(stack_t):.3f} ms")
        if profile and name in ("q1", "q3"):
            store.clear_result_cache()
            _busy, launches = profile_path(f"phase 7 {name} batch over {len(regions)} regions",
                                           lambda: served(store.batch_coprocessor(reqs), f"{name} profile"),
                                           med(batch_t))
            store.clear_result_cache()
            _busy, one = profile_path(f"phase 7 {name} one region request ({BATCH_REGION} rows)",
                                      lambda: store.coprocessor(reqs[0]), med(single_t) / len(regions))
            log(f"phase 7 {name} launches: the batch {launches} ({buckets} buckets) vs {len(regions)} x one region "
                f"request's {one} = {len(regions) * one}")
    st = store.stats()
    if st["oracle_fallbacks"] != fallbacks or st["other_errors"] != others or st["batch_fallbacks"]:
        raise SystemExit(f"phase 7: an oracle fallback, an other_error or a bucket's fallback while timing ({st})")
    log(f"phase 7 store counts: {st}")


# ---------------------------------------------------------------------------
# phase 8: the statement's root half
# ---------------------------------------------------------------------------

def numpy_statement(name, t, shifts):
    """The exact answer of store statement `name` over the generated
    columns, in decoded_statement's form."""
    import numpy as np

    if name == "q6":
        return numpy_q6(t, shifts["T"])
    if name == "q1":
        return numpy_q1(t, shifts["T"], shifts["q1"])
    if name == "distinct_scalar":
        return len(np.unique(t["okey"]))
    if name in ("okey", "okey spilled"):
        keys, inv = np.unique(t["okey"], return_inverse=True)
        s = np.zeros(len(keys), np.int64)
        np.add.at(s, inv, t["price"] * (100 - t["disc"]))
        return keys, s, np.bincount(inv, minlength=len(keys))
    out = {}
    gid = t["rflag"].astype(np.int64) * 2 + t["lstat"].astype(np.int64)
    for g in np.unique(gid):
        m = gid == g
        key = ("ANR"[g // 2], "OF"[g % 2])
        okey = t["okey"][m]
        if name == "bit":
            out[key] = [int(np.bitwise_and.reduce(okey)), int(np.bitwise_or.reduce(okey)),
                        int(np.bitwise_xor.reduce(okey)), int(m.sum())]
        else:  # distinct
            disc = np.unique(t["disc"][m])
            out[key] = [len(np.unique(okey)), int(np.unique(t["qty"][m]).sum()),
                        round_div(int(disc.sum()) * 10 ** shifts["avg"], len(disc)), int(m.sum())]
    return out


def decoded_statement(name, chunk):
    """A statement's root rows in numpy_statement's form."""
    import numpy as np

    cols = chunk.columns
    if name == "q6":
        return int(cols[0].data[0]), int(cols[1].data[0])
    if name == "q1":
        return decoded_q1(chunk)
    if name == "distinct_scalar":
        return int(cols[0].data[0])
    if name in ("okey", "okey spilled"):
        order = np.argsort(cols[2].data, kind="stable")
        return cols[2].data[order], cols[0].data[order], cols[1].data[order]
    return {(cols[4].get_bytes(j).decode(), cols[5].get_bytes(j).decode()): [int(cols[i].data[j]) for i in range(4)]
            for j in range(chunk.num_rows())}


def statement_shifts(E, T, stmts) -> dict:
    """numpy_statement's decimal shifts for the AVG results of Q1 and of
    the DISTINCT statement."""
    q1_avg = next(e for e in stmts["q1"].executors if isinstance(e, E.Aggregation)).aggs[3]
    dis_avg = stmts["distinct"].executors[-1].aggs[2]
    return {"T": T, "q1": q1_avg.ft.decimal - q1_avg.partial_fts()[1].decimal,
            "avg": dis_avg.ft.decimal - dis_avg.partial_fts()[1].decimal}


def same_answer(got, want) -> bool:
    if isinstance(want, tuple) and len(want) == 3:  # the okey arrays
        return all(len(a) == len(b) and (a == b).all() for a, b in zip(got, want))
    return got == want


def root_phase(store, E, X, T, W, counters, profile: bool, card: str) -> dict:
    """Phase 8: each statement of workloads.store_statements on phase 7's
    nine regions as the JAX package's root runs it: split_dag, the push
    half as ONE batch_coprocessor_bytes frame over the regions, the answers
    concatenated in region order, then the root DAG through
    run_dag_on_chunks on the card with oracle_fallback=False; every answer
    against numpy, no oracle fallback, other_error, bucket fallback or
    lane-by-lane vmap op, K1 once per bucket in Q1's push half, and
    SPILL_PARTITIONS moved by exactly 1 in the forced spill of the GROUP BY
    l_orderkey merge and by 0 elsewhere. Then the median ms, over 10 runs,
    of the push frame, of the root merge alone and of the whole statement
    (each run times its push and its root apart), beside `card`, the
    card's name and power limit from nvidia-smi. Returns {statement: the
    whole's median ms}."""
    import torch

    from tidb_tpu_torch import codec
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.codec import wire
    from tidb_tpu_torch.distsql import split_dag
    from tidb_tpu_torch.exec.builder import ProgramCache
    from tidb_tpu_torch.exec.executor import run_dag_on_chunks
    from tidb_tpu_torch.store import CopRequest, KeyRange
    from tidb_tpu_torch.util import metrics

    tid = W.LINEITEM_TABLE_ID
    t = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    table = [KeyRange(codec.record_prefix(tid), codec.record_prefix(tid + 1))]
    regions = store.cluster.regions()
    if len(regions) != 9:
        raise SystemExit(f"phase 8: {len(regions)} regions, not phase 7's nine")
    stmts = W.store_statements(E, X, T)
    shifts = statement_shifts(E, T, stmts)
    cache = ProgramCache()
    ts = store.next_ts()
    buckets = 2
    st0 = store.stats()
    unspilled = None  # the GROUP BY l_orderkey rows, before the forced spill
    wholes = {}
    statements = list(stmts.items()) + [("okey spilled", stmts["okey"])]
    for name, dag in statements:
        plan = split_dag(dag)
        spill = {"group_capacity": ROOT_SPILL_CAPACITY, "max_retries": 0} if name == "okey spilled" else {}
        reqs = [CopRequest(plan.push_dag, table, ts, r.region_id, r.epoch, small_groups=G if name == "q1" else None)
                for r in regions]
        frame = wire.encode_batch_cop_request(reqs)

        def push():
            store.clear_result_cache()
            resps = wire.decode_batch_cop_response(store.batch_coprocessor_bytes(frame))
            for r in resps:
                if r.other_error is not None or r.region_error is not None:
                    raise SystemExit(f"phase 8 {name} push: {r.other_error!r} {r.region_error!r}")
            return Chunk.concat([r.chunk for r in resps]), resps

        def root(root_in):
            return run_dag_on_chunks(plan.root_dag, [root_in], cache=cache, device=store.device,
                                     oracle_fallback=False, **spill)

        def statement():
            root_in, resps = push()
            return root(root_in), root_in, resps

        spills = metrics.SPILL_PARTITIONS.value
        t0 = time.perf_counter()
        (out, root_in, resps), fallback = vmap_fallbacks(lambda: counters.path(
            f"statement {name}", statement, need=("dense_agg",) if name == "q1" else (), phase=8))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        spilled = metrics.SPILL_PARTITIONS.value - spills
        if spilled != (1 if name == "okey spilled" else 0):
            raise SystemExit(f"phase 8 {name}: SPILL_PARTITIONS moved by {spilled}")
        if name == "q1":
            require_launches("phase 8 q1 dense_agg, once per bucket", counters.last["dense_agg"], buckets)
        if fallback:
            raise SystemExit(f"phase 8 {name}: vmap ran {fallback} lane by lane")
        got, want = decoded_statement(name, out), numpy_statement(name, t, shifts)
        if not same_answer(got, want):
            raise SystemExit(f"phase 8 {name}: the root's answer differs from numpy")
        if name == "okey spilled" and not same_answer(got, unspilled):
            raise SystemExit("phase 8: the spilled merge's rows differ from the unspilled run's")
        unspilled = got
        st = store.stats()
        if any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks")):
            raise SystemExit(f"phase 8 {name}: an oracle fallback, an other_error or a bucket's fallback ({st})")
        what = {"q6": "(sum, count)", "distinct_scalar": "count(distinct l_orderkey)"}.get(
            name, f"{out.num_rows()} groups")
        log(f"phase 8 {name}: push {[type(e).__name__ for e in plan.push_dag.executors]} over {len(regions)} "
            f"regions (buckets {sorted({r.batched for r in resps})}), root {[type(e).__name__ for e in plan.root_dag.executors]} "
            f"over {root_in.num_rows()} input rows -> {what} == numpy"
            f"{' = ' + str(got) if name in ('q6', 'distinct_scalar') else ''}; SPILL_PARTITIONS +{spilled}; "
            f"first run {first_ms:.1f} ms; vmap ran lane by lane: no op")

        # each run: the push frame (its answers concatenated), then the
        # root merge over them, each part ending in a synchronise
        push_t, root_t, whole_t = [], [], []
        for i in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            part_in, _ = push()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            root(part_in)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i:  # run 0 warms up
                push_t.append((t1 - t0) * 1e3)
                root_t.append((t2 - t1) * 1e3)
                whole_t.append((t2 - t0) * 1e3)
        root_ms, whole_ms = statistics.median(root_t), statistics.median(whole_t)
        wholes[name] = whole_ms
        log(f"phase 8 {name} ({REPS} runs): push frame {statistics.median(push_t):.3f} ms, root merge "
            f"{root_ms:.3f} ms ({root_in.num_rows()} input rows), whole {whole_ms:.3f} ms "
            f"({STORE_ROWS / whole_ms / 1e3:.1f} Mrows/s) on {card}")
        if profile and name in ("okey", "distinct"):
            profile_path(f"phase 8 {name} root merge ({root_in.num_rows()} input rows)", lambda: root(root_in),
                         root_ms)
            host_profile(f"phase 8 {name} push frame", push)
    st = store.stats()
    if any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks")):
        raise SystemExit(f"phase 8: an oracle fallback, an other_error or a bucket's fallback while timing ({st})")
    log(f"phase 8 store counts: {st}")
    return wholes


# ---------------------------------------------------------------------------
# phase 9: the dispatch loop
# ---------------------------------------------------------------------------

def dispatch_phase(store, E, X, T, W, counters, profile: bool, card: str, phase8_wholes: dict) -> list:
    """Phase 9: statements through distsql execute_root on phase 7's nine
    regions, in the pool, batch and single tiers (see the module
    docstring), every answer against numpy, the kernels' launches per
    region or per bucket, no fallback of any kind and no call of the
    root's row oracle; the wire route, the low-memory fold, the timings,
    and last the failpoint's mid-statement split. Returns the lineitem
    regions' row counts after the splits."""
    import threading

    import torch

    import tidb_tpu_torch.chunk as C
    import tidb_tpu_torch.exec.executor as EX
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.distsql import KVRequest, execute_root, full_table_ranges, select, split_dag
    from tidb_tpu_torch.exec.builder import ProgramCache
    from tidb_tpu_torch.exec.executor import _pow2
    from tidb_tpu_torch.util import failpoint, metrics

    tid = W.LINEITEM_TABLE_ID
    t = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    bounds = sorted(set(BATCH_SPLITS) | {0, STORE_SPLIT, STORE_ROWS})
    if len(store.cluster.regions()) != len(bounds) - 1:
        raise SystemExit(f"phase 9: {len(store.cluster.regions())} regions, not phase 7's {len(bounds) - 1}")
    ranges = full_table_ranges(tid)
    stmts = W.store_statements(E, X, T)
    shifts = statement_shifts(E, T, stmts)
    dags = W.store_dags(E, X, T)
    q3_dag, q3_fts = dags["q3"]
    q3_build = W.store_q3_build_columns(STORE_ORDERS, STORE_CUSTOMERS)
    q3_aux = [W.make_chunk(C, f, c) for c, f in zip(q3_build, q3_fts)]
    revenue = X.col(0, q3_dag.executors[-1].aggs[0].ft)
    q3_top = E.DAGRequest(q3_dag.executors + (E.TopN(order_by=((revenue, True),), limit=10),),
                          output_offsets=q3_dag.output_offsets)
    q3_want = numpy_q3([[W.fixed_col(t[k]) for k in ("okey", "price", "disc", "shipdate")]] + q3_build, T)
    entries = [(name, dag, {"small_groups": G} if name == "q1" else {}) for name, dag in stmts.items()]
    entries += [("q3", q3_top, {"aux_chunks": q3_aux}), ("topn", dags["topn"][0], {})]
    need = {"q1": ("dense_agg",), "q3": ("postsort_segscan", "membership_segscan")}
    cache = ProgramCache()
    ts = store.next_ts()

    def answer(name, out) -> str:
        """Hold a root answer against numpy; returns what was compared."""
        if name == "topn":
            check_rows(f"phase 9 {name}", out, numpy_order(t["price"], t["shipdate"], TOPN_K), t["price"],
                       t["shipdate"])
            return f"the first {TOPN_K} rows"
        if name == "q3":
            got = decoded_q3(out)
            top = sorted(q3_want.values(), reverse=True)[:10]
            if sorted(got.values(), reverse=True) != top or any(q3_want.get(k) != v for k, v in got.items()):
                raise SystemExit(f"phase 9 q3: the root's top 10 differ from numpy ({got})")
            return f"the top 10 of {len(q3_want)} groups"
        got = decoded_statement(name, out)
        if not same_answer(got, numpy_statement(name, t, shifts)):
            raise SystemExit(f"phase 9 {name}: the root's answer differs from numpy")
        return {"q6": "(sum, count)", "distinct_scalar": "count(distinct l_orderkey)"}.get(
            name, f"{out.num_rows()} groups")

    def buckets_of(sizes) -> int:
        """Kernel launches of the batch tier: one per capacity bucket (a
        bucket of one region runs the single path, also one launch)."""
        return len({_pow2(n) for n in sizes})

    oracle_calls = [0]
    real_oracle = EX.run_dag_reference

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle(*a, **k)

    def clean(what, st0, o0):
        st = store.stats()
        if any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks")):
            raise SystemExit(f"phase 9 {what}: an oracle fallback, an other_error or a bucket's fallback ({st})")
        if oracle_calls[0] != o0:
            raise SystemExit(f"phase 9 {what}: the root's row oracle ran {oracle_calls[0] - o0} times")

    def run(name, dag, extra, tier, **more):
        store.clear_result_cache()  # every run sends its programs
        return execute_root(store, dag, ranges, ts, cache=cache, **extra, **DISPATCH_TIERS[tier], **more)

    def checked(name, dag, extra, tier, launches, kernels=None, **more):
        """One main-path run with the counters zeroed: the answer, the
        launches of the statement's kernels (`kernels`, by default those
        of `need`), no fallback and no oracle call."""
        kernels = need.get(name, ()) if kernels is None else kernels
        st0, o0 = store.stats(), oracle_calls[0]
        t0 = time.perf_counter()
        out, fallback = vmap_fallbacks(lambda: counters.path(
            f"execute_root {name} {tier}{' ' + str(more) if more else ''}",
            lambda: run(name, dag, extra, tier, **more), need=kernels, phase=9))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k in kernels:
            require_launches(f"phase 9 {name} {tier} {k}", counters.last[k], launches)
        if fallback:
            raise SystemExit(f"phase 9 {name} {tier}: vmap ran {fallback} lane by lane")
        what = answer(name, out)
        clean(f"{name} {tier}", st0, o0)
        return out, what, ms

    sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
    EX.run_dag_reference = counted_oracle
    try:
        # every statement in every tier
        for name, dag, extra in entries:
            for tier in DISPATCH_TIERS:
                launches = buckets_of(sizes) if tier == "batch" else len(sizes)
                out, what, ms = checked(name, dag, extra, tier, launches)
                log(f"phase 9 {name} {tier}: execute_root over {len(sizes)} regions -> {what} == numpy; launches "
                    f"{counters.last}; {ms:.1f} ms; no oracle call, fallback or lane-by-lane vmap op")

        # Q1's push half over the wire, in the single and the batch tier
        plan = split_dag(stmts["q1"])
        for tier in ("single", "batch"):
            st0, o0 = store.stats(), oracle_calls[0]

            def wire_statement():
                store.clear_result_cache()
                res = select(store, KVRequest(plan.push_dag, ranges, ts, use_wire=True, small_groups=G,
                                              **DISPATCH_TIERS[tier]))
                merged = C.Chunk.concat(res.chunks)
                return EX.run_dag_on_chunks(plan.root_dag, [merged], cache=cache, device=store.device,
                                            oracle_fallback=False), res

            out, res = counters.path(f"select(use_wire=True) q1 {tier}", wire_statement, need=need["q1"], phase=9)
            require_launches(f"phase 9 q1 over the wire {tier} dense_agg", counters.last["dense_agg"],
                             buckets_of(sizes) if tier == "batch" else len(sizes))
            what = answer("q1", out)
            clean(f"q1 over the wire {tier}", st0, o0)
            log(f"phase 9 q1 {tier} over the wire: select(use_wire=True) -> {len(res.chunks)} chunks, batch stats "
                f"{res.batch_stats}, root merge -> {what} == numpy")

        # the low-memory fold: one region at a time over select_stream; its
        # requests carry no small-groups hint (the JAX package's fold builds
        # them without one), so Q1's push half takes the sort path, not K1
        for name in ("q1", "okey"):
            dag, extra = stmts[name], ({"small_groups": G} if name == "q1" else {})
            out, what, ms = checked(name, dag, extra, "single", 0, kernels=(), low_memory=True)
            log(f"phase 9 {name} low_memory=True: the Partial2 fold over {len(sizes)} regions -> {what} == numpy; "
                f"launches {counters.last}; {ms:.1f} ms")

        # times: execute_root per statement in each tier, in turns
        med = statistics.median

        def timed_runs(dag, extra, tier, reps):
            runs = []
            for _ in range(reps):
                store.clear_result_cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                execute_root(store, dag, ranges, ts, cache=cache, **extra, **DISPATCH_TIERS[tier])
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            return med(runs)

        st0, o0 = store.stats(), oracle_calls[0]
        for name, dag, extra in entries:
            reps = DISPATCH_DISTINCT_REPS if name == "distinct" else DISPATCH_REPS
            times = {tier: timed_runs(dag, extra, tier, reps) for tier in DISPATCH_TIERS}
            hand = phase8_wholes.get(name)
            log(f"phase 9 {name} ({reps} runs): execute_root median pool {times['pool']:.3f} ms, batch "
                f"{times['batch']:.3f} ms, single {times['single']:.3f} ms; phase 8's hand-joined whole "
                f"{'%.3f ms' % hand if hand is not None else '(not in phase 8)'}; on {card}")
            if profile and name in ("q1", "q3"):
                store.clear_result_cache()
                profile_path(f"phase 9 {name} execute_root, pool tier",
                             lambda: run(name, dag, extra, "pool"), times["pool"])
            if profile and name in ("q1", "bit"):
                # why the pool tier is slower than one thread: the
                # interpreter lock's switch interval (5 ms by default; at
                # 0.1 ms a thread back from the card gets the lock sooner),
                # torch's intra-op CPU threads (one per core, in each of the
                # pool's threads), and the host records of each tier
                interval, cpu_threads = sys.getswitchinterval(), torch.get_num_threads()
                sys.setswitchinterval(1e-4)
                try:
                    fast = timed_runs(dag, extra, "pool", reps)
                finally:
                    sys.setswitchinterval(interval)
                torch.set_num_threads(1)
                try:
                    one = timed_runs(dag, extra, "pool", reps)
                finally:
                    torch.set_num_threads(cpu_threads)
                log(f"phase 9 {name} pool tier ({reps} runs): {fast:.3f} ms at a 0.1 ms switch interval, {one:.3f} ms "
                    f"with one intra-op CPU thread, against {times['pool']:.3f} ms at {interval * 1e3:.1f} ms and "
                    f"{cpu_threads} threads")
                for tier in ("pool", "single"):
                    store.clear_result_cache()
                    runtime_calls(f"phase 9 {name} {tier} tier", lambda: run(name, dag, extra, tier))
        clean("timing", st0, o0)

        # last: a region split mid-statement by the failpoint's first
        # evaluation (every evaluation waits for the split, so no task is
        # sent before it); the stale task answers epoch_not_match and is
        # re-split and retried
        for tier, handle in zip(("pool", "batch"), DISPATCH_SPLITS):
            j = next(i for i in range(len(sizes)) if bounds[i] < handle < bounds[i + 1])
            stale = sizes[j]
            lock, done = threading.Lock(), []

            def split_once():
                with lock:
                    if not done:
                        done.append(store.cluster.split(codec.encode_row_key(tid, handle)))

            epochs = metrics.REGION_ERRORS.labels("epoch_not_match").value
            n_regions = len(store.cluster.regions())
            others = sizes[:j] + sizes[j + 1:]
            launches = (buckets_of(others) + 2) if tier == "batch" else len(sizes) + 1
            failpoint.enable("distsql.before_task", split_once)
            try:
                out, what, ms = checked("q1", stmts["q1"], {"small_groups": G}, tier, launches)
            finally:
                failpoint.disable("distsql.before_task")
            rose = metrics.REGION_ERRORS.labels("epoch_not_match").value - epochs
            if not done or len(store.cluster.regions()) != n_regions + 1 or rose != 1:
                raise SystemExit(f"phase 9 split {tier}: split {bool(done)}, regions {len(store.cluster.regions())}, "
                                 f"epoch_not_match +{rose}")
            bounds = sorted(set(bounds) | {handle})
            sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
            log(f"phase 9 q1 {tier}, a {stale}-row region split at handle {handle} by the failpoint mid-statement: "
                f"REGION_ERRORS{{kind=\"epoch_not_match\"}} +{rose}, {what} == numpy, launches {counters.last}; "
                f"{len(sizes)} regions now")
    finally:
        EX.run_dag_reference = real_oracle
    log(f"phase 9 store counts: {store.stats()}")
    return sizes


# ---------------------------------------------------------------------------
# phase 10: the expression families
# ---------------------------------------------------------------------------

def ulps(a, b):
    """Units in the last place between float64 arrays (0 where both are
    equal or both NaN; a large number where the signs differ)."""
    import numpy as np

    same = (a == b) | (np.isnan(a) & np.isnan(b))
    ia, ib = a.view(np.int64), b.view(np.int64)
    lo = np.int64(-0x8000000000000000)
    la, lb = np.where(ia < 0, lo - ia, ia), np.where(ib < 0, lo - ib, ib)
    far = np.signbit(a) != np.signbit(b)
    d = np.where(far, np.int64(1 << 62), np.abs(la - lb))
    return np.where(same, 0, d)


def expr_op_columns(W, T, cust, line, n: int):
    """The op check's columns (numpy, DeviceBatch form) and field types:
    the customer table's strings, c_acctbal as a decimal and a double,
    c_nationkey, full datetimes (every day of each month, with times),
    l_shipdate, shift counts, int64 extremes, SUBSTR positions and
    numeric strings, all from one seed."""
    import numpy as np

    rng = np.random.default_rng(10)
    y, mo = rng.integers(1992, 2030, n), rng.integers(1, 13, n)
    dim = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])[mo - 1] + (
        (mo == 2) & (((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)))
    d = 1 + (rng.random(n) * dim).astype(np.int64)
    hms = rng.integers(0, 24, n) << 12 | rng.integers(0, 60, n) << 6 | rng.integers(0, 60, n)
    dt = ((((y * 13 + mo) << 5 | d) << 17 | hms) << 24).astype(np.int64)
    big = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    big[:4] = [-1, -(1 << 63), (1 << 63) - 1, 0]
    shift = rng.integers(-2, 67, n).astype(np.int64)
    pos = rng.integers(-45, 46, n).astype(np.int64)
    bal = cust["acctbal"][:n]
    forms = [f"{v / 100:.2f}" for v in bal[:4096].tolist()] + ["1e400", "-1e400", " 12e-3x", "abc", "", ".5e",
                                                                 "9999999999999999999", "0x1A", "-.25", "+7"]
    numstr = [forms[i] for i in rng.integers(0, len(forms), n)]
    nlen = np.array([len(x) for x in numstr], np.int32)
    ndata = np.zeros((n, int(nlen.max())), np.uint8)
    flat = np.frombuffer("".join(numstr).encode(), np.uint8)
    ndata[np.arange(ndata.shape[1])[None, :] < nlen[:, None]] = flat
    cols = W.customer_columns(cust, ("name", "address", "phone", "mktsegment", "comment"))
    cols = [(c[0][:n], c[1][:n], c[2][:n]) for c in cols]
    cols += [W.fixed_col(bal), W.fixed_col(bal / 100.0), W.fixed_col(cust["nationkey"][:n]), W.fixed_col(dt),
             W.fixed_col(line["shipdate"][:n]), W.fixed_col(shift), W.fixed_col(big), W.fixed_col(pos),
             (ndata, np.zeros(n, bool), nlen)]
    cf = W.customer_fts(T)
    fts = [cf[1], cf[2], cf[4], cf[6], cf[7], cf[5], T.new_double(), cf[3], T.new_datetime(), T.new_datetime(),
           T.new_longlong(), T.new_longlong(), T.new_longlong(), T.new_varchar(32)]
    return cols, fts


def expr_op_cases(X, T, fts) -> dict:
    """name -> the Expr of each op of the expression families over
    expr_op_columns (columns: 0 name, 1 address, 2 phone, 3 mktsegment,
    4 comment, 5 acctbal, 6 acctbal double, 7 nationkey, 8 datetime,
    9 shipdate, 10 shift, 11 big, 12 pos, 13 numeric strings)."""
    f, lit = X.func, X.lit
    C = lambda i: X.col(i, fts[i])  # noqa: E731
    LL, UB, DBL, VC, DT, dec = (T.new_longlong(), T.new_longlong(unsigned=True), T.new_double(), T.new_varchar,
                                T.new_datetime(), T.new_decimal)
    CI = T.new_varchar(16, collate=T.Collation.Utf8MB4GeneralCI)
    B = T.new_longlong(notnull=True)
    unit = lambda u: lit(u, VC(8))  # noqa: E731
    return {
        "ceil real": f("ceil", DBL, C(6)), "ceil decimal": f("ceil", dec(15, 0), C(5)),
        "floor real": f("floor", DBL, C(6)), "floor decimal": f("floor", dec(15, 0), C(5)),
        "round real": f("round", DBL, C(6)), "round real 1": f("round", DBL, C(6), lit(1, LL)),
        "round decimal": f("round", dec(15, 0), C(5)), "round decimal 1": f("round", dec(15, 1), C(5), lit(1, LL)),
        "round int -2": f("round", LL, C(11), lit(-2, LL)),
        "sqrt": f("sqrt", DBL, C(6)), "exp": f("exp", DBL, f("div", DBL, C(6), lit(1000.0, DBL))),
        "ln": f("ln", DBL, C(6)), "log": f("log", DBL, C(5)), "pow": f("pow", DBL, C(6), lit(1.5, DBL)),
        "sign": f("sign", LL, C(5)),
        "bitand": f("bitand", UB, C(11), C(7)), "bitor": f("bitor", UB, C(11), C(7)),
        "bitxor": f("bitxor", UB, C(11), C(12)), "bitneg": f("bitneg", UB, C(11)),
        "shiftleft": f("shiftleft", UB, C(11), C(10)), "shiftright": f("shiftright", UB, C(11), C(10)),
        "length": f("length", LL, C(4)),
        "strcmp": f("strcmp", LL, f("upper", VC(40), C(1)), C(1)), "strcmp columns": f("strcmp", LL, C(0), C(1)),
        "strcmp ci": f("strcmp", LL, C(3), lit("building", CI)),
        "like prefix": f("like", B, C(3), lit("BUILD%", VC(6))), "like exact": f("like", B, C(3), lit("MACHINERY", VC(9))),
        "like ci": f("like", B, C(4), lit("FURIOUSLY%", CI)),
        "substr": f("substr", VC(3), C(2), lit(4, LL), lit(3, LL)), "substr negative": f("substr", VC(8), C(4), lit(-5, LL)),
        "substr column": f("substr", VC(40), C(1), C(12)), "substr column len": f("substr", VC(40), C(1), lit(2, LL), C(12)),
        "upper": f("upper", VC(117), C(4)), "lower": f("lower", VC(25), C(0)),
        "concat": f("concat", VC(48), C(0), lit(" ", VC(1)), C(2), C(3)),
        "trim": f("trim", VC(40), C(1)), "ltrim": f("ltrim", VC(40), C(1)), "rtrim": f("rtrim", VC(40), C(1)),
        "date_add month": f("date_add", DT, C(8), lit(1, LL), unit("month")),
        "date_add day": f("date_add", DT, C(8), C(7), unit("day")),
        "date_add quarter": f("date_add", DT, C(8), lit(-5, LL), unit("quarter")),
        "date_add year": f("date_add", DT, C(8), lit(1, LL), unit("year")),
        "date_add week": f("date_add", DT, C(8), lit(3, LL), unit("week")),
        "date_add hour": f("date_add", DT, C(8), C(10), unit("hour")),
        "date_add minute": f("date_add", DT, C(8), lit(-61, LL), unit("minute")),
        "date_add second": f("date_add", DT, C(8), lit(3599, LL), unit("second")),
        "date_sub": f("date_sub", DT, C(8), lit(2, LL), unit("quarter")),
        "datediff": f("datediff", LL, C(8), C(9)),
        "year": f("year", LL, C(8)), "month": f("month", LL, C(8)), "day": f("day", LL, C(8)),
        "hour": f("hour", LL, C(8)), "minute": f("minute", LL, C(8)), "second": f("second", LL, C(8)),
        "to_days": f("to_days", LL, C(8)), "weekday": f("weekday", LL, C(8)),
        "extract": f("extract", LL, lit("YEAR", VC(4)), C(9)),
        "string to double": f("cast", DBL, C(13)), "string to decimal": f("cast", dec(20, 3), C(13)),
        "string to int": f("cast", LL, f("substr", VC(8), C(13), lit(1, LL), lit(8, LL))),
        "address to double": f("cast", DBL, C(1)),
    }


def expr_phase(store, E, X, T, W, counters, profile: bool, card: str, line_sizes: list) -> None:
    """Phase 10: the expression families on the card. Load the customer
    table (EXPR_ROWS rows, four regions) into phase 6's store; run each op
    of the families over EXPR_ROWS rows on the card and on the CPU through
    decode_outputs (integer, decimal, date and string results equal; exp,
    ln, log and pow within ULP_TOL; sqrt on the card bit-equal to np.sqrt;
    string truthiness in WHERE equal); then each statement of
    workloads.store_expr_statements through execute_root in the single
    and batch tiers against numpy, K1 once a region or a bucket in
    q22_cntry and year, no fallback of any kind, no lane-by-lane vmap op
    and no call of the root's row oracle; the median ms per statement and
    tier, and the device operations of one `text` region request split
    into parse_f64_prefix's and the rest. With `profile`, a host profile
    and a device profile of the text statement in both tiers and of
    q22_cntry's batch."""
    import numpy as np
    import torch

    import tidb_tpu_torch.exec.executor as EX
    import tidb_tpu_torch.expr.compile as XC
    import tidb_tpu_torch.ops.selection as SEL
    from tidb_tpu_torch import codec, native
    from tidb_tpu_torch.distsql import execute_root, full_table_ranges, split_dag
    from tidb_tpu_torch.exec.builder import ProgramCache, _pack_cols
    from tidb_tpu_torch.exec.executor import _pow2, decode_outputs
    from tidb_tpu_torch.interop import device_batch_from_numpy
    from tidb_tpu_torch.store import CopRequest

    if not native.available():
        raise SystemExit("phase 10: the native row decoder did not build")
    n, ctid, ltid = EXPR_ROWS, W.CUSTOMER_TABLE_ID, W.LINEITEM_TABLE_ID
    t0 = time.perf_counter()
    # the table's own regions: the first starts at its record prefix, so no
    # lineitem region overlaps its key range
    store.cluster.split(codec.record_prefix(ctid))
    for h in range(EXPR_REGION, n, EXPR_REGION):
        store.cluster.split(codec.encode_row_key(ctid, h))
    h0 = hook_seconds(store)
    secs, nbytes = load_store(store, n, None, _customer_init, (n,), _customer_encode)
    log(f"phase 10 load: {n} customer rows ({nbytes} B of keys and rowcodec values, {nbytes / n:.1f} B a row) in "
        f"{secs:.2f} s ({LOAD_WORKERS} encoder processes; the store's write hooks {hook_seconds(store) - h0:.2f} s"
        f" of it), {n // EXPR_REGION} regions of {EXPR_REGION} rows")
    cust = W.store_customer(n)
    line = W.store_lineitem(STORE_ROWS, STORE_ORDERS)

    # the op check: every op on the card and on the CPU, through decode_outputs
    cols, fts = expr_op_columns(W, T, cust, line, n)
    valid = np.ones(n, bool)
    on = [(d, device_batch_from_numpy(cols, valid, n, fts, device=d)) for d in (DEVICE, "cpu")]
    t1 = time.perf_counter()
    for name, e in expr_op_cases(X, T, fts).items():
        gc, wc = (decode_outputs(_pack_cols(XC.ExprCompiler(fts, device=d).run([e], b.cols)), b.row_valid,
                                 [e.ft]).columns[0] for d, b in on)
        if not np.array_equal(gc.null, wc.null):
            raise SystemExit(f"phase 10 op {name}: NULLs differ between the card and the CPU")
        keep = ~wc.null
        if e.ft.eval_type() == "string":
            same = np.array_equal(gc.offsets, wc.offsets) and np.array_equal(gc.blob, wc.blob)
            what = "bytes equal"
        elif e.ft.eval_type() == "real":
            u = ulps(np.asarray(gc.data)[keep], np.asarray(wc.data)[keep])
            if name == "sqrt":
                arg = cols[6][0][keep]
                same = np.array_equal(np.asarray(gc.data)[keep], np.sqrt(np.where(arg < 0, 0.0, arg)))
                what = f"card == np.sqrt bit for bit, CPU within {int(u.max(initial=0))} ulp"
                same = same and int(u.max(initial=0)) <= ULP_TOL
            elif name in ("exp", "ln", "log", "pow"):
                same = int(u.max(initial=0)) <= ULP_TOL
                what = f"within {int(u.max(initial=0))} ulp ({int((u > 0).sum())} lanes differ)"
            else:
                same, what = int(u.max(initial=0)) == 0, "bit for bit"
        else:
            same, what = np.array_equal(np.asarray(gc.data)[keep], np.asarray(wc.data)[keep]), "equal"
        if not same:
            raise SystemExit(f"phase 10 op {name}: the card and the CPU differ ({what})")
        log(f"phase 10 op {name}: {n} rows, card == CPU through decode_outputs ({what}; {int(keep.sum())} not NULL)")
    for name, ci in (("substr(c_phone, 4, 3)", None), ("c_address", 1), ("numeric strings", 13)):
        masks = []
        for d, b in on:
            e = X.func("substr", T.new_varchar(3), X.col(2, fts[2]), X.lit(4, T.new_longlong()),
                       X.lit(3, T.new_longlong())) if ci is None else X.col(ci, fts[ci])
            (cv,) = XC.ExprCompiler(fts, device=d).run([e], b.cols)
            masks.append(SEL.apply_selection(b.row_valid, [cv]).cpu().numpy())
        if not np.array_equal(*masks):
            raise SystemExit(f"phase 10 string truthiness of {name}: the card and the CPU differ")
        log(f"phase 10 WHERE {name}: card == CPU ({int(masks[0].sum())} of {n} rows true)")
    log(f"phase 10 op check: {time.perf_counter() - t1:.1f} s")
    del on

    # the statements through execute_root
    stmts = W.store_expr_statements(E, X, T)
    cust_sizes = [EXPR_REGION] * (n // EXPR_REGION)
    for tid, sizes in ((ctid, cust_sizes), (ltid, line_sizes)):
        (rng,) = full_table_ranges(tid)
        over = [r for r in store.cluster.regions() if r.start_key < rng.end and (not r.end_key or r.end_key > rng.start)]
        if len(over) != len(sizes):
            raise SystemExit(f"phase 10: table {tid} spans {len(over)} regions, not {len(sizes)}")
    cache = ProgramCache()
    ts = store.next_ts()
    oracle_calls = [0]
    real_oracle = EX.run_dag_reference

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle(*a, **k)

    def run(name, tier):
        store.clear_result_cache()  # every run sends its programs
        return execute_root(store, stmts[name], full_table_ranges(stmts[name].executors[0].table_id), ts,
                            cache=cache, small_groups=EXPR_HINT if name in ("q22_cntry", "year") else None,
                            **DISPATCH_TIERS[tier])

    want = numpy_expr_statements(cust, line)
    times = {}
    EX.run_dag_reference = counted_oracle
    try:
        for name in stmts:
            sizes = cust_sizes if stmts[name].executors[0].table_id == ctid else line_sizes
            for tier in ("single", "batch"):
                st0, o0 = store.stats(), oracle_calls[0]
                need = ("dense_agg",) if name in ("q22_cntry", "year") else ()
                out, fallback = vmap_fallbacks(lambda: counters.path(
                    f"execute_root {name} {tier}", lambda: run(name, tier), need=need, phase=10))
                if need:
                    launches = len({_pow2(k) for k in sizes}) if tier == "batch" else len(sizes)
                    require_launches(f"phase 10 {name} {tier} dense_agg", counters.last["dense_agg"], launches)
                if fallback:
                    raise SystemExit(f"phase 10 {name} {tier}: vmap ran {fallback} lane by lane")
                st = store.stats()
                if any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks")):
                    raise SystemExit(f"phase 10 {name} {tier}: an oracle fallback, an other_error or a bucket's "
                                     f"fallback ({st})")
                if oracle_calls[0] != o0:
                    raise SystemExit(f"phase 10 {name} {tier}: the root's row oracle ran {oracle_calls[0] - o0} times")
                what = check_expr_statement(name, out, want[name])
                log(f"phase 10 {name} {tier}: execute_root over {len(sizes)} regions -> {what}; launches "
                    f"{counters.last}; no oracle call, fallback or lane-by-lane vmap op")
                runs = []
                for _ in range(EXPR_REPS):
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    run(name, tier)
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t2) * 1e3)
                times[(name, tier)] = statistics.median(runs)
        counters.zero()
    finally:
        EX.run_dag_reference = real_oracle
    for name in stmts:
        log(f"phase 10 {name} ({EXPR_REPS} runs): execute_root median single {times[(name, 'single')]:.3f} ms, "
            f"batch {times[(name, 'batch')]:.3f} ms; on {card}")
    if profile:
        for name, tier in (("text", "batch"), ("text", "single"), ("q22_cntry", "batch")):
            host_profile(f"phase 10 {name} {tier}", lambda: run(name, tier), top=8)
            profile_path(f"phase 10 {name} {tier}", lambda: run(name, tier), times[(name, tier)], top=6)

    # the device operations of one `text` region request: parse_f64_prefix's
    # (its calls counted, one call's operations profiled) and the rest
    plan = split_dag(stmts["text"])
    region = next(r for r in store.cluster.regions() if r.contains(codec.encode_row_key(ctid, 0)))
    req = CopRequest(plan.push_dag, full_table_ranges(ctid), ts, region.region_id, region.epoch)
    calls, real_parse = [], XC.parse_f64_prefix

    def counted_parse(data, length):
        calls.append(tuple(data.shape))
        return real_parse(data, length)

    XC.parse_f64_prefix = SEL.parse_f64_prefix = counted_parse
    try:
        store.clear_result_cache()
        store.coprocessor(req)
        store.clear_result_cache()
        total = device_ops(lambda: store.coprocessor(req))
    finally:
        XC.parse_f64_prefix = SEL.parse_f64_prefix = real_parse
    parse_calls = calls[len(calls) // 2:]
    per = {}
    for shape in set(parse_calls):
        data = torch.zeros(shape, dtype=torch.uint8, device=DEVICE)
        length = torch.full(shape[:1], shape[1], dtype=torch.int32, device=DEVICE)
        per[shape] = device_ops(lambda: real_parse(data, length))
    parse_ops = sum(per[s] for s in parse_calls)
    log(f"phase 10 text, one region request ({EXPR_REGION} rows): {total} device operations; parse_f64_prefix "
        f"{parse_ops} ({len(parse_calls)} calls over widths {sorted(s[1] for s in parse_calls)}: "
        f"{', '.join(f'{per[s]} at width {s[1]}' for s in sorted(per))}), the rest {total - parse_ops}")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s; store counts {store.stats()}")


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) of one run of fn, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


def _civil(packed):
    """datetime.date of each distinct packed datetime, and the inverse map."""
    import datetime

    import numpy as np

    keys, inv = np.unique(packed, return_inverse=True)
    ymd = (keys >> 41).tolist()
    dates = [datetime.date((v >> 5) // 13, (v >> 5) % 13, v & 31) for v in ymd]
    return dates, inv


def numpy_expr_statements(cust, line) -> dict:
    """The exact answers of workloads.store_expr_statements over the
    generated columns (Python's datetime for the calendar; the 32-byte
    compare prefix for STRCMP, as the packed compare words hold), in
    check_expr_statement's form."""
    import datetime

    import numpy as np

    out = {}
    phone, _ = cust["phone"]
    cc = (phone[:, 0].astype(np.int64) - 48) * 10 + (phone[:, 1].astype(np.int64) - 48)
    bal = cust["acctbal"]
    keep = np.isin(cc, [13, 31, 23, 29, 30, 18, 17]) & (bal > 0)
    out["q22_cntry"] = {f"{c:02d}": (int((keep & (cc == c)).sum()), int(bal[keep & (cc == c)].sum()))
                        for c in np.unique(cc[keep])}

    price, disc, okey, qty, ship = (line[k] for k in ("price", "disc", "okey", "qty", "shipdate"))
    rev = price * (100 - disc)
    dates, inv = _civil(ship)
    year = np.array([d.year for d in dates])[inv]
    out["year"] = {int(y): (int(rev[year == y].sum()), int((year == y).sum())) for y in np.unique(year)}

    seg, seg_len = cust["mktsegment"]
    com, _ = cust["comment"]
    segs = [bytes(seg[i, : seg_len[i]]) for i in range(len(seg_len))]
    local = (phone[:, 3:6].astype(np.int64) - 48) @ np.array([100, 10, 1])
    cond = ((seg[:, :5] == np.frombuffer(b"BUILD", np.uint8)).all(1) | (com[:, :9] == np.frombuffer(
        b"furiously", np.uint8)).all(1) | np.array([s == b"MACHINERY" for s in segs])) & (local != 0)
    name, name_len = cust["name"]
    addr, addr_len = cust["address"]
    pre = np.where(np.arange(32)[None, :] < addr_len[:, None], addr[:, :32], 0)
    strcmp = -((pre >= 0x61) & (pre <= 0x7A)).any(1).astype(np.int64)
    padded = [b"  " + bytes(name[i, : name_len[i]]) + b" " for i in range(len(name_len))]
    text = {}
    for s in sorted(set(segs)):
        m = cond & np.array([x == s for x in segs])
        idx = np.nonzero(m)[0]
        text[s.lower().decode()] = (
            len(idx), sum(len(padded[i].strip(b" ")) for i in idx), sum(len(padded[i].lstrip(b" ")) for i in idx),
            sum(len(padded[i].rstrip(b" ")) for i in idx), int(strcmp[m].sum()), float(cc[m].astype(np.float64).sum()))
    out["text"] = text

    neg = disc - price
    first = [d.replace(day=1) for d in dates]
    d_month = np.array([((f + datetime.timedelta(days=32)).replace(day=1) - f).days for f in first])[inv]
    back = np.array([shift_months(d, -6).toordinal() + 365 for d in dates])[inv]
    cal = np.array([(d.month, d.day, d.weekday()) for d in dates])[inv]
    q = qty / 100.0
    ints = [(rev + 9999) // 10000, rev // 10000, (2 * rev + 10000) // 20000,
            -((-neg) // 100), -((-neg + 99) // 100), -((2 * (-neg) + 10) // 20), np.sign(disc - 5),
            okey & 255, okey | 255, okey ^ 255, okey << 3, okey >> 2, d_month, back, cal[:, 0], cal[:, 1],
            np.zeros_like(okey), cal[:, 2]]
    reals = [np.sqrt(q), np.exp(q / 10.0), np.log(q), np.power(q, 1.5)]
    out["numeric"] = ([int(v.sum()) for v in ints], [float(v.sum()) for v in reals],
                      int(np.bitwise_xor.reduce(~okey).view(np.uint64)), len(okey))
    return out


def shift_months(d, months: int):
    """d moved by `months` months (day 1-28: no month-end clamp needed)."""
    t = d.year * 12 + d.month - 1 + months
    return d.replace(year=t // 12, month=t % 12 + 1)


def check_expr_statement(name, chunk, want) -> str:
    """Hold a root answer of an expression statement against numpy
    (exact; the real SUMs to 1e-9 relative, their order being the
    merge's); returns what was compared."""
    cols = chunk.columns
    rel = 1e-9
    if name in ("q22_cntry", "year"):
        key = (lambda j: cols[2].get_bytes(j).decode()) if name == "q22_cntry" else (lambda j: int(cols[2].data[j]))
        got = {key(j): (int(cols[0].data[j]), int(cols[1].data[j])) for j in range(chunk.num_rows())}
        if got != want:
            raise SystemExit(f"phase 10 {name}: the root's answer differs from numpy ({got} != {want})")
        return f"{len(got)} groups == numpy"
    if name == "text":
        got = {cols[6].get_bytes(j).decode(): tuple(int(cols[i].data[j]) for i in range(5)) + (float(cols[5].data[j]),)
               for j in range(chunk.num_rows())}
        ok = got.keys() == want.keys() and all(
            got[k][:5] == want[k][:5] and abs(got[k][5] - want[k][5]) <= rel * abs(want[k][5]) for k in want)
        if not ok:
            raise SystemExit(f"phase 10 text: the root's answer differs from numpy ({got} != {want})")
        return f"{len(got)} groups == numpy (the real SUM to {rel} relative)"
    ints, reals, xor, count = want
    row = [cols[i].data[0] for i in range(len(cols))]
    got_ints = [int(v) for v in row[: len(ints)]]
    got_reals = [float(v) for v in row[len(ints): len(ints) + len(reals)]]
    ok = (got_ints == ints and int(row[-2]) == xor and int(row[-1]) == count
          and all(abs(g - w) <= rel * abs(w) for g, w in zip(got_reals, reals)))
    if not ok:
        raise SystemExit(f"phase 10 numeric: the root's answer differs from numpy ({row} != {want})")
    return f"{len(row)} aggregates == numpy (the real SUMs to {rel} relative)"


# ---------------------------------------------------------------------------
# phase 11: the SQL session
# ---------------------------------------------------------------------------

SESSION_REPS = 3
SESSION_ORDERS = STORE_ORDERS   # o_orderkey 0..2^19-1, the keys l_orderkey draws from
SESSION_CUSTOMERS = EXPR_ROWS   # o_custkey draws from phase 10's customers
SESSION_ACCT_ROWS = 2048        # the transaction table
SESSION_CSV_ROWS = 1000         # LOAD DATA's file
SESSION_DIR = os.path.join("build", "session_phase")  # LOAD DATA's CSV and LOAD STATS' JSON (ignored by git)

LINEITEM_DDL = ("CREATE TABLE lineitem (l_orderkey BIGINT NOT NULL, l_extendedprice DECIMAL(15,2) NOT NULL,"
                " l_discount DECIMAL(15,2) NOT NULL, l_shipdate DATE NOT NULL, l_quantity DECIMAL(15,2) NOT NULL,"
                " l_returnflag CHAR(1) NOT NULL, l_linestatus CHAR(1) NOT NULL)")
ORDERS_DDL = ("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_orderdate DATE NOT NULL,"
              " o_shippriority BIGINT NOT NULL, o_custkey BIGINT NOT NULL)")
CUSTOMER_DDL = ("CREATE TABLE customer (c_custkey BIGINT NOT NULL, c_name VARCHAR(25) NOT NULL,"
                " c_address VARCHAR(40) NOT NULL, c_nationkey BIGINT NOT NULL, c_phone CHAR(15) NOT NULL,"
                " c_acctbal DECIMAL(15,2) NOT NULL, c_mktsegment CHAR(10) NOT NULL, c_comment VARCHAR(117) NOT NULL)")

# TPC-H Q1 over the seven columns (no l_tax: no sum_charge), its ORDER BY
# cut: the JAX package's planner reads its small-groups hint from the
# statement's last executor (tidb_tpu/sql/planner.py _ndv_group_hint),
# which the root Sort of the full text hides; "q1_ordered" is the full text
Q1_SELECT = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),"
             " sum(l_extendedprice * (1 - l_discount)), avg(l_quantity), avg(l_extendedprice), avg(l_discount),"
             " count(*) FROM lineitem WHERE l_shipdate <= {d} GROUP BY l_returnflag, l_linestatus")
SESSION_STATEMENTS = {
    # name: (text with {d} for its one parameter, the parameter's value)
    "q1": (Q1_SELECT, "'1998-09-02'"),
    "q1_ordered": (Q1_SELECT + " ORDER BY l_returnflag, l_linestatus", "'1998-09-02'"),
    "q6": ("SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem WHERE l_shipdate >= {d}"
           " AND l_shipdate < '1995-01-01' AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24", "'1994-01-01'"),
    "q3": ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue FROM lineitem JOIN orders"
           " ON l_orderkey = o_orderkey WHERE o_orderdate < {d} AND l_shipdate > '1995-03-15' GROUP BY l_orderkey"
           " ORDER BY revenue DESC LIMIT 10", "'1995-03-15'"),
    "topn": ("SELECT l_extendedprice, l_shipdate FROM lineitem WHERE l_shipdate >= {d}"
             " ORDER BY l_extendedprice DESC, l_shipdate LIMIT 100", "'1992-01-01'"),
    # phase 10's q22_cntry; GROUP BY names the expression: both packages'
    # planners resolve a GROUP BY alias of an expression to the wrong column
    "q22_cntry": ("SELECT SUBSTRING(c_phone, 1, 2) AS cntrycode, count(*), sum(c_acctbal) FROM customer"
                  " WHERE SUBSTRING(c_phone, 1, 2) IN ('13', '31', '23', '29', '30', '18', '17')"
                  " AND c_acctbal > {d} GROUP BY SUBSTRING(c_phone, 1, 2)", "0.00"),
}
# the TPC-H Q3 join order over all three tables: the planner's plan is a
# left-deep pair of joins, which the packed chain (K3's membership scan
# under K2) does not take; printed, not run
Q3_THREE_TABLES = ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue FROM customer, orders,"
                   " lineitem WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey AND l_orderkey = o_orderkey"
                   " AND o_orderdate < '1995-03-15' AND l_shipdate > '1995-03-15' GROUP BY l_orderkey"
                   " ORDER BY revenue DESC LIMIT 10")


def _orders_init(n: int, n_cust: int, table_id: int):
    """A load worker's copy of the orders table (q3's seeded build sides)."""
    global _LOAD_TABLE
    from tidb_tpu_torch import workloads as W

    _LOAD_TABLE = (table_id, [c[0] for c in W.store_q3_build_columns(n, n_cust)[0]])


def _orders_encode(span):
    """Orders rows lo..hi as (row key, rowcodec value) pairs: the handle is
    o_orderkey, the values (o_orderkey, o_orderdate, o_shippriority 0,
    o_custkey) under column ids 1..4, as the session's INSERT encodes them."""
    from tidb_tpu_torch import codec, types as T

    tid, (okey, cust, odate) = _LOAD_TABLE
    lo, hi = span
    enc = codec.RowEncoder()
    return [(codec.encode_row_key(tid, k), enc.encode([1, 2, 3, 4], [T.Datum.i64(k), T.Datum.time(T.MyTime(d, 0)),
                                                                       T.Datum.i64(0), T.Datum.i64(c)]))
            for k, c, d in zip(okey[lo:hi].tolist(), cust[lo:hi].tolist(), odate[lo:hi].tolist())]


def copy_table(src, src_tid: int, dst, dst_tid: int, ts: int | None = None, hi: int | None = None) -> int:
    """Copy a table's rows from store `src` into store `dst` under another
    table id: a row's value bytes depend only on its column ids and types,
    so only the key's table prefix changes. The rows are those visible at
    `ts` (the newest by default) with a handle below `hi` (every row by
    default). Returns the rows copied."""
    from tidb_tpu_torch.codec import encode_row_key, record_prefix
    from tidb_tpu_torch.distsql import full_table_ranges

    (r,) = full_table_ranges(src_tid)
    end = r.end if hi is None else encode_row_key(src_tid, hi)
    old, new = record_prefix(src_tid), record_prefix(dst_tid)
    items = [(new + k[len(old):], v) for k, v in src.kv.scan(r.start, end, src.next_ts() if ts is None else ts)]
    dst.bulk_ingest(items, dst.next_ts())
    return len(items)


def _scaled(d, scale: int) -> int:
    """A decimal Datum as an integer at `scale` digits (exact)."""
    from decimal import Decimal

    v = Decimal(str(d.val)).scaleb(scale)
    if v != v.to_integral_value():
        raise SystemExit(f"phase 11: {d.val} has more than {scale} digits")
    return int(v)


def numpy_session_q1(t, T) -> dict:
    """Q1_SELECT's exact answer in session_answer's form."""
    import numpy as np

    m = t["shipdate"] <= T.MyTime.parse("1998-09-02", 0).packed
    gid = (t["rflag"].astype(np.int64) * 2 + t["lstat"].astype(np.int64))[m]
    qty, price, disc = t["qty"][m], t["price"][m], t["disc"][m]
    q1 = {}
    for g in np.unique(gid):
        s = gid == g
        cnt = int(s.sum())
        sq, sp, sd = int(qty[s].sum()), int(price[s].sum()), int(disc[s].sum())
        q1[("ANR"[g // 2], "OF"[g % 2])] = [sq, sp, int((price[s] * (100 - disc[s])).sum()),
                                            round_div(sq * 10 ** 4, cnt), round_div(sp * 10 ** 4, cnt),
                                            round_div(sd * 10 ** 4, cnt), cnt]
    return q1


def numpy_lineitem_sql(t, orders, T) -> dict:
    """The exact answers of SESSION_STATEMENTS' q1, q6, q3 and topn (the
    statements over lineitem and orders) in session_answer's form."""
    import numpy as np

    out = {"q1": numpy_session_q1(t, T), "q6": numpy_q6(t, T)[0]}
    okey, o_date = orders
    cut = T.MyTime.parse("1995-03-15", 0).packed
    l_ok = (t["shipdate"] > cut) & (o_date[t["okey"]] < cut)
    out["q3"] = {k: v for k, (v, _c) in _sum_by(t["okey"][l_ok], t["price"][l_ok] * (100 - t["disc"][l_ok])).items()}
    lo = T.MyTime.parse("1992-01-01", 0).packed
    idx = numpy_order(np.where(t["shipdate"] >= lo, t["price"], -1), t["shipdate"], TOPN_K)
    out["topn"] = [(int(t["price"][i]), int(t["shipdate"][i])) for i in idx]
    return out


def numpy_sql(t, cust, orders, T) -> dict:
    """The exact answers of SESSION_STATEMENTS over the generated columns,
    in session_answer's form."""
    import numpy as np

    out = numpy_lineitem_sql(t, orders, T)
    out["q1_ordered"] = out["q1"]
    phone, _ = cust["phone"]
    cc = (phone[:, 0].astype(np.int64) - 48) * 10 + (phone[:, 1].astype(np.int64) - 48)
    bal = cust["acctbal"]
    keep = np.isin(cc, [13, 31, 23, 29, 30, 18, 17]) & (bal > 0)
    out["q22_cntry"] = {f"{c:02d}": (int((keep & (cc == c)).sum()), int(bal[keep & (cc == c)].sum()))
                        for c in np.unique(cc[keep])}
    return out


def session_answer(name, res, want, where: str = "phase 11") -> str:
    """Hold a statement's Result against numpy (exact); returns what was
    compared. `where` names the phase in a failure."""
    rows = res.rows
    if name in ("q1", "q1_ordered"):
        got = {(r[0].val, r[1].val): [_scaled(r[2], 2), _scaled(r[3], 2), _scaled(r[4], 4), _scaled(r[5], 6),
                                      _scaled(r[6], 6), _scaled(r[7], 6), int(r[8].val)] for r in rows}
        if got != want:
            raise SystemExit(f"{where} {name}: {got} != numpy {want}")
        if name == "q1_ordered" and list(got) != sorted(got):
            raise SystemExit(f"{where} {name}: rows not in ORDER BY order ({list(got)})")
        return f"{len(got)} groups"
    if name == "q6":
        if len(rows) != 1 or _scaled(rows[0][0], 4) != want:
            raise SystemExit(f"{where} q6: {rows} != numpy {want}")
        return "the revenue"
    if name == "q3":
        got = {int(r[0].val): _scaled(r[1], 4) for r in rows}
        top = sorted(want.values(), reverse=True)[:10]
        if [_scaled(r[1], 4) for r in rows] != top or any(want.get(k) != v for k, v in got.items()):
            raise SystemExit(f"{where} q3: the top 10 {got} differ from numpy")
        return f"the top 10 of {len(want)} groups"
    if name == "topn":
        got = [(_scaled(r[0], 2), r[1].val.packed) for r in rows]
        if got != want:
            raise SystemExit(f"{where} topn: the rows differ from numpy's order")
        return f"{len(got)} rows in order"
    got = {r[0].val: (int(r[1].val), _scaled(r[2], 2)) for r in rows}
    if got != want:
        raise SystemExit(f"{where} q22_cntry: {got} != numpy {want}")
    return f"{len(got)} groups"


class SessionSplit:
    """The host time a Session.execute spends in the parser and in
    execute_root (build-side fetches included), read by wrapping the
    session module's parse_one and execute_root; the rest is planning."""

    def __init__(self, mod):
        self.mod, self.parse, self.root = mod, 0.0, 0.0
        self.real = (mod.parse_one, mod.execute_root)

        def parse_one(*a, **k):
            t0 = time.perf_counter()
            try:
                return self.real[0](*a, **k)
            finally:
                self.parse += time.perf_counter() - t0

        def execute_root(*a, **k):
            t0 = time.perf_counter()
            try:
                return self.real[1](*a, **k)
            finally:
                self.root += time.perf_counter() - t0

        mod.parse_one, mod.execute_root = parse_one, execute_root

    def close(self):
        self.mod.parse_one, self.mod.execute_root = self.real

    def run(self, fn):
        """(result, total ms, parse ms, plan ms, execute_root ms) of fn()."""
        import torch

        self.parse = self.root = 0.0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        parse, root = self.parse * 1e3, self.root * 1e3
        return out, total, parse, total - parse - root, root


def session_phase(old, E, X, T, W, counters, profile: bool, card: str, line_sizes: list):
    """Phase 11: the SQL session on the card (see the module docstring).
    Returns the session (phase 12 copies its tables)."""
    import numpy as np

    import tidb_tpu_torch.exec as EXP
    import tidb_tpu_torch.exec.executor as EX
    import tidb_tpu_torch.sql.session as SM
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.exec.executor import _pow2
    from tidb_tpu_torch.parser import parse_one
    from tidb_tpu_torch.sql import Session, SQLError, plan_select

    t0 = time.perf_counter()
    s = Session(device=DEVICE)
    store = s.store
    for ddl in (LINEITEM_DDL, ORDERS_DDL, CUSTOMER_DDL):
        s.execute(ddl)
    tids = {name: s.catalog.table(name).table_id for name in ("lineitem", "orders", "customer")}
    # each table's own regions, lineitem's as phase 9 left them
    bounds = np.cumsum(line_sizes)[:-1].tolist()
    for name, handles in (("lineitem", bounds), ("orders", [SESSION_ORDERS // 2]),
                          ("customer", list(range(EXPR_REGION, EXPR_ROWS, EXPR_REGION)))):
        store.cluster.split(codec.record_prefix(tids[name]))
        for h in handles:
            store.cluster.split(codec.encode_row_key(tids[name], h))
    h0, t_copy = hook_seconds(store), time.perf_counter()
    n_line = copy_table(old, W.LINEITEM_TABLE_ID, store, tids["lineitem"])
    n_cust = copy_table(old, W.CUSTOMER_TABLE_ID, store, tids["customer"])
    t_copy, h_copy = time.perf_counter() - t_copy, hook_seconds(store) - h0
    secs, _nbytes = load_store(store, SESSION_ORDERS, SESSION_CUSTOMERS, _orders_init,
                               (SESSION_ORDERS, SESSION_CUSTOMERS, tids["orders"]), _orders_encode,
                               chunk=max(SESSION_ORDERS // LOAD_WORKERS, 1))
    if (n_line, n_cust) != (STORE_ROWS, EXPR_ROWS):
        raise SystemExit(f"phase 11: copied {n_line} lineitem and {n_cust} customer rows")
    t = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    cust = W.store_customer(EXPR_ROWS)
    okey, _ocust, odate = (c[0] for c in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
    log(f"phase 11 load: lineitem {n_line} rows ({len(line_sizes)} regions) and customer {n_cust} rows (4 regions)"
        f" copied from phase 10's store under the catalog's table ids {tids} in {t_copy:.2f} s (the store's write"
        f" hooks {h_copy:.2f} s of it), orders {SESSION_ORDERS} rows encoded in {secs:.2f} s ({LOAD_WORKERS}"
        f" processes, 2 regions; write hooks {hook_seconds(store) - h0 - h_copy:.2f} s);"
        f" {time.perf_counter() - t0:.2f} s")
    r = s.execute(f"SELECT o_orderkey, o_orderdate, o_custkey FROM orders WHERE o_orderkey = {SESSION_ORDERS - 3}")
    if [(r.rows[0][0].val, r.rows[0][1].val.packed, r.rows[0][2].val)] != [
            (SESSION_ORDERS - 3, int(odate[-3]), int(_ocust[-3]))]:
        raise SystemExit(f"phase 11: the orders point get read {r.values()}")

    # LOAD DATA of a small file, then ANALYZE of that table
    os.makedirs(SESSION_DIR, exist_ok=True)
    csv = os.path.abspath(os.path.join(SESSION_DIR, "acct_load.csv"))
    with open(csv, "w") as f:
        f.writelines(f"{i},{i % 7},{i * 3}\n" for i in range(SESSION_CSV_ROWS))
    s.execute("CREATE TABLE loaded (id BIGINT PRIMARY KEY, g BIGINT NOT NULL, v BIGINT NOT NULL)")
    n_loaded = s.execute(f"LOAD DATA INFILE '{csv}' INTO TABLE loaded FIELDS TERMINATED BY ','").affected
    got = s.execute("SELECT count(*), sum(v) FROM loaded").values()[0]
    if n_loaded != SESSION_CSV_ROWS or [got[0], int(str(got[1]))] != [SESSION_CSV_ROWS, 3 * sum(range(SESSION_CSV_ROWS))]:
        raise SystemExit(f"phase 11 LOAD DATA: {n_loaded} rows, read back {got}")
    s.execute("ANALYZE TABLE loaded")
    ndv = s.catalog.stats[s.catalog.table("loaded").table_id].columns["g"].ndv
    if ndv != 7:
        raise SystemExit(f"phase 11 ANALYZE: NDV of g {ndv}, not 7")
    log(f"phase 11 LOAD DATA: {n_loaded} rows from a CSV, read back through the coprocessor; ANALYZE: NDV(g) = {ndv}")

    # the planner's column stats for lineitem through LOAD STATS (ANALYZE
    # would decode every row in Python)
    stats_json = os.path.abspath(os.path.join(SESSION_DIR, "lineitem_stats.json"))
    with open(stats_json, "w") as f:
        json.dump({"table_name": "lineitem", "count": STORE_ROWS, "columns": {
            "l_returnflag": {"null_count": 0, "histogram": {"ndv": int(len(np.unique(t["rflag"])))}},
            "l_linestatus": {"null_count": 0, "histogram": {"ndv": int(len(np.unique(t["lstat"])))}}}}, f)
    s.execute(f"LOAD STATS '{stats_json}'")
    plans = {name: plan_select(parse_one(text.format(d=arg)), s.catalog)
             for name, (text, arg) in SESSION_STATEMENTS.items()}
    for name, p in plans.items():
        log(f"phase 11 plan {name}: {[type(e).__name__ for e in p.dag.executors]}, small_groups {p.small_groups}")
    if plans["q1"].small_groups != G or plans["q1_ordered"].small_groups is not None:
        raise SystemExit(f"phase 11: Q1's hint {plans['q1'].small_groups}, ordered {plans['q1_ordered'].small_groups}")
    p3 = plan_select(parse_one(Q3_THREE_TABLES), s.catalog)
    log(f"phase 11 plan of Q3 over customer, orders and lineitem (not run): "
        f"{[type(e).__name__ for e in p3.dag.executors]}; the builds "
        f"{[[type(b).__name__ for b in e.build] for e in p3.dag.executors if isinstance(e, E.Join)]}"
        f" (left-deep: K3's membership chain needs a join inside a build)")

    want = numpy_sql(t, cust, (okey, odate), T)
    oracle_calls = [0]
    real_oracle = (EX.run_dag_reference, EXP.run_dag_reference)

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle[0](*a, **k)

    EX.run_dag_reference = EXP.run_dag_reference = counted_oracle
    split = SessionSplit(SM)
    regions = len(line_sizes)
    buckets = len({_pow2(x) for x in line_sizes})
    need = {"q1": "dense_agg", "q3": "postsort_segscan"}
    timings = {}
    try:
        for tier, sets in (("pool", ()), ("batch", ("SET tidb_allow_batch_cop = 1",))):
            for q in sets:
                s.execute(q)
            for name, (text, arg) in SESSION_STATEMENTS.items():
                sql = text.format(d=arg)

                def checked(sql=sql, name=name):
                    store.clear_result_cache()
                    res = s.execute(sql)
                    return res, session_answer(name, res, want[name])

                _res, what = counters.path(f"{name} ({tier})", checked, need=(need[name],) if name in need else (),
                                           phase=11)
                for k, v in counters.last.items():
                    # K1 / K2 once a region (pool) or a capacity bucket (batch)
                    k_want = (regions if tier == "pool" else buckets) if need.get(name) == k else 0
                    require_launches(f"phase 11 {name} ({tier}) {k}", v, k_want)
                miss, hit = [], []
                for _ in range(SESSION_REPS):
                    s.catalog.plan_cache.clear()
                    store.clear_result_cache()
                    res, *ms = split.run(lambda sql=sql: s.execute(sql))
                    if s._last_plan_cache[0] != "miss":
                        raise SystemExit(f"phase 11 {name}: plan cache {s._last_plan_cache} after a clear")
                    session_answer(name, res, want[name])
                    miss.append(ms)
                for _ in range(SESSION_REPS):
                    store.clear_result_cache()
                    res, *ms = split.run(lambda sql=sql: s.execute(sql))
                    if s._last_plan_cache[0] != "hit":
                        raise SystemExit(f"phase 11 {name}: plan cache {s._last_plan_cache} on a repeat")
                    session_answer(name, res, want[name])
                    hit.append(ms)
                med = lambda rows: [statistics.median(c) for c in zip(*rows)]  # noqa: E731
                timings[(name, tier)] = (med(miss), med(hit))
                if profile and tier == "batch" and name == "q22_cntry":
                    store.clear_result_cache()
                    host_profile(f"phase 11 {name} ({tier})", lambda sql=sql: s.execute(sql))
                (mt, mp, mpl, mr), (ht, hp, hpl, hr) = timings[(name, tier)]
                log(f"phase 11 {name} ({tier}): {what} == numpy; median of {SESSION_REPS} runs, result cache cleared:"
                    f" plan-cache miss {mt:.3f} ms (parse {mp:.3f}, plan {mpl:.3f}, execute_root {mr:.3f}),"
                    f" hit {ht:.3f} ms (parse {hp:.3f}, plan {hpl:.3f}, execute_root {hr:.3f}) [{card}]")
        s.execute("SET tidb_allow_batch_cop = 0")
        # PREPARE / EXECUTE, the second EXECUTE a plan-cache hit
        for name, (text, arg) in SESSION_STATEMENTS.items():
            s.execute(f"PREPARE p_{name} FROM '{text.format(d='?').replace(chr(39), chr(39) * 2)}'")
            s.execute(f"SET @p_{name} = {arg}")

            def executed(name=name):
                out = []
                for _ in range(2):
                    store.clear_result_cache()
                    res, *ms = split.run(lambda: s.execute(f"EXECUTE p_{name} USING @p_{name}"))
                    session_answer(name, res, want[name])
                    out.append((s._last_plan_cache, ms))
                return out

            runs = counters.path(f"{name} (prepared)", executed, need=(need[name],) if name in need else (), phase=11)
            if runs[1][0][0] != "hit":
                raise SystemExit(f"phase 11 {name}: the second EXECUTE was a plan-cache {runs[1][0]}")
            (_pc0, (t1, p1, pl1, r1)), (_pc1, (t2, p2, pl2, r2)) = runs
            log(f"phase 11 {name} (PREPARE / EXECUTE): == numpy twice; first EXECUTE {runs[0][0][0]} {t1:.3f} ms"
                f" (plan {pl1:.3f}, execute_root {r1:.3f}), second a hit {t2:.3f} ms (plan {pl2:.3f},"
                f" execute_root {r2:.3f}) [{card}]")
        if oracle_calls[0]:
            raise SystemExit(f"phase 11: the root's row oracle answered {oracle_calls[0]} times")
    finally:
        split.close()
        EX.run_dag_reference, EXP.run_dag_reference = real_oracle
    st = store.stats()
    if st["oracle_fallbacks"] or st["other_errors"] or st["batch_fallbacks"]:
        raise SystemExit(f"phase 11: store fell back or failed ({st})")

    # transactions on a fresh table: every committed write read back
    # through the coprocessor (a GROUP BY, not a point get)
    s2 = Session(store=store, catalog=s.catalog, device=DEVICE)
    s.execute("CREATE TABLE acct (id BIGINT PRIMARY KEY, g BIGINT NOT NULL, v BIGINT NOT NULL)")
    model = {i: [i % 5, i] for i in range(SESSION_ACCT_ROWS)}
    s.execute("INSERT INTO acct VALUES " + ", ".join(f"({i}, {g}, {v})" for i, (g, v) in model.items()))
    acct = s.catalog.table("acct").table_id
    store.cluster.split(codec.record_prefix(acct))
    store.cluster.split(codec.encode_row_key(acct, SESSION_ACCT_ROWS // 2))
    read = "SELECT g, count(*), sum(v) FROM acct GROUP BY g"

    def check_read(sess, m, what):
        got = {r[0].val: (int(r[1].val), int(str(r[2].val))) for r in sess.execute(read).rows}
        exp = {}
        for g, v in m.values():
            c, sm = exp.get(g, (0, 0))
            exp[g] = (c + 1, sm + v)
        if got != exp:
            raise SystemExit(f"phase 11 txn {what}: read {got}, the acknowledged writes give {exp}")

    hits0 = store.stats()["result_cache_hits"]
    check_read(s, model, "warm")
    check_read(s, model, "warm again")
    if store.stats()["result_cache_hits"] <= hits0:
        raise SystemExit("phase 11 txn: the repeated read was not a result-cache hit")
    before = {k: list(v) for k, v in model.items()}
    s2.execute("BEGIN")
    check_read(s2, before, "s2's snapshot")
    s.execute("BEGIN")
    s.execute("INSERT INTO acct VALUES (100000, 1, 7), (100001, 2, 9)")
    s.execute("UPDATE acct SET v = v + 1000 WHERE id < 100")
    s.execute("DELETE FROM acct WHERE id >= 2000 AND id < 2010")
    s.execute("COMMIT")
    model[100000], model[100001] = [1, 7], [2, 9]
    for i in range(100):
        model[i][1] += 1000
    for i in range(2000, 2010):
        del model[i]
    check_read(s, model, "after COMMIT")
    check_read(s2, before, "s2 inside its earlier txn")
    s2.execute("COMMIT")
    s2.execute("BEGIN")
    check_read(s2, model, "s2 after its own BEGIN")
    s2.execute("COMMIT")
    s.execute("SET tidb_txn_mode = 'optimistic'")
    s.execute("BEGIN")
    s.execute("UPDATE acct SET v = v + 1 WHERE id = 1")
    s2.execute("UPDATE acct SET v = v + 2 WHERE id = 1")
    model[1][1] += 2
    try:
        s.execute("COMMIT")
        raise SystemExit("phase 11 txn: the optimistic commit over a newer write did not conflict")
    except SQLError as exc:
        conflict = str(exc)
    check_read(s, model, "after the conflict")
    s.execute("SET tidb_txn_mode = 'pessimistic'")
    s.execute("BEGIN")
    s.execute("UPDATE acct SET v = v + 5 WHERE id = 2")
    try:
        s2.execute("UPDATE acct SET v = v + 6 WHERE id = 2")
        raise SystemExit("phase 11 txn: a pessimistic lock did not block a second writer")
    except SQLError as exc:
        locked = str(exc)
    s.execute("COMMIT")
    model[2][1] += 5
    check_read(s2, model, "after the pessimistic COMMIT")
    st = store.stats()
    if st["oracle_fallbacks"] or st["other_errors"] or st["batch_fallbacks"]:
        raise SystemExit(f"phase 11 txn: store fell back or failed ({st})")
    log(f"phase 11 txn: BEGIN / INSERT / UPDATE / DELETE / COMMIT read back after the result cache was warm;"
        f" an earlier snapshot did not see the commit until its own BEGIN; SQLError on a write conflict"
        f" ({conflict!r}) and on a held lock ({locked!r})")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s; store {st}")
    return s


# ---------------------------------------------------------------------------
# phase 12: the device mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4                 # shards of one card: mesh_devices = ["cuda:0"] * 4
MESH_REPS = 3
MESH_Q3_GROUPS = 1 << 17        # Q3's 70,670 groups at 2^21 rows: the store's group capacity for its frame
MESH_OKEY_GROUPS = 1 << 19      # GROUP BY l_orderkey's 514,729 groups (and a shard's Partial1 table)
MESH_JOIN_BUILD = 1 << 16       # the join 1:32's build: the first 2^16 order keys
MESH_JOIN_GROUPS = JOIN_GROUPS  # its payload's groups (bench.py's ladder section)
MESH_OKEY_REPS = 1              # GROUP BY l_orderkey: one run a path (its 514,729-row Result takes 10-14 s)
MPP_COUNTERS = ("MPP_SELECTS", "MPP_FALLBACKS", "MESH_SELECTS", "MPP_FRAGMENTS", "MPP_TASKS", "MPP_EXCHANGED_BYTES",
                "DISTSQL_RETRIES")
MESH_SESSION = {
    # name: (statement, tidb_tpu_group_capacity); no ORDER BY, whose Sort
    # keeps a plan off the mesh select
    "q1": (Q1_SELECT.format(d="'1998-09-02'"), 4096),
    "okey": ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)), count(*) FROM lineitem"
             " GROUP BY l_orderkey", MESH_OKEY_GROUPS),
    "distinct": ("SELECT l_returnflag, l_linestatus, count(DISTINCT l_orderkey), count(*) FROM lineitem"
                 " GROUP BY l_returnflag, l_linestatus", MESH_OKEY_GROUPS),
    "join": ("SELECT o_orderdate, count(*), sum(l_extendedprice) FROM lineitem JOIN orders"
             " ON l_orderkey = o_orderkey GROUP BY o_orderdate", 4096),
}


def bitu_statement(E, X, T, W, tid: int):
    """BIT_AND / BIT_OR / BIT_XOR(l_orderkey), MIN / MAX of an unsigned
    BIGINT (l_orderkey with its low bit moved to the top bit: half the
    values above 2^63) and COUNT(*), no GROUP BY: on the mesh tier its
    partial states merge by a gather (the bit states) and in the
    sign-flipped domain (the unsigned extremes)."""
    LL, ULL = T.new_longlong(notnull=True), T.new_longlong(unsigned=True)
    scan = E.TableScan(tid, (E.ColumnInfo(W.LINEITEM_COL_IDS["okey"], LL),))
    okey = X.col(0, LL)
    top = X.func("shiftleft", ULL, X.func("bitand", ULL, okey, X.lit(1, LL)), X.lit(63, LL))
    u = X.func("bitxor", ULL, okey, top)
    A = X.AggDesc
    aggs = (A("bit_and", (okey,)), A("bit_or", (okey,)), A("bit_xor", (okey,)), A("min", (u,)), A("max", (u,)),
            A("count", ()))
    return E.DAGRequest((scan, E.Aggregation(group_by=(), aggs=aggs)), output_offsets=tuple(range(len(aggs))))


def numpy_bitu(t) -> list:
    import numpy as np

    okey = t["okey"]
    u = okey.astype(np.uint64) ^ ((okey & 1).astype(np.uint64) << np.uint64(63))
    m64 = (1 << 64) - 1
    return [int(np.bitwise_and.reduce(okey)) & m64, int(np.bitwise_or.reduce(okey)) & m64,
            int(np.bitwise_xor.reduce(okey)) & m64, int(u.min()), int(u.max()), len(okey)]


def decoded_bitu(chunk) -> list:
    return [int(c.data[0]) & ((1 << 64) - 1) for c in chunk.columns]


def chunk_values(chunk) -> list:
    """A chunk's rows as plain values (the mesh and batch answers compared)."""
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in chunk.rows()]


def mesh_phase(src, E, X, T, W, counters, profile: bool, card: str, line_sizes: list) -> None:
    """Phase 12: the device mesh on the card (see the module docstring)."""
    import numpy as np
    import torch

    import tidb_tpu_torch.chunk as C
    import tidb_tpu_torch.exec.executor as EX
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.distsql import KVRequest, execute_root, full_table_ranges, select, split_dag
    from tidb_tpu_torch.mpp import dispatch as mppd
    from tidb_tpu_torch.parallel.sql import try_mesh_select
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.store import CopRequest, TPUStore
    from tidb_tpu_torch.util import metrics, tracing

    t0 = time.perf_counter()
    lead = torch.device(DEVICE, 0) if torch.device(DEVICE).type == "cuda" else torch.device(DEVICE)
    shards = [str(lead)] * MESH_SHARDS
    store = TPUStore(device=DEVICE, mesh_devices=shards)
    tids = {name: src.catalog.table(name).table_id for name in ("lineitem", "orders")}
    bounds = np.cumsum(line_sizes)[:-1].tolist()
    for name, handles in (("lineitem", bounds), ("orders", [SESSION_ORDERS // 2])):
        store.cluster.split(codec.record_prefix(tids[name]))
        for h in handles:
            store.cluster.split(codec.encode_row_key(tids[name], h))
    # the session store's encoded pairs, through bulk_ingest (no re-encoding)
    h0 = hook_seconds(store)
    n_line = copy_table(src.store, tids["lineitem"], store, tids["lineitem"])
    n_ord = copy_table(src.store, tids["orders"], store, tids["orders"])
    if (n_line, n_ord) != (STORE_ROWS, SESSION_ORDERS):
        raise SystemExit(f"phase 12: copied {n_line} lineitem and {n_ord} orders rows")
    regions = len(line_sizes)
    lanes = -(-regions // MESH_SHARDS) * MESH_SHARDS
    log(f"phase 12 load: lineitem {n_line} rows in {regions} regions (padded to {lanes} lanes, {lanes // MESH_SHARDS}"
        f" a shard) and orders {n_ord} rows copied into a TPUStore(mesh_devices={shards}) in"
        f" {time.perf_counter() - t0:.2f} s (the store's write hooks {hook_seconds(store) - h0:.2f} s of it)")

    t = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    tid = tids["lineitem"]
    ranges = full_table_ranges(tid)

    def rebind(dag):
        """A workloads DAG over the catalog's lineitem table (its column ids
        are the workloads' own)."""
        import dataclasses

        sc = dag.executors[0]
        return dataclasses.replace(dag, executors=(dataclasses.replace(sc, table_id=tid),) + tuple(dag.executors[1:]))

    stmts = W.store_statements(E, X, T)
    shifts = statement_shifts(E, T, stmts)
    dags = W.store_dags(E, X, T)
    q3_dag, q3_fts = dags["q3"]
    q3_build = W.store_q3_build_columns(STORE_ORDERS, STORE_CUSTOMERS)
    q3_aux = [W.make_chunk(C, f, c) for c, f in zip(q3_build, q3_fts)]
    revenue = X.col(0, q3_dag.executors[-1].aggs[0].ft)
    q3_top = E.DAGRequest(q3_dag.executors + (E.TopN(order_by=((revenue, True),), limit=10),),
                          output_offsets=q3_dag.output_offsets)
    q3_want = numpy_q3([[W.fixed_col(t[k]) for k in ("okey", "price", "disc", "shipdate")]] + q3_build, T)
    entries = [("q6", rebind(stmts["q6"]), {}), ("q1", rebind(stmts["q1"]), {"small_groups": G}),
               ("bitu", bitu_statement(E, X, T, W, tid), {}),
               ("q3", rebind(q3_top), {"aux_chunks": q3_aux, "group_capacity": MESH_Q3_GROUPS}),
               ("topn", rebind(dags["topn"][0]), {})]
    # execute_root's push requests run at the store's default group
    # capacity (4096, as in the JAX package); Q3's 70,670 groups overflow
    # the mesh merge there and the store would degrade the group to the
    # batch tier. Its push half goes as one frame at MESH_Q3_GROUPS.
    framed = {"q3"}
    line_regions = store.cluster.regions_in_range(ranges[0].start, ranges[0].end)
    if len(line_regions) != regions:
        raise SystemExit(f"phase 12: {len(line_regions)} lineitem regions, not {regions}")
    need = {"q1": ("dense_agg",), "q3": ("postsort_segscan", "membership_segscan")}
    ts = store.next_ts()

    def answer(name, out) -> str:
        if name == "topn":
            check_rows(f"phase 12 {name}", out, numpy_order(t["price"], t["shipdate"], TOPN_K), t["price"],
                       t["shipdate"])
            return f"the first {TOPN_K} rows"
        if name == "q3":
            got = decoded_q3(out)
            top = sorted(q3_want.values(), reverse=True)[:10]
            if sorted(got.values(), reverse=True) != top or any(q3_want.get(k) != v for k, v in got.items()):
                raise SystemExit(f"phase 12 q3: the top 10 differ from numpy ({got})")
            return f"the top 10 of {len(q3_want)} groups"
        if name == "bitu":
            if decoded_bitu(out) != numpy_bitu(t):
                raise SystemExit(f"phase 12 bitu: {decoded_bitu(out)} != numpy {numpy_bitu(t)}")
            return "BIT_AND / OR / XOR, unsigned MIN / MAX, count"
        if decoded_statement(name, out) != numpy_statement(name, t, shifts):
            raise SystemExit(f"phase 12 {name}: the answer differs from numpy")
        return "(sum, count)" if name == "q6" else f"{out.num_rows()} groups"

    oracle_calls = [0]
    real_oracle = EX.run_dag_reference

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle(*a, **k)

    def clean(what, st0, o0, f0):
        st = store.stats()
        if any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks", "mesh_fallbacks")):
            raise SystemExit(f"phase 12 {what}: an oracle answer, an other_error or a fallback ({st})")
        if metrics.MESH_COP_FALLBACKS.value != f0:
            raise SystemExit(f"phase 12 {what}: MESH_COP_FALLBACKS moved by {metrics.MESH_COP_FALLBACKS.value - f0}")
        if oracle_calls[0] != o0:
            raise SystemExit(f"phase 12 {what}: the root's row oracle ran {oracle_calls[0] - o0} times")

    def run(dag, extra, mesh: bool, name=""):
        store.clear_result_cache()
        if name in framed:
            # the push half as one batch frame (mesh-marked or not) at the
            # statement's group capacity, the root half on the card
            gc = extra["group_capacity"]
            plan = split_dag(dag)
            reqs = [CopRequest(plan.push_dag, ranges, ts, r.region_id, r.epoch, list(extra.get("aux_chunks", [])),
                               small_groups=extra.get("small_groups"), mesh=mesh) for r in line_regions]
            resps = store.batch_coprocessor(reqs, group_capacity=gc)
            if any(x.chunk is None for x in resps):
                raise SystemExit(f"phase 12 {name}: {[x.other_error or x.region_error for x in resps]}")
            if mesh and [x.mesh_merged for x in resps] != [len(reqs)] * len(reqs):
                raise SystemExit(f"phase 12 {name}: mesh_merged {[x.mesh_merged for x in resps]}")
            return EX.run_dag_on_chunks(plan.root_dag, [C.Chunk.concat([x.chunk for x in resps])], group_capacity=gc,
                                        device=store.device, oracle_fallback=False)
        tier = {"mesh": True} if mesh else {"mesh": False, "batch_cop": True}
        return execute_root(store, dag, ranges, ts, **extra, **tier)

    def timed(fn, first=None, reps=MESH_REPS):
        """(median ms of `reps` runs, the first run's result); the first
        run is `first` (the checked main-path run) when given."""
        ms, out = [], None
        for i in range(reps):
            t1 = time.perf_counter()
            res = (first if i == 0 and first is not None else fn)()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            out = res if i == 0 else out
        return statistics.median(ms), out

    EX.run_dag_reference = counted_oracle
    try:
        # the store's mesh tier through execute_root
        for name, dag, extra in entries:
            t1 = time.perf_counter()
            st0, o0, f0 = store.stats(), oracle_calls[0], metrics.MESH_COP_FALLBACKS.value
            how = "one push frame + the root merge" if name in framed else "execute_root"
            out = counters.path(f"{how} {name} mesh", lambda: run(dag, extra, True, name), need=need.get(name, ()),
                                phase=12)
            st1 = store.stats()
            for k in need.get(name, ()):
                require_launches(f"phase 12 {name} {k}, once per shard", counters.last[k], MESH_SHARDS)
            if (st1["mesh_batches"] - st0["mesh_batches"], st1["mesh_lanes"] - st0["mesh_lanes"]) != (1, regions):
                raise SystemExit(f"phase 12 {name}: mesh batches / lanes {st0} -> {st1}, not 1 / {regions}")
            what = answer(name, out)
            clean(f"{name} mesh", st0, o0, f0)
            batch = run(dag, extra, False, name)
            answer(name, batch)
            if chunk_values(batch) != chunk_values(out):
                raise SystemExit(f"phase 12 {name}: the mesh tier's answer differs from the batch tier's")
            bs = None
            if name not in framed:
                plan = split_dag(dag)
                store.clear_result_cache()
                res = select(store, KVRequest(plan.push_dag, ranges, ts, small_groups=extra.get("small_groups"),
                                              aux_chunks=extra.get("aux_chunks", [])))
                bs = res.batch_stats
                if bs["mesh_batches"] < 1 or bs["mesh_lanes"] != regions:
                    raise SystemExit(f"phase 12 {name}: the push half's batch_stats {bs}")
            ms_mesh = timed(lambda: run(dag, extra, True, name))[0]
            ms_batch = timed(lambda: run(dag, extra, False, name))[0]
            clean(f"{name} timed", st0, o0, f0)
            log(f"phase 12 {name} ({time.perf_counter() - t1:.1f} s): {how} over {regions} regions on {MESH_SHARDS}"
                f" shards -> {what} == numpy"
                f" == the batch tier; batch_stats {bs}; median of {MESH_REPS}: mesh {ms_mesh:.3f} ms, batch"
                f" {ms_batch:.3f} ms [{card}]")
            if profile and name == "q1":
                profile_path("phase 12 q1 on the mesh tier", lambda: run(dag, extra, True, name), ms_mesh)
        if torch.cuda.device_count() > 1:
            # the default list, every visible card: Q1 over peer copies
            wide = TPUStore(device=DEVICE)
            wide.cluster.split(codec.record_prefix(tid))
            for h in bounds:
                wide.cluster.split(codec.encode_row_key(tid, h))
            copy_table(store, tid, wide, tid)
            q1, q1_extra = entries[1][1], entries[1][2]
            width = min(len(wide.mesh_devices), regions)
            t1 = time.perf_counter()
            out = counters.path("execute_root q1 on the default mesh",
                                lambda: execute_root(wide, q1, ranges, wide.next_ts(), mesh=True, **q1_extra),
                                need=need["q1"], phase=12)
            ms = (time.perf_counter() - t1) * 1e3
            require_launches("phase 12 q1 on the default mesh dense_agg, once per card", counters.last["dense_agg"],
                             width)
            if wide.stats()["mesh_batches"] != 1 or wide.stats()["mesh_fallbacks"]:
                raise SystemExit(f"phase 12 q1 on the default mesh: {wide.stats()}")
            log(f"phase 12 q1 on the default mesh ({len(wide.mesh_devices)} cards visible, {width} wide):"
                f" {answer('q1', out)} == numpy in {ms:.3f} ms (one run, the program built) [{card}]")
        else:
            log("phase 12: one card visible: the default mesh (every visible card) is 1 wide and declines; the"
                f" {MESH_SHARDS} shards above share it")

        # the session's exchange statements: the MPP tier (tidb_allow_mpp
        # ON, the default: try_mpp_select, the fragment plan through the
        # wire frames, the probe scan through select), the mesh select
        # (tidb_allow_mpp OFF) and the batch tier (the mesh off)
        from tidb_tpu_torch.codec.wire import encode_fragment_plan
        from tidb_tpu_torch.mpp.fragment import fragment_plan
        from tidb_tpu_torch.parser import parse_one
        from tidb_tpu_torch.sql import plan_select
        from tidb_tpu_torch.util import failpoint

        s = Session(store=store, catalog=src.catalog, device=DEVICE)
        _okey, _ocust, odate = (c[0] for c in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
        want = session_mesh_answers(t, odate, T)
        tiers = {"mpp": (1, 0, 1), "mesh": (0, 0, 1)}  # (MPP_SELECTS, MPP_FALLBACKS, MESH_SELECTS) a run

        def mpp_counts() -> dict:
            return {k: getattr(metrics, k).value for k in MPP_COUNTERS}

        for name, (sql, gc) in MESH_SESSION.items():
            s.execute(f"SET tidb_tpu_group_capacity = {gc}")
            reps = MESH_OKEY_REPS if name == "okey" else MESH_REPS

            def on_tier(tier, sql=sql, name=name):
                """One run on `tier`, its counters held to the tier's."""
                store.clear_result_cache()
                c0 = mpp_counts()
                res = s.execute(sql)
                d = {k: v - c0[k] for k, v in mpp_counts().items()}
                if (d["MPP_SELECTS"], d["MPP_FALLBACKS"], d["MESH_SELECTS"]) != tiers[tier]:
                    raise SystemExit(f"phase 12 session {name} ({tier}): counters moved by {d}, not "
                                     f"(MPP_SELECTS, MPP_FALLBACKS, MESH_SELECTS) = {tiers[tier]}")
                return res, d

            def first_on(tier, name=name):
                # the main path: counters zeroed around it, its exchanges
                # read from the trace's spans
                with tracing.trace(f"session {name} {tier}") as root:
                    res, d = counters.path(f"session {name} {tier}", lambda: on_tier(tier), phase=12)
                moved[tier] = (exchange_spans(root), d, len(root.find("mpp.dispatch")))
                return res

            t1 = time.perf_counter()
            st0, o0, f0 = store.stats(), oracle_calls[0], metrics.MESH_COP_FALLBACKS.value
            moved = {}
            dag = plan_select(parse_one(sql), s.catalog).dag
            frame = encode_fragment_plan(fragment_plan(dag, n_tasks=MESH_SHARDS))
            answers, ms = {}, {}
            for tier in ("mpp", "mesh"):
                s.execute(f"SET tidb_allow_mpp = {'ON' if tier == 'mpp' else 'OFF'}")
                # the first run of each tier is checked against numpy, and
                # every run is timed (a 514,729-row Result takes seconds)
                ms[tier], res = timed(lambda tier=tier: on_tier(tier)[0], first=lambda tier=tier: first_on(tier),
                                      reps=reps)
                what = session_mesh_answer(name, res, want[name], T)
                answers[tier] = sorted(tuple(None if d.is_null() else str(d.val) for d in r) for r in res.rows)
            s.execute("SET tidb_allow_mpp = ON")
            if answers["mpp"] != answers["mesh"]:
                raise SystemExit(f"phase 12 session {name}: the MPP tier's answer differs from the mesh select's")
            clean(f"session {name}", st0, o0, f0)
            rung = mppd.ladder_rung(dag, MESH_SHARDS, gc)
            s.execute("SET tidb_enable_tpu_mesh = 0")
            s.execute("SET tidb_allow_batch_cop = 1")
            ms_batch, res = timed(lambda sql=sql: (store.clear_result_cache(), s.execute(sql))[1], reps=reps)
            session_mesh_answer(name, res, want[name], T)
            s.execute("SET tidb_enable_tpu_mesh = 1")
            s.execute("SET tidb_allow_batch_cop = 0")
            clean(f"session {name} timed", st0, o0, f0)
            ex, d, spans = moved["mpp"]
            log(f"phase 12 session {name}: the MPP tier -> {what} == numpy == the mesh select; fragment plan frame"
                f" {len(frame)} B, {spans} mpp.dispatch span; MPP_FRAGMENTS +{d['MPP_FRAGMENTS']}, MPP_TASKS"
                f" +{d['MPP_TASKS']}, MPP_EXCHANGED_BYTES +{d['MPP_EXCHANGED_BYTES']}; ladder rung (group"
                f" capacity, scale) {rung}; exchanges {ex['exchanges']}, {ex['bytes']} B of send buckets, bucket"
                f" capacities {ex['bucket_caps']}; each shard's local join {sorted({str(j) for j in ex['joins']})};"
                f" median of {reps}: MPP {ms['mpp']:.3f} ms, mesh select {ms['mesh']:.3f} ms, batch tier"
                f" {ms_batch:.3f} ms [{card}] ({time.perf_counter() - t1:.1f} s)")
            if profile and name == "join":
                profile_path("phase 12 session join on the MPP tier", lambda: on_tier("mpp"), ms["mpp"])
        # the MPP tier's failure discipline on Q1's GROUP BY: a lost
        # dispatch and a stalled exchange are counted fallbacks that the
        # mesh select answers; an injected epoch error in the probe scan
        # is retried by the dispatch loop and MPP still serves
        sql, gc = MESH_SESSION["q1"]
        s.execute(f"SET tidb_tpu_group_capacity = {gc}")
        for fp_name, hits, moves in (("mpp/dispatch-lost", True, {"MPP_FALLBACKS": 1, "MPP_SELECTS": 0}),
                                     ("mpp/exchange-stall", True, {"MPP_FALLBACKS": 1, "MPP_SELECTS": 0}),
                                     ("cop-region-error", 1, {"DISTSQL_RETRIES": 1, "MPP_SELECTS": 1,
                                                              "MPP_FALLBACKS": 0})):
            st0, o0, f0 = store.stats(), oracle_calls[0], metrics.MESH_COP_FALLBACKS.value
            store.clear_result_cache()
            c0 = mpp_counts()
            with failpoint.enabled(fp_name, hits):
                res = s.execute(sql)
            d = {k: v - c0[k] for k, v in mpp_counts().items()}
            if any(d[k] != v for k, v in moves.items()) or d["MESH_SELECTS"] != 1:
                raise SystemExit(f"phase 12 {fp_name}: counters moved by {d}, expected {moves} and MESH_SELECTS 1")
            what = session_mesh_answer("q1", res, want["q1"], T)
            clean(f"session q1 under {fp_name}", st0, o0, f0)
            log(f"phase 12 session q1 with {fp_name} armed ({hits}): {what} == numpy; counters moved by {d}")
        s.execute("SET tidb_tpu_group_capacity = 4096")

        # the join 1:32 through try_mesh_select, the build as aux_chunks
        jdag, (_l, ofts) = W.join_bench_dag(E, X, T, groups=MESH_JOIN_GROUPS, v_ft=T.new_decimal(15, 2))
        jdag = W.store_scan(E, jdag, ("okey", "price"), table_id=tid)
        jcols = W.store_join_build_columns(MESH_JOIN_BUILD, MESH_JOIN_GROUPS)
        jbuild = W.make_chunk(C, ofts, jcols[0])
        jwant = numpy_join([[W.fixed_col(t["okey"]), W.fixed_col(t["price"])]] + jcols, True)

        def join132():
            store.clear_result_cache()
            m0 = metrics.MESH_SELECTS.value
            out = try_mesh_select(store, jdag, ranges, store.next_ts(), group_capacity=4096, aux_chunks=[jbuild])
            if out is None or metrics.MESH_SELECTS.value != m0 + 1:
                raise SystemExit("phase 12 join 1:32: try_mesh_select declined (execute_exchange_plan returned None)")
            return out

        st0, o0, f0 = store.stats(), oracle_calls[0], metrics.MESH_COP_FALLBACKS.value
        with tracing.trace("join 1:32") as root:
            out = counters.path("join 1:32 mesh select", join132, phase=12)
        moved = exchange_spans(root)
        plans = {j.get("radix_plan") for j in moved["joins"]}
        if len(plans) != 1:
            raise SystemExit(f"phase 12 join 1:32: the shards' local joins took {moved['joins']}")
        jplan = plans.pop()
        if decoded_join(out, True) != jwant:
            raise SystemExit("phase 12 join 1:32: the answer differs from numpy")
        clean("join 1:32", st0, o0, f0)
        k4 = counters.last["probe_tables"]
        from tidb_tpu_torch.ops.join_probe import probe_kernel_eligible

        gate = jplan is not None and probe_kernel_eligible(*jplan[:3])
        if gate:
            require_launches("phase 12 join 1:32 probe_tables, once per shard", k4, MESH_SHARDS)
        ms = timed(join132)[0]
        log(f"phase 12 join 1:32 (build {MESH_JOIN_BUILD} rows, {MESH_JOIN_GROUPS} groups): == numpy"
            f" ({len(jwant)} groups); each shard's local join {moved['joins'][0]}: radix plan"
            f" {jplan or 'none (the sort-merge join)'} (n_parts, part_cap, probe_cap, esc_cap), K4's gate"
            f" {'passes' if gate else 'fails'}, probe_tables launches {k4};"
            f" exchanges {moved['exchanges']}, {moved['bytes']} B, bucket capacities {moved['bucket_caps']};"
            f" median of {MESH_REPS}: {ms:.3f} ms [{card}]")
    finally:
        EX.run_dag_reference = real_oracle
    log(f"phase 12: {time.perf_counter() - t0:.1f} s; store {store.stats()}")


def exchange_spans(root) -> dict:
    """The exchanges and local joins a traced mesh run made
    (mpp/exchange_op.py's `mpp.exchange` and `mpp.local_join` spans)."""
    ex = root.find("mpp.exchange")
    return {"exchanges": len(ex), "bytes": sum(sp.attrs.get("bytes", 0) for sp in ex),
            "bucket_caps": [sp.attrs["bucket_cap"] for sp in ex],
            "joins": [dict(sp.attrs) for sp in root.find("mpp.local_join")]}


def session_mesh_answers(t, odate, T) -> dict:
    """The exact answers of MESH_SESSION over the generated columns."""
    import numpy as np

    out = {"q1": numpy_session_q1(t, T)}
    out["okey"] = _sum_by(t["okey"], t["price"] * (100 - t["disc"]))
    gid = t["rflag"].astype(np.int64) * 2 + t["lstat"].astype(np.int64)
    out["distinct"] = {("ANR"[g // 2], "OF"[g % 2]): (len(np.unique(t["okey"][gid == g])), int((gid == g).sum()))
                       for g in np.unique(gid)}
    out["join"] = {d: (c, s) for d, (s, c) in _sum_by(odate[t["okey"]], t["price"]).items()}
    return out


def session_mesh_answer(name, res, want, T, where: str = "phase 12") -> str:
    rows = res.rows
    if name == "q1":
        return session_answer("q1", res, want)
    if name == "okey":
        got = {int(r[0].val): (_scaled(r[1], 4), int(r[2].val)) for r in rows}
    elif name == "distinct":
        got = {(r[0].val, r[1].val): (int(r[2].val), int(r[3].val)) for r in rows}
    else:
        got = {r[0].val.packed: (int(r[1].val), _scaled(r[2], 2)) for r in rows}
    if got != want:
        bad = next((k for k in want if got.get(k) != want[k]), None)
        raise SystemExit(f"{where} session {name}: {len(got)} groups, numpy {len(want)}; first difference at {bad}:"
                         f" {got.get(bad)} != {want.get(bad)}")
    return f"{len(got)} groups"


# ---------------------------------------------------------------------------
# phase 13: the control plane
# ---------------------------------------------------------------------------

CONTROL_STORES = 3               # logical placement stores: three peers a region
CONTROL_REPS = 3
CONTROL_SPLIT_SIZE = 96 << 20    # TiKV's documented region-split-size (bytes)
CONTROL_SPLIT_KEYS = 960_000     # TiKV's documented region-split-keys (the setup's; no region is near it)
CONTROL_STORM_KEYS = 1 << 17     # the storm's key limit: every 2^18-row region splits in two
CONTROL_STORM_TICK = 0.05        # seconds between the PD timer's ticks during the storm
CONTROL_STORM_SECONDS = 60.0     # the storm's deadline
CONTROL_UPDATE_KEYS = 64         # the gated UPDATE touches the lineitem rows with l_orderkey below this
CONTROL_STATEMENTS = ("q1", "q6", "q3")


def region_errors(metrics, kind: str) -> int:
    return metrics.REGISTRY.counter_vec("tidb_tpu_region_errors_total", labelnames=("kind",)).labels(kind).value


def control_phase(sess, E, X, T, W, counters, profile: bool, card: str) -> dict:
    """Phase 13: the control plane on phase 11's session and store (see the
    module docstring). Returns the numpy answers of SESSION_STATEMENTS over
    the tables as it leaves them (phase 15 reads them)."""
    import numpy as np

    import tidb_tpu_torch.exec as EXP
    import tidb_tpu_torch.exec.executor as EX
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.codec import record_prefix
    from tidb_tpu_torch.replication import QUORUM_SAFE_TS_MAX
    from tidb_tpu_torch.util import failpoint, metrics

    t0 = time.perf_counter()
    s, store = sess, sess.store
    pd, repl = store.pd, store.replication
    tids = {name: s.catalog.table(name).table_id for name in ("lineitem", "orders", "customer")}

    def table_regions(name):
        tid = s.catalog.table(name).table_id
        lo, hi = record_prefix(tid), record_prefix(tid + 1)
        return store.cluster.regions_in_range(lo, hi)

    def follower_reads() -> int:
        return metrics.REPLICA_READS.labels("follower").value

    oracle_calls = [0]
    real_oracle = (EX.run_dag_reference, EXP.run_dag_reference)

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle[0](*a, **k)

    st_start = store.stats()

    def clean(what):
        st = store.stats()
        if st["oracle_fallbacks"] != st_start["oracle_fallbacks"] or st["other_errors"] != st_start["other_errors"]:
            raise SystemExit(f"phase 13 {what}: an oracle answer or an other_error ({st})")
        if oracle_calls[0]:
            raise SystemExit(f"phase 13 {what}: the root's row oracle ran {oracle_calls[0]} times")

    t = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    cust = W.store_customer(EXPR_ROWS)
    okey, _ocust, odate = (c[0] for c in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
    want = numpy_sql(t, cust, (okey, odate), T)
    need = {"q1": "dense_agg", "q3": "postsort_segscan"}

    def run(name, what, checked=True, main=False):
        """One run of a SESSION_STATEMENTS statement, its answer held to
        numpy; on the main path, with the launch counters around it."""
        text, arg = SESSION_STATEMENTS[name]
        sql = text.format(d=arg)

        def once():
            store.clear_result_cache()
            res = s.execute(sql)
            return res, session_answer(name, res, want[name]) if checked else ""

        if main:
            return counters.path(f"{name} ({what})", once, need=(need[name],) if name in need else (), phase=13)
        return once()

    def median_run(name, what) -> float:
        ms = []
        for _ in range(CONTROL_REPS):
            t1 = time.perf_counter()
            run(name, what)
            ms.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ms)

    EX.run_dag_reference = EXP.run_dag_reference = counted_oracle
    try:
        # setup: three peers a region over three logical placement stores,
        # TiKV's split thresholds (no region is near them), one PD tick
        pd.conf.max_region_size, pd.conf.max_region_keys = CONTROL_SPLIT_SIZE, CONTROL_SPLIT_KEYS
        store.cluster.set_stores(CONTROL_STORES)
        n_regions0 = len(store.cluster.regions())
        ops0 = pd.tick()
        rows = s.execute("SHOW PLACEMENT").rows
        peers = {len(store.cluster.peers_of(r.region_id)) for r in store.cluster.regions()}
        if peers != {CONTROL_STORES}:
            raise SystemExit(f"phase 13: peer-set sizes {peers}, not {CONTROL_STORES}")
        log(f"phase 13 setup: {n_regions0} regions over {CONTROL_STORES} stores, {CONTROL_STORES} peers each; one PD"
            f" tick dispatched {sorted(collections.Counter(o.kind for o in ops0).items())}; SHOW PLACEMENT"
            f" {len(rows)} rows; leaders per store {store.cluster.counts_per_store()}")

        # follower reads beside leader reads, in the pool and batch tiers
        t1 = time.perf_counter()
        for tier in ("pool", "batch"):
            s.execute(f"SET tidb_allow_batch_cop = {1 if tier == 'batch' else 0}")
            for name in CONTROL_STATEMENTS:
                s.execute("SET tidb_replica_read = 'leader'")
                leader_res, _ = run(name, f"leader read, {tier}")
                ms_leader = median_run(name, tier)
                s.execute("SET tidb_replica_read = 'follower'")
                f0, d0 = follower_reads(), region_errors(metrics, "data_not_ready")
                res, what = run(name, f"follower read, {tier}", main=True)
                if follower_reads() <= f0:
                    raise SystemExit(f"phase 13 {name} ({tier}): no follower read was counted")
                if sorted(map(str, res.values())) != sorted(map(str, leader_res.values())):
                    raise SystemExit(f"phase 13 {name} ({tier}): the follower read differs from the leader read")
                ms_follower = median_run(name, tier)
                clean(f"{name} follower read ({tier})")
                log(f"phase 13 {name} ({tier}): the follower read -> {what} == numpy == the leader read;"
                    f" REPLICA_READS{{follower}} +{follower_reads() - f0} over {1 + CONTROL_REPS} runs,"
                    f" data_not_ready +{region_errors(metrics, 'data_not_ready') - d0}; median of {CONTROL_REPS}:"
                    f" follower {ms_follower:.3f} ms, leader {ms_leader:.3f} ms [{card}]")
        s.execute("SET tidb_allow_batch_cop = 0")
        log(f"phase 13 follower reads: {time.perf_counter() - t1:.1f} s")

        # failover: the leader store of lineitem's first region goes down;
        # leader reads fail its regions over by leader transfer (three
        # peers, two alive: quorum holds)
        t1 = time.perf_counter()
        s.execute("SET tidb_replica_read = 'leader'")
        user_tables = [n for n in s.catalog.tables() if not n.startswith("mysql")]
        counts0 = {n: s.execute(f"SELECT count(*) FROM {n}").scalar() for n in user_tables}
        line = table_regions("lineitem")
        down = store.cluster.leader_of(line[0].region_id)
        f0, x0 = metrics.PD_FAILOVERS.value, metrics.PD_TRANSFER_LEADER.value
        peers0 = {r.region_id: store.cluster.peers_of(r.region_id) for r in store.cluster.regions()}
        hist0 = len(pd.queue.history_view())
        store.set_down(down)
        try:
            for name in ("q1", "q6"):
                _res, what = run(name, f"store {down} down", main=True)
                log(f"phase 13 failover {name}: -> {what} == numpy with store {down} down")
        finally:
            store.set_up(down)
        moved_placement = [r.region_id for r in store.cluster.regions()
                           if r.region_id in peers0 and store.cluster.peers_of(r.region_id) != peers0[r.region_id]]
        kinds = collections.Counter(o.kind for o in pd.queue.history_view()[hist0:])
        if metrics.PD_FAILOVERS.value <= f0 or metrics.PD_TRANSFER_LEADER.value <= x0:
            raise SystemExit(f"phase 13 failover: PD_FAILOVERS +{metrics.PD_FAILOVERS.value - f0}, PD_TRANSFER_LEADER"
                             f" +{metrics.PD_TRANSFER_LEADER.value - x0}")
        if moved_placement or kinds.get("failover"):
            raise SystemExit(f"phase 13 failover: a placement move ({moved_placement}, {kinds})")
        open_after = dict(store.breakers.states())
        pd.tick()
        # the tick re-closes the breaker of a store that leads no region; a
        # store that still leads some is re-closed by its own traffic (the
        # breaker's half-open probe): one count(*) of each table it leads
        probed = []
        for n in user_tables:
            sick = {sid for sid, st in store.breakers.states().items() if st != "closed"}
            if not sick:
                break
            if any(store.cluster.leader_of(r.region_id) in sick for r in table_regions(n)):
                got = s.execute(f"SELECT count(*) FROM {n}").scalar()
                if got != counts0[n]:
                    raise SystemExit(f"phase 13 failover: count(*) of {n} {got}, before {counts0[n]}")
                probed.append(n)
        if not store.breakers.all_closed():
            raise SystemExit(f"phase 13 failover: breakers {store.breakers.states()} after set_up, a tick and"
                             f" traffic to {probed}")
        clean("failover")
        log(f"phase 13 failover: PD_FAILOVERS +{metrics.PD_FAILOVERS.value - f0}, PD_TRANSFER_LEADER"
            f" +{metrics.PD_TRANSFER_LEADER.value - x0}, operators {sorted(kinds.items())}, no placement move;"
            f" breakers {open_after} after the queries; every breaker closed after set_up, a tick and the"
            f" half-open probes of count(*) over {probed}; leaders per store {store.cluster.counts_per_store()}"
            f" ({time.perf_counter() - t1:.1f} s)")

        # the safe_ts gate: a store whose apply loop lags may not serve a
        # snapshot past what it applied
        t1 = time.perf_counter()
        # the lagging store: the one the follower router will pick next (the
        # least read-loaded; the UPDATE's own scan adds a read at the
        # leader of each lineitem region)
        loads = repl.read_counts()
        for r in table_regions("lineitem"):
            lead = store.cluster.leader_of(r.region_id)
            loads[lead] = loads.get(lead, 0) + 1
        lag_store = min(range(CONTROL_STORES), key=lambda sid: (loads.get(sid, 0), sid))
        q1_name = "q1"
        with failpoint.enabled("replica/apply-lag", {lag_store}):
            # the UPDATE of l_quantity + 1 where l_orderkey < 64, committed
            # as one transaction of its rows through the store's Percolator
            # engine (the session's COMMIT path: the quorum gate, the flow
            # record, one replication proposal a region). SQL's UPDATE of a
            # table without a primary key scans every row to the host as
            # Datums first, about two minutes at 2^21 rows.
            touched = t["okey"] < CONTROL_UPDATE_KEYS
            t["qty"] = t["qty"] + np.where(touched, 100, 0)
            rows = [next(W.store_rows(T, t, h, h + 1)) for h in np.nonzero(touched)[0].tolist()]
            muts = dict(W.store_items(codec, rows, table_id=tids["lineitem"]))
            store.txn.commit_txn(muts, store.next_ts(), store.next_ts)
            want.update(numpy_sql(t, cust, (okey, odate), T))
            lagged = {r.region_id: repl.safe_ts(r.region_id, lag_store) for r in table_regions("lineitem")}
            gated = sum(1 for v in lagged.values() if v < store.kv.max_committed())
            if not gated:
                raise SystemExit(f"phase 13: no lineitem region of store {lag_store} lags ({lagged})")
            s.execute("SET tidb_replica_read = 'follower'")
            f0, d0 = follower_reads(), region_errors(metrics, "data_not_ready")
            res, what = run(q1_name, "follower read past a lagging store's safe_ts", main=True)
            dnr = region_errors(metrics, "data_not_ready") - d0
            if dnr < 1:
                raise SystemExit(f"phase 13: no DataIsNotReady from store {lag_store}'s lagging peers")
        clean("the safe_ts gate")
        pd.tick()
        lag = repl.lag_view()
        if any(lag.values()):
            raise SystemExit(f"phase 13: safe_ts lag {lag} after the catch-up tick")
        caught = {r.region_id: repl.safe_ts(r.region_id, lag_store) for r in table_regions("lineitem")}
        if any(v != QUORUM_SAFE_TS_MAX for v in caught.values()):
            raise SystemExit(f"phase 13: store {lag_store}'s safe_ts after the catch-up {caught}")
        loads = repl.read_counts()
        routed = min(range(CONTROL_STORES), key=lambda sid: (loads.get(sid, 0), sid)) == lag_store
        r0 = loads.get(lag_store, 0)
        d1 = region_errors(metrics, "data_not_ready")
        run(q1_name, "follower read after the catch-up")
        served = repl.read_counts().get(lag_store, 0) - r0
        if region_errors(metrics, "data_not_ready") != d1 or (routed and served < 1):
            raise SystemExit(f"phase 13: after the catch-up store {lag_store} served {served} reads, data_not_ready"
                             f" +{region_errors(metrics, 'data_not_ready') - d1}")
        log(f"phase 13 safe_ts gate: store {lag_store}'s apply lagged under the committed UPDATE of"
            f" {int(touched.sum())} rows"
            f" ({gated} of {len(lagged)} lineitem regions gated); the follower read at the new snapshot took"
            f" DataIsNotReady {dnr} times, retried and -> {what} == numpy on the updated rows; after disarm and a"
            f" tick the lag is {lag}, and store {lag_store} served {served} follower reads with no DataIsNotReady"
            f" ({time.perf_counter() - t1:.1f} s)")

        # PD scheduling during queries: the timer splits every region above
        # the storm's key limit while Q1 and Q6 run in the pool tier
        t1 = time.perf_counter()
        pd.conf.max_region_keys, pd.conf.max_region_size = CONTROL_STORM_KEYS, CONTROL_SPLIT_SIZE
        before = {name: len(table_regions(name)) for name in tids}
        n_before = len(store.cluster.regions())
        r0 = metrics.DISTSQL_RETRIES.value
        hist0 = len(pd.queue.history_view())
        e0 = {k: region_errors(metrics, k) for k in ("epoch_not_match", "not_leader")}

        def biggest() -> int:
            stats = pd.flow.stats()
            return max(stats.get(r.region_id, (0, 0))[1] for r in store.cluster.regions())

        timer = pd.timer(CONTROL_STORM_TICK).start()
        runs = 0
        try:
            deadline = time.perf_counter() + CONTROL_STORM_SECONDS
            while True:
                for name in ("q1", "q6"):
                    run(name, "the split storm")
                    runs += 1
                if biggest() <= CONTROL_STORM_KEYS:
                    break
                if time.perf_counter() > deadline:
                    raise SystemExit(f"phase 13 storm: a region of {biggest()} keys after {CONTROL_STORM_SECONDS} s")
        finally:
            timer.stop()
        if timer.error_count:
            raise SystemExit(f"phase 13 storm: the PD timer failed {timer.error_count} times ({timer.last_error})")
        for name in ("q1", "q6"):
            run(name, "after the split storm", main=True)
        after = {name: len(table_regions(name)) for name in tids}
        ops = collections.Counter((o.kind, o.state) for o in pd.queue.history_view()[hist0:])
        clean("the split storm")
        log(f"phase 13 split storm: {runs} statements == numpy while the PD timer ticked every {CONTROL_STORM_TICK} s"
            f" ({timer.fire_count} ticks); regions {n_before} -> {len(store.cluster.regions())} (by table {before}"
            f" -> {after}); the largest {biggest()} keys; operators {sorted(ops.items())}; DISTSQL_RETRIES"
            f" +{metrics.DISTSQL_RETRIES.value - r0}, region errors"
            f" {({k: region_errors(metrics, k) - v for k, v in e0.items()})} ({time.perf_counter() - t1:.1f} s)")
    finally:
        EX.run_dag_reference, EXP.run_dag_reference = real_oracle
        s.execute("SET tidb_replica_read = 'leader'")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s; store {store.stats()}")
    return want


# ---------------------------------------------------------------------------
# phase 14: change data capture and the columnar replica
# ---------------------------------------------------------------------------

CDC_ROWS = 1 << 18               # lineitem_r: the first 2^18 rows of phase 11's lineitem (2^19 until the
                                 # whole script outgrew its time limit)
CDC_REGIONS = 4
CDC_REPS = 3
CDC_DIR = os.path.join("build", "cdc_phase")  # the file changefeed's segments (ignored by git)
CDC_UPDATE_KEYS = 64             # the UPDATEs touch lineitem_r's rows with l_orderkey below this
CDC_NEW_ROWS = 16                # the transaction inserts phase 11's lineitem rows CDC_ROWS.. (handles kept)
CDC_DELETED_ROWS = 16            # and deletes the last 16 rows the UPDATE does not touch
CDC_STATEMENTS = ("q1", "q6", "q3", "topn")  # SESSION_STATEMENTS over lineitem_r


def cdc_sql(name: str) -> str:
    text, arg = SESSION_STATEMENTS[name]
    return text.format(d=arg).replace("FROM lineitem ", "FROM lineitem_r ")


class Calls:
    """Counts (and times) the calls of an attribute of `owner` while
    installed; `close` puts the original back."""

    def __init__(self, owner, name: str, sync: bool = False):
        import torch

        self.owner, self.name, self.real = owner, name, getattr(owner, name)
        self.calls, self.seconds = 0, 0.0

        def fn(*a, **k):
            self.calls += 1
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return self.real(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0

        setattr(owner, name, fn)

    def close(self):
        setattr(self.owner, self.name, self.real)


class ProgramRuns:
    """Counts the programs exec.executor.drive_program_info runs (the
    first and each overflow retry) for callers that look the function up
    at call time, as the columnar route does; the store's region path binds
    its own name and is not counted. `close` puts the original back."""

    def __init__(self, EX):
        self.EX, self.real, self.calls = EX, EX.drive_program_info, 0

        def drive(cache, *a, **k):
            real_get = cache.get_info

            def get_info(*aa, **kk):
                self.calls += 1
                return real_get(*aa, **kk)

            cache.get_info = get_info
            try:
                return self.real(cache, *a, **k)
            finally:
                del cache.get_info

        EX.drive_program_info = drive

    def close(self):
        self.EX.drive_program_info = self.real


def cdc_phase(src, snap_ts: int, E, X, T, W, counters, profile: bool, card: str):
    """Phase 14: change data capture and the columnar replica on the card
    (see the module docstring). `src` is phase 11's session; lineitem_r and
    orders are its rows as of `snap_ts`. With `profile`, a host profile of
    the overlay read. Returns the session and lineitem_r's model as it
    leaves it (phase 11's generated columns, the l_quantity it wrote and the
    live handles), for phase 16."""
    import shutil
    from decimal import Decimal

    import numpy as np
    import torch

    import tidb_tpu_torch.chunk.device as CD
    import tidb_tpu_torch.exec as EXP
    import tidb_tpu_torch.exec.executor as EX
    import tidb_tpu_torch.util.backoff as BO
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.cdc import Changefeed, FileSink
    from tidb_tpu_torch.parser import parse_one
    from tidb_tpu_torch.sql import Session, plan_select
    from tidb_tpu_torch.util import failpoint, metrics, tracing

    t0 = time.perf_counter()
    lead = torch.device(DEVICE, 0) if torch.device(DEVICE).type == "cuda" else torch.device(DEVICE)
    s = Session(device=DEVICE, mesh_devices=[str(lead)] * MESH_SHARDS)
    store = s.store
    # TiKV's split thresholds: the PD ticks below keep lineitem_r's regions
    store.pd.conf.max_region_size, store.pd.conf.max_region_keys = CONTROL_SPLIT_SIZE, CONTROL_SPLIT_KEYS
    s.execute(LINEITEM_DDL.replace("TABLE lineitem ", "TABLE lineitem_r "))
    s.execute(ORDERS_DDL)
    tid, o_tid = s.catalog.table("lineitem_r").table_id, s.catalog.table("orders").table_id
    for t_id, handles in ((tid, [CDC_ROWS // CDC_REGIONS * k for k in range(1, CDC_REGIONS)]),
                          (o_tid, [SESSION_ORDERS // 2])):
        store.cluster.split(codec.record_prefix(t_id))
        for h in handles:
            store.cluster.split(codec.encode_row_key(t_id, h))
    h0 = hook_seconds(store)
    n_line = copy_table(src.store, src.catalog.table("lineitem").table_id, store, tid, ts=snap_ts, hi=CDC_ROWS)
    n_ord = copy_table(src.store, src.catalog.table("orders").table_id, store, o_tid, ts=snap_ts)
    if (n_line, n_ord) != (CDC_ROWS, SESSION_ORDERS):
        raise SystemExit(f"phase 14: copied {n_line} lineitem_r and {n_ord} orders rows")
    log(f"phase 14 load: lineitem_r (phase 11's first {n_line} lineitem rows, {CDC_REGIONS} regions) and orders"
        f" ({n_ord} rows) copied into a Session(mesh_devices={[str(lead)] * MESH_SHARDS}) in"
        f" {time.perf_counter() - t0:.2f} s (the store's write hooks {hook_seconds(store) - h0:.2f} s of it)")

    # the model: lineitem_r's rows as numpy columns, kept in handle order
    full = W.store_lineitem(STORE_ROWS, STORE_ORDERS)
    okey, _ocust, odate = (c[0] for c in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
    qty = full["qty"].copy()
    live = np.arange(CDC_ROWS)

    def model() -> dict:
        return {k: (qty if k == "qty" else v)[live] for k, v in full.items()}

    want = numpy_lineitem_sql(model(), (okey, odate), T)
    os.makedirs(SESSION_DIR, exist_ok=True)
    stats_json = os.path.abspath(os.path.join(SESSION_DIR, "lineitem_r_stats.json"))
    with open(stats_json, "w") as f:
        json.dump({"table_name": "lineitem_r", "count": CDC_ROWS, "columns": {
            "l_returnflag": {"null_count": 0, "histogram": {"ndv": int(len(np.unique(full["rflag"][:CDC_ROWS])))}},
            "l_linestatus": {"null_count": 0, "histogram": {"ndv": int(len(np.unique(full["lstat"][:CDC_ROWS])))}}}},
            f)
    s.execute(f"LOAD STATS '{stats_json}'")
    hint = plan_select(parse_one(cdc_sql("q1")), s.catalog).small_groups
    if hint != G:
        raise SystemExit(f"phase 14: Q1's small-groups hint {hint}, not {G}")

    # the replica's birth: the changefeed's incremental scan and mount (pd.cdc),
    # the first compaction and its upload (pd.columnar)
    table = None

    def replica_view(what, state="normal") -> dict:
        """The table's view, held to a live, device-resident, error-free
        replica; and the feed's state to `state`."""
        v = table.view()
        got = store.columnar.feed_state(tid)
        if not v["on_device"] or v["error"] or got != state:
            raise SystemExit(f"phase 14 {what}: the replica's view {v}, its feed {got}")
        return v

    s.execute("ALTER TABLE lineitem_r SET COLUMNAR REPLICA 1")
    table = store.columnar.table_for(tid)
    upload = Calls(CD, "to_device_batch", sync=True)
    scan = Calls(Changefeed, "_recover_lost")
    try:
        t1 = time.perf_counter()
        store.pd.tick()
        tick_s = time.perf_counter() - t1
    finally:
        upload.close()
        scan.close()
    spans = {c.name: c.duration_ns / 1e9 for c in store.pd.last_tick_root.children}
    rows = s.execute("SHOW COLUMNAR TABLES").values()
    v = replica_view("birth")
    if [r[:5] for r in rows] != [["lineitem_r", "normal", 1, 0, CDC_ROWS]] or v["stable_rows"] != CDC_ROWS:
        raise SystemExit(f"phase 14 birth: SHOW COLUMNAR TABLES {rows}")
    batch = table._stable_batch
    if batch.device.type != torch.device(DEVICE).type or upload.calls != 1:
        raise SystemExit(f"phase 14 birth: the stable batch on {batch.device}, {upload.calls} uploads")
    log(f"phase 14 birth: one PD tick {tick_s:.2f} s: pd.cdc {spans['pd.cdc']:.2f} s (the incremental scan"
        f" {scan.seconds:.2f} s, then the mount and the apply of {v['applied_events']} events), pd.columnar"
        f" {spans['pd.columnar']:.2f} s (the fold and Chunk.from_rows, then the upload {upload.seconds:.3f} s of a"
        f" {batch.capacity}-row batch to {batch.device}); SHOW COLUMNAR TABLES {rows[0]}")

    oracle_calls = [0]
    real_oracle = (EX.run_dag_reference, EXP.run_dag_reference)

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle[0](*a, **k)

    st_start = store.stats()

    def clean(what):
        st = store.stats()
        if any(st[k] != st_start[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks")) or \
                oracle_calls[0]:
            raise SystemExit(f"phase 14 {what}: an oracle answer, an other_error or a bucket fallback ({st},"
                             f" root oracle {oracle_calls[0]})")

    chunks = Calls(EX, "run_dag_on_chunks")
    waits = Calls(BO.Backoffer, "backoff")
    runs = ProgramRuns(EX)
    need = {"q1": "dense_agg", "q3": "postsort_segscan"}

    def moved(fn):
        """(fn(), COLUMNAR_SCANS, COLUMNAR_FALLBACKS, run_dag_on_chunks
        calls, program runs, backoffs moved by it)."""
        c0 = (metrics.COLUMNAR_SCANS.value, metrics.COLUMNAR_FALLBACKS.value, chunks.calls, runs.calls, waits.calls)
        out = fn()
        c1 = (metrics.COLUMNAR_SCANS.value, metrics.COLUMNAR_FALLBACKS.value, chunks.calls, runs.calls, waits.calls)
        return (out,) + tuple(b - a for a, b in zip(c0, c1))

    def routed(name, what, scans=1, fallbacks=0, overlay=0, k1=1, backoffs=0):
        """One routed run of a statement on the main path: its answer held
        to numpy, the counters to what `what` must move, K1 / K2 to one
        launch a program run when the replica serves."""
        sql = cdc_sql(name)

        def once():
            store.clear_result_cache()
            return moved(lambda: s.execute(sql))

        res, d_scans, d_fb, d_chunks, d_runs, d_waits = counters.path(
            f"{name} ({what})", once, need=(need[name],) if name in need else (), phase=14)
        if (d_scans, d_fb, d_chunks, d_waits) != (scans, fallbacks, overlay, backoffs):
            raise SystemExit(f"phase 14 {name} ({what}): COLUMNAR_SCANS +{d_scans}, COLUMNAR_FALLBACKS +{d_fb},"
                             f" run_dag_on_chunks {d_chunks} calls, {d_waits} backoffs; not +{scans}, +{fallbacks},"
                             f" {overlay}, {backoffs}")
        for k, got in counters.last.items():
            k_want = 0
            if need.get(name) == k:
                k_want = k1 if k == "dense_agg" else d_runs
            require_launches(f"phase 14 {name} ({what}) {k}", got, k_want)
        return res, session_answer(name, res, want[name], where=f"phase 14 ({what})"), d_runs

    def host_ms(sql) -> float:
        ms = []
        for _ in range(CDC_REPS):
            store.clear_result_cache()
            t1 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ms)

    def engines(which):
        s.execute(f"SET tidb_isolation_read_engines = '{which}'")

    EX.run_dag_reference = EXP.run_dag_reference = counted_oracle
    try:
        # routed reads: execute_root's columnar branch (the MPP tier and the
        # mesh select off), each beside the row store's pool tier
        t1 = time.perf_counter()
        s.execute("SET tidb_allow_mpp = 0")
        s.execute("SET tidb_enable_tpu_mesh = 0")
        for name in CDC_STATEMENTS:
            engines("tpu,columnar")
            res, what, n_runs = routed(name, "routed")
            ms_routed = host_ms(cdc_sql(name))
            engines("tpu")
            store.clear_result_cache()
            row = s.execute(cdc_sql(name))
            session_answer(name, row, want[name], where="phase 14 (row store)")
            if sorted(map(str, row.values())) != sorted(map(str, res.values())):
                raise SystemExit(f"phase 14 {name}: the routed answer differs from the row store's")
            ms_row = host_ms(cdc_sql(name))
            clean(f"{name} routed")
            log(f"phase 14 {name}: routed to the replica -> {what} == numpy == the row store; COLUMNAR_SCANS +1,"
                f" COLUMNAR_FALLBACKS +0, run_dag_on_chunks 0 calls, {n_runs} program run(s) over the stable batch;"
                f" median of {CDC_REPS} runs, result cache cleared: routed {ms_routed:.3f} ms, row store (pool of 4,"
                f" {CDC_REGIONS} regions) {ms_row:.3f} ms [{card}]")
        log(f"phase 14 routed reads: {time.perf_counter() - t1:.1f} s")

        # the MPP tier: the statement tier hands a replicated single-table
        # plan to engine routing (distsql/planner.py choose_statement_tier),
        # and takes a join whose probe table is replicated, its probe scan
        # from the replica's stable chunks
        t1 = time.perf_counter()
        engines("tpu,columnar")
        s.execute("SET tidb_enable_tpu_mesh = 1")
        s.execute("SET tidb_allow_mpp = 1")
        m0 = metrics.MPP_SELECTS.value
        _res, what, _n = routed("q1", "the MPP tier on, engine routing")
        if metrics.MPP_SELECTS.value != m0:
            raise SystemExit("phase 14 q1: the MPP tier took a plan the columnar replica owns")
        join_sql, join_gc = MESH_SESSION["join"]
        join_sql = join_sql.replace("FROM lineitem ", "FROM lineitem_r ")
        s.execute(f"SET tidb_tpu_group_capacity = {join_gc}")
        m = model()
        join_want = {d: (c, sm) for d, (sm, c) in _sum_by(odate[m["okey"]], m["price"]).items()}
        answers, ms = {}, {}
        for which in ("tpu,columnar", "tpu"):
            engines(which)

            def mpp_once():
                store.clear_result_cache()
                c0 = (metrics.MPP_SELECTS.value, metrics.MPP_FALLBACKS.value)
                with tracing.trace("phase 14 mpp") as root:
                    res = s.execute(join_sql)
                served = [sp.attrs.get("replica_served") for sp in root.find("mpp.dispatch")]
                return res, (metrics.MPP_SELECTS.value - c0[0], metrics.MPP_FALLBACKS.value - c0[1]), served

            res, d_mpp, served = counters.path(f"join ({which}, the MPP tier)", mpp_once, phase=14)
            if d_mpp != (1, 0) or served != [which != "tpu"]:
                raise SystemExit(f"phase 14 join ({which}): MPP_SELECTS, MPP_FALLBACKS moved by {d_mpp}, the"
                                 f" mpp.dispatch spans' replica_served {served}")
            what = session_mesh_answer("join", res, join_want, T, where="phase 14")
            answers[which] = sorted(map(str, res.values()))
            ms[which] = host_ms(join_sql)
        if answers["tpu,columnar"] != answers["tpu"]:
            raise SystemExit("phase 14 join: the replica-served MPP answer differs from the row store's")
        s.execute("SET tidb_tpu_group_capacity = 4096")
        s.execute("SET tidb_allow_mpp = 0")
        s.execute("SET tidb_enable_tpu_mesh = 0")
        clean("the MPP tier")
        log(f"phase 14 MPP tier: Q1's GROUP BY stays with engine routing (MPP_SELECTS +0, COLUMNAR_SCANS +1, K1"
            f" once); lineitem_r JOIN orders grouped by o_orderdate on the MPP tier with its probe scan from the"
            f" replica (replica_served true on the mpp.dispatch span) -> {what} == numpy == the MPP tier over the"
            f" row store; median of {CDC_REPS} runs: replica probe {ms['tpu,columnar']:.3f} ms, row-store probe"
            f" {ms['tpu']:.3f} ms [{card}] ({time.perf_counter() - t1:.1f} s)")

        # writes through the feed: a file changefeed from now, then one
        # transaction (UPDATE, INSERT, DELETE) through the store's
        # Percolator engine, as phase 13 commits its UPDATE
        t1 = time.perf_counter()
        engines("tpu,columnar")
        shutil.rmtree(CDC_DIR, ignore_errors=True)
        feed_ts = store.next_ts()
        s.execute(f"CREATE CHANGEFEED f INTO 'file://{CDC_DIR}' FOR TABLE lineitem_r WITH start_ts = {feed_ts}")
        touched = np.nonzero(full["okey"][:CDC_ROWS] < CDC_UPDATE_KEYS)[0]
        deleted = np.nonzero(full["okey"][:CDC_ROWS] >= CDC_UPDATE_KEYS)[0][-CDC_DELETED_ROWS:]
        new = np.arange(CDC_ROWS, CDC_ROWS + CDC_NEW_ROWS)

        def commit_update(handles, more=None) -> int:
            """l_quantity + 1 on `handles` (and the `more` mutations) in one
            transaction; returns its commit ts."""
            qty[handles] += 100
            cur = dict(full, qty=qty)
            muts = dict(W.store_items(codec, [next(W.store_rows(T, cur, h, h + 1)) for h in handles.tolist()],
                                      table_id=tid))
            muts.update(more or {})
            return store.txn.commit_txn(muts, store.next_ts(), store.next_ts)

        more = dict(W.store_items(codec, W.store_rows(T, full, CDC_ROWS, CDC_ROWS + CDC_NEW_ROWS), table_id=tid))
        more.update({codec.encode_row_key(tid, int(h)): None for h in deleted})
        commit_ts = commit_update(touched, more)
        live = np.concatenate([np.setdiff1d(np.arange(CDC_ROWS), deleted), new])
        want["q1"] = numpy_session_q1(model(), T)
        # (a) the frontier trails the commit: one data_not_ready wait, then
        # a counted fallback to the row store (K1 once a region)
        _res, what, _n = routed("q1", "the frontier behind the commit", scans=0, fallbacks=1, k1=CDC_REGIONS,
                                backoffs=1)
        log(f"phase 14 (a): the transaction (UPDATE of {len(touched)} rows, INSERT of {len(new)}, DELETE of"
            f" {len(deleted)}) committed at {commit_ts}; the routed Q1 before any tick waited once on"
            f" data_not_ready and fell back to the row store -> {what} == numpy on the new rows")
        # (b) the changefeeds alone: the delta overlay serves on the host
        t2 = time.perf_counter()
        emitted = store.cdc.tick()
        tick_ms = (time.perf_counter() - t2) * 1e3
        v = replica_view("after the changefeed tick")
        if v["delta_rows"] != len(touched) + len(new) + len(deleted):
            raise SystemExit(f"phase 14 (b): {v['delta_rows']} delta rows after the tick")
        t2 = time.perf_counter()
        _res, what, _n = routed("q1", "the delta overlay", overlay=1)
        overlay_ms = (time.perf_counter() - t2) * 1e3
        log(f"phase 14 (b): store.cdc.tick() emitted {emitted} events in {tick_ms:.1f} ms ({v['delta_rows']} delta"
            f" rows); the routed Q1 from the delta overlay (the host merge, run_dag_on_chunks once) -> {what} =="
            f" numpy in {overlay_ms:.1f} ms [{card}]")
        if profile:
            host_profile("phase 14 the overlay read", lambda: s.execute(cdc_sql("q1")))
        # (c) the PD tick compacts: back on the device-resident batch
        t2 = time.perf_counter()
        store.pd.tick()
        compact_s = store.pd.last_tick_root.find("pd.columnar")[0].duration_ns / 1e9
        v = replica_view("after the compaction")
        if (v["delta_rows"], v["stable_rows"]) != (0, CDC_ROWS + len(new) - len(deleted)):
            raise SystemExit(f"phase 14 (c): the view after the compaction {v}")
        _res, what, _n = routed("q1", "compacted")
        log(f"phase 14 (c): a PD tick folded the delta (pd.columnar {compact_s:.2f} s, the tick"
            f" {time.perf_counter() - t2:.2f} s); the routed Q1 from the stable batch -> {what} == numpy")

        # the file changefeed holds exactly the transaction's changes
        recs = FileSink(CDC_DIR, "f").read_records()
        got = [(r["handle"], r["op"], r["commit_ts"]) for r in recs if r["type"] == "row"]
        exp = sorted([(int(h), "put") for h in touched] + [(int(h), "put") for h in new]
                     + [(int(h), "delete") for h in deleted])
        if sorted((h, op) for h, op, _ts in got) != exp or len(got) != len(exp) or \
                any(ts != commit_ts for _h, _op, ts in got):
            raise SystemExit(f"phase 14 file feed: {len(got)} row records, the transaction made {len(exp)}")
        for r in recs:
            if r["type"] == "row" and r["op"] == "put":
                q = int(Decimal(str(r["columns"]["l_quantity"])) * 100)
                if q != int(qty[r["handle"]]):
                    raise SystemExit(f"phase 14 file feed: handle {r['handle']} l_quantity {q}, not {qty[r['handle']]}")
        feeds = {row[0]: row for row in s.execute("SHOW CHANGEFEEDS").values()}
        if feeds["f"][1] != "normal" or feeds["f"][4] < commit_ts:
            raise SystemExit(f"phase 14: SHOW CHANGEFEEDS {feeds['f']}")
        s.execute("DROP CHANGEFEED f")
        log(f"phase 14 file feed: {len(got)} row records in {len(FileSink(CDC_DIR, 'f').writer.segments())}"
            f" segment(s), the transaction's changes each once at its commit ts, the puts' l_quantity as committed;"
            f" SHOW CHANGEFEEDS f checkpoint {feeds['f'][4]} >= {commit_ts}; dropped"
            f" ({time.perf_counter() - t1:.1f} s)")

        # the staleness gate under a fault: the replica's apply loop stalls
        t1 = time.perf_counter()
        with failpoint.enabled("columnar/apply-stall"):
            stall_ts = commit_update(touched)
            want["q1"] = numpy_session_q1(model(), T)
            store.cdc.tick()
            if store.columnar.feed_state(tid) != "error":
                raise SystemExit(f"phase 14 apply-stall: the replica's feed is {store.columnar.feed_state(tid)}")
            _res, what, _n = routed("q1", "the apply loop stalled", scans=0, fallbacks=1, k1=CDC_REGIONS,
                                    backoffs=1)
        store.columnar.resume_all()
        store.pd.tick()
        v = replica_view("after the resume")
        if v["applied_ts"] < stall_ts:
            raise SystemExit(f"phase 14 apply-stall: applied_ts {v['applied_ts']} < the commit {stall_ts}")
        _res, what2, _n = routed("q1", "resumed")
        log(f"phase 14 apply-stall: the UPDATE at {stall_ts} parked the replica's feed in error; the routed Q1 fell"
            f" back once -> {what} == numpy; after the disarm, RESUME and a PD tick the replica serves again ->"
            f" {what2} == numpy, its view's error empty ({time.perf_counter() - t1:.1f} s)")
        clean("the writes")
    finally:
        EX.run_dag_reference, EXP.run_dag_reference = real_oracle
        for c in (chunks, runs, waits):
            c.close()
        failpoint.disable("columnar/apply-stall")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; store {store.stats()}")
    return s, full, qty, live


# ---------------------------------------------------------------------------
# phase 15: the front door
# ---------------------------------------------------------------------------

FRONT_CONNS = 32                 # concurrent client connections
FRONT_POINT_GETS = 64            # PREPARE / EXECUTE point gets a connection
FRONT_INSERTS = 32               # autocommit single-row INSERTs a connection
FRONT_REPS = 3
FRONT_STATEMENTS = ("q1", "q6", "q3")  # SESSION_STATEMENTS that reach K1 and K2 (q1 without ORDER BY)
FRONT_TIMEOUT = 300.0            # seconds a client socket or a client thread may wait
FRONT_FAMILIES = ("tidb_tpu_coalesce_batches_total", "tidb_tpu_coalesce_lanes_total",
                  "tidb_tpu_coalesce_launches_saved_total", "tidb_tpu_coalesce_fallbacks_total",
                  "tidb_tpu_coalesce_group_commits_total", "tidb_tpu_coalesce_group_proposals_saved_total")


def text_rows(res) -> list:
    """A Result's rows as the wire's text cells."""
    from tidb_tpu_torch.server.server import datum_text

    return [[datum_text(d) for d in row] for row in res.rows]


def run_clients(what: str, n: int, fn) -> list:
    """fn(i) on n threads released together, each join with a deadline;
    returns their results in order and fails on the first error."""
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def body(i):
        try:
            barrier.wait(timeout=FRONT_TIMEOUT)
            out[i] = fn(i)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + FRONT_TIMEOUT
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    if any(t.is_alive() for t in threads):
        raise SystemExit(f"phase 15 {what}: a client thread still runs after {FRONT_TIMEOUT} s")
    if errors:
        raise SystemExit(f"phase 15 {what}: {errors[0]!r}")
    return out


def exposition_ok(text: str) -> dict:
    """The Prometheus text exposition's families (name -> TYPE); fails on a
    sample line that does not parse or a sample of a family with no TYPE."""
    import re

    kinds, line_re = {}, re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (\S+)$')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split()
            kinds[name] = kind
        elif line and not line.startswith("#"):
            m = line_re.match(line)
            if m is None:
                raise SystemExit(f"phase 15 /metrics: the line {line!r} does not parse")
            float(m.group(3))
            base = re.sub(r"_(bucket|sum|count|total)$", "", m.group(1))
            if not ({m.group(1), base, base + "_total"} & set(kinds)):
                raise SystemExit(f"phase 15 /metrics: {m.group(1)} has no TYPE line")
    return kinds


def fallbacks(metrics) -> int:
    from tidb_tpu_torch.server.coalesce import FALLBACK_REASONS

    return sum(metrics.COALESCE_FALLBACKS.labels(r).value for r in FALLBACK_REASONS)


def front_phase(sess, want: dict, E, X, T, W, counters, profile: bool, card: str) -> dict:
    """Phase 15: the front door over phase 11's store and catalog (see the
    module docstring). `want` holds numpy's answers over the tables as
    phase 13 left them. Returns each FRONT_STATEMENTS statement's median
    host ms in process (phase 17 prints its storm beside them)."""
    import urllib.request

    import numpy as np
    import torch

    from tidb_tpu_torch.server import MiniClient, MySQLServer
    from tidb_tpu_torch.server.http_api import StatusServer
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.util import metrics

    t0 = time.perf_counter()
    store = sess.store
    need = {"q1": "dense_agg", "q3": "postsort_segscan"}
    in_process_ms = {}
    srv = MySQLServer(store=store, catalog=sess.catalog, device=DEVICE)
    srv.start_background()
    http, conns = None, []
    try:
        def connect():
            c = MiniClient(srv.host, srv.port, timeout=FRONT_TIMEOUT)
            conns.append(c)
            return c

        # the statements that reach K1 and K2, over the wire and in process
        local = Session(store=store, catalog=sess.catalog, device=DEVICE)
        c = connect()
        if local.store.device != store.device:
            raise SystemExit(f"phase 15: the in-process session is on {local.store.device}")
        for name in FRONT_STATEMENTS:
            text, arg = SESSION_STATEMENTS[name]
            sql = text.format(d=arg)

            def in_process(sql=sql):
                store.clear_result_cache()
                res = local.execute(sql)
                torch.cuda.synchronize()
                return res

            def wire(sql=sql):
                store.clear_result_cache()
                return c.query(sql)

            res = counters.path(f"{name} (in process)", in_process, need=(need[name],) if name in need else (),
                                phase=15)
            n_local = dict(counters.last)
            what = session_answer(name, res, want[name], where="phase 15 (in process)")
            cols, rows = counters.path(f"{name} (wire)", wire, need=(need[name],) if name in need else (), phase=15)
            if counters.last != n_local:
                raise SystemExit(f"phase 15 {name}: launches over the wire {counters.last}, in process {n_local}")
            if cols != [str(x) for x in res.columns] or rows != text_rows(res):
                raise SystemExit(f"phase 15 {name}: the wire's result set differs from the in-process one")
            ms = {}
            for how, fn in (("wire", wire), ("in process", in_process)):
                runs = []
                for _ in range(FRONT_REPS):
                    t1 = time.perf_counter()
                    fn()
                    runs.append((time.perf_counter() - t1) * 1e3)
                ms[how] = statistics.median(runs)
            in_process_ms[name] = ms["in process"]
            log(f"phase 15 {name}: over the wire -> {len(rows)} rows, each cell equal to the in-process result's"
                f" text, {what} == numpy; launches {n_local} either way; median of {FRONT_REPS} runs, result cache"
                f" cleared: wire {ms['wire']:.3f} ms, in process {ms['in process']:.3f} ms (the protocol and"
                f" datum_text {ms['wire'] - ms['in process']:.3f} ms) [{card}]")

        # point gets from 32 connections, coalescing OFF then ON
        t1 = time.perf_counter()
        _okey, ocust, _odate = (c_[0] for c_ in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
        keys = np.random.default_rng(15).integers(0, SESSION_ORDERS, size=(FRONT_CONNS, FRONT_POINT_GETS))
        pool = [c] + [connect() for _ in range(FRONT_CONNS - 1)]
        for cl in pool:
            cl.query("PREPARE pg FROM 'SELECT * FROM orders WHERE o_orderkey = ?'")

        def point_gets(on: bool):
            for cl in pool:
                cl.query(f"SET tidb_tpu_enable_coalesce = {'ON' if on else 'OFF'}")

            def work(i):
                out, ms = [], []
                for k in keys[i].tolist():
                    t2 = time.perf_counter()
                    _cols, rows = pool[i].query(f"SET @k = {k}; EXECUTE pg USING @k")
                    ms.append((time.perf_counter() - t2) * 1e3)
                    if len(rows) != 1 or rows[0][0] != str(k) or rows[0][3] != str(int(ocust[k])):
                        raise SystemExit(f"phase 15 point get {k}: {rows}")
                    out.append(rows)
                return out, ms

            cpu, wall = time.process_time(), time.perf_counter()
            res = run_clients(f"point gets (coalescing {'ON' if on else 'OFF'})", FRONT_CONNS, work)
            busy = (time.process_time() - cpu, time.perf_counter() - wall)
            return [r for r, _ms in res], sorted(m for _r, ms in res for m in ms), busy

        # one point get alone on this host, in process (then under cProfile)
        # and over one connection, beside the 32 connections' storm
        local.execute("PREPARE pg FROM 'SELECT * FROM orders WHERE o_orderkey = ?'")

        def get_in_process(k):
            local.execute(f"SET @k = {k}")
            return [[str(d.val) for d in r] for r in local.execute("EXECUTE pg USING @k").rows]

        def get_wire(k):
            return c.query(f"SET @k = {k}; EXECUTE pg USING @k")[1]

        c.query("SET tidb_tpu_enable_coalesce = OFF")
        alone = {}
        for how, fn in (("in process", get_in_process), ("wire", get_wire)):
            ms = []
            for k in keys[0].tolist():
                t2 = time.perf_counter()
                rows = fn(k)
                ms.append((time.perf_counter() - t2) * 1e3)
                if len(rows) != 1 or rows[0][0] != str(k):
                    raise SystemExit(f"phase 15 point get {k} alone ({how}): {rows}")
            alone[how] = statistics.median(ms)
        log(f"phase 15 point get alone, coalescing OFF: median of {FRONT_POINT_GETS} in process"
            f" {alone['in process']:.3f} ms, over one connection {alone['wire']:.3f} ms [{card}]")
        host_profile(f"phase 15 {FRONT_POINT_GETS} point gets alone in process",
                     lambda: [get_in_process(k) for k in keys[0].tolist()], top=8)

        off, off_ms, off_busy = point_gets(False)
        m0 = (metrics.COALESCE_BATCHES.value, metrics.COALESCE_LAUNCHES_SAVED.value, fallbacks(metrics),
              metrics.COALESCE_LANES.labels("read").value)
        on, on_ms, on_busy = point_gets(True)
        d_batches, d_saved, d_fb, d_lanes = (b - a for a, b in zip(m0, (
            metrics.COALESCE_BATCHES.value, metrics.COALESCE_LAUNCHES_SAVED.value, fallbacks(metrics),
            metrics.COALESCE_LANES.labels("read").value)))
        if on != off:
            raise SystemExit("phase 15 point gets: a coalesced answer differs from the uncoalesced one")
        if d_batches < 1 or d_saved < 1 or d_fb:
            raise SystemExit(f"phase 15 point gets: COALESCE_BATCHES +{d_batches}, COALESCE_LAUNCHES_SAVED +{d_saved},"
                             f" COALESCE_FALLBACKS +{d_fb}")

        def pct(ms, q):
            return ms[min(int(q * len(ms)), len(ms) - 1)]

        log(f"phase 15 point gets: {FRONT_CONNS} connections x {FRONT_POINT_GETS} PREPARE / EXECUTE of orders by"
            f" seeded o_orderkey, every answer equal with coalescing ON and OFF and to numpy's o_custkey;"
            f" COALESCE_BATCHES +{d_batches}, COALESCE_LAUNCHES_SAVED +{d_saved}, COALESCE_FALLBACKS +0, lanes a batch"
            f" {d_lanes / d_batches:.2f} ({d_lanes} lanes); a point get (SET @k and EXECUTE, one round trip):"
            f" coalesced median {pct(on_ms, 0.5):.3f} ms p99 {pct(on_ms, 0.99):.3f} ms, uncoalesced median"
            f" {pct(off_ms, 0.5):.3f} ms p99 {pct(off_ms, 0.99):.3f} ms; the process's CPU s over the storm's wall s"
            f" (the server's and the clients' threads): coalesced {on_busy[0]:.3f} / {on_busy[1]:.3f}, uncoalesced"
            f" {off_busy[0]:.3f} / {off_busy[1]:.3f} ({off_busy[0] * 1e3 / keys.size:.3f} ms of CPU a get)"
            f" [{card}] ({time.perf_counter() - t1:.1f} s)")

        # group commit: autocommit single-row INSERTs from 32 connections
        t1 = time.perf_counter()
        local.execute("CREATE TABLE front_gc (id BIGINT PRIMARY KEY, v BIGINT NOT NULL)")
        g0 = (metrics.COALESCE_GROUP_COMMITS.value, metrics.COALESCE_GROUP_PROPOSALS_SAVED.value,
              metrics.COALESCE_LANES.labels("write").value)

        def inserts(i):
            for j in range(FRONT_INSERTS):
                if pool[i].query(f"INSERT INTO front_gc VALUES ({i * FRONT_INSERTS + j}, {j})") != 1:
                    raise SystemExit(f"phase 15 group commit: INSERT {i * FRONT_INSERTS + j} did not write a row")

        run_clients("group commit", FRONT_CONNS, inserts)
        d_gc, d_prop, d_wl = (b - a for a, b in zip(g0, (
            metrics.COALESCE_GROUP_COMMITS.value, metrics.COALESCE_GROUP_PROPOSALS_SAVED.value,
            metrics.COALESCE_LANES.labels("write").value)))
        n_rows = FRONT_CONNS * FRONT_INSERTS
        ids = [r[0] for r in local.execute("SELECT id, v FROM front_gc ORDER BY id").values()]
        agg = local.execute("SELECT count(*), sum(v) FROM front_gc").values()[0]
        if ids != list(range(n_rows)) or [int(str(x)) for x in agg] != [n_rows, FRONT_CONNS * sum(range(FRONT_INSERTS))]:
            raise SystemExit(f"phase 15 group commit: read back {len(ids)} rows, count and sum {agg}")
        if d_gc < 1 or d_prop < 1:
            raise SystemExit(f"phase 15 group commit: COALESCE_GROUP_COMMITS +{d_gc},"
                             f" COALESCE_GROUP_PROPOSALS_SAVED +{d_prop}")
        log(f"phase 15 group commit: {FRONT_CONNS} connections x {FRONT_INSERTS} autocommit INSERTs, all {n_rows} rows"
            f" read back; COALESCE_GROUP_COMMITS +{d_gc} ({d_wl} write lanes), COALESCE_GROUP_PROPOSALS_SAVED"
            f" +{d_prop} ({time.perf_counter() - t1:.1f} s)")

        # the status server
        http = StatusServer(sess).start_background()

        def get(path):
            with urllib.request.urlopen(f"http://{http.host}:{http.port}{path}", timeout=FRONT_TIMEOUT) as r:
                if r.status != 200:
                    raise SystemExit(f"phase 15 GET {path}: {r.status}")
                body = r.read()
                return body.decode() if path == "/metrics" else json.loads(body)

        status = get("/status")
        meta = sess.catalog.table("lineitem")
        schema = get("/schema/test/lineitem")
        if schema["id"] != meta.table_id or [c_["name"]["O"] for c_ in schema["cols"]] != [
                c_.name for c_ in meta.columns]:
            raise SystemExit(f"phase 15 /schema/test/lineitem: {schema}")
        kinds = exposition_ok(get("/metrics"))
        missing = [f for f in FRONT_FAMILIES if kinds.get(f.removesuffix("_total")) is None and f not in kinds]
        if missing:
            raise SystemExit(f"phase 15 /metrics: no {missing}")
        regions = get("/pd/api/v1/regions")
        if sorted(r["region_id"] for r in regions) != sorted(r.region_id for r in store.cluster.regions()):
            raise SystemExit("phase 15 /pd/api/v1/regions: the regions differ from the PD's")
        feeds = get("/cdc/api/v1/changefeeds")
        if [(f["name"], f["state"]) for f in feeds] != [(v["name"], v["state"]) for v in store.cdc.views()]:
            raise SystemExit(f"phase 15 /cdc/api/v1/changefeeds: {feeds}")
        tables = get("/columnar/api/v1/tables")
        if [v["table"] for v in tables] != [v["table"] for v in store.columnar.views()]:
            raise SystemExit(f"phase 15 /columnar/api/v1/tables: {tables}")
        log(f"phase 15 HTTP: /status {status['version']}, /schema/test/lineitem id {schema['id']} with"
            f" {len(schema['cols'])} columns, /metrics {len(kinds)} families (every sample parses, the coalescer's"
            f" there), /pd/api/v1/regions {len(regions)} regions == the PD, /cdc/api/v1/changefeeds {len(feeds)},"
            f" /columnar/api/v1/tables {len(tables)}; each 200")
    finally:
        for cl in conns:
            cl.close()
        if http is not None:
            http.close()
        srv.close()
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return in_process_ms


# ---------------------------------------------------------------------------
# phase 16: BR and point-in-time recovery
# ---------------------------------------------------------------------------

BR_DIR = os.path.join("build", "br_phase")  # the full backup and the log backup (ignored by git)
BR_STATEMENTS = ("q1", "q3")                # over lineitem_r: K1 and K2 on the restored tables


def dir_bytes(path: str) -> tuple:
    """(files, bytes) under `path`."""
    n = b = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            n += 1
            b += os.path.getsize(os.path.join(root, f))
    return n, b


def br_phase(src, full, qty, live, E, X, T, W, counters, profile: bool, card: str) -> None:
    """Phase 16: BR and point-in-time recovery over phase 14's session (see
    the module docstring). `full`, `qty` and `live` are lineitem_r's model
    as phase 14 leaves it."""
    import shutil
    import urllib.request

    import numpy as np
    import torch

    import tidb_tpu_torch.exec as EXP
    import tidb_tpu_torch.exec.executor as EX
    import tidb_tpu_torch.tools.br as BRT
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.parser import parse_one
    from tidb_tpu_torch.server.http_api import StatusServer
    from tidb_tpu_torch.sql import Session, plan_select

    t0 = time.perf_counter()
    s, store = src, src.store
    tid = s.catalog.table("lineitem_r").table_id
    okey, _ocust, odate = (c[0] for c in W.store_q3_build_columns(SESSION_ORDERS, SESSION_CUSTOMERS)[0])
    stats_json = os.path.abspath(os.path.join(SESSION_DIR, "lineitem_r_stats.json"))
    shutil.rmtree(BR_DIR, ignore_errors=True)
    root = os.path.abspath(BR_DIR)

    def model() -> dict:
        return {k: (qty if k == "qty" else v)[live] for k, v in full.items()}

    # the full backup, then the log backup on the same root
    t1 = time.perf_counter()
    r = s.execute(f"BACKUP DATABASE * TO '{root}'")
    backup_s = time.perf_counter() - t1
    keys, snap = r.values()[0][1], r.values()[0][2]
    manifest = json.load(open(os.path.join(root, "manifest.json")))
    full_files, full_bytes = dir_bytes(root)
    s.execute(f"BACKUP LOG TO 'file://{root}'")
    t1 = time.perf_counter()
    store.pd.tick()
    first_tick_s = time.perf_counter() - t1
    cuts = {"before": store.next_ts()}
    store.pd.tick()
    http = StatusServer(s).start_background()
    try:
        with urllib.request.urlopen(f"http://{http.host}:{http.port}/cdc/api/v1/changefeeds",
                                    timeout=FRONT_TIMEOUT) as resp:
            feeds = {f["name"]: f for f in json.loads(resp.read())}
    finally:
        http.close()
    logs = s.execute("SHOW BACKUP LOGS").values()
    if len(logs) != 1 or logs[0][1] not in feeds or logs[0][2] != "normal" or logs[0][4] < cuts["before"]:
        raise SystemExit(f"phase 16: SHOW BACKUP LOGS {logs}, /cdc/api/v1/changefeeds {sorted(feeds)}")
    models = {"before": {k: v.copy() for k, v in model().items()}}
    log(f"phase 16 backup: BACKUP DATABASE * of {keys} keys at snapshot {snap} in {backup_s:.2f} s"
        f" ({len(manifest['segments'])} segments, {full_files} files, {full_bytes} bytes); BACKUP LOG TO"
        f" 'file://{BR_DIR}' and its first PD tick (the raw feed's scan from ts 0) {first_tick_s:.2f} s;"
        f" SHOW BACKUP LOGS {logs[0]}; the feed {logs[0][1]} in /cdc/api/v1/changefeeds")

    # the transaction, shaped like phase 14's, then the second cut
    touched = np.nonzero(full["okey"][:CDC_ROWS] < CDC_UPDATE_KEYS)[0]
    old = live[live < CDC_ROWS]
    deleted = old[full["okey"][old] >= CDC_UPDATE_KEYS][-CDC_DELETED_ROWS:]
    new = np.arange(CDC_ROWS + CDC_NEW_ROWS, CDC_ROWS + 2 * CDC_NEW_ROWS)
    qty[touched] += 100
    cur = dict(full, qty=qty)
    muts = dict(W.store_items(codec, [next(W.store_rows(T, cur, h, h + 1)) for h in touched.tolist()], table_id=tid))
    muts.update(W.store_items(codec, W.store_rows(T, full, int(new[0]), int(new[-1]) + 1), table_id=tid))
    muts.update({codec.encode_row_key(tid, int(h)): None for h in deleted})
    commit_ts = store.txn.commit_txn(muts, store.next_ts(), store.next_ts)
    live = np.concatenate([np.setdiff1d(live, deleted), new])
    store.pd.tick()
    cuts["after"] = store.next_ts()
    store.pd.tick()
    models["after"] = model()
    log_files, log_bytes = dir_bytes(os.path.join(root, "log"))
    lm = json.load(open(os.path.join(root, "log", "manifest.json")))
    if lm["checkpoint_ts"] < cuts["after"]:
        raise SystemExit(f"phase 16: the log's checkpoint {lm['checkpoint_ts']} is behind the cut {cuts['after']}")
    log(f"phase 16 transaction: UPDATE of {len(touched)} rows, INSERT of {len(new)}, DELETE of {len(deleted)}"
        f" committed at {commit_ts}; cuts {cuts}; the log {len(lm['segments'])} segments"
        f" ({sum(x['events'] for x in lm['segments'])} events, {log_files} files, {log_bytes} bytes), checkpoint"
        f" {lm['checkpoint_ts']}")

    oracle_calls = [0]
    real_oracle = (EX.run_dag_reference, EXP.run_dag_reference)

    def counted_oracle(*a, **k):
        oracle_calls[0] += 1
        return real_oracle[0](*a, **k)

    need = {"q1": "dense_agg", "q3": "postsort_segscan"}
    EX.run_dag_reference = EXP.run_dag_reference = counted_oracle
    full_restore = Calls(BRT, "restore")
    try:
        for cut_name, cut in cuts.items():
            want = numpy_lineitem_sql(models[cut_name], (okey, odate), T)
            rs = Session(device=DEVICE)
            t1 = time.perf_counter()
            f_s0 = full_restore.seconds
            res = rs.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {cut}")
            restore_s = time.perf_counter() - t1
            base_s = full_restore.seconds - f_s0
            _src, until, segs, events = res.values()[0]
            rs.execute(f"LOAD STATS '{stats_json}'")
            hint = plan_select(parse_one(cdc_sql("q1")), rs.catalog).small_groups
            if until != cut or hint != G:
                raise SystemExit(f"phase 16 {cut_name}: restored until {until}, Q1's small-groups hint {hint}")
            st0 = rs.store.stats()
            answers = []
            for name in BR_STATEMENTS:
                sql = cdc_sql(name)

                def once(sql=sql):
                    rs.store.clear_result_cache()
                    out = rs.execute(sql)
                    torch.cuda.synchronize()
                    return out

                got = counters.path(f"{name} (restored, {cut_name} the transaction)", once, need=(need[name],),
                                    phase=16)
                what = session_answer(name, got, want[name], where=f"phase 16 ({cut_name})")
                s.execute("SET tidb_isolation_read_engines = 'tpu'")
                s.execute(f"SET tidb_snapshot = '{cut}'")
                try:
                    at = s.execute(sql)
                finally:
                    s.execute("SET tidb_snapshot = ''")
                    s.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
                if sorted(map(str, at.values())) != sorted(map(str, got.values())):
                    raise SystemExit(f"phase 16 {name} ({cut_name}): the restored answer differs from the source's"
                                     f" at {cut}")
                answers.append(f"{name} {what}")
            st = rs.store.stats()
            if oracle_calls[0] or any(st[k] != st0[k] for k in ("oracle_fallbacks", "other_errors")):
                raise SystemExit(f"phase 16 {cut_name}: an oracle answer or an other_error ({st}, root oracle"
                                 f" {oracle_calls[0]})")
            log(f"phase 16 restore {cut_name} the transaction: RESTORE ... UNTIL TS = {cut} into a fresh"
                f" Session(device={DEVICE!r}) in {restore_s:.2f} s (the full backup's restore {base_s:.2f} s, the"
                f" replay of {segs} segments / {events} events {restore_s - base_s:.2f} s); {', '.join(answers)} =="
                f" numpy == the source at {cut} (tidb_snapshot); no oracle answer, no other_error [{card}]")
    finally:
        EX.run_dag_reference, EXP.run_dag_reference = real_oracle
        full_restore.close()
        s.execute(f"STOP BACKUP LOG TO 'file://{root}'")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the seeded chaos storms
# ---------------------------------------------------------------------------

STORM_SEED = 11                  # (a): tests/test_chaos.py test_chaos_short_run_smoke's seed
STORM_STATEMENTS = 40            # and its statement count
STORM_DATA_STATEMENTS = 30       # (b): FRONT_STATEMENTS in turn under default_schedule(30)


def storm_phase(sess, want: dict, counters, card: str, front_ms: dict) -> None:
    """Phase 17: the seeded chaos storms on the card (see the module
    docstring). `want` holds numpy's answers over phase 11's tables as
    phase 13 left them; `front_ms` phase 15's in-process medians."""
    from tidb_tpu_torch.analysis import lockwatch
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.tools import chaos

    t0 = time.perf_counter()

    def storm_ok(what, rep, n, fired: bool):
        """The reference's storm invariants; with `fired`, also that the
        storm's outage really tripped a breaker and failed over."""
        bad = []
        if rep["wrong_results"] or rep["untyped_errors"]:
            bad.append(f"wrong {rep['wrong_results'][:3]}, untyped {rep['untyped_errors'][:3]}")
        if not rep["breakers_all_closed"]:
            bad.append(f"breakers {rep['breakers']}")
        if rep["failovers"] < 1 or rep["failover_moves"] != 0 or rep["replica_reads"]["follower"] < 1:
            bad.append(f"failovers {rep['failovers']}, failover moves {rep['failover_moves']}, replica reads"
                       f" {rep['replica_reads']}")
        if fired and (rep["breaker_trips"] < 1 or rep["transfer_leaders"] < 1):
            bad.append(f"breaker trips {rep['breaker_trips']}, leader transfers {rep['transfer_leaders']}")
        if rep["ok"] + rep["typed_errors"] != n:
            bad.append(f"ok {rep['ok']} + typed {rep['typed_errors']} != {n}")
        if bad:
            raise SystemExit(f"phase 17 {what}: " + "; ".join(bad))

    # (a) the reference's short run on the card, under the port's lock watcher
    t1 = time.perf_counter()

    def short_run():
        with lockwatch.watching() as w:
            rep = chaos.run_chaos(seed=STORM_SEED, statements=STORM_STATEMENTS, device=DEVICE)
        return rep, w

    rep, w = counters.path(f"run_chaos(seed={STORM_SEED}, statements={STORM_STATEMENTS}) under lockwatch",
                           short_run, phase=17)
    storm_ok("(a) run_chaos", rep, STORM_STATEMENTS, fired=False)
    watch = w.report()
    if watch["cycles"] or watch["violations"]:
        raise SystemExit(f"phase 17 (a) lockwatch: cycles {watch['cycles']}, violations {watch['violations'][:5]}")
    port_edges = w.edges_under()
    if not port_edges:
        raise SystemExit("phase 17 (a) lockwatch: no lock nesting of the port was seen")
    log(f"phase 17 (a) run_chaos(seed={STORM_SEED}, statements={STORM_STATEMENTS}, device={DEVICE!r}) under"
        f" tidb_tpu_torch.analysis.lockwatch.watching(): ok {rep['ok']}, typed {rep['typed_errors']}"
        f" {rep['errors_by_code']}, no wrong result, no untyped error, breakers all closed; failovers"
        f" {rep['failovers']} (moves 0), leader transfers {rep['transfer_leaders']}, breaker trips"
        f" {rep['breaker_trips']}, replica reads {rep['replica_reads']}; statement p50 {rep['p50_ms']} ms, p99"
        f" {rep['p99_ms']} ms; lockwatch: {len(watch['edges'])} lock-order edges ({len(port_edges)} between the"
        f" port's own locks), 0 cycles, 0 violations [{card}] ({time.perf_counter() - t1:.1f} s)")

    # (b) the storm's schedule over phase 11's tables: four stores again
    # (phase 13 left three; default_schedule downs stores 1 and 2 and lags
    # store 3), the sharded storm cluster's settings, FRONT_STATEMENTS in turn
    t1 = time.perf_counter()
    store = sess.store
    s = Session(store=store, catalog=sess.catalog)
    store.cluster.set_stores(chaos.N_STORES)
    store.cluster.scatter()
    chaos.storm_settings(s)
    names = [FRONT_STATEMENTS[i % len(FRONT_STATEMENTS)] for i in range(STORM_DATA_STATEMENTS)]
    workload = [SESSION_STATEMENTS[name][0].format(d=SESSION_STATEMENTS[name][1]) for name in names]
    # one run of each statement before the storm: phase 15's INSERTs bumped
    # the store's write version, which drops every decoded region, and the
    # storm's first statements would time the cold decode, not the faults
    warm = {}
    for name, sql in zip(FRONT_STATEMENTS, workload):
        t2 = time.perf_counter()
        session_answer(name, s.execute(sql), want[name], where="phase 17 (b) before the storm")
        warm[name] = (time.perf_counter() - t2) * 1e3
    lat = collections.defaultdict(list)
    in_order = []  # each workload statement's ms, in the storm's order
    execute = s.execute

    def timed(sql, *a, **k):
        t2 = time.perf_counter()
        try:
            return execute(sql, *a, **k)
        finally:
            if sql in workload:
                in_order.append((time.perf_counter() - t2) * 1e3)
                lat[names[workload.index(sql)]].append(in_order[-1])

    def check(i, res):
        """Statement i's answer against numpy, exact; then the result cache
        is cleared, so the next statement computes on the card."""
        try:
            session_answer(names[i], res, want[names[i]], where="phase 17 (b)")
        except SystemExit as exc:
            return {"got": str(exc)[:200], "want": "numpy"}
        finally:
            store.clear_result_cache()
        return None

    s.execute = timed
    store.clear_result_cache()
    rep = counters.path(f"the default schedule over {STORM_DATA_STATEMENTS} statements of phase 11's tables",
                        lambda: chaos.storm(s, workload, check, chaos.default_schedule(STORM_DATA_STATEMENTS),
                                            seed=STORM_SEED),
                        need=("dense_agg", "postsort_segscan"), phase=17)
    storm_ok("(b) the storm over phase 11's tables", rep, STORM_DATA_STATEMENTS, fired=True)

    def pct(ms, q):
        ms = sorted(ms)
        return ms[min(int(q * len(ms)), len(ms) - 1)]

    slow = max(range(len(in_order)), key=in_order.__getitem__)
    sched = chaos.default_schedule(STORM_DATA_STATEMENTS)
    before = [a for i in sorted(sched) if i <= slow for a in sched[i]]
    per = "; ".join(f"{name} median {statistics.median(lat[name]):.3f} ms, p99 {pct(lat[name], 0.99):.3f} ms over"
                    f" {len(lat[name])} (phase 15 in process {front_ms[name]:.3f} ms)" for name in FRONT_STATEMENTS)
    log(f"phase 17 (b) default_schedule({STORM_DATA_STATEMENTS}) over {', '.join(FRONT_STATEMENTS)} in turn on"
        f" phase 11's tables ({len(store.cluster.regions())} regions, {chaos.N_STORES} stores, follower reads, batch"
        f" cop): ok {rep['ok']} == numpy, typed {rep['typed_errors']} {rep['errors_by_code']}, no wrong result, no"
        f" untyped error, breakers all closed; failovers {rep['failovers']} (moves 0), leader transfers"
        f" {rep['transfer_leaders']}, breaker trips {rep['breaker_trips']}, replica reads {rep['replica_reads']};"
        f" K1 / K2 launches {counters.last['dense_agg']} / {counters.last['postsort_segscan']}; {per}; all"
        f" statements p50 {rep['p50_ms']} ms, p99 {rep['p99_ms']} ms [{card}] ({time.perf_counter() - t1:.1f} s)")
    log(f"phase 17 (b) the slowest statement: #{slow} ({names[slow]}) {in_order[slow]:.3f} ms, after the schedule's"
        f" actions {before}; before the storm, one run of each (the cold decode after phase 15's writes):"
        f" {', '.join(f'{k} {v:.3f} ms' for k, v in warm.items())}")
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")


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
    from tidb_tpu_torch.exec.ladder import rung_for
    from tidb_tpu_torch.expr.compile import CompVal
    from tidb_tpu_torch.interop import device_batch_from_numpy
    from tidb_tpu_torch.ops import dense_agg as K1
    from tidb_tpu_torch.ops import join_probe as K4
    from tidb_tpu_torch.ops import joinscan as K23
    from tidb_tpu_torch.ops.radix_join import probe_strategy

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
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
            if any(k in line for k in ("Compiling entry function", "registers", "smem", "spill")):
                log(f"  ptxas: {line.strip()}")

    n = N_ROWS
    gen = torch.Generator(device=dev).manual_seed(1)
    counters = Counters()

    def batches_of(cols_list, fts_list):
        return [device_batch_from_numpy(c, np.ones(len(c[0][0]), bool), len(c[0][0]), f, device=dev)
                for c, f in zip(cols_list, fts_list)]

    # phase 3, K1: against its plain version at Q1's shape
    t = W.make_tables(n, seed=0)
    q1_dag, q1_fts = W.q1_dag(E, X, T)
    q1_batch = device_batch_from_numpy(W.q1_columns(t), np.ones(n, bool), n, q1_fts, device=dev)
    valid, gvals, aggs = q1_agg_inputs(q1_dag, q1_fts, q1_batch)
    q1_lanes = K1.dense_agg_lanes(gvals, aggs, valid, G)[:5]
    k1_names = ("group_rep", "n_groups", "overflow", "counts", "sums", "nns")

    def check_k1(case, lanes, want_overflow, g=G, flag_only=False):
        got = K1.dense_agg(*lanes, g)
        torch.cuda.synchronize()
        if bool(got[2]) != want_overflow:
            raise SystemExit(f"K1 {case}: overflow {bool(got[2])}, expected {want_overflow}")
        if flag_only:
            log(f"phase 3 K1 {case}: overflow={bool(got[2])} (the flag alone is compared)")
            return 0
        e = compare("K1", case, got, K1._dense_agg_plain(*lanes, g), k1_names)
        log(f"phase 3 K1 {case}: kernel == plain ({lanes[0].shape[0]} rows, G={g}, {len(lanes[3])} combos, "
            f"n_groups={int(got[1])}, overflow={bool(got[2])})")
        return e

    def cut(lanes, m):
        hp_, hv_, va_, vs_, ns_ = lanes
        return hp_[:m], hv_[:m], va_[:m], [v[:m] for v in vs_], [x[:m] for x in ns_]

    def shifted(x):
        """x as a view at a 1-element offset (no 16-B or 2-B alignment)."""
        y = torch.empty(x.shape[0] + 1, dtype=x.dtype, device=x.device)
        y[1:] = x
        return y[1:]

    k1_err = check_k1("q1", q1_lanes, False)
    null_mask = torch.rand(n, generator=gen, device=dev) < 0.1
    rflag_nulls = CompVal(gvals[0].value, gvals[0].null | null_mask, gvals[0].ft, raw=gvals[0].raw)
    k1_err = max(k1_err, check_k1("string keys with NULLs", (*K1.dense_agg_lanes([rflag_nulls, gvals[1]], aggs, valid, G)[:5],), False))
    wide = torch.randint(0, 40, (n,), generator=gen, device=dev, dtype=torch.int64)
    wide_key = CompVal(wide, torch.zeros(n, dtype=torch.bool, device=dev), T.new_longlong())
    k1_err = max(k1_err, check_k1("40 keys > G", K1.dense_agg_lanes([wide_key], aggs, valid, G)[:5], True))
    hp_rflag_only = K1.dense_agg_lanes([gvals[0]], aggs, valid, G)[0]
    k1_err = max(k1_err, check_k1("forced hp collision", (hp_rflag_only,) + tuple(q1_lanes[1:]), True))
    # the one-pass kernel's edges: ragged and short inputs (128-row warp
    # chunks, 2048-row block steps), no valid row, G = 1 and 32, NC = 0 and
    # 6, wrapping sums, misaligned lanes, the last block's reset of the
    # scratch (two calls in a row, small after large, after an overflow) and
    # a second stream
    for m in (n - 37, 1000, 129, 127, 1):
        k1_err = max(k1_err, check_k1(f"n = {m}", cut(q1_lanes, m), False))
    hp1, hv1, va1, vs1, ns1 = q1_lanes
    k1_err = max(k1_err, check_k1("no valid row", (hp1, hv1, torch.zeros_like(va1), vs1, ns1), False))
    k1_err = max(k1_err, check_k1("G = 1", q1_lanes, True, g=1))
    k1_err = max(k1_err, check_k1("G = 32", q1_lanes, False, g=32))
    key32 = CompVal(torch.randint(0, 32, (n,), generator=gen, device=dev), wide_key.null, T.new_longlong())
    k1_err = max(k1_err, check_k1("32 keys, G = 32", K1.dense_agg_lanes([key32], aggs, valid, 32)[:5], False, g=32))
    k1_err = max(k1_err, check_k1("NC = 0", (hp1, hv1, va1, [], []), False))
    full = [torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev) * 2 + 1 for _ in range(2)]
    rnd_nulls = [torch.rand(n, generator=gen, device=dev) < 0.2 for _ in range(2)]
    k1_err = max(k1_err, check_k1("NC = 6", (hp1, hv1, va1, vs1 + full, ns1 + rnd_nulls), False))
    near = torch.randint(0, 1 << 40, (n,), generator=gen, device=dev)
    edge = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, I64_MAX - near, -I64_MAX - 1 + near)
    k1_err = max(k1_err, check_k1("values near +-2^63", (hp1, hv1, va1, [edge, vs1[1]], [ns1[0], rnd_nulls[0]]), False))
    k1_err = max(k1_err, check_k1("misaligned lanes", (shifted(hp1), shifted(hv1), shifted(va1), [shifted(vs1[0])] + vs1[1:],
                                                       [shifted(ns1[0])] + ns1[1:]), False))
    first = K1.dense_agg(*q1_lanes, G)
    again = K1.dense_agg(*q1_lanes, G)
    torch.cuda.synchronize()
    compare("K1", "two calls in a row", again, first, k1_names)
    log("phase 3 K1 two calls in a row on Q1's inputs: equal")
    k1_err = max(k1_err, check_k1("a small call after a large one", cut(q1_lanes, 1000), False))
    check_k1("40 keys > G, again", K1.dense_agg_lanes([wide_key], aggs, valid, G)[:5], True)
    k1_err = max(k1_err, check_k1("right after an overflow call", q1_lanes, False))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k1_err = max(k1_err, check_k1("on a second stream", q1_lanes, False))
    key100 = CompVal(torch.randint(0, 100, (n,), generator=gen, device=dev), wide_key.null, T.new_longlong())
    check_k1("100 keys > 64 slots", K1.dense_agg_lanes([key100], aggs, valid, G)[:5], True, flag_only=True)

    # phase 3, K2 and K3: on Q3's own inputs at 2^22 lineitem rows
    q3_dag, q3_fts = W.q3_dag(E, X, T)
    q3_cols = W.q3_columns(n, seed=0)
    q3_batches = batches_of(q3_cols, q3_fts)
    k3_in, k2_in, (hay_key, hay_ok, pkv, probe_ok, q3_aggs) = q3_kernel_inputs(q3_dag, q3_fts, q3_batches)
    k2_names = ("gv", "cnt", "key32", "sum0", "sum1", "nn0", "nn1", "overflow", "join_rows")

    def check_k2(case, spk, lanes_s, bad, nw_s, nn_bits, want_overflow):
        got = K23.postsort_segscan(spk, lanes_s, bad, nw_s, nn_bits)
        torch.cuda.synchronize()
        want = K23._postsort_segscan_plain(spk, lanes_s, bad, nw_s, nn_bits)
        names = k2_names[:3] + k2_names[3:3 + len(lanes_s)] + k2_names[5:5 + len(lanes_s)] + k2_names[7:]
        e = compare("K2", case, got, want, names)
        if bool(got[5]) != want_overflow:
            raise SystemExit(f"K2 {case}: overflow {bool(got[5])}, expected {want_overflow}")
        log(f"phase 3 K2 {case}: kernel == plain ({spk.shape[0]} rows, {int(got[0].sum())} groups, "
            f"{len(lanes_s)} lanes, overflow={bool(got[5])}, join rows {int(got[6])})")
        return e

    def check_k3(case, spk, bad, want_overflow):
        got = K23.membership_segscan(spk, bad)
        torch.cuda.synchronize()
        e = compare("K3", case, got, K23._membership_segscan_plain(spk, bad), ("ok_out", "overflow"))
        if bool(got[1]) != want_overflow:
            raise SystemExit(f"K3 {case}: overflow {bool(got[1])}, expected {want_overflow}")
        log(f"phase 3 K3 {case}: kernel == plain ({spk.shape[0]} rows, {int(got[0].sum())} ok, overflow={bool(got[1])})")
        return e

    from tidb_tpu_torch.ops.joinagg import membership_lanes, packed_groupsum_lanes

    k2_spk, k2_lanes, k2_bad, k2_nw, k2_bits, _ = k2_in
    k2_err = check_k2("q3", k2_spk, k2_lanes, k2_bad, k2_nw, k2_bits, False)
    # a nullable second lane beside Q3's revenue
    lcols = q3_batches[0].cols
    price = CompVal(lcols[1].data, torch.rand(n, generator=gen, device=dev) < 0.2, T.new_decimal(15, 2))
    two = [(q3_aggs[0][0], [q3_aggs[0][1][0]]), (q3_aggs[0][0], [price])]
    spk, lanes_s, bad, nw_s, bits, _ = packed_groupsum_lanes(hay_key, hay_ok, pkv, probe_ok, two)
    k2_err = max(k2_err, check_k2("nullable two lanes", spk, lanes_s, bad, nw_s, bits, False))
    # a duplicate usable hay key
    dup_key = hay_key.clone()
    usable = torch.nonzero(hay_ok).flatten()[:2]
    dup_key[usable[1]] = dup_key[usable[0]]
    spk, lanes_s, bad, nw_s, bits, _ = packed_groupsum_lanes(dup_key, hay_ok, pkv, probe_ok, q3_aggs)
    k2_err = max(k2_err, check_k2("duplicate hay key", spk, lanes_s, bad, nw_s, bits, True))
    # every row usable: the max-key run ends at element n - 1
    m = n // 8
    all_hay = torch.arange(m, device=dev)
    all_probe = CompVal(torch.randint(0, m, (n,), generator=gen, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
                        pkv.ft)
    all_probe.value[-1] = m - 1
    ones_b, ones_p = torch.ones(m, dtype=torch.bool, device=dev), torch.ones(n, dtype=torch.bool, device=dev)
    spk, lanes_s, bad, nw_s, bits, _ = packed_groupsum_lanes(all_hay, ones_b, all_probe, ones_p, q3_aggs)
    k2_err = max(k2_err, check_k2("every row usable", spk, lanes_s, bad, nw_s, bits, False))
    got_last = K23.postsort_segscan(spk, lanes_s, bad, nw_s, bits)[0][-1]
    if not bool(got_last):
        raise SystemExit("K2 every row usable: the last run was not emitted at n - 1")
    # the look-back's edges, at the kernel's own tile size
    tile = K23._fn("postsort_segscan_tile")()
    if tile != K23.K2_TILE:
        raise SystemExit(f"K2 tile: the kernel has {tile}, ops/joinscan.py says {K23.K2_TILE}")
    edges = {
        "runs over 12 and 9 whole tiles": (24 * tile, [(True, 5), (True, 12 * tile + 100), (False, 9 * tile)], 2),
        "runs ending on tile boundaries": (6 * tile + 37, [(True, tile), (True, tile), (False, tile), (True, 2 * tile)], 2),
        "n = 1": (1, [], 2), "n = TILE - 1": (tile - 1, [], 2), "n = TILE": (tile, [], 2),
        "n = TILE + 1": (tile + 1, [], 2), "no value lane": (3 * tile + 5, [], 0),
    }
    for seed, (case, (rows, fixed, nl)) in enumerate(edges.items()):
        k2_err = max(k2_err, check_k2(case, *k2_runs(rows, seed, dev, fixed, nl), False))
    # a small call, then a large one on the same scratch: the small call's
    # payload sums equal the status words the large call will publish
    # ((epoch << 2) | 1 or 2, with the epoch the kernel keeps at byte 32 of
    # the scratch), and the large call looks back across 44 tiles
    big = k2_runs(48 * tile, 7, dev, [(True, 5), (True, 44 * tile)], 2)
    e1 = int(K23._k2_scratch_for(dev, 48 * tile)[32:40].view(torch.int64)) + 1
    small = 3 * tile
    s_pk = torch.full((small,), 3, dtype=torch.int32, device=dev)
    s_pk[0] = 2
    s_lanes = [torch.zeros(small, dtype=torch.int32, device=dev) for _ in range(2)]
    for t_, st in enumerate((2, 1, 2)):
        s_lanes[0][t_ * tile + 1] = e1 << 2 | st
        s_lanes[1][t_ * tile + 1] = e1 << 2 | (3 - st)
    s_nw = torch.zeros(small, dtype=torch.uint8, device=dev)
    k2_err = max(k2_err, check_k2("small call, status-like sums", s_pk, s_lanes,
                                  torch.zeros(small, dtype=torch.bool, device=dev), s_nw, [-1, 0], False))
    k2_err = max(k2_err, check_k2("then a large call", *big, False))
    first =K23.postsort_segscan(k2_spk, k2_lanes, k2_bad, k2_nw, k2_bits)
    again = K23.postsort_segscan(k2_spk, k2_lanes, k2_bad, k2_nw, k2_bits)
    torch.cuda.synchronize()
    compare("K2", "two calls in a row", again, first, k2_names[:4] + k2_names[5:6] + k2_names[7:])
    log("phase 3 K2 two calls in a row on Q3's inputs: equal")

    k3_spk, _k3_pay, k3_bad = k3_in
    k3_err = check_k3("q3", k3_spk, k3_bad, False)
    okey_t, cust_t = q3_batches[1].cols[1].data, q3_batches[2].cols[0].data.clone()
    cust_t[1] = cust_t[0]
    dup3 = membership_lanes(okey_t, torch.ones_like(okey_t, dtype=torch.bool), cust_t,
                            torch.ones_like(cust_t, dtype=torch.bool), q3_batches[1].cols[0].data)
    dup3 = (dup3[0], dup3[2])
    k3_err = max(k3_err, check_k3("duplicate inner keys", *dup3, True))
    # the tiled pass's edges, at the kernel's own tile size: sorted keys of
    # runs (k2_runs: one inner row heading a run, outer rows after it)
    k3_tile = K23._fn("membership_segscan_tile")()
    if k3_tile != K23.K3_TILE:
        raise SystemExit(f"K3 tile: the kernel has {k3_tile}, ops/joinscan.py says {K23.K3_TILE}")

    def runs3(rows, seed, fixed=()):
        return k2_runs(rows, seed, dev, fixed, 0)[0]

    def i32(*parts):
        return torch.cat([torch.as_tensor(p_, dtype=torch.int32, device=dev).reshape(-1) for p_ in parts])

    T3, i32min = k3_tile, -(1 << 31)
    dup_edge = runs3(3 * T3, 24, [(True, T3 - 1), (True, 60)])
    dup_edge[T3] = dup_edge[T3 - 1]  # the inner row at T3 - 1, again at T3
    last_bad = torch.zeros_like(k3_bad)
    last_bad[-1] = True
    k3_edges = {
        "a real outer run over two tile boundaries, headed": (runs3(4 * T3, 21, [(True, T3 - 100), (True, 2 * T3 + 300)]), False),
        "a real outer run over two tile boundaries, not headed": (runs3(4 * T3, 22, [(True, T3 - 100), (False, 2 * T3 + 300)]), False),
        "runs starting at a tile's last row": (runs3(3 * T3, 23, [(True, T3 - 1), (True, 50), (True, T3 - 50), (False, 40)]), False),
        "a 40-row leading run, headed": (runs3(2 * T3 + 9, 25, [(True, T3 - 40), (True, 80)]), False),
        "a 40-row leading run, not headed": (runs3(2 * T3 + 9, 26, [(True, T3 - 40), (False, 80)]), False),
        "a run over 5 whole tiles": (runs3(7 * T3, 27, [(True, 7), (True, 5 * T3 + 11)]), False),
        "a duplicate inner key straddling a boundary": (dup_edge, True),
        # the plain version's element 0 has the predecessor INT32_MIN: an
        # INT32_MIN inner row there is no run head (and is a duplicate)
        "INT32_MIN inner at element 0, then INT32_MIN + 1 outer rows": (
            i32([i32min], [i32min + 1] * (T3 + 50), runs3(2 * T3, 28)), True),
        "all rows pinned": (i32([K23.PIN] * (3 * T3 // 2), [K23.PIN + 1] * (3 * T3 // 2 + 5)), False),
    }
    for i, m_ in enumerate((1, T3 - 1, T3, T3 + 1)):
        k3_edges[f"n = {m_}"] = (runs3(m_, 30 + i), False)
    for case, (spk, want) in k3_edges.items():
        k3_err = max(k3_err, check_k3(case, spk, torch.zeros(spk.shape[0], dtype=torch.bool, device=dev), want))
    k3_err = max(k3_err, check_k3("a bad bit on the last row only", k3_spk, last_bad, True))
    k3_err = max(k3_err, check_k3("misaligned views", shifted(k3_spk), shifted(k3_bad), False))
    check_k3("duplicate inner keys, again", *dup3, True)
    k3_err = max(k3_err, check_k3("right after an overflow call", k3_spk, k3_bad, False))
    first = K23.membership_segscan(k3_spk, k3_bad)
    again = K23.membership_segscan(k3_spk, k3_bad)
    torch.cuda.synchronize()
    compare("K3", "two calls in a row", again, first, ("ok_out", "overflow"))
    log("phase 3 K3 two calls in a row on Q3's inputs: equal")
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k3_err = max(k3_err, check_k3("on a second stream", k3_spk, k3_bad, False))
        check_k3("on a second stream, a duplicate", *dup3, True)

    # phase 3, K4: at the 1:32 radix join's plan
    jb_dag, jb_fts = W.join_bench_dag(E, X, T)
    jb_cols = W.join_bench_columns(n, JOIN_RATIO, False)
    jb_batches = batches_of(jb_cols, jb_fts)
    jc = rung_for(n)
    plan, k4_in = join_kernel_inputs(jb_dag, jb_fts, jb_batches, jc)
    if probe_strategy(*plan[:3]) != "kernel":
        raise SystemExit(f"radix plan {plan} is not the probe kernel's shape")
    k4_names = ("bpos", "dup")

    def check_k4(case, tables, want_dup):
        got = K4.probe_tables(*tables)
        torch.cuda.synchronize()
        e = compare("K4", case, got, K4._probe_tables_plain(*tables), k4_names)
        if bool(got[1]) != want_dup:
            raise SystemExit(f"K4 {case}: dup {bool(got[1])}, expected {want_dup}")
        hits = int((got[0] < tables[0].shape[1]).sum())
        log(f"phase 3 K4 {case}: kernel == plain (plan {tuple(tables[0].shape)} x {tables[2].shape[1]}, "
            f"{hits} matched slots, dup={bool(got[1])})")
        return e

    b_key, b_ok, p_key, p_ok = k4_in
    k4_err = check_k4("join 1:32", k4_in, False)
    k4_err = max(k4_err, check_k4("NULL keys", (b_key, b_ok & (torch.rand(b_ok.shape, generator=gen, device=dev) < 0.8),
                                               p_key, p_ok & (torch.rand(p_ok.shape, generator=gen, device=dev) < 0.8)), False))
    k4_err = max(k4_err, check_k4("unmatched keys", (b_key, b_ok, p_key + (1 << 40), p_ok), False))
    b_dup = b_key.clone()
    b_dup[:, 1] = b_dup[:, 0]
    b_ok2 = b_ok.clone()
    b_ok2[:, :2] = True
    k4_err = max(k4_err, check_k4("duplicate build key", (b_dup, b_ok2, torch.where(p_ok, b_dup[:, :1].expand_as(p_key), p_key), p_ok), True))
    top = -(1 << 63)
    k4_err = max(k4_err, check_k4("unsigned keys", (b_key ^ top, b_ok, p_key ^ top, p_ok), False))
    b_ext = b_key.clone()
    b_ext[:, 0], b_ext[:, 1] = -(1 << 63), (1 << 63) - 1
    p_ext = p_key.clone()
    p_ext[:, 0::3], p_ext[:, 1::3] = -(1 << 63), (1 << 63) - 1
    k4_err = max(k4_err, check_k4("INT64 extremes", (b_ext, b_ok2, p_ext, p_ok), False))
    # the hash table's edges. Every build slot usable, distinct keys (an odd
    # multiplier is a bijection of int64), the probe keys drawn from the
    # partition's own build keys, one in 8 left unmatched
    P, part_cap = b_key.shape
    probe_cap = p_key.shape[1]
    all_b = torch.ones_like(b_ok)
    b_full = torch.arange(P * part_cap, device=dev).view(P, part_cap) * 0x3C6EF372FE94F82B
    pick = torch.randint(0, part_cap, (P, probe_cap), generator=gen, device=dev)
    miss = torch.rand(p_key.shape, generator=gen, device=dev) < 0.125
    p_full = torch.where(miss, b_full.gather(1, pick) ^ (1 << 62), b_full.gather(1, pick))
    k4_err = max(k4_err, check_k4("full partitions", (b_full, all_b, p_full, p_ok), False))
    # one chain: partition 0's build keys all share one home entry, 3 before
    # the table's end, so the chain wraps; its probes walk that chain
    size = 1 << table_bits(part_cap)
    cand = np.arange(1, 1 << 18, dtype=np.int64) * 7919
    chain = torch.from_numpy(cand[table_home(cand, part_cap) == size - 3][:part_cap + 64]).to(dev)
    if chain.numel() < part_cap + 64:
        raise SystemExit(f"K4 one hash chain: only {chain.numel()} keys found for one home entry")
    b_chain = b_full.clone()
    b_chain[0] = chain[:part_cap]
    p_chain = p_full.clone()
    p_chain[0] = chain[torch.randint(0, part_cap + 64, (probe_cap,), generator=gen, device=dev)]
    k4_err = max(k4_err, check_k4("one hash chain", (b_chain, all_b, p_chain, p_ok), False))
    # one key at slots 3, 5, 40, 77 and 120 (two warps' lanes, three more
    # warps): inserts race, so a later slot may sit first in the chain
    b_many = b_full.clone()
    for s_ in (5, 40, 77, 120):
        b_many[:, s_] = b_many[:, 3]
    p_many = p_full.clone()
    p_many[:, 0::2] = b_many[:, 3:4]
    k4_err = max(k4_err, check_k4("duplicate at a later slot found first", (b_many, all_b, p_many, p_ok), True))
    # part_cap 256 (two partitions' rows side by side) with every slot usable
    wide = (P // 2, 2 * part_cap), (P // 2, 2 * probe_cap)
    k4_err = max(k4_err, check_k4("part_cap 256", (b_full.view(wide[0]), all_b.view(wide[0]),
                                                   p_full.view(wide[1]), p_ok.view(wide[1])), False))
    # the wrapper's range beyond the gate: rows that are not a multiple of 4
    # (the scalar-load copy), a part_cap that is not a power of two
    for pc, qc in ((100, 1001), (100, 1)):
        rb = torch.arange(64 * pc, device=dev).view(64, pc) * 0x3C6EF372FE94F82B
        rk = rb.gather(1, torch.randint(0, pc, (64, qc), generator=gen, device=dev))
        rk = torch.where(torch.rand(rk.shape, generator=gen, device=dev) < 0.2, rk + 1, rk)
        k4_err = max(k4_err, check_k4(f"part_cap {pc}, probe_cap {qc}", (
            rb, torch.rand(rb.shape, generator=gen, device=dev) < 0.7, rk,
            torch.rand(rk.shape, generator=gen, device=dev) < 0.6), False))

    def shifted2d(x):
        """x as a view at a 1-element offset (the scalar-load copy)."""
        return shifted(x.reshape(-1)).view(x.shape)

    k4_err = max(k4_err, check_k4("misaligned tables", tuple(shifted2d(x) for x in k4_in), False))
    dup_in = (b_dup, b_ok2, torch.where(p_ok, b_dup[:, :1].expand_as(p_key), p_key), p_ok)
    check_k4("duplicate build key, again", dup_in, True)
    k4_err = max(k4_err, check_k4("two calls in a row after a dup", k4_in, False))
    first = K4.probe_tables(*k4_in)
    again = K4.probe_tables(*k4_in)
    torch.cuda.synchronize()
    compare("K4", "two calls in a row", again, first, k4_names)
    with torch.cuda.stream(side):
        k4_err = max(k4_err, check_k4("on a second stream", k4_in, False))
        check_k4("on a second stream, a dup", dup_in, True)

    # phase 4: the main paths, end to end
    q6_dag, q6_fts = W.q6_dag(E, X, T)
    q6_batch = device_batch_from_numpy(W.q6_columns(t), np.ones(n, bool), n, q6_fts, device=dev)
    cache = ProgramCache()

    def run_q6():
        return drive_program_info(cache, q6_dag, q6_batch, 64)

    q6_chunk, _, _ = counters.path("Q6", run_q6)
    got = (int(q6_chunk.columns[0].data[0]), int(q6_chunk.columns[1].data[0]))
    want = numpy_q6(t, T)
    if got != want:
        raise SystemExit(f"Q6 mismatch: port {got}, numpy {want}")
    log(f"phase 4 Q6 at {n} rows: revenue(scaled 1e4)={got[0]} count={got[1]} == numpy")

    def run_q1():
        return drive_program_info(cache, q1_dag, q1_batch, 64, small_groups=G)

    q1_chunk, _, _ = counters.path("Q1", run_q1, need=("dense_agg",))
    avg_agg = next(e for e in q1_dag.executors if isinstance(e, E.Aggregation)).aggs[3]
    shift = avg_agg.ft.decimal - avg_agg.partial_fts()[1].decimal
    got, want = decoded_q1(q1_chunk), numpy_q1(t, T, shift)
    if got != want:
        raise SystemExit(f"Q1 mismatch:\n port  {got}\n numpy {want}")
    log(f"phase 4 Q1 at {n} rows: {len(got)} groups == numpy")

    q3_gc = rung_for(n // 4)

    def run_q3():
        return drive_program_info(cache, q3_dag, q3_batches, q3_gc)

    q3_chunk, q3_counts, _ = counters.path("Q3", run_q3, need=("postsort_segscan", "membership_segscan"))
    got, want = decoded_q3(q3_chunk), numpy_q3(q3_cols, T)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:5]
        raise SystemExit(f"Q3 mismatch: port {len(got)} groups, numpy {len(want)}; first differences {diff}")
    log(f"phase 4 Q3 at {n} lineitem rows: {len(got)} groups == numpy; row counts {q3_counts}")

    jg_dag, jg_fts = W.join_bench_dag(E, X, T, groups=JOIN_GROUPS)
    jg_cols = W.join_bench_columns(n, JOIN_RATIO, False, JOIN_GROUPS)
    jg_batches = batches_of(jg_cols, jg_fts)
    js_cols = W.join_bench_columns(n, JOIN_RATIO, True)
    js_batches = batches_of(js_cols, jb_fts)
    join_cases = {
        "join 1:32 uniform": (jb_dag, jb_batches, jb_cols, False, 128, ("probe_tables",)),
        "join 1:32 uniform, 700 groups": (jg_dag, jg_batches, jg_cols, True, rung_for(JOIN_GROUPS), ("probe_tables",)),
        "join 1:32 skewed": (jb_dag, js_batches, js_cols, False, 128, ()),
    }
    radix = {}
    for name, (dag, batches, cols, grouped, gcap, need) in join_cases.items():
        chunk, _counts, info = counters.path(name, lambda: drive_program_info(cache, dag, batches, gcap), need=need)
        got, want = decoded_join(chunk, grouped), numpy_join(cols, grouped)
        if got != want:
            raise SystemExit(f"{name} mismatch: port {len(got)} rows, numpy {len(want)}")
        radix[name] = info.get("radix")
        log(f"phase 4 {name}: {len(got)} rows == numpy; radix {info.get('radix')}")
    if radix["join 1:32 uniform"]["strategy"] != "kernel" or radix["join 1:32 skewed"]["escapes"] < 1:
        raise SystemExit(f"radix attribution unexpected: {radix}")

    # the order-dependent executors: TopN (BASELINE config 4), its
    # full-sort retry, LIMIT above FAST_K_LIMIT, Sort and Window
    tn_dag, tn_fts = W.topn_dag(E, X, T, limit=TOPN_K)
    tn_batch = device_batch_from_numpy(W.topn_columns(t), np.ones(n, bool), n, tn_fts, device=dev)
    tn_cache = ProgramCache()

    def run_topn():
        return drive_program_info(tn_cache, tn_dag, tn_batch, 64)

    chunk, _, _ = counters.path("TopN", run_topn)
    check_rows("TopN", chunk, numpy_order(t["price"], t["shipdate"], TOPN_K), t["price"], t["shipdate"])
    if tn_cache.stats()["compiles"] != 1:
        raise SystemExit(f"TopN built {tn_cache.stats()['compiles']} programs; the fast path should hold")
    log(f"phase 4 TopN at {n} rows: the first {TOPN_K} rows == numpy, one program (the sampled fast path)")

    nb = TOPN_BIG_ROWS
    big_t = W.make_tables(nb, seed=0)
    big_price, big_ship = big_t["price"], big_t["shipdate"]
    del big_t
    big_batch = device_batch_from_numpy(W.topn_columns({"price": big_price, "shipdate": big_ship}),
                                        np.ones(nb, bool), nb, tn_fts, device=dev)

    def run_topn_big():
        return drive_program_info(tn_cache, tn_dag, big_batch, 64)

    chunk, _, _ = counters.path("TopN 2^26", run_topn_big)
    check_rows("TopN 2^26", chunk, numpy_order(big_price, big_ship, TOPN_K), big_price, big_ship)
    log(f"phase 4 TopN at {nb} rows: the first {TOPN_K} rows == numpy")
    del big_price, big_ship

    tie_price = np.full(n, 123456, np.int64)
    tie_batch = device_batch_from_numpy(W.topn_columns({"price": tie_price, "shipdate": t["shipdate"]}),
                                        np.ones(n, bool), n, tn_fts, device=dev)
    tie_cache = ProgramCache()

    def run_topn_tie():
        return drive_program_info(tie_cache, tn_dag, tie_batch, 64)

    chunk, _, _ = counters.path("TopN, every price equal", run_topn_tie)
    check_rows("TopN, every price equal", chunk, numpy_order(tie_price, t["shipdate"], TOPN_K), tie_price, t["shipdate"])
    if tie_cache.stats()["compiles"] != 2:
        raise SystemExit(f"the tie-heavy TopN built {tie_cache.stats()['compiles']} programs, not 2 (sampled, full sort)")
    log(f"phase 4 TopN at {n} rows, every price equal: == numpy through the full-sort retry (2 programs)")

    k4k_dag, _ = W.topn_dag(E, X, T, limit=4096)

    def run_topn_4096():
        return drive_program_info(tn_cache, k4k_dag, tn_batch, 64)

    chunk, _, _ = counters.path("TopN k = 4096", run_topn_4096)
    check_rows("TopN k = 4096", chunk, numpy_order(t["price"], t["shipdate"], 4096), t["price"], t["shipdate"])
    log(f"phase 4 TopN k = 4096 at {n} rows: == numpy (the direct full sort)")

    sort_dag, _ = W.sort_dag(E, X, T)

    def run_sort():
        return drive_program_info(tn_cache, sort_dag, tn_batch, 64)

    chunk, _, _ = counters.path("Sort", run_sort)
    check_rows("Sort", chunk, numpy_order(t["price"], t["shipdate"]), t["price"], t["shipdate"])
    log(f"phase 4 Sort at {n} rows: every row == numpy, in order")

    win_dag, win_fts = W.window_dag(E, X, T)
    win_cols = q3_cols[0]
    win_batch = device_batch_from_numpy(win_cols, np.ones(n, bool), n, win_fts, device=dev)

    def run_window():
        return drive_program_info(cache, win_dag, win_batch, 64)

    chunk, _, _ = counters.path("Window", run_window)
    want_v, want_n = numpy_window(win_cols)
    if chunk.num_rows() != n:
        raise SystemExit(f"Window: {chunk.num_rows()} rows, numpy {n}")
    for i, (c, (d, _null, _len)) in enumerate(zip(chunk.columns[:4], win_cols)):
        if not (np.array_equal(c.data.view(np.int64), d) and not c.null.any()):
            raise SystemExit(f"Window: input column {i} did not pass through")
    names = ("row_number", "rank", "dense_rank", "sum(price)", "count(*)", "max(disc)", "lag(price)", "first_value(price)")
    for nm, c, wv, wn in zip(names, chunk.columns[4:], want_v, want_n):
        if not np.array_equal(c.null, wn) or not np.array_equal(np.where(wn, 0, c.data.view(np.int64)), np.where(wn, 0, wv)):
            bad = np.nonzero((c.null != wn) | ((c.data.view(np.int64) != wv) & ~wn))[0][:5]
            raise SystemExit(f"Window {nm} differs from numpy at rows {bad.tolist()}")
    log(f"phase 4 Window at {n} lineitem rows: the 8 window columns == numpy (exact; none is real-valued)")

    # phase 5: times (the timing launches are not the main paths')
    timing = {}

    def time_kernel(name, cuda_names, kernel, plain, args, in_bytes, out_bytes, ops, one_op=False):
        call_ms = median_ms(lambda: kernel(*args))
        host_us = host_us_per_call(lambda: kernel(*args))
        k_ms, dev_ops = device_ms(lambda: kernel(*args), cuda_names)
        if one_op and dev_ops != 1:
            raise SystemExit(f"{name}: a wrapper call ran {dev_ops} device operations, not its one kernel")
        p_ms = median_ms(lambda: plain(*args))
        b_ms, b_by = bound(in_bytes, out_bytes, ops)
        timing[name] = (k_ms, p_ms, b_ms, b_by)
        log(f"phase 5 {name}: kernel {k_ms:.5f} ms on the device, {call_ms:.4f} ms a wrapper call "
            f"({host_us:.1f} us of it on the host), {dev_ops:g} device ops a call (plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
            f"{in_bytes + out_bytes} B, {ops} ops)")

    nc1 = len(q1_lanes[3])
    time_kernel("dense_agg", ("k1_kernel",), lambda *a: K1.dense_agg(*a, G), lambda *a: K1._dense_agg_plain(*a, G), q1_lanes,
                n * (8 + 8 + 1) + nc1 * n * (8 + 1), G * (4 + 8 * (1 + 2 * nc1)) + 8, n * (1 + 2 * nc1),
                one_op=True)
    n2, nl2 = k2_spk.shape[0], len(k2_lanes)
    nn2 = sum(1 for b in k2_bits if b >= 0)
    time_kernel("postsort_segscan", ("k2_",), K23.postsort_segscan, K23._postsort_segscan_plain,
                (k2_spk, k2_lanes, k2_bad, k2_nw, k2_bits),
                n2 * (4 + 4 * nl2 + 1 + (1 if nn2 else 0)), n2 * (1 + 8 + 4 + 8 * nl2 + 8 * nn2) + 16,
                n2 * (3 + nl2 + nn2))
    n3 = k3_spk.shape[0]
    k3_bytes = n3 * (4 + 1) + n3 + 1
    time_kernel("membership_segscan", ("k3_kernel",), K23.membership_segscan, K23._membership_segscan_plain, (k3_spk, k3_bad),
                n3 * (4 + 1), n3 + 1, n3 * K3_OPS_PER_ROW, one_op=True)
    # the floor under a kernel this small, timed as K3 is: the card's
    # smallest kernel (a one-element fill) and a device copy that moves
    # K3's bytes, half read and half written
    one = torch.empty(1, dtype=torch.int32, device=dev)
    fill_ms, _ = device_ms(lambda: one.fill_(0), ("",))
    src, dst = torch.ones(k3_bytes // 2, dtype=torch.uint8, device=dev), torch.empty(k3_bytes // 2, dtype=torch.uint8, device=dev)
    copy3_ms, _ = device_ms(lambda: dst.copy_(src), ("",))
    log(f"phase 5 membership_segscan floor: a one-element fill {fill_ms:.5f} ms, a device copy moving "
        f"{2 * (k3_bytes // 2)} B {copy3_ms:.5f} ms, K3 {timing['membership_segscan'][0]:.5f} ms (device time, {REPS} calls each)")
    del src, dst
    compares = int((p_ok.sum(1) * b_ok.sum(1)).sum())
    k4_bytes = K4.probe_tables_bytes(b_ok, p_ok)
    time_kernel("probe_tables", ("probe_kernel",), K4.probe_tables, K4._probe_tables_plain, k4_in,
                *k4_bytes, 2 * compares, one_op=True)
    # what the card streams: one device copy (8-byte elements) that moves
    # K4's bytes, half read and half written
    words = sum(k4_bytes) // 16
    src, dst = torch.ones(words, dtype=torch.int64, device=dev), torch.empty(words, dtype=torch.int64, device=dev)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=50)
    log(f"phase 5 probe_tables yardstick: a device copy moving the same {16 * words} B takes {copy_ms:.4f} ms "
        f"({16 * words / copy_ms / 1e9:.2f} TB/s)")
    del src, dst
    counters.zero()

    # phase 5b: each kernel's region-batched launch (the vmap rule of its
    # custom op) over BATCH_LANES lanes of phase 3's inputs, every lane's
    # data different, against the plain version lane by lane, bit for bit;
    # then its device time beside BATCH_LANES single calls and its bound
    B = BATCH_LANES

    def lanes_of(outs, b):
        return [[x[b] for x in o] if isinstance(o, (list, tuple)) else o[b] for o in outs]

    def check_batched(name, call, plain_lanes, names, want_flags, flag_at):
        got, fallback = vmap_fallbacks(call)
        torch.cuda.synchronize()
        if fallback:
            raise SystemExit(f"{name}: vmap ran {fallback} lane by lane")
        err = 0
        for b in range(B):
            err = max(err, compare(name, f"batched lane {b}", lanes_of(got, b), plain_lanes[b](), names))
        flags = [bool(x) for x in got[flag_at]]
        if flags != want_flags:
            raise SystemExit(f"{name} batched: flags {flags}, expected {want_flags}")
        return err

    batched_timing = {}

    def time_batched(name, cuda_names, call, singles, single_in_out_ops, one_op):
        """The batched call's device time beside the single calls over the
        same lanes' inputs (`singles` runs them one after another) and its
        bound over B times a single call's bytes and operations."""
        k_ms, dev_ops = device_ms(call, cuda_names)
        if one_op and dev_ops != 1:
            raise SystemExit(f"{name} batched: a call ran {dev_ops} device operations, not its one kernel")
        s_ms, _ = device_ms(singles, cuda_names, launches=B)
        call_ms, s_call_ms = median_ms(call), median_ms(singles)
        in_b, out_b, ops = single_in_out_ops
        b_ms, b_by = bound(B * in_b, B * out_b, B * ops)
        batched_timing[name] = (k_ms, s_ms, b_ms)
        log(f"phase 5b {name}: one batched launch over {B} lanes {k_ms:.5f} ms on the device ({call_ms:.4f} ms a "
            f"call, {dev_ops:g} device ops); the {B} lanes as single calls {s_ms:.5f} ms on the device ({s_call_ms:.4f} "
            f"ms); batched / singles {k_ms / s_ms:.3f}; bound {b_ms:.4f} ms by {b_by} ({B * (in_b + out_b)} B)")

    roll = [0, 12345, 0, 0]
    k1_lane_in = [q1_lanes, tuple(torch.roll(x, roll[1]) if torch.is_tensor(x) else [torch.roll(v, roll[1]) for v in x]
                                  for x in q1_lanes),
                  K1.dense_agg_lanes([rflag_nulls, gvals[1]], aggs, valid, G)[:5],
                  K1.dense_agg_lanes([wide_key], aggs, valid, G)[:5]]
    k1_st = [torch.stack([lane[i] for lane in k1_lane_in]) for i in range(3)]
    k1_vals = [torch.stack([lane[3][c] for lane in k1_lane_in]) for c in range(nc1)]
    k1_nulls = [torch.stack([lane[4][c] for lane in k1_lane_in]) for c in range(nc1)]

    def k1_batched():
        return torch.func.vmap(lambda hp, hv, va, *vn: K1.dense_agg(hp, hv, va, list(vn[:nc1]), list(vn[nc1:]), G))(
            *k1_st, *k1_vals, *k1_nulls)

    counters.zero()
    k1_err = max(k1_err, check_batched("dense_agg", k1_batched,
                                       [lambda b=b: K1._dense_agg_plain(*k1_lane_in[b], G) for b in range(B)],
                                       k1_names, [False, False, False, True], 2))
    require_launches("K1 batched", counters.read()["dense_agg"], 1)
    log(f"phase 5b K1 batched ({B} lanes x {n} rows, lane 3 with 40 keys > G): each lane == plain, one launch")
    time_batched("dense_agg", ("k1_kernel",), k1_batched, lambda: [K1.dense_agg(*x, G) for x in k1_lane_in],
                 (n * (8 + 8 + 1) + nc1 * n * (8 + 1), G * (4 + 8 * (1 + 2 * nc1)) + 8, n * (1 + 2 * nc1)), True)

    def shift_keys(spk, b):
        """spk moved up by 2b below the pinned rows: still sorted, each
        row's side kept."""
        return torch.where(spk < K23.PIN - 8, spk + 2 * b, spk)

    def bad_on_last_lane(bad, b):
        if b != B - 1:
            return bad
        out = bad.clone()
        out[0] = True
        return out

    k2_lane_in = [(shift_keys(k2_spk, b), [torch.where(x != 0, x + b, x) for x in k2_lanes],
                   bad_on_last_lane(k2_bad, b), k2_nw, k2_bits) for b in range(B)]
    k2_st = [torch.stack([ln[0] for ln in k2_lane_in]), [torch.stack([ln[1][c] for ln in k2_lane_in]) for c in range(nl2)],
             torch.stack([ln[2] for ln in k2_lane_in]), torch.stack([ln[3] for ln in k2_lane_in])]

    def k2_batched():
        return torch.func.vmap(lambda sp, bd, nw, *ln: K23.postsort_segscan(sp, list(ln), bd, nw, k2_bits))(
            k2_st[0], k2_st[2], k2_st[3], *k2_st[1])

    names2 = k2_names[:3] + k2_names[3:3 + nl2] + k2_names[5:5 + nl2] + k2_names[7:]
    counters.zero()
    k2_err = max(k2_err, check_batched("postsort_segscan", k2_batched,
                                       [lambda b=b: K23._postsort_segscan_plain(*k2_lane_in[b]) for b in range(B)],
                                       names2, [False, False, False, True], 5))
    require_launches("K2 batched", counters.read()["postsort_segscan"], 1)
    log(f"phase 5b K2 batched ({B} lanes x {n2} rows, lane 3 with a bad bit): each lane == plain, one launch")
    time_batched("postsort_segscan", ("k2_",), k2_batched, lambda: [K23.postsort_segscan(*x) for x in k2_lane_in],
                 (n2 * (4 + 4 * nl2 + 1 + (1 if nn2 else 0)), n2 * (1 + 8 + 4 + 8 * nl2 + 8 * nn2) + 16,
                  n2 * (3 + nl2 + nn2)), False)

    k3_lane_in = [(shift_keys(k3_spk, b), bad_on_last_lane(k3_bad, b)) for b in range(B)]
    k3_st = [torch.stack([ln[i] for ln in k3_lane_in]) for i in range(2)]

    def k3_batched():
        return torch.func.vmap(K23.membership_segscan)(*k3_st)

    counters.zero()
    k3_err = max(k3_err, check_batched("membership_segscan", k3_batched,
                                       [lambda b=b: K23._membership_segscan_plain(*k3_lane_in[b]) for b in range(B)],
                                       ("ok_out", "overflow"), [False, False, False, True], 1))
    require_launches("K3 batched", counters.read()["membership_segscan"], 1)
    log(f"phase 5b K3 batched ({B} lanes x {n3} rows, lane 3 with a bad bit): each lane == plain, one launch")
    time_batched("membership_segscan", ("k3_kernel",), k3_batched,
                 lambda: [K23.membership_segscan(*x) for x in k3_lane_in], (n3 * (4 + 1), n3 + 1, n3 * K3_OPS_PER_ROW), True)

    # K4: the build tables shared (no region axis, as the broadcast build
    # side reaches the kernel), a different probe side per lane
    keep = torch.rand(p_ok.shape, generator=gen, device=dev) < 0.8
    k4_lane_p = [(p_key, p_ok), (p_key, p_ok & keep), (p_key + (1 << 40), p_ok), (torch.roll(p_key, 1, dims=1), p_ok)]
    k4_pk = torch.stack([x[0] for x in k4_lane_p])
    k4_po = torch.stack([x[1] for x in k4_lane_p])

    def k4_batched():
        return torch.func.vmap(lambda pk_, po_: K4.probe_tables(b_key, b_ok, pk_, po_))(k4_pk, k4_po)

    counters.zero()
    k4_err = max(k4_err, check_batched("probe_tables", k4_batched,
                                       [lambda b=b: K4._probe_tables_plain(b_key, b_ok, *k4_lane_p[b]) for b in range(B)],
                                       k4_names, [False] * B, 1))
    require_launches("K4 batched", counters.read()["probe_tables"], 1)
    log(f"phase 5b K4 batched ({B} lanes, plan {tuple(b_key.shape)} x {p_key.shape[1]}, one build table shared): "
        f"each lane == plain, one launch")
    time_batched("probe_tables", ("probe_kernel",), k4_batched,
                 lambda: [K4.probe_tables(b_key, b_ok, *x) for x in k4_lane_p], (*k4_bytes, 2 * compares), True)
    del k1_lane_in, k1_st, k1_vals, k1_nulls, k2_lane_in, k2_st, k3_lane_in, k3_st, k4_pk, k4_po
    counters.zero()

    paths = {
        "Q6": (run_q6, n), "Q1": (run_q1, n),
        "Q3": (run_q3, sum(int(b.n_rows) for b in q3_batches)),
    }
    for name, (dag, batches, _c, _g, gcap, _n) in join_cases.items():
        paths[name] = ((lambda d=dag, b=batches, g=gcap: drive_program_info(cache, d, b, g)),
                       sum(int(x.n_rows) for x in batches))
    paths.update({
        "TopN": (run_topn, n), "TopN 2^26": (run_topn_big, nb),
        "TopN, every price equal (retry)": (run_topn_tie, n), "TopN k = 4096": (run_topn_4096, n),
        "Sort": (run_sort, n), "Window": (run_window, n),
    })
    wall = {}
    for name, (fn, rows) in paths.items():
        ms = host_median_ms(fn)
        wall[name] = ms
        log(f"phase 5 {name} end to end: {ms:.3f} ms ({rows / ms / 1e3:.1f} Mrows/s, {rows} rows)")
    if "--profile" in sys.argv[1:]:
        for name, (fn, _rows) in paths.items():
            profile_path(name, fn, wall[name])
    counters.zero()

    # phases 6 and 7: the store's coprocessor endpoints
    store = store_phase(E, X, T, W, counters, dev, "--profile" in sys.argv[1:])
    # phase 8: the statement's root half on phase 7's regions
    wholes = root_phase(store, E, X, T, W, counters, "--profile" in sys.argv[1:], smi)
    # phase 9: the dispatch loop, execute_root in every tier
    sizes = dispatch_phase(store, E, X, T, W, counters, "--profile" in sys.argv[1:], smi, wholes)
    # phase 10: the expression families, the customer table beside lineitem
    expr_phase(store, E, X, T, W, counters, "--profile" in sys.argv[1:], smi, sizes)
    # phase 11: the SQL session over its own store, the tables copied in
    sess = session_phase(store, E, X, T, W, counters, "--profile" in sys.argv[1:], smi, sizes)
    # phase 12: the device mesh, four shards of the card
    mesh_phase(sess, E, X, T, W, counters, "--profile" in sys.argv[1:], smi, sizes)
    # phase 14 reads phase 11's tables as they stand before phase 13 writes
    snap_ts = sess.store.next_ts()
    # phase 13: the control plane on phase 11's session and store
    want = control_phase(sess, E, X, T, W, counters, "--profile" in sys.argv[1:], smi)
    # phase 14: change data capture and the columnar replica
    replicated = cdc_phase(sess, snap_ts, E, X, T, W, counters, "--profile" in sys.argv[1:], smi)
    # phase 15: the front door over phase 11's store and catalog
    front_ms = front_phase(sess, want, E, X, T, W, counters, "--profile" in sys.argv[1:], smi)
    # phase 16: BR and point-in-time recovery over phase 14's session
    br_phase(*replicated, E, X, T, W, counters, "--profile" in sys.argv[1:], smi)
    # phase 17: the seeded chaos storms, the second over phase 11's tables
    storm_phase(sess, want, counters, smi, front_ms)
    main_launches = dict(counters.main)
    counters.zero()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    sources = {
        "dense_agg": ("tidb_tpu_torch/csrc/dense_agg.cu", "tidb_tpu/ops/dense_pallas.py:223", k1_err),
        "postsort_segscan": ("tidb_tpu_torch/csrc/joinscan.cu", "tidb_tpu/ops/joinscan.py:198", k2_err),
        "membership_segscan": ("tidb_tpu_torch/csrc/joinscan.cu", "tidb_tpu/ops/joinscan.py:344", k3_err),
        "probe_tables": ("tidb_tpu_torch/csrc/join_probe.cu", "tidb_tpu/ops/join_pallas.py:103", k4_err),
    }
    record = {"kernels": []}
    for name, (src, replaces, err) in sources.items():
        k_ms, p_ms, b_ms, b_by = timing[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
