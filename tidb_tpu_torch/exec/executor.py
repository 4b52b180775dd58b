"""Host-side DAG drivers (port of tidb_tpu/exec/executor.py).

run_dag_on_chunk(s): pad host Chunks into DeviceBatches, run the program,
decode outputs back to a host Chunk. drive_batched_program_info runs the
region-batched program once over a stack of regions and slices each
region's result out; a region whose flags fired answers None.
drive_mesh_program_info runs the mesh program once over a stack of
regions split over the mesh's shards and returns ONE merged chunk, or
None when its global overflow flag fired.

Each drive_*_info function opens three spans under the ambient one for
every program run: `exec.launch` (the program's call, which enqueues its
device work), `exec.wait` (the first blocking read, the overflow flags:
the host waits for the device) and `exec.fetch` (the other
device-to-host reads and the decode into a Chunk); info["fetches"]
counts the device-to-host reads.

drive_program_info handles the overflow contract: on overflow it retries
on the capacity ladder (exec/ladder.py), drops a wrong small-G hint,
drops the unique-build and radix join hints when no rung can clear a
join overflow, and rebuilds a TopN whose sampled threshold missed as the
exact full sort. Exhausted
retries raise OverflowRetryError, and operators the device program does
not express raise NotImplementedError.

run_dag_on_chunks catches both: an exhausted overflow first spills
(_spill_partitioned: the input partitions on the host and the same
program runs once per part), and what neither the device nor the spill
can run goes to the oracle.

run_dag_reference: the row-at-a-time oracle, copied from the JAX package
(`tidb_tpu/exec/executor.py`, datum_group_key .. _ref_join). It
interprets the same DAG with RefEvaluator; the store and
run_dag_on_chunks fall back to it when the device path raises either
error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..chunk import Chunk, Column, to_device_batch
from ..expr.agg import AggDesc
from ..expr.eval_ref import RefEvaluator, compare, _truth
from ..expr.ir import ColumnRef
from ..types import Datum, DatumKind, FieldType, MyDecimal
from ..util import metrics, tracing
from .builder import DEFAULT_GROUP_CAPACITY, ProgramCache
from .dag import Aggregation, DAGRequest, Join, Limit, Projection, Selection, Sort, TableScan, TopN, Window, current_schema_fts
from .ladder import overflow_step, rung_for


def _pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Reads:
    """The device-to-host reads of one drive_*_info call, counted
    (info["fetches"]): each read of a tensor counts one; host arrays
    count none."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def array(self, x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            self.n += 1
        return _np(x)

    def scalar(self, x):
        if isinstance(x, torch.Tensor):
            self.n += 1
            return x.item()
        return x


def decode_outputs(packed, valid, out_fts, fetch=_np) -> Chunk:
    """The program's packed outputs as a host Chunk of the valid rows;
    `fetch` brings each leaf to the host (drive_*_info's counting read)."""
    valid = fetch(valid)
    idx = np.nonzero(valid)[0]
    cols = []
    for ft, out in zip(out_fts, packed):
        if len(out) == 4:  # string: words, null, raw bytes, lengths
            _, null, data, length = out
            null = fetch(null)[idx]
            data = fetch(data)[idx]
            length = fetch(length)[idx]
            keep = np.where(null, 0, length)
            offs = np.zeros(len(idx) + 1, np.int64)
            np.cumsum(keep, out=offs[1:])
            # each row's first `keep` bytes, in row order
            blob = np.ascontiguousarray(data[np.arange(data.shape[1])[None, :] < keep[:, None]], np.uint8)
            cols.append(Column(ft, None, null, offs, blob))
        elif ft.is_string() and out[0].ndim == 2:
            # string column without raw bytes (e.g. CASE/IF over string
            # operands): reconstruct from the packed compare words — covers
            # the first STRING_WORDS*8 bytes, the packed-key contract
            words, null = fetch(out[0]), fetch(out[1])
            words, null = words[idx], null[idx]
            w = words.shape[1] - 1
            payload = (words[:, :w].astype(np.uint64) ^ np.uint64(1 << 63))
            length = np.minimum(np.maximum(words[:, w], 0), w * 8).astype(np.int64)
            length = np.where(null, 0, length)
            byte_mat = np.zeros((len(idx), w * 8), np.uint8)
            for k in range(w):
                for b in range(8):
                    byte_mat[:, k * 8 + b] = ((payload[:, k] >> np.uint64(56 - 8 * b)) & np.uint64(0xFF)).astype(np.uint8)
            offs = np.zeros(len(idx) + 1, np.int64)
            np.cumsum(length, out=offs[1:])
            blob = np.ascontiguousarray(byte_mat[np.arange(w * 8)[None, :] < length[:, None]], np.uint8)
            cols.append(Column(ft, None, null.copy(), offs, blob))
        else:
            v, null = out
            v = fetch(v)[idx]
            null = fetch(null)[idx]
            if ft.is_unsigned() or ft.is_time():
                v = v.view(np.uint64) if v.dtype == np.int64 else v.astype(np.uint64)
            cols.append(Column(ft, v.copy(), null.copy()))
    return Chunk(cols)


# Shared default so repeated executions of the same plan shape reuse the
# built program.
DEFAULT_PROGRAM_CACHE = ProgramCache()


class OverflowRetryError(RuntimeError):
    """Capacity growth retries exhausted (run_dag_on_chunks spills, then
    falls back to the row oracle; the store goes to the oracle)."""


def drive_program(cache: ProgramCache, dag: DAGRequest, batches, group_capacity: int, max_retries: int = 3, join_capacity: int | None = None, small_groups: int | None = None):
    """drive_program_info without the attribution dict:
    (chunk, per-executor produced-row counts, scan first)."""
    chunk, counts, _ = drive_program_info(cache, dag, batches, group_capacity, max_retries, join_capacity, small_groups)
    return chunk, counts


def _radix_attribution(prog, jc: int, esc: int, info: dict):
    """info["radix"]: what the first radix join of the program ran
    (partitions, probe strategy), the join-capacity rung, and the escaped
    row count, already on the host."""
    ri = prog.radix_info
    if ri:
        with tracing.span("exec.join_radix", partitions=ri.get("partitions"), rung=jc, escapes=esc,
                          strategy=ri.get("strategy")):
            pass
        info["radix"] = {"partitions": ri.get("partitions", 0), "rung": jc,
                         "escapes": esc, "strategy": ri.get("strategy")}


def drive_program_info(cache: ProgramCache, dag: DAGRequest, batches, group_capacity: int, max_retries: int = 3, join_capacity: int | None = None, small_groups: int | None = None):
    """Run the program, growing capacity on overflow; returns (chunk,
    counts, {"cache_hit", "compile_ns"[, "radix"]}). batches: one
    DeviceBatch per scan in canonical order (a single batch for single-scan
    DAGs); the program runs on their device.

    Capacities snap to the ladder rungs; an overflow retry consults the
    program's NEED hints to re-dispatch the exact rung. A group overflow
    also drops the small-G hint (`smg = None`): the driver cannot tell
    whether the one-pass kernel ran, so doing both never wastes a retry. A
    join overflow that no rung can clear (a violated unique-build hint, a
    hash collision) drops the unique-build and radix hints, so the retry
    lands on the general kernel (ops/join.py). A TopN overflow (its sampled
    threshold missed) rebuilds with topn_full=True, the exact full sort."""
    if not isinstance(batches, (list, tuple)):
        batches = [batches]
    device = batches[0].row_valid.device
    caps = tuple(b.capacity for b in batches)
    gc = rung_for(group_capacity)
    jc = rung_for(join_capacity or max(caps))
    tf = False
    smg = small_groups
    uj = True
    rj = True
    info = {"cache_hit": True, "compile_ns": 0}
    reads = _Reads()
    for _ in range(max_retries + 1):
        prog, hit, build_ns = cache.get_info(dag, caps, gc, jc, tf, smg, device=device, unique_joins=uj,
                                             radix_joins=rj)
        t0 = time.perf_counter_ns()
        metrics.PROGRAM_LAUNCHES.inc()
        with tracing.span("exec.launch"):
            packed, valid, n, (g_ovf, j_ovf, t_ovf, g_need, j_need, radix_esc), ex_rows = prog.fn(*batches)
        with tracing.span("exec.wait"):
            g_ovf = bool(reads.scalar(g_ovf))
            j_ovf, t_ovf = bool(reads.scalar(j_ovf)), bool(reads.scalar(t_ovf))
        if not hit:
            info["cache_hit"] = False
            info["compile_ns"] += build_ns + (time.perf_counter_ns() - t0)
        if not g_ovf and not j_ovf and not t_ovf:
            with tracing.span("exec.fetch"):
                counts = [int(x) for x in reads.array(ex_rows)]
                esc = int(reads.scalar(radix_esc)) if prog.radix_info else 0
                chunk = decode_outputs(packed, valid, prog.out_fts, reads.array)
            _radix_attribution(prog, jc, esc, info)
            info["fetches"] = reads.n
            return chunk, counts, info
        with tracing.span("exec.fetch"):
            g_need, j_need = int(reads.scalar(g_need)), int(reads.scalar(j_need))
        if g_ovf:
            smg = None
        gc, jc, drop = overflow_step(gc, jc, g_ovf, j_ovf, g_need, j_need)
        if drop:
            uj = False
            rj = False
        if t_ovf:
            tf = True  # TopN candidate overflow: the exact full-sort variant
    raise OverflowRetryError("DAG overflow not resolved after retries")


def _slice_region(packed, b: int) -> list:
    """Region lane `b` of the region-batched program's packed outputs
    (host arrays): each leaf loses its leading region axis, which gives
    the single-region layout decode_outputs consumes."""
    return [tuple(a[b] for a in out) for out in packed]


def drive_batched_program_info(cache: ProgramCache, dag: DAGRequest, stacked, aux_batches, group_capacity: int,
                               join_capacity: int | None = None, small_groups: int | None = None):
    """ONE execution of the region-batched program over a region-stacked
    probe batch (chunk/device.py to_stacked_device_batch), the build-side
    batches shared: the device half of the batch coprocessor. Where the
    per-region path runs the program once per region, this runs it once
    for all of them, then slices each region's result out.

    The flag vectors, ex_rows and the radix escapes come back in one host
    fetch. Returns (per_region, info): per_region[b] is (chunk,
    per-executor row counts) for a lane that completed, or None for a lane
    whose group, join or TopN flag fired (overflow is data-dependent per
    region, so only that region falls out; the caller retries it through
    the single-region ladder, drive_program_info). info is the batch's
    {"cache_hit", "compile_ns"[, "radix"]}; "radix" carries
    "escapes_by_lane", aligned with per_region."""
    B, cap = stacked.row_valid.shape
    caps = (int(cap),) + tuple(b.capacity for b in aux_batches)
    jc = rung_for(join_capacity or max(caps))
    prog, hit, build_ns = cache.get_info(dag, caps, rung_for(group_capacity), jc, False, small_groups,
                                         device=stacked.device, vmap_batch=int(B))
    t0 = time.perf_counter_ns()
    metrics.PROGRAM_LAUNCHES.inc()
    reads = _Reads()
    with tracing.span("exec.launch"):
        packed, valid, _n, flags, ex_rows = prog.fn(stacked, *aux_batches)
    g_ovf, j_ovf, t_ovf, _g_need, _j_need, radix_esc = flags
    with tracing.span("exec.wait"):
        # one fetch: the three flags, the escapes and ex_rows side by side
        head = torch.stack([g_ovf.to(torch.int64), j_ovf.to(torch.int64), t_ovf.to(torch.int64),
                            radix_esc.to(torch.int64)], dim=1)
        fetched = reads.array(torch.cat([head, ex_rows.to(torch.int64)], dim=1))
    info = {"cache_hit": hit, "compile_ns": 0}
    if not hit:
        # the fetch above waited for the program: the first call's time
        # counts as build time, as drive_program_info counts it
        info["compile_ns"] = build_ns + (time.perf_counter_ns() - t0)
    fell = fetched[:, :3].any(axis=1)
    per_region: list = []
    esc_by_lane: list = []
    with tracing.span("exec.fetch"):
        host_packed = [tuple(reads.array(a) for a in out) for out in packed] if not fell.all() else []
        valid_np = reads.array(valid) if not fell.all() else None
        for b in range(int(B)):
            if fell[b]:
                per_region.append(None)
                esc_by_lane.append(0)
                continue
            esc_by_lane.append(int(fetched[b, 3]))
            chunk = decode_outputs(_slice_region(host_packed, b), valid_np[b], prog.out_fts)
            per_region.append((chunk, [int(x) for x in fetched[b, 4:]]))
    info["fetches"] = reads.n
    _radix_attribution(prog, jc, sum(esc_by_lane), info)
    if "radix" in info:
        # each lane's own escapes (the batch total stamped on every lane
        # would multiply in a sum over the lanes' summaries)
        info["radix"]["escapes_by_lane"] = esc_by_lane
    return per_region, info


def drive_mesh_program_info(cache: ProgramCache, dag: DAGRequest, stacked, aux_batches, group_capacity: int,
                            kind: str, mesh, join_capacity: int | None = None, small_groups: int | None = None):
    """ONE run of the mesh program over a region-stacked batch: the device
    half of the MESH dispatch tier. The stacked lanes split over the
    mesh's shards (a parallel/mesh.py RegionMesh), each shard runs the
    region-batched program over its lanes, and the per-region partial
    results merge across the shards per `kind` (a sum / min / max of
    partial states, a merge-mode re-group, a re-top-k), so the caller gets
    ONE merged chunk instead of R per-region partials.

    The global overflow flag, the radix escapes and every lane's row counts
    come back in one host fetch. Returns (chunk, lane_counts, info): chunk
    is None when the overflow flag fired (the caller degrades to the
    batched tier, whose per-lane capacity ladder takes over);
    lane_counts[b] is lane b's per-executor produced-row counts; info is
    the {"cache_hit", "compile_ns"[, "radix"]} attribution."""
    R, cap = stacked.row_valid.shape
    caps = (int(cap),) + tuple(b.capacity for b in aux_batches)
    jc = rung_for(join_capacity or max(caps))
    prog, hit, build_ns = cache.get_info(dag, caps, rung_for(group_capacity), jc, False, small_groups,
                                         device=stacked.device, mesh_lanes=int(R), mesh_devices=mesh,
                                         mesh_kind=kind)
    t0 = time.perf_counter_ns()
    metrics.PROGRAM_LAUNCHES.inc()
    reads = _Reads()
    with tracing.span("exec.launch"):
        merged, mvalid, ex_rows, ovf, radix_esc = prog.fn(stacked, *aux_batches)
    with tracing.span("exec.wait"):
        head = torch.stack([ovf.to(torch.int64).reshape(()), radix_esc.to(torch.int64).reshape(())])
        fetched = reads.array(torch.cat([head, ex_rows.to(torch.int64).reshape(-1)]))
    info = {"cache_hit": hit, "compile_ns": 0}
    if not hit:
        # the fetch above waited for the program: the first call's time
        # counts as build time, as drive_program_info counts it
        info["compile_ns"] = build_ns + (time.perf_counter_ns() - t0)
    lane_counts = [[int(x) for x in row] for row in fetched[2:].reshape(int(R), -1)]
    with tracing.span("exec.fetch"):
        chunk = None if fetched[0] else decode_outputs(merged, mvalid, prog.out_fts, reads.array)
    info["fetches"] = reads.n
    if chunk is None:
        return None, lane_counts, info
    _radix_attribution(prog, jc, int(fetched[1]), info)
    return chunk, lane_counts, info


def _group_key_partition(chunk: Chunk, key_cols: list[int], n_parts: int, salt: int = 0) -> list[Chunk]:
    """Split rows by a host-side hash of the named columns: equal keys land
    in the same part, so per-part aggregation results are disjoint. `salt`
    varies per recursion depth — an unsalted re-partition of one part maps
    every row back into a single bucket. The hash is the JAX package's,
    Python's (per-process salted) hash() of string bytes included, so in
    one process both packages partition alike."""
    n = chunk.num_rows()
    h = np.full(n, 1469598103934665603 ^ (salt * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF), np.uint64)
    prime = np.uint64(1099511628211)
    for ci in key_cols:
        col = chunk.columns[ci]
        if col.is_varlen():
            w = np.fromiter(
                (0 if col.null[i] else hash(col.get_bytes(i)) & 0xFFFFFFFFFFFFFFFF
                 for i in range(n)),
                np.uint64, count=n,
            )
        else:
            w = np.where(col.null, 0, col.data).astype(np.uint64)
        h = (h ^ w) * prime
    part = (h % np.uint64(n_parts)).astype(np.int64)
    return [chunk.take(np.nonzero(part == p)[0]) for p in range(n_parts)]


def _spill_partitioned(dag: DAGRequest, chunks, cache, group_capacity, small_groups, depth, device) -> Chunk:
    """Out-of-capacity execution — the spill analog (ref:
    pkg/executor/aggregate/agg_spill.go, join/hash_join_spill.go): when
    device capacity retries exhaust, the input partitions on the HOST and
    the same program runs once per partition — device kernels only, never
    the row-at-a-time oracle.

      * Partial-mode aggregation: ANY row split works (the downstream
        Final merge combines duplicate groups), so halve the probe chunk.
      * Complete/Final aggregation over bare column group keys: partition
        rows by a host hash of the key columns into 4 parts — per-part
        group sets are disjoint and results concatenate.
      * Join/Selection/Projection-terminal DAGs whose every executor is
        row-local: halve the probe side (each probe row's matches are
        independent); slices concatenate in probe order.

    Each level counts once in SPILL_PARTITIONS; at most 4 levels. Raises
    OverflowRetryError when no safe decomposition exists."""
    if depth >= 4:
        raise OverflowRetryError("spill partitioning depth exhausted")
    probe = chunks[0]
    n = probe.num_rows()
    if n < 2:
        raise OverflowRetryError("cannot partition a <2-row input")
    last = dag.executors[-1]

    def run_parts(parts: list) -> Chunk:
        outs = [
            run_dag_on_chunks(dag, [p] + list(chunks[1:]), cache=cache, group_capacity=group_capacity,
                              oracle_fallback=False, small_groups=small_groups, device=device,
                              _spill_depth=depth + 1)
            for p in parts if p.num_rows()
        ]
        return Chunk.concat(outs) if outs else Chunk.empty(dag.output_fts())

    if isinstance(last, Aggregation):
        simple_pipeline = all(isinstance(e, (TableScan, Selection)) for e in dag.executors[:-1])
        if last.partial and simple_pipeline:
            metrics.SPILL_PARTITIONS.inc()
            return run_parts([probe.slice(0, n // 2), probe.slice(n // 2, n)])
        if simple_pipeline and last.group_by and all(isinstance(g, ColumnRef) for g in last.group_by):
            metrics.SPILL_PARTITIONS.inc()
            keys = [g.index for g in last.group_by]
            return run_parts(_group_key_partition(probe, keys, 4, salt=depth + 1))
        raise OverflowRetryError("no safe spill decomposition for this aggregation")
    row_local = all(isinstance(e, (TableScan, Selection, Projection, Join)) for e in dag.executors)
    if row_local and isinstance(last, (Join, Selection, Projection)):
        # probe-halving is only sound when EVERY main-pipeline executor is
        # row-local: a mid-pipeline Aggregation/TopN/Limit/Window would
        # make per-half results non-concatenable
        metrics.SPILL_PARTITIONS.inc()
        return run_parts([probe.slice(0, n // 2), probe.slice(n // 2, n)])
    raise OverflowRetryError(f"no spill decomposition for {type(last).__name__}")


def run_dag_on_chunks(
    dag: DAGRequest,
    chunks: list,
    cache: ProgramCache | None = None,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    max_retries: int = 3,
    oracle_fallback: bool = True,
    small_groups: int | None = None,
    device="cuda",
    _spill_depth: int = 0,
) -> Chunk:
    """Device path over one chunk per scan. Capacity-retry exhaustion
    first tries host-partitioned multi-pass device execution (the spill
    analog); the row oracle is the last resort, also for operators the
    device program does not express. With oracle_fallback=False both
    errors propagate. Nothing else is caught: the no-CUDA error, kernel
    build and launch failures pass through."""
    cache = cache or DEFAULT_PROGRAM_CACHE
    try:
        batches = [to_device_batch(c, capacity=_pow2(max(c.num_rows(), 1)), device=device) for c in chunks]
        return drive_program(cache, dag, batches, group_capacity, max_retries, small_groups=small_groups)[0]
    except OverflowRetryError:  # a RuntimeError, caught alone: a missing card or a kernel's failure passes
        try:
            return _spill_partitioned(dag, chunks, cache, group_capacity, small_groups, _spill_depth, device)
        except OverflowRetryError:
            if not oracle_fallback:
                raise
        rows = run_dag_reference(dag, chunks)
        return Chunk.from_rows(dag.output_fts(), rows)
    except NotImplementedError:
        # a host-only operator (replace, group_concat): the row-at-a-time
        # oracle is the documented fallback
        if not oracle_fallback:
            raise
        rows = run_dag_reference(dag, chunks)
        return Chunk.from_rows(dag.output_fts(), rows)


def run_dag_on_chunk(
    dag: DAGRequest,
    chunk: Chunk,
    cache: ProgramCache | None = None,
    capacity: int | None = None,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    max_retries: int = 3,
    device="cuda",
) -> Chunk:
    cache = cache or DEFAULT_PROGRAM_CACHE
    cap = capacity or _pow2(max(chunk.num_rows(), 1))
    batch = to_device_batch(chunk, capacity=cap, device=device)
    return drive_program(cache, dag, batch, group_capacity, max_retries)[0]


# ---------------------------------------------------------------------------
# Reference interpreter (oracle)
# ---------------------------------------------------------------------------

def datum_group_key(d: Datum, ft: FieldType | None = None):
    if d.is_null():
        return (0, None)
    if d.kind == DatumKind.MysqlJSON:
        return (1, bytes(d.val))
    if d.kind in (DatumKind.MysqlEnum, DatumKind.MysqlSet):
        return (1, int(d.val))
    if d.kind == DatumKind.MysqlDecimal:
        return (1, str(d.val.d.normalize()))
    if d.kind in (DatumKind.String, DatumKind.Bytes):
        if ft is not None and ft.is_ci():
            # one group per collation WEIGHT key (full Unicode,
            # types/collate.py — é and É and e share a unicode_ci group)
            from ..types.collate import weight_bytes

            return (1, weight_bytes(d.val, ft.collate))
        v = d.val.encode() if isinstance(d.val, str) else bytes(d.val)
        return (1, v)
    if d.kind == DatumKind.MysqlTime:
        return (1, d.val.packed)
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        return (1, float(d.val) + 0.0)  # -0.0 -> 0.0
    return (1, d.val)


class _RefAgg:
    """One aggregate's accumulator (Complete mode), incl. DISTINCT via a
    seen-set (ref: executor/aggfuncs distinct wrappers) and the BIT_*
    aggregates (ref: aggfuncs/func_bitfuncs.go)."""

    def __init__(self, desc: AggDesc):
        self.d = desc
        self.count = 0
        self.sum = None
        self.extreme = None
        self.first = None
        self.has_first = False
        self.bits = None
        self.fsum = 0.0  # float moments for stddev/var
        self.sumsq = 0.0
        self.strs: list = []  # group_concat pieces
        self.seen = set() if desc.distinct else None

    def update(self, args: list[Datum]):
        name = self.d.name
        if self.seen is not None and name in (
            "count", "sum", "avg", "group_concat",
            "stddev_pop", "stddev_samp", "var_pop", "var_samp",
        ):
            # DISTINCT: rows with any NULL arg are skipped; each distinct
            # arg tuple contributes once
            if any(a.is_null() for a in args):
                return
            key = tuple(
                datum_group_key(a, ae.ft)
                for a, ae in zip(args, self.d.args)
            )
            if key in self.seen:
                return
            self.seen.add(key)
        if name == "count":
            if all(not a.is_null() for a in args):
                self.count += 1
            return
        a = args[0]
        if name == "first_row":
            if not self.has_first:
                self.first, self.has_first = a, True
            return
        if a.is_null():
            return
        if name in ("bit_and", "bit_or", "bit_xor"):
            v = int(a.val) & ((1 << 64) - 1)
            if self.bits is None:
                self.bits = v
            elif name == "bit_and":
                self.bits &= v
            elif name == "bit_or":
                self.bits |= v
            else:
                self.bits ^= v
            return
        self.count += 1
        if name in ("sum", "avg"):
            self._add_sum(a)
        elif name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            v = a.val.to_float() if a.kind == DatumKind.MysqlDecimal else float(a.val)
            self.fsum += v
            self.sumsq += v * v
        elif name == "group_concat":
            v = a.val if isinstance(a.val, str) else (
                bytes(a.val).decode("utf-8", "surrogateescape") if isinstance(a.val, (bytes, bytearray)) else str(a.val)
            )
            self.strs.append(v)
        elif name in ("min", "max"):
            if self.extreme is None:
                self.extreme = a
            else:
                c = compare(a, self.extreme)
                if (name == "min" and c < 0) or (name == "max" and c > 0):
                    self.extreme = a
        else:
            raise NotImplementedError(name)

    def _add_sum(self, a: Datum):
        if self.sum is None:
            if a.kind in (DatumKind.Float64, DatumKind.Float32):
                self.sum = float(a.val)
            elif a.kind == DatumKind.MysqlDecimal:
                self.sum = a.val
            else:
                self.sum = MyDecimal(a.val, 0)
        else:
            if isinstance(self.sum, float):
                self.sum += float(a.val)
            else:
                self.sum = self.sum + (a.val if a.kind == DatumKind.MysqlDecimal else MyDecimal(a.val, 0))

    def merge_update(self, args: list[Datum]):
        """Consume partial-state columns (Partial2/Final modes) — the state
        schemas of expr/agg.py (ref: aggfuncs MergePartialResult)."""
        name = self.d.name
        if self.seen is not None and name not in ("min", "max", "first_row"):
            raise NotImplementedError("DISTINCT partials are not mergeable")
        if name == "count":
            if not args[0].is_null():
                self.count += int(args[0].val)
            return
        if name == "avg":
            c, s = args
            if not c.is_null():
                self.count += int(c.val)
            if not s.is_null():
                self._add_sum(s)
            return
        if name == "sum":
            if not args[0].is_null():
                self.count += 1
                self._add_sum(args[0])
            return
        if name == "first_row":
            has, val = args
            if not has.is_null() and int(has.val) > 0 and not self.has_first:
                self.first, self.has_first = val, True
            return
        if name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            c, s, q = args
            if not c.is_null():
                self.count += int(c.val)
            if not s.is_null():
                self.fsum += float(s.val)
                self.sumsq += float(q.val)
            return
        if name == "group_concat":
            raise NotImplementedError("group_concat partials are not mergeable (root-only aggregate)")
        # min/max/bit_*: state column == value column, same combine
        self.update(args)

    def partial_result(self) -> list[Datum]:
        """Emit this accumulator's partial-state columns (Partial1 mode)."""
        name = self.d.name
        pf = self.d.partial_fts()
        if name == "count":
            return [Datum.i64(self.count)]
        if name == "sum":
            return [self._sum_datum(pf[0])]
        if name == "avg":
            return [Datum.i64(self.count), self._sum_datum(pf[1])]
        if name in ("min", "max"):
            return [self.extreme if self.extreme is not None else Datum.NULL]
        if name == "first_row":
            return [Datum.i64(1 if self.has_first else 0), self.first if self.has_first else Datum.NULL]
        if name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            return [Datum.i64(self.count), Datum.f64(self.fsum), Datum.f64(self.sumsq)]
        return [self.result()]  # bit_*: state == result

    def _sum_datum(self, ft: FieldType) -> Datum:
        if self.sum is None:
            return Datum.NULL
        if isinstance(self.sum, float):
            return Datum.f64(self.sum)
        return Datum.dec(self.sum.round(max(ft.decimal, 0)))

    def result(self) -> Datum:
        name = self.d.name
        ft = self.d.ft
        if name == "count":
            return Datum.i64(self.count)
        if name == "first_row":
            return self.first if self.has_first else Datum.NULL
        if name == "sum":
            if self.sum is None:
                return Datum.NULL
            if isinstance(self.sum, float):
                return Datum.f64(self.sum)
            return Datum.dec(self.sum.round(max(ft.decimal, 0)))
        if name == "avg":
            if self.count == 0:
                return Datum.NULL
            if isinstance(self.sum, float):
                return Datum.f64(self.sum / self.count)
            q = self.sum.div(MyDecimal(self.count, 0))
            return Datum.dec(q.round(max(ft.decimal, 0)))
        if name in ("min", "max"):
            return self.extreme if self.extreme is not None else Datum.NULL
        if name in ("bit_and", "bit_or", "bit_xor"):
            if self.bits is None:  # empty: AND -> all ones, OR/XOR -> 0
                return Datum.u64((1 << 64) - 1 if name == "bit_and" else 0)
            return Datum.u64(self.bits)
        if name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            import math

            n = self.count
            if n == 0 or (name.endswith("samp") and n < 2):
                return Datum.NULL
            mean = self.fsum / n
            if name.endswith("samp"):
                var = max(self.sumsq - n * mean * mean, 0.0) / (n - 1)
            else:
                var = max(self.sumsq / n - mean * mean, 0.0)
            return Datum.f64(math.sqrt(var) if name.startswith("stddev") else var)
        if name == "group_concat":
            if not self.strs:
                return Datum.NULL
            return Datum.string((self.d.extra if self.d.extra is not None else ",").join(self.strs))
        raise NotImplementedError(name)


def run_dag_reference(dag: DAGRequest, chunks) -> list[list[Datum]]:
    """Row-at-a-time oracle over one chunk per scan (canonical order);
    accepts a bare Chunk for single-scan DAGs."""
    if isinstance(chunks, Chunk):
        chunks = [chunks]
    ev = RefEvaluator()
    cursor = [0]
    rows = _ref_pipeline(dag.executors, chunks, cursor, ev)
    return [[r[i] for i in dag.output_offsets] for r in rows]


def _ref_pipeline(executors, chunks, cursor, ev) -> list[list[Datum]]:
    chunk = chunks[cursor[0]]
    cursor[0] += 1
    rows = chunk.rows()
    for ex in executors[1:]:
        if isinstance(ex, Selection):
            rows = [r for r in rows if all(_truth(ev.eval(c, r)) for c in ex.conditions)]
        elif isinstance(ex, Projection):
            rows = [[ev.eval(e, r) for e in ex.exprs] for r in rows]
        elif isinstance(ex, Limit):
            rows = rows[: ex.limit]
        elif isinstance(ex, TopN):
            rows = _order_by_sorted(rows, ex.order_by, ev)[: ex.limit]
        elif isinstance(ex, Sort):
            rows = _order_by_sorted(rows, ex.order_by, ev)
        elif isinstance(ex, Window):
            rows = _ref_window(ex, rows, ev)
        elif isinstance(ex, Join):
            rows = _ref_join(ex, rows, chunks, cursor, ev)
        elif isinstance(ex, Aggregation):
            groups: dict = {}
            order: list = []
            for r in rows:
                key = tuple(datum_group_key(ev.eval(g, r), g.ft) for g in ex.group_by)
                if key not in groups:
                    groups[key] = ([_RefAgg(a) for a in ex.aggs], [ev.eval(g, r) for g in ex.group_by])
                    order.append(key)
                accs, _ = groups[key]
                for acc, a in zip(accs, ex.aggs):
                    args = [ev.eval(x, r) for x in a.args]
                    if ex.merge:
                        acc.merge_update(args)
                    else:
                        acc.update(args)
            if not ex.group_by:
                if not rows:
                    groups[()] = ([_RefAgg(a) for a in ex.aggs], [])
                    order.append(())
            rows = []
            for key in order:
                accs, gvals = groups[key]
                out: list[Datum] = []
                for acc in accs:
                    if ex.partial:
                        out.extend(acc.partial_result())
                    else:
                        out.append(acc.result())
                rows.append(out + gvals)
        else:
            raise TypeError(f"unsupported executor {ex}")
    return rows


def _order_by_sorted(rows, order_by, ev) -> list:
    """Stable ORDER BY sort — THE null-first/desc-flip comparator both TopN
    and Sort (and only they) define order with."""
    import functools

    def cmp_rows(r1, r2):
        for e, desc in order_by:
            a, b = ev.eval(e, r1), ev.eval(e, r2)
            if a.is_null() and b.is_null():
                continue
            ci = e.ft.is_string() and e.ft.is_ci()
            c = -1 if a.is_null() else (
                1 if b.is_null() else compare(a, b, ci=ci, collation=e.ft.collate if ci else None)
            )
            if c:
                return -c if desc else c
        return 0

    return sorted(rows, key=functools.cmp_to_key(cmp_rows))


def _ref_window(ex, rows, ev) -> list[list[Datum]]:
    """Window oracle: partition dict -> stable sort by order keys -> per-row
    frame evaluation with MySQL default frames (RANGE UNBOUNDED
    PRECEDING..CURRENT ROW including peers with ORDER BY; whole partition
    without). Semantics ref: pkg/executor/aggfuncs/func_*.go per function."""
    import functools

    from ..types import MyDecimal

    def okey_cmp(r1, r2):
        for e, desc in ex.order_by:
            a, b = ev.eval(e, r1), ev.eval(e, r2)
            if a.is_null() and b.is_null():
                continue
            ci = e.ft.is_string() and e.ft.is_ci()
            c = -1 if a.is_null() else (
                1 if b.is_null() else compare(a, b, ci=ci, collation=e.ft.collate if ci else None)
            )
            if c:
                return -c if desc else c
        return 0

    parts: dict = {}
    order: list = []
    for i, r in enumerate(rows):
        key = tuple(datum_group_key(ev.eval(g, r), g.ft) for g in ex.partition_by)
        if key not in parts:
            parts[key] = []
            order.append(key)
        parts[key].append(i)

    results: dict = {i: [] for i in range(len(rows))}
    for key in order:
        idxs = parts[key]
        idxs.sort(key=functools.cmp_to_key(lambda a, b: okey_cmp(rows[a], rows[b]) or (a - b)))
        n = len(idxs)
        # peer groups (equal order keys)
        peer_id = [0] * n
        for j in range(1, n):
            peer_id[j] = peer_id[j - 1] + (1 if okey_cmp(rows[idxs[j - 1]], rows[idxs[j]]) else 0)
        peer_end = [0] * n
        end = n - 1
        for j in range(n - 1, -1, -1):
            if j < n - 1 and peer_id[j] != peer_id[j + 1]:
                end = j
            peer_end[j] = end
        has_order = bool(ex.order_by)
        for w in ex.funcs:
            for j, ri in enumerate(idxs):
                frame_hi = (peer_end[j] if has_order else n - 1)
                results[ri].append(_ref_window_value(w, ex, rows, idxs, j, n, frame_hi, peer_id, ev))
    return [r + results[i] for i, r in enumerate(rows)]


def _ref_window_value(w, ex, rows, idxs, j, n, frame_hi, peer_id, ev) -> Datum:
    from ..types import MyDecimal

    name = w.name

    def argval(ri, k=0):
        return ev.eval(w.args[k], rows[ri])

    if name == "row_number":
        return Datum.i64(j + 1)
    if name == "rank":
        first = next(k for k in range(n) if peer_id[k] == peer_id[j])
        return Datum.i64(first + 1)
    if name == "dense_rank":
        return Datum.i64(peer_id[j] + 1)
    if name == "percent_rank":
        if n <= 1:
            return Datum.f64(0.0)
        first = next(k for k in range(n) if peer_id[k] == peer_id[j])
        return Datum.f64(first / (n - 1))
    if name == "cume_dist":
        return Datum.f64((frame_hi + 1) / n) if ex.order_by else Datum.f64(1.0)
    if name == "ntile":
        k = w.offset
        base, rem = n // k, n % k
        cut = rem * (base + 1)
        if j < cut:
            return Datum.i64(j // (base + 1) + 1)
        return Datum.i64(rem + (j - cut) // max(base, 1) + 1)
    if name in ("lead", "lag"):
        off = w.offset if name == "lead" else -w.offset
        t = j + off
        if 0 <= t < n:
            return argval(idxs[t])
        if w.default is not None:
            return ev.eval(w.default, rows[idxs[j]])
        return Datum.NULL
    if name == "first_value":
        return argval(idxs[0])
    if name == "last_value":
        return argval(idxs[frame_hi])
    if name == "nth_value":
        t = w.offset - 1
        if t <= frame_hi:
            return argval(idxs[t])
        return Datum.NULL
    # frame aggregates over rows[0..frame_hi]
    if name == "count" and not w.args:
        return Datum.i64(frame_hi + 1)
    vals = [argval(idxs[k]) for k in range(frame_hi + 1)]
    live = [d for d in vals if not d.is_null()]
    if name == "count":
        return Datum.i64(len(live))
    if not live:
        return Datum.NULL
    if name in ("min", "max"):
        best = live[0]
        for d in live[1:]:
            c = compare(d, best)
            if (name == "max" and c > 0) or (name == "min" and c < 0):
                best = d
        return best
    # sum / avg with MySQL numeric promotion
    et = w.ft.eval_type()
    if et == "real":
        s = sum(float(d.val.to_float() if isinstance(d.val, MyDecimal) else d.val) for d in live)
        return Datum.f64(s if name == "sum" else s / len(live))
    acc = None
    for d in live:
        dv = d.val if isinstance(d.val, MyDecimal) else MyDecimal(str(d.val))
        acc = dv if acc is None else acc + dv
    if name == "sum":
        return Datum.dec(acc)
    return Datum.dec(acc.div(MyDecimal(str(len(live)))))


def _ref_join(ex: Join, probe_rows, chunks, cursor, ev) -> list[list[Datum]]:
    """Hash-join oracle (ref: mpp_exec.go:844 joinExec — build a key map,
    probe row by row; NULL keys never match)."""
    build_rows = _ref_pipeline(ex.build, chunks, cursor, ev)
    nb_cols = len(current_schema_fts(ex.build))

    def key_of(row, exprs):
        ds = [ev.eval(k, row) for k in exprs]
        if any(d.is_null() for d in ds):
            return None
        return tuple(datum_group_key(d, k.ft) for d, k in zip(ds, exprs))

    table: dict = {}
    for br in build_rows:
        k = key_of(br, ex.build_keys)
        if k is not None:
            table.setdefault(k, []).append(br)

    out: list[list[Datum]] = []
    for pr in probe_rows:
        k = key_of(pr, ex.probe_keys)
        matches = table.get(k, []) if k is not None else []
        if ex.join_type == "inner":
            out.extend(pr + br for br in matches)
        elif ex.join_type == "left_outer":
            if matches:
                out.extend(pr + br for br in matches)
            else:
                out.append(pr + [Datum.NULL] * nb_cols)
        elif ex.join_type == "semi":
            if matches:
                out.append(pr)
        elif ex.join_type == "anti":
            if not matches:
                out.append(pr)
        else:
            raise TypeError(f"unknown join type {ex.join_type}")
    return out
