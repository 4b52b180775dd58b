"""DAG -> one program over eager torch ops (port of tidb_tpu/exec/builder.py).

The JAX package traces the whole executor list into a single jitted XLA
program. PyTorch runs eagerly, so here the "program" is a Python closure
over eager ops with the same signature and outputs:

    program(*batches) -> (packed, valid, n_out,
                          (g_ovf, j_ovf, t_ovf, g_need, j_need, radix_esc),
                          ex_rows)

Ported executors: TableScan / IndexScan, Selection, Projection, Limit and
Aggregation (scalar and GROUP BY). TopN, Sort, Join and Window raise
NotImplementedError. There is no vmapped (region-batched) and no mesh
variant. Programs cache by (DAG fingerprint, capacities, knobs, device,
kernel route), with a single-flight miss so racing threads build once.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ..expr.compile import CompVal, ExprCompiler, normalize_device_column
from ..ops import apply_selection, group_aggregate, scalar_aggregate
from ..ops.aggregate import GatherState, finalize_agg
from ..types import FieldType
from .dag import Aggregation, DAGRequest, IndexScan, Join, Limit, Projection, Selection, Sort, TableScan, TopN, Window, collect_scans

DEFAULT_GROUP_CAPACITY = 4096


def _gather(cols: list[CompVal], idx) -> list[CompVal]:
    idx = idx.to(torch.int64)
    out = []
    for c in cols:
        raw = None
        if c.raw is not None:
            raw = (c.raw[0][idx], c.raw[1][idx])
        out.append(CompVal(c.value[idx], c.null[idx], c.ft, raw=raw))
    return out


@dataclass
class CompiledDAG:
    fn: object  # (DeviceBatch, ...) -> (outputs, valid, n_rows, overflows, ex_rows)
    out_fts: list[FieldType]
    capacities: tuple  # one per scan, canonical order (dag.collect_scans)
    group_capacity: int
    join_capacity: int


class _TraceState:
    """Per-run accumulators shared across the pipeline: the group overflow
    flag, the group capacity NEED hint, and per-executor produced-row
    counts. (Join and TopN are not ported, so their flags and hints are
    constant and built by the program itself.)"""

    def __init__(self, device):
        self.group_overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.group_need = torch.zeros((), dtype=torch.int64, device=device)
        self.ex_rows: list = []

    def note_group(self, need):
        if need is not None:
            self.group_need = torch.maximum(self.group_need, need.to(torch.int64))

    def rows(self, arr_or_scalar):
        """Record a produced-row count (a mask or a count)."""
        v = arr_or_scalar
        if v.dim() > 0:
            v = v.sum()
        self.ex_rows.append(v.to(torch.int64))


def _run_pipeline(executors, batches, cursor, group_capacity, state: _TraceState, small_groups: int | None = None):
    """Run one executor pipeline; batches are consumed in canonical scan
    order (dag.collect_scans), `cursor` is the index of the next one."""
    scan = executors[0]
    assert isinstance(scan, (TableScan, IndexScan)), "pipeline must start with a scan"
    batch = batches[cursor[0]]
    cursor[0] += 1
    fts = [c.ft for c in scan.columns]
    cols = [normalize_device_column(c) for c in batch.cols]
    valid = batch.row_valid
    dev = valid.device
    state.rows(batch.n_rows)

    for ex in executors[1:]:
        comp = ExprCompiler(fts, device=dev)
        if isinstance(ex, Selection):
            conds = comp.run(list(ex.conditions), cols)
            valid = apply_selection(valid, conds)
        elif isinstance(ex, Projection):
            cols = comp.run(list(ex.exprs), cols)
            fts = [e.ft for e in ex.exprs]
        elif isinstance(ex, Limit):
            keep = torch.cumsum(valid.to(torch.int64), 0) <= ex.limit
            valid = valid & keep
        elif isinstance(ex, (TopN, Sort, Join, Window)):
            raise NotImplementedError(f"{type(ex).__name__} not on device in this port")
        elif isinstance(ex, Aggregation):
            garg_exprs = []
            for a in ex.aggs:
                garg_exprs.extend(a.args)
            gvals = comp.run(list(ex.group_by), cols) if ex.group_by else []
            avals = comp.run(list(garg_exprs), cols) if garg_exprs else []
            aggs = []
            k = 0
            for a in ex.aggs:
                aggs.append((a, avals[k : k + len(a.args)]))
                k += len(a.args)
            new_cols: list[CompVal] = []
            if ex.group_by:
                res = group_aggregate(gvals, aggs, valid, group_capacity, merge=ex.merge, small_groups=small_groups, stream=ex.stream)
                state.group_overflow = state.group_overflow | res.overflow
                state.note_group(res.need)
                for (a, av), st in zip(aggs, res.states):
                    new_cols.extend(_agg_result_cols(a, av, st, res.group_valid, ex.partial))
                new_cols.extend(_gather(gvals, res.group_rep))
                valid = res.group_valid
            else:
                states, s_ovf = scalar_aggregate(aggs, valid, merge=ex.merge, salt=group_capacity)
                state.group_overflow = state.group_overflow | s_ovf
                ones = torch.ones(1, dtype=torch.bool, device=dev)
                for (a, av), st in zip(aggs, states):
                    new_cols.extend(_agg_result_cols(a, av, st, ones, ex.partial))
                valid = ones
            cols = new_cols
            fts = ex.output_fts()
        else:
            raise TypeError(f"unsupported executor {ex}")
        state.rows(valid)

    return cols, valid, fts


def _pack_cols(cols: list[CompVal]) -> list[tuple]:
    """CompVals -> the program's packed output tuples: (value, null) per
    column, raw string bytes + lengths riding along when present."""
    packed = []
    for c in cols:
        if c.raw is not None:
            packed.append((c.value, c.null, c.raw[0], c.raw[1]))
        else:
            packed.append((c.value, c.null))
    return packed


def _agg_result_cols(a, av: list[CompVal], st, group_valid, partial: bool) -> list[CompVal]:
    """One aggregate's output columns from its states (a GatherState
    gathers the value column, raw string bytes included, from the rows)."""
    if isinstance(st, GatherState):
        has = st.has & group_valid
        g = _gather([av[-1]], st.idx)[0]
        null = g.null | ~has
        out = []
        if a.name == "first_row" and partial:
            out.append(CompVal(has.to(torch.int64), torch.zeros_like(has), a.partial_fts()[0]))
        out.append(CompVal(g.value, null, a.ft, raw=g.raw))
        return out
    fts = a.partial_fts()
    if partial:
        return [CompVal(v, nl, ft) for (v, nl), ft in zip(st, fts)]
    v, nl = finalize_agg(a, st, group_valid)
    return [CompVal(v, nl, a.ft)]


def build_program(
    dag: DAGRequest,
    capacities,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    join_capacity: int | None = None,
    small_groups: int | None = None,
) -> CompiledDAG:
    """The whole DAG as one closure over a tuple of device batches."""
    if isinstance(capacities, int):
        capacities = (capacities,)
    capacities = tuple(capacities)
    n_scans = len(collect_scans(dag.executors))
    assert len(capacities) == n_scans, f"need {n_scans} batch capacities, got {len(capacities)}"
    join_capacity = join_capacity or max(capacities)

    def program(*batches):
        dev = batches[0].row_valid.device
        state = _TraceState(dev)
        cols, valid, _ = _run_pipeline(dag.executors, batches, [0], group_capacity, state, small_groups)
        packed = _pack_cols([cols[i] for i in dag.output_offsets])
        n_out = valid.sum()
        no = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        # (group, join, topn overflow, group need, join need, radix escapes)
        ovfs = (state.group_overflow, no, no, state.group_need, zero, zero)
        return packed, valid, n_out, ovfs, torch.stack(state.ex_rows)

    return CompiledDAG(program, dag.output_fts(), capacities, group_capacity, join_capacity)


def kernel_route(device) -> str:
    """Which version of the hand-written kernels a device runs: the CUDA
    kernels on a card, their plain torch versions on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


class ProgramCache:
    """Fingerprint -> CompiledDAG (ref: coprocessor cache keying).

    The key is the JAX package's (builder.py:900) less the TopN / join
    knobs this port has no executors for, with the device and the kernel
    route in place of the pallas mode. Builds are single-flight per key: the first
    thread to miss claims the key, racers wait on its event and land as
    hits."""

    def __init__(self):
        self._cache: dict = {}
        self._stats_mu = threading.Lock()
        self.compiles = 0  # guarded_by: _stats_mu
        self.hits = 0  # guarded_by: _stats_mu
        self._inflight: dict = {}  # key -> Event, guarded_by: _stats_mu

    def get(self, dag: DAGRequest, capacities, group_capacity: int = DEFAULT_GROUP_CAPACITY,
            join_capacity: int | None = None, small_groups: int | None = None,
            device="cuda") -> CompiledDAG:
        return self.get_info(dag, capacities, group_capacity, join_capacity, small_groups, device)[0]

    def get_info(self, dag: DAGRequest, capacities, group_capacity: int = DEFAULT_GROUP_CAPACITY,
                 join_capacity: int | None = None, small_groups: int | None = None,
                 device="cuda") -> tuple:
        """(program, cache_hit, build_ns)."""
        import time as _t

        if isinstance(capacities, int):
            capacities = (capacities,)
        capacities = tuple(capacities)
        dev = str(torch.device(device))
        key = (dag.fingerprint(), capacities, group_capacity, join_capacity, small_groups,
               dev, kernel_route(dev))
        while True:
            prog = self._cache.get(key)
            if prog is not None:
                with self._stats_mu:
                    self.hits += 1
                return prog, True, 0
            with self._stats_mu:
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    break  # this thread owns the build
            # another thread is building this key: wait, then re-read the
            # cache (if its build raised, the next waiter claims the key)
            ev.wait()
        try:
            with self._stats_mu:
                self.compiles += 1
            t0 = _t.perf_counter_ns()
            prog = build_program(dag, capacities, group_capacity, join_capacity, small_groups)
            build_ns = _t.perf_counter_ns() - t0
            self._cache[key] = prog
        finally:
            with self._stats_mu:
                self._inflight.pop(key).set()
        return prog, False, build_ns

    def stats(self):
        with self._stats_mu:
            return {"entries": len(self._cache), "compiles": self.compiles, "hits": self.hits}
