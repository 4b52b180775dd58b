"""DAG -> one program over eager torch ops (port of tidb_tpu/exec/builder.py).

The JAX package traces the whole executor list into a single jitted XLA
program. PyTorch runs eagerly, so here the "program" is a Python closure
over eager ops with the same signature and outputs:

    program(*batches) -> (packed, valid, n_out,
                          (g_ovf, j_ovf, t_ovf, g_need, j_need, radix_esc),
                          ex_rows)

Ported executors: TableScan / IndexScan, Selection, Projection, Limit,
TopN, Sort, Window, Aggregation (scalar and GROUP BY) and Join (inner /
left_outer / semi / anti), with the JAX package's join routes: the packed
join+group chain (ops/joinagg.py, TPC-H Q3's shape), the fused one-sort
join + stream aggregation, the radix-partitioned join (ops/radix_join.py)
and the general sort-merge kernel (ops/join.py). TopN takes the sampled
threshold path (ops/topn.py) and sets its overflow flag when the check
fails; topn_full=True builds the exact full-sort variant that
drive_program_info retries with. vmap_batch=B builds the region-batched
variant: torch.func.vmap over the same program, the probe batch mapped on
its leading region axis and every build-side batch shared, so B regions
run as one program execution and each hand kernel launches once over all
of them (its custom op's vmap rule). mesh_lanes=R with mesh_devices (a
parallel/mesh.py RegionMesh) builds the MESH variant: the R stacked lanes
split into one block per shard, each shard runs the region-batched
program over its lanes on its device (so each hand kernel launches once a
shard), and the per-region results merge across the shards — a sum / min
/ max of partial states, a merge-mode re-group of GROUP BY tables, or a
re-top-k (mesh_kind "scalar" / "group" / "topn").
Programs cache by (DAG fingerprint, capacities, knobs, region batch,
device, kernel route, mesh lanes, mesh devices, mesh kind), with a
single-flight miss so racing threads build once.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

from ..expr.compile import CompVal, ExprCompiler, normalize_device_column
from ..ops import apply_selection, group_aggregate, scalar_aggregate
from ..ops.aggregate import GatherState, finalize_agg
from ..ops.join import hash_join
from ..ops.seg import dense_lanes
from ..ops.topn import sort_all, topn
from ..ops.window import window_cols
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
    # radix-join attribution, filled when the program runs: the partition
    # count / per-partition build capacity / probe strategy of the first
    # radix join; empty when no Join rode the radix path
    radix_info: dict = field(default_factory=dict)


class _TraceState:
    """Per-run accumulators shared across nested pipelines.

    Group and join overflow are SEPARATE flags so the retry driver grows
    only the capacity that overflowed. The NEED hints (exec/ladder.py) ride
    next to them: the true group count / join fan-out when a kernel knows
    it. TopN's flag says its sampled threshold missed (the retry rebuilds
    with the full sort)."""

    def __init__(self, device):
        self.group_overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.join_overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.topn_overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.group_need = torch.zeros((), dtype=torch.int64, device=device)
        self.join_need = torch.zeros((), dtype=torch.int64, device=device)
        self.radix_escapes = torch.zeros((), dtype=torch.int64, device=device)
        self.radix_meta: dict = {}  # partitions / part_cap / strategy
        self.radix_joins = True  # builder knob: False = monolithic only
        self.ex_rows: list = []

    def note_group(self, need):
        if need is not None:
            self.group_need = torch.maximum(self.group_need, need.to(torch.int64))

    def note_join(self, need):
        if need is not None:
            self.join_need = torch.maximum(self.join_need, need.to(torch.int64))

    def rows(self, arr_or_scalar):
        """Record a produced-row count (a mask or a count)."""
        v = arr_or_scalar
        if v.dim() > 0:
            v = v.sum()
        self.ex_rows.append(v.to(torch.int64))


def _used_cols_after(rest, width: int, out_offsets):
    """Column indexes < width referenced by the remaining executors (or by
    the DAG outputs when the schema survives to the end): the join output
    gathers only these. Schema-REPLACING executors (Projection,
    Aggregation) end the walk; schema-EXTENDING ones (Join, Window) keep
    the prefix, so later references < width still mean these columns."""
    from ..expr.ir import ColumnRef, ScalarFunc

    used: set = set()

    def collect(e):
        if isinstance(e, ColumnRef):
            if e.index < width:
                used.add(e.index)
        elif isinstance(e, ScalarFunc):
            for a in e.args:
                collect(a)

    for ex in rest:
        if isinstance(ex, Selection):
            for c in ex.conditions:
                collect(c)
        elif isinstance(ex, (TopN, Sort)):
            for e, _ in ex.order_by:
                collect(e)
        elif isinstance(ex, Limit):
            pass
        elif isinstance(ex, Window):
            for e in ex.partition_by:
                collect(e)
            for e, _ in ex.order_by:
                collect(e)
            for w in ex.funcs:
                for a in w.args:
                    collect(a)
                if w.default is not None:
                    collect(w.default)
        elif isinstance(ex, Join):
            for e in ex.probe_keys:
                collect(e)
        elif isinstance(ex, Projection):
            for e in ex.exprs:
                collect(e)
            return used
        elif isinstance(ex, Aggregation):
            for e in ex.group_by:
                collect(e)
            for d in ex.aggs:
                for a in d.args:
                    collect(a)
            return used
    if out_offsets is None:
        return set(range(width))
    used.update(o for o in out_offsets if o < width)
    return used


def _gather_pruned(cols: list, idx, used: set, base: int) -> list:
    """Gather only the live columns; dead slots get an all-NULL zero column
    (schema positions preserved, no memory traffic)."""
    n = idx.shape[0]
    out = []
    for j, c in enumerate(cols):
        if (base + j) in used:
            out.append(_gather([c], idx)[0])
        else:
            v = torch.zeros((n,) + tuple(c.value.shape[1:]), dtype=c.value.dtype, device=idx.device)
            out.append(CompVal(v, torch.ones(n, dtype=torch.bool, device=idx.device), c.ft))
    return out


def _split_aggs(aggs, avals):
    """[(AggDesc, [its arg CompVals])] from the flat compiled arg list."""
    out, k = [], 0
    for a in aggs:
        out.append((a, avals[k : k + len(a.args)]))
        k += len(a.args)
    return out


def _run_pipeline(executors, batches, cursor, group_capacity, join_capacity, state: _TraceState,
                  topn_full: bool = False, small_groups: int | None = None, unique_joins: bool = True,
                  out_offsets=None):
    """Run one executor pipeline; recursion handles Join build sides.
    Batches are consumed in canonical scan order (dag.collect_scans);
    `cursor` is the index of the next one."""
    scan = executors[0]
    assert isinstance(scan, (TableScan, IndexScan)), "pipeline must start with a scan"
    batch = batches[cursor[0]]
    cursor[0] += 1
    fts = [c.ft for c in scan.columns]
    cols = [normalize_device_column(c) for c in batch.cols]
    valid = batch.row_valid
    dev = valid.device
    state.rows(batch.n_rows)

    ei = 1
    while ei < len(executors):
        ex = executors[ei]
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
        elif isinstance(ex, TopN):
            order_vals = comp.run([e for e, _ in ex.order_by], cols)
            by = list(zip(order_vals, [d for _, d in ex.order_by]))
            idx, out_valid, t_ovf = topn(by, valid, ex.limit, full_sort=topn_full)
            state.topn_overflow = state.topn_overflow | t_ovf
            cols = _gather(cols, idx)
            valid = out_valid
        elif isinstance(ex, Sort):
            order_vals = comp.run([e for e, _ in ex.order_by], cols)
            by = list(zip(order_vals, [d for _, d in ex.order_by]))
            idx, out_valid = sort_all(by, valid)
            cols = _gather(cols, idx)
            valid = out_valid
        elif isinstance(ex, Window):
            part_vals = comp.run(list(ex.partition_by), cols) if ex.partition_by else []
            order_vals = comp.run([e for e, _ in ex.order_by], cols) if ex.order_by else []
            order_pairs = list(zip(order_vals, [d for _, d in ex.order_by]))
            funcs = []
            for w in ex.funcs:
                argv = comp.run(list(w.args), cols) if w.args else []
                if w.default is not None:
                    argv = argv + comp.run([w.default], cols)
                funcs.append((w, argv))
            cols = cols + window_cols(part_vals, order_pairs, funcs, valid)
            fts = fts + [w.ft for w in ex.funcs]
        elif isinstance(ex, Join):
            nxt = executors[ei + 1] if ei + 1 < len(executors) else None
            fused_ok = isinstance(nxt, Aggregation) and _joinagg_pattern(ex, nxt, len(fts), unique_joins)
            if fused_ok:
                fused = _trace_packed_chain(ex, nxt, comp, cols, valid, batches, cursor, group_capacity,
                                            join_capacity, state, topn_full, small_groups, unique_joins)
                if fused is not None:
                    cols, valid, fts = fused
                    state.rows(valid)
                    ei += 2
                    continue
            bcols, bvalid, bfts = _run_pipeline(list(ex.build), batches, cursor, group_capacity, join_capacity,
                                                state, topn_full, small_groups, unique_joins)
            bkeys = ExprCompiler(bfts, device=dev).run(list(ex.build_keys), bcols)
            pkeys = comp.run(list(ex.probe_keys), cols)
            _check_join_key_types(pkeys, bkeys)
            if fused_ok and _single_word(pkeys[0]) and _single_word(bkeys[0]):
                fused = _trace_joinagg(nxt, comp, cols, bkeys, pkeys, bvalid, valid, group_capacity, state)
                if fused is not None:
                    cols, valid, fts = fused
                    state.rows(valid)
                    ei += 2
                    continue
            res = _trace_radix_join(ex, bkeys, pkeys, bvalid, valid, join_capacity, state, unique_joins)
            if res is None:
                res = hash_join(bkeys, pkeys, bvalid, valid, join_capacity, ex.join_type,
                                build_unique=ex.build_unique and unique_joins)
            state.join_overflow = state.join_overflow | res.overflow
            state.note_join(res.need)
            if ex.join_type in ("semi", "anti"):
                # probe schema preserved, rows filtered by match-existence
                valid = res.out_valid
            else:
                nb = bvalid.shape[0]
                used = _used_cols_after(executors[ei + 1:], len(fts) + len(bfts), out_offsets)
                if res.probe_identity:
                    p_g = cols  # unique-build layout: slot j == probe row j
                else:
                    p_g = _gather_pruned(cols, res.probe_idx, used, 0)
                b_g = _gather_pruned(bcols, torch.clamp(res.build_idx, 0, nb - 1), used, len(fts))
                b_g = [CompVal(c.value, c.null | res.build_null, c.ft, raw=c.raw) for c in b_g]
                cols = p_g + b_g
                valid = res.out_valid
                if ex.join_type == "left_outer":
                    bfts = [f.clone_nullable() for f in bfts]
                fts = fts + bfts
        elif isinstance(ex, Aggregation):
            garg_exprs = []
            for a in ex.aggs:
                garg_exprs.extend(a.args)
            gvals = comp.run(list(ex.group_by), cols) if ex.group_by else []
            avals = comp.run(list(garg_exprs), cols) if garg_exprs else []
            aggs = _split_aggs(ex.aggs, avals)
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
        ei += 1

    return cols, valid, fts


def _trace_radix_join(ex, bkeys, pkeys, bvalid, valid, join_capacity, state: _TraceState, unique_joins: bool):
    """Route an eligible Join through the radix-partitioned kernel
    (ops/radix_join.py); None = take the monolithic kernel. Eligibility is
    decided from the join's shape alone — join type, planner-proven unique
    build, single int-class key word, build / probe capacity ratio —
    before any value work."""
    from ..ops.radix_join import probe_strategy, radix_hash_join, radix_plan

    if not (state.radix_joins and ex.build_unique and unique_joins):
        return None
    if ex.join_type not in ("inner", "left_outer", "semi", "anti"):
        return None
    if len(bkeys) != 1 or len(pkeys) != 1:
        return None
    if not (_single_word(bkeys[0]) and _single_word(pkeys[0])):
        return None
    if bkeys[0].eval_type == "real" or pkeys[0].eval_type == "real":
        return None  # float keys: NaN / -0.0 classes stay on the sort kernel
    plan = radix_plan(bvalid.shape[0], valid.shape[0], join_capacity)
    if plan is None:
        return None
    mode = probe_strategy(*plan[:3])
    res, escapes = radix_hash_join(bkeys, pkeys, bvalid, valid, ex.join_type, join_capacity, plan)
    state.radix_escapes = state.radix_escapes + escapes
    # attribution reports what ran: the search strategy probes one
    # un-partitioned sorted build table (partitions = 1, no escape hatch);
    # the first radix join of the program wins, escapes total over all
    state.radix_meta.setdefault("partitions", 1 if mode == "search" else plan[0])
    state.radix_meta.setdefault("part_cap", plan[1])
    state.radix_meta.setdefault("strategy", mode)
    return res


def _single_word(k: CompVal) -> bool:
    """True when the key normalizes to exactly one sort word (ops/keys.py
    layout: [null_flag, word])."""
    from ..ops.keys import sort_key_arrays

    return len(sort_key_arrays(k)) == 2


def _joinagg_pattern(ex, agg, n_probe_cols: int, unique_joins: bool) -> bool:
    """Join(unique build, inner) immediately under GROUP BY probe-key with
    probe-only aggregate arguments — the shape ops/joinagg.py fuses."""
    from ..expr.ir import ColumnRef, ScalarFunc
    from ..ops.joinagg import FUSABLE_AGGS

    if not (ex.join_type == "inner" and ex.build_unique and unique_joins):
        return False
    if len(ex.probe_keys) != 1 or len(ex.build_keys) != 1:
        return False
    if len(agg.group_by) != 1 or agg.group_by[0] != ex.probe_keys[0]:
        return False
    if agg.merge:
        return False

    def probe_only(e) -> bool:
        if isinstance(e, ColumnRef):
            return e.index < n_probe_cols
        if isinstance(e, ScalarFunc):
            return all(probe_only(a) for a in e.args)
        return True

    for d in agg.aggs:
        if d.distinct or d.name not in FUSABLE_AGGS:
            return False
        if not all(probe_only(a) for a in d.args):
            return False
    return True


def _chain_shape(build):
    """[scan, Sel*, Join(inner, unique, single-key, build=[scan, Sel*])]
    -> (outer_execs, inner_join) or None — the 3-table membership shape the
    packed chain collapses (TPC-H Q3)."""
    if not build or not isinstance(build[0], (TableScan, IndexScan)):
        return None
    i = 1
    while i < len(build) and isinstance(build[i], Selection):
        i += 1
    if i != len(build) - 1 or not isinstance(build[i], Join):
        return None
    j = build[i]
    if j.join_type != "inner" or not j.build_unique:
        return None
    if len(j.probe_keys) != 1 or len(j.build_keys) != 1:
        return None
    inner = j.build
    if not inner or not isinstance(inner[0], (TableScan, IndexScan)):
        return None
    if not all(isinstance(e, Selection) for e in inner[1:]):
        return None
    return list(build[:i]), j


def _int_expr(e) -> bool:
    return e.ft.eval_type() == "int"


def _trace_packed_chain(ex, agg, comp, cols, valid, batches, cursor, group_capacity, join_capacity,
                        state: _TraceState, topn_full, small_groups, unique_joins):
    """The packed-int path (ops/joinagg.py packed_join_groupsum): every
    eligibility check is static (expression FieldTypes) and comes before
    any batch is consumed, so returning None never consumes a scan twice."""
    from ..expr.ir import ColumnRef, ScalarFunc
    from ..ops.joinagg import _PACKED_AGGS, membership_chain, packed_join_groupsum

    for d in agg.aggs:
        if d.name not in _PACKED_AGGS or d.distinct:
            return None
        for a in d.args:
            if a.ft.eval_type() not in ("int", "decimal"):
                return None
    pk_e, bk_e = ex.probe_keys[0], ex.build_keys[0]
    if not _int_expr(pk_e) or not _int_expr(bk_e):
        return None
    if pk_e.ft.is_unsigned() != bk_e.ft.is_unsigned():
        raise TypeError("join key signedness mismatch (insert casts)")
    chain = _chain_shape(ex.build)
    simple = all(isinstance(e, Selection) for e in ex.build[1:]) and isinstance(ex.build[0], (TableScan, IndexScan))
    if chain is not None:
        outer_execs, ij = chain
        if not (_int_expr(ij.probe_keys[0]) and _int_expr(ij.build_keys[0])):
            return None
        if ij.probe_keys[0].ft.is_unsigned() != ij.build_keys[0].ft.is_unsigned():
            raise TypeError("join key signedness mismatch (insert casts)")
        # the next join's key must come from the OUTER scan's schema
        outer_w = len(outer_execs[0].columns)

        def within(e, w):
            if isinstance(e, ColumnRef):
                return e.index < w
            if isinstance(e, ScalarFunc):
                return all(within(x, w) for x in e.args)
            return True

        if not within(bk_e, outer_w) or not within(ij.probe_keys[0], outer_w):
            return None
    elif not simple:
        return None

    # compile the probe-side agg args (probe columns only: no consumption)
    garg_exprs = []
    for a in agg.aggs:
        garg_exprs.extend(a.args)
    avals = comp.run(list(garg_exprs), cols) if garg_exprs else []
    if any(a.value.dim() != 1 or a.raw is not None for a in avals):
        return None
    if len({id(a.null) for a in avals}) > 8:
        return None
    pkv = comp.run([pk_e], cols)[0]
    probe_ok = valid & ~pkv.null
    dev = valid.device

    if chain is not None:
        outer_execs, ij = chain
        ocols, ovalid, ofts = _run_pipeline(outer_execs, batches, cursor, group_capacity, join_capacity, state,
                                            topn_full, small_groups, unique_joins)
        icols, ivalid, ifts = _run_pipeline(list(ij.build), batches, cursor, group_capacity, join_capacity, state,
                                            topn_full, small_groups, unique_joins)
        ocomp, icomp = ExprCompiler(ofts, device=dev), ExprCompiler(ifts, device=dev)
        okey = ocomp.run([ij.probe_keys[0]], ocols)[0]
        ckey = icomp.run([ij.build_keys[0]], icols)[0]
        payload = ocomp.run([bk_e], ocols)[0]
        o_ok = ovalid & ~okey.null & ~payload.null
        i_ok = ivalid & ~ckey.null
        hay_key, hay_ok, ovf = membership_chain(okey.value, o_ok, ckey.value, i_ok, payload.value)
        state.join_overflow = state.join_overflow | ovf
        state.rows(hay_ok)  # inner join rows
    else:
        bcols, bvalid, bfts = _run_pipeline(list(ex.build), batches, cursor, group_capacity, join_capacity, state,
                                            topn_full, small_groups, unique_joins)
        bkv = ExprCompiler(bfts, device=dev).run([bk_e], bcols)[0]
        hay_key = bkv.value
        hay_ok = bvalid & ~bkv.null

    aggs = _split_aggs(agg.aggs, avals)
    states, group_valid, key_out, ovf, extent_cnt = packed_join_groupsum(hay_key, hay_ok, pkv, probe_ok, aggs)
    state.join_overflow = state.join_overflow | ovf
    state.rows(torch.where(group_valid, extent_cnt, 0))
    new_cols: list[CompVal] = []
    for (a, av), st in zip(aggs, states):
        new_cols.extend(_agg_result_cols(a, av, st, group_valid, agg.partial))
    new_cols.append(key_out)
    return new_cols, group_valid, agg.output_fts()


def _trace_joinagg(agg, comp, cols, bkeys, pkeys, bvalid, valid, group_capacity, state: _TraceState):
    """The fused one-sort join + stream aggregation; None when a compiled
    arg shape is ineligible (multi-word value or raw string bytes)."""
    from ..ops.joinagg import join_stream_agg

    garg_exprs = []
    for a in agg.aggs:
        garg_exprs.extend(a.args)
    avals = comp.run(list(garg_exprs), cols) if garg_exprs else []
    if any(a.value.dim() != 1 or a.raw is not None for a in avals):
        return None
    aggs = _split_aggs(agg.aggs, avals)
    res, sorted_aggs, group_out, j_ovf, join_rows = join_stream_agg(bkeys, pkeys, bvalid, valid, aggs, group_capacity)
    state.join_overflow = state.join_overflow | j_ovf
    state.group_overflow = state.group_overflow | res.overflow
    state.rows(join_rows)
    new_cols: list[CompVal] = []
    for (a, av_s), st in zip(sorted_aggs, res.states):
        new_cols.extend(_agg_result_cols(a, av_s, st, res.group_valid, agg.partial))
    new_cols.extend(_gather([group_out], res.group_rep))
    return new_cols, res.group_valid, agg.output_fts()


def _check_join_key_types(pkeys: list[CompVal], bkeys: list[CompVal]):
    """Join keys must normalize to identical sort-key layouts; the planner
    inserts casts (decimal keys are brought to one scale)."""
    if len(pkeys) != len(bkeys):
        raise TypeError("join key arity mismatch")
    for p, b in zip(pkeys, bkeys):
        pe, be = p.eval_type, b.eval_type
        if pe != be:
            raise TypeError(f"join key class mismatch: {pe} vs {be} (insert casts)")
        if pe == "decimal" and max(p.ft.decimal, 0) != max(b.ft.decimal, 0):
            raise TypeError("join key decimal scale mismatch (insert casts)")
        if pe == "int" and p.ft.is_unsigned() != b.ft.is_unsigned():
            raise TypeError("join key signedness mismatch (insert casts)")


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


def _flatten_batch(batch) -> tuple[list, list]:
    """A DeviceBatch's tensors in a fixed order, and what rebuilds it:
    per column its FieldType and whether it carries lengths."""
    leaves, spec = [], []
    for c in batch.cols:
        leaves += [c.data, c.null] + ([c.length] if c.length is not None else [])
        spec.append((c.ft, c.length is not None))
    return leaves + [batch.row_valid, batch.n_rows], spec


def _unflatten_batch(leaves, spec):
    from ..chunk.device import DeviceBatch, DeviceColumn

    cols, k = [], 0
    for ft, has_len in spec:
        cols.append(DeviceColumn(leaves[k], leaves[k + 1], leaves[k + 2] if has_len else None, ft))
        k += 3 if has_len else 2
    return DeviceBatch(cols, leaves[k], leaves[k + 1])


def _region_batched(program):
    """The program over a region-stacked probe batch (chunk/device.py
    to_stacked_device_batch): torch.func.vmap maps every leaf of the probe
    batch on its leading region axis; the build-side batches are closed
    over, so every region shares them (in_dims None, the broadcast
    operand every region task of a join carries). Every output gains the
    region axis. The lanes share the dense GROUP BY route's block budget
    (ops/seg.py dense_lanes)."""

    def fn(stacked, *aux):
        leaves, spec = _flatten_batch(stacked)
        with dense_lanes(stacked.row_valid.shape[0]):
            return torch.func.vmap(lambda *lv: program(_unflatten_batch(lv, spec), *aux))(*leaves)

    return fn


def build_program(
    dag: DAGRequest,
    capacities,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    join_capacity: int | None = None,
    topn_full: bool = False,
    small_groups: int | None = None,
    unique_joins: bool = True,
    radix_joins: bool = True,
    vmap_batch: int | None = None,
    mesh_lanes: int | None = None,
    mesh_devices=None,
    mesh_kind: str | None = None,
) -> CompiledDAG:
    """The whole DAG (probe pipeline and every join build pipeline) as one
    closure over a tuple of device batches. topn_full=True runs every TopN
    as the exact full sort (the TopN-overflow retry). unique_joins=False
    ignores the planner's unique-build hints and radix_joins=False the
    radix path: the join-overflow retry drops both and lands on the general
    kernel.

    vmap_batch=B builds the REGION-BATCHED variant: the first (probe)
    batch carries a leading region axis of size B and the program runs
    under torch.func.vmap over it, build-side batches shared. All outputs
    (packed columns, valid, n_out, the six flags, ex_rows) gain the
    leading region axis, so overflow is per region.

    mesh_lanes=R over mesh_devices (a RegionMesh) builds the mesh
    program: fn(stacked, *aux) -> (merged packed columns, valid,
    ex_rows [R, E], overflow, radix escapes), the merge per mesh_kind
    (_build_mesh_fn)."""
    if isinstance(capacities, int):
        capacities = (capacities,)
    capacities = tuple(capacities)
    n_scans = len(collect_scans(dag.executors))
    assert len(capacities) == n_scans, f"need {n_scans} batch capacities, got {len(capacities)}"
    join_capacity = join_capacity or max(capacities)
    radix_info: dict = {}

    def program(*batches):
        dev = batches[0].row_valid.device
        state = _TraceState(dev)
        state.radix_joins = radix_joins
        cols, valid, _ = _run_pipeline(dag.executors, batches, [0], group_capacity, join_capacity, state,
                                       topn_full, small_groups, unique_joins, out_offsets=dag.output_offsets)
        packed = _pack_cols([cols[i] for i in dag.output_offsets])
        n_out = valid.sum()
        radix_info.update(state.radix_meta)
        # (group, join, topn overflow, group need, join need, radix escapes)
        ovfs = (state.group_overflow, state.join_overflow, state.topn_overflow, state.group_need,
                state.join_need, state.radix_escapes)
        return packed, valid, n_out, ovfs, torch.stack(state.ex_rows)

    if mesh_lanes is not None:
        fn = _build_mesh_fn(dag, _region_batched(program), mesh_lanes, mesh_devices, mesh_kind, group_capacity)
    else:
        fn = program if vmap_batch is None else _region_batched(program)
    return CompiledDAG(fn, dag.output_fts(), capacities, group_capacity, join_capacity, radix_info)


def _build_mesh_fn(dag: DAGRequest, local_fn, lanes: int, mesh, kind: str, group_capacity: int):
    """The mesh tier's program body: split the stacked lanes over the
    shards, run the region-batched program on each shard's block (the
    build-side batches replicated to every shard), then merge the
    per-region results — the partial states across the shards
    (parallel/mesh.py merge seam), or the gathered GROUP BY tables / TopN
    candidates re-grouped / re-top-k'd once, on the lead device, where the
    reference computes that replicated output on every device. `lanes`
    must divide over the shards (the store pads the region axis with
    empty lanes)."""
    from ..parallel.collectives import pmax, psum
    from ..parallel.mesh import merge_packed_states, move_batch, shard_batch

    if kind not in ("scalar", "group", "topn"):
        raise ValueError(f"unknown mesh kind {kind!r}")
    devices = list(mesh.devices)
    if lanes % len(devices):
        raise ValueError("mesh lanes must divide over the shards")
    last = dag.executors[-1]
    out_fts = dag.output_fts()
    lead = devices[0]

    def fn(stacked, *aux):
        shards = shard_batch(stacked, devices)
        outs = [local_fn(shards[s], *[move_batch(a, d) for a in aux]) for s, d in enumerate(devices)]
        local_ovf = [o[3][0].any() | o[3][1].any() | o[3][2].any() for o in outs]
        # radix escape total over the region axis (join_radix attribution)
        radix_esc = psum([o[3][5].sum() for o in outs], devices)[0]
        if kind == "scalar":
            merged = [tuple(t) for t in merge_packed_states(list(last.aggs), [o[0] for o in outs], devices)]
            mvalid = torch.ones(1, dtype=torch.bool, device=lead)
            m_ovf = torch.zeros((), dtype=torch.bool, device=lead)
        else:
            cols, gvalid = _gather_mesh_outputs([o[0] for o in outs], [o[1] for o in outs], out_fts, lead)
            if kind == "group":
                out_cols, mvalid, m_ovf = _mesh_merge_group(last, out_fts, cols, gvalid, group_capacity)
            else:
                out_cols, mvalid, m_ovf = _mesh_merge_topn(last, out_fts, cols, gvalid)
            merged = _pack_cols(out_cols)
        ovf = (pmax([x.to(torch.int32) for x in local_ovf], devices)[0] > 0) | m_ovf
        ex = torch.cat([o[4].to(lead) for o in outs])
        return merged, mvalid, ex, ovf, radix_esc

    return fn


def _gather_mesh_outputs(packed: list, valid: list, out_fts, lead):
    """Flatten each shard's region-batched outputs [R_local, L, ...] to
    rows and gather them on the lead device in shard order (shard-major ==
    the region stack == task order). Raw string bytes ride whole."""
    cols = []
    for i, ft in enumerate(out_fts):
        flat = [torch.cat([p[i][j].reshape((-1,) + tuple(p[i][j].shape[2:])).to(lead) for p in packed])
                for j in range(len(packed[0][i]))]
        if len(flat) == 4:
            cols.append(CompVal(flat[0], flat[1], ft, raw=(flat[2], flat[3])))
        else:
            cols.append(CompVal(flat[0], flat[1], ft))
    gvalid = torch.cat([v.reshape(-1).to(lead) for v in valid])
    return cols, gvalid


def _mesh_merge_group(agg, state_fts, cols, valid, group_capacity: int):
    """Merge of the gathered per-region group tables: the root Final
    merge's Partial2 re-group (distsql/root.py _merge_aggregation, partial
    output) — the output schema is the push DAG's partial schema again, so
    one merged table per store replaces R per-region tables while the
    root's Final pass runs unchanged."""
    from dataclasses import replace as _replace

    from ..distsql.root import _merge_aggregation

    p2 = _replace(_merge_aggregation(agg), partial=True)
    comp = ExprCompiler(state_fts, device=valid.device)
    gvals = comp.run(list(p2.group_by), cols)
    garg_exprs = [a for d in p2.aggs for a in d.args]
    aggs = _split_aggs(p2.aggs, comp.run(garg_exprs, cols) if garg_exprs else [])
    res = group_aggregate(gvals, aggs, valid, group_capacity, merge=True)
    new_cols: list[CompVal] = []
    for (d, av), st in zip(aggs, res.states):
        new_cols.extend(_agg_result_cols(d, av, st, res.group_valid, True))
    new_cols.extend(_gather(gvals, res.group_rep))
    return new_cols, res.group_valid, res.overflow


def _mesh_merge_topn(ex, fts, cols, valid):
    """Re-top-k over the gathered per-region candidates (the global top-k
    is in the union of the per-region top-k); TopN keeps its input schema,
    so its order expressions apply to the candidates. The exact full sort:
    the candidate block is small and never overflows."""
    comp = ExprCompiler(fts, device=valid.device)
    order_vals = comp.run([e for e, _ in ex.order_by], cols)
    by = list(zip(order_vals, [d for _, d in ex.order_by]))
    idx, out_valid, _ovf = topn(by, valid, ex.limit, full_sort=True)
    return _gather(cols, idx), out_valid, torch.zeros((), dtype=torch.bool, device=valid.device)


def kernel_route(device) -> str:
    """Which version of the hand-written kernels a device runs: the CUDA
    kernels on a card, their plain torch versions on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


class ProgramCache:
    """Fingerprint -> CompiledDAG (ref: coprocessor cache keying).

    The key is the JAX package's (builder.py:900) with the device and the
    kernel route in place of the pallas mode and the mesh's device list in
    place of its device count; topn_full keeps its place after the join
    capacity and vmap_batch (the region batch, None for a single region)
    follows the radix knob. Builds are single-flight per key: the first
    thread to miss claims the key, racers wait on its event and land as
    hits."""

    def __init__(self):
        self._cache: dict = {}
        self._stats_mu = threading.Lock()
        self.compiles = 0  # guarded_by: _stats_mu
        self.hits = 0  # guarded_by: _stats_mu
        self._inflight: dict = {}  # key -> Event, guarded_by: _stats_mu

    def get(self, dag: DAGRequest, capacities, group_capacity: int = DEFAULT_GROUP_CAPACITY,
            join_capacity: int | None = None, topn_full: bool = False, small_groups: int | None = None,
            device="cuda", unique_joins: bool = True, radix_joins: bool = True,
            vmap_batch: int | None = None, mesh_lanes: int | None = None, mesh_devices=None,
            mesh_kind: str | None = None) -> CompiledDAG:
        return self.get_info(dag, capacities, group_capacity, join_capacity, topn_full, small_groups,
                             device, unique_joins, radix_joins, vmap_batch, mesh_lanes, mesh_devices,
                             mesh_kind)[0]

    def get_info(self, dag: DAGRequest, capacities, group_capacity: int = DEFAULT_GROUP_CAPACITY,
                 join_capacity: int | None = None, topn_full: bool = False, small_groups: int | None = None,
                 device="cuda", unique_joins: bool = True, radix_joins: bool = True,
                 vmap_batch: int | None = None, mesh_lanes: int | None = None, mesh_devices=None,
                 mesh_kind: str | None = None) -> tuple:
        """(program, cache_hit, build_ns)."""
        import time as _t

        from ..util import metrics, tracing

        if isinstance(capacities, int):
            capacities = (capacities,)
        capacities = tuple(capacities)
        dev = str(torch.device(device))
        key = (dag.fingerprint(), capacities, group_capacity, join_capacity, topn_full, small_groups,
               unique_joins, radix_joins, vmap_batch, dev, kernel_route(dev), mesh_lanes,
               None if mesh_devices is None else tuple(str(d) for d in mesh_devices.devices), mesh_kind)
        while True:
            prog = self._cache.get(key)
            if prog is not None:
                with self._stats_mu:
                    self.hits += 1
                metrics.PROGRAM_CACHE_HITS.inc()
                with tracing.span("exec.program", cache_hit=True):
                    pass
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
            with tracing.span("exec.program", cache_hit=False) as sp:
                with self._stats_mu:
                    self.compiles += 1
                metrics.PROGRAM_COMPILES.inc()
                t0 = _t.perf_counter_ns()
                prog = build_program(dag, capacities, group_capacity, join_capacity, topn_full, small_groups,
                                     unique_joins, radix_joins, vmap_batch, mesh_lanes, mesh_devices, mesh_kind)
                # the build of the program's closures; the kernels' nvcc
                # build happens at their first launch (kernels.py) and is not
                # counted here
                build_ns = _t.perf_counter_ns() - t0
                metrics.PROGRAM_COMPILE_DURATION.observe(build_ns / 1e9)
                if sp is not None:
                    sp.set("compile_ns", build_ns)
                    if vmap_batch is not None:
                        sp.set("batch_size", vmap_batch)
                    if mesh_lanes is not None:
                        sp.set("mesh_lanes", mesh_lanes)
            self._cache[key] = prog
            metrics.PROGRAM_CACHE_ENTRIES.set(len(self._cache))
        finally:
            with self._stats_mu:
                self._inflight.pop(key).set()
        return prog, False, build_ns

    def stats(self):
        with self._stats_mu:
            return {"entries": len(self._cache), "compiles": self.compiles, "hits": self.hits}
