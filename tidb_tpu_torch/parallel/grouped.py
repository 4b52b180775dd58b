"""Grouped aggregation over the mesh — the MPP partial / exchange / final
pipeline as ONE exchange program (port of tidb_tpu/parallel/grouped.py;
ref: unistore/cophandler/mpp_exec.go aggExec:999 below
exchSenderExec:609, the receiver-side final agg above exchRecvExec:723;
fragment planning pkg/planner/core/fragment.go:116).

Phases over the shards:
  1. flatten each shard's local regions into one row block, run the scan
     expressions + selection;
  2. Partial1 group aggregation -> a local group-state table [G_local];
  3. hash-partition the group states by group key and all_to_all them
     (parallel/collectives.py) — every shard then owns one hash partition
     of the global group space (ref: ExchangeSender Hash mode);
  4. merge-mode group aggregation over the owned states -> FINAL values
     for the owned groups.

The host wrapper concatenates the shards' final tables in shard order and
decodes one result Chunk. Group keys AND string aggregate values
(min/max/first_row over varchar) travel as packed compare words (the
first 32 bytes; the SQL gate rejects wider string columns)."""

from __future__ import annotations

import torch

from ..chunk.device import DeviceBatch, DeviceColumn
from ..exec.dag import Aggregation, DAGRequest, Selection
from ..expr.compile import CompVal, ExprCompiler, normalize_device_column
from ..mpp.exchange_op import exchange_arrays, hash_partition_ids
from ..ops import apply_selection, group_aggregate
from ..ops.aggregate import GatherState, finalize_agg
from .collectives import pmax


def _flatten_local(local: DeviceBatch):
    """[R_local, cap] region-stacked batch -> flat [R_local*cap] columns."""
    cols = []
    for c in local.cols:
        data = c.data.reshape((-1,) + tuple(c.data.shape[2:]))
        length = c.length.reshape(-1) if c.length is not None else None
        cols.append(DeviceColumn(data, c.null.reshape(-1), length, c.ft))
    return cols, local.row_valid.reshape(-1)


def _take(value, idx):
    return value[idx.to(torch.int64)]


def _materialize_gather(desc, arg_vals, st: GatherState, final: bool = False):
    """GatherState -> concrete state columns. The partial form keeps the
    [has, value] wire schema for first_row; `final` collapses to the single
    result column. String values ride as their packed compare words."""
    vcol = arg_vals[-1]
    zero = torch.zeros((), dtype=vcol.value.dtype, device=vcol.value.device)
    has = st.has[:, None] if vcol.value.dim() == 2 else st.has
    val = torch.where(has, _take(vcol.value, st.idx), zero)
    null = torch.where(st.has, _take(vcol.null, st.idx), True)
    if desc.name == "first_row" and not final:
        return [(st.has.to(torch.int64), torch.zeros(st.has.shape, dtype=torch.bool, device=st.has.device)),
                (val, null)]
    return [(val, null)]


def _final_cols(aggs_args, fin, gkeys):
    """The Complete-mode output columns of one shard's final table:
    [aggs..., group keys...] as (value, null) pairs."""
    out_cols = []
    for (d, av), st in zip(aggs_args, fin.states):
        if isinstance(st, GatherState):
            out_cols.extend(_materialize_gather(d, av, GatherState(st.idx, st.has & fin.group_valid), final=True))
        else:
            out_cols.append(finalize_agg(d, st, fin.group_valid))
    for gk in gkeys:
        out_cols.append((_take(gk.value, fin.group_rep), _take(gk.null, fin.group_rep) | ~fin.group_valid))
    return out_cols


def _split_args(aggs, avals):
    out, k = [], 0
    for d in aggs:
        out.append((d, avals[k:k + len(d.args)]))
        k += len(d.args)
    return out


def _finish(out_cols_s, gvalid_s, local_ovf_s, devices):
    """Per-shard flat output tuples [group_valid, (value, null)*,
    overflow], the overflow max-reduced over the shards."""
    ovf = pmax([o.to(torch.int32) for o in local_ovf_s], devices)
    return [tuple([gv] + [a for v, nl in oc for a in (v, nl)] + [o > 0])
            for gv, oc, o in zip(gvalid_s, out_cols_s, ovf)]


def agg_exchange_phases(agg, schema_fts, cvals: list, valid: list, n_parts: int, group_capacity: int, bcap: int,
                        devices, extra_overflow: list | None = None):
    """The partial / exchange / final pipeline given the pre-agg schema,
    over the shards: cvals[s] and valid[s] are shard s's columns and row
    mask. Called by the scan + selection path (run_sharded_grouped_agg)
    and the shuffle join (mpp/exchange_op.py). Returns one flat output
    tuple [group_valid, (value, null)*, overflow] per shard."""
    D = len(devices)
    gvals, aggs = [], []
    for s in range(D):
        comp = ExprCompiler(schema_fts, device=devices[s])
        gvals.append(comp.run(list(agg.group_by), cvals[s]))
        arg_exprs = [a for d in agg.aggs for a in d.args]
        aggs.append(_split_args(agg.aggs, comp.run(arg_exprs, cvals[s]) if arg_exprs else []))

    if any(d.distinct for d in agg.aggs):
        # DISTINCT is not state-decomposable, but it IS local-exact after
        # the group-key shuffle: every group lands whole on one shard
        return _distinct_exchange_phases(agg, gvals, aggs, valid, n_parts, group_capacity, bcap, devices,
                                         extra_overflow)

    # -- phase 1: local Partial1 ------------------------------------------
    flat_s, gvalid_s, p1_ovf = [], [], []
    state_fts = [ft for d in agg.aggs for ft in d.partial_fts()]
    n_state = len(state_fts)  # one column per partial state (a gather state materializes to its schema)
    for s in range(D):
        res = group_aggregate(gvals[s], aggs[s], valid[s], group_capacity, merge=False)
        state_cols: list[tuple] = []
        for (d, av), st in zip(aggs[s], res.states):
            state_cols.extend(_materialize_gather(d, av, st) if isinstance(st, GatherState) else st)
        gkey_cols = [(_take(gv.value, res.group_rep), _take(gv.null, res.group_rep)) for gv in gvals[s]]
        flat_s.append([a for v, nl in state_cols + gkey_cols for a in (v, nl)])
        gvalid_s.append(res.group_valid)
        p1_ovf.append(res.overflow)

    # -- phase 2: hash-exchange the group-state rows ----------------------
    part = []
    for s in range(D):
        base = 2 * n_state
        key_cvs = [CompVal(flat_s[s][base + 2 * j], flat_s[s][base + 2 * j + 1], g.ft)
                   for j, g in enumerate(agg.group_by)]
        part.append(hash_partition_ids(key_cvs, n_parts))
    flat, fvalid, ex_ovf = exchange_arrays(flat_s, gvalid_s, part, n_parts, bcap, devices)

    # -- phase 3: merge-mode aggregation on the owned partition -----------
    out_cols_s, fvalid_s, local_ovf = [], [], []
    for s in range(D):
        owned_states = [(flat[s][i], flat[s][i + 1].to(torch.bool)) for i in range(0, 2 * n_state, 2)]
        base = 2 * n_state
        owned_gkeys = [CompVal(flat[s][base + 2 * j], flat[s][base + 2 * j + 1].to(torch.bool), g.ft)
                       for j, g in enumerate(agg.group_by)]
        merge_aggs, si = [], 0
        for d in agg.aggs:
            n = len(d.partial_fts())
            merge_aggs.append((d, [CompVal(owned_states[si + i][0], owned_states[si + i][1], state_fts[si + i])
                                   for i in range(n)]))
            si += n
        fin = group_aggregate(owned_gkeys, merge_aggs, fvalid[s], group_capacity, merge=True)
        out_cols_s.append(_final_cols(merge_aggs, fin, owned_gkeys))
        fvalid_s.append(fin.group_valid)
        ovf = p1_ovf[s] | ex_ovf[s] | fin.overflow
        if extra_overflow is not None:
            ovf = ovf | extra_overflow[s]
        local_ovf.append(ovf)
    return _finish(out_cols_s, fvalid_s, local_ovf, devices)


def _distinct_exchange_phases(agg, gvals, aggs, valid, n_parts: int, group_capacity: int, bcap: int, devices,
                              extra_overflow=None):
    """Raw-row exchange + Complete-mode owner aggregation (the DISTINCT
    path): the group keys and agg arguments travel row by row, and the
    owner runs the single-device group aggregation in Complete mode, whose
    hash-distinct machinery is exact. Output layout as agg_exchange_phases."""
    D = len(devices)
    part = [hash_partition_ids(gvals[s], n_parts) for s in range(D)]
    row_cvs = [list(gvals[s]) + [a for _, avs in aggs[s] for a in avs] for s in range(D)]
    flat_arrays = [[a for cv in row_cvs[s] for a in (cv.value, cv.null)] for s in range(D)]
    flat, fvalid, ex_ovf = exchange_arrays(flat_arrays, valid, part, n_parts, bcap, devices)
    n_g = len(gvals[0])
    out_cols_s, fvalid_s, local_ovf = [], [], []
    for s in range(D):
        owned = [CompVal(flat[s][2 * k], flat[s][2 * k + 1].to(torch.bool), cv.ft)
                 for k, cv in enumerate(row_cvs[0])]
        o_gvals = owned[:n_g]
        o_aggs, ai = [], 0
        for d, avs in aggs[0]:
            o_aggs.append((d, owned[n_g + ai:n_g + ai + len(avs)]))
            ai += len(avs)
        fin = group_aggregate(o_gvals, o_aggs, fvalid[s], group_capacity, merge=False)
        out_cols_s.append(_final_cols(o_aggs, fin, o_gvals))
        fvalid_s.append(fin.group_valid)
        ovf = ex_ovf[s] | fin.overflow
        if extra_overflow is not None:
            ovf = ovf | extra_overflow[s]
        local_ovf.append(ovf)
    return _finish(out_cols_s, fvalid_s, local_ovf, devices)


def run_sharded_grouped_agg(dag: DAGRequest, stacked: DeviceBatch, mesh, group_capacity: int = 1024,
                            bucket_cap: int | None = None):
    """Execute TableScan [Selection] Aggregation(group_by) over a
    region-sharded mesh; returns (chunk, overflow flag).

    The Aggregation node is the LOGICAL (Complete-mode) shape; the partial
    / final split happens inside. Output layout as the single-device
    executor: [agg results..., group keys...]."""
    from ..mpp.exchange_op import cached_exchange_program
    from .mesh import decode_group_mesh_outputs, gather_shard_outputs, shard_batch

    executors = dag.executors
    agg = executors[-1]
    assert isinstance(agg, Aggregation) and agg.group_by, "grouped mesh agg needs GROUP BY"
    if any(d.name == "group_concat" for d in agg.aggs):
        raise NotImplementedError("group_concat on mesh (root-only, oracle-evaluated)")
    input_fts = [c.ft for c in dag.scan().columns]
    devices = list(mesh.devices)
    n_parts = len(devices)
    bcap = bucket_cap or group_capacity

    def build():
        def fn(st):
            cvals, valid = [], []
            for s, local in enumerate(shard_batch(st, devices)):
                cols, v = _flatten_local(local)
                cv = [normalize_device_column(c) for c in cols]
                for ex in executors[1:-1]:
                    if not isinstance(ex, Selection):
                        raise TypeError(f"mesh pipeline supports scan+selection+agg, got {ex}")
                    v = apply_selection(v, ExprCompiler(input_fts, device=devices[s]).run(list(ex.conditions), cv))
                cvals.append(cv)
                valid.append(v)
            return agg_exchange_phases(agg, input_fts, cvals, valid, n_parts, group_capacity, bcap, devices)

        return fn

    fn = cached_exchange_program(dag, mesh, build, group_capacity, bcap)
    return decode_group_mesh_outputs(gather_shard_outputs(fn(stacked), mesh.lead), agg)
