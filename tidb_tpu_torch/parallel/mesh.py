"""Mesh data parallelism: regions sharded over a list of devices (port of
tidb_tpu/parallel/mesh.py).

The reference fans per-region cop tasks out to store nodes over gRPC
(ref: copr/coprocessor.go:806 worker pool; batch_coprocessor.go groups
regions per store). The device-native shape (SURVEY.md §2.5): stack
region batches on a leading axis, split that axis over the mesh's shards,
run the DAG's region-batched program on each shard's lanes, and merge the
partial aggregate states across the shards — per-region partial
aggregates reduced over the device mesh before the final merge.

A mesh here is a `RegionMesh`: the list of devices a store owns
(runtime.mesh_devices), one shard each; a device may repeat, so four
shards can share one card and eight the CPU. Mesh programs are phases
over that list with the collectives of parallel/collectives.py between
them (PyTorch has no shard_map).

This module owns the SHARED merge seam: `partial_merge_plan` +
`merge_packed_states` (a sum for sum/count/avg/moments, min/max with the
flipped unsigned domain, a gather for bit and first states), consumed by
`run_sharded_partial_agg` and by exec/builder.py's mesh-tier programs.
Region stacking delegates to the chunk layer's `to_stacked_device_batch`,
the stacking the batch coprocessor uses.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..chunk import Chunk
from ..chunk.device import DeviceBatch, DeviceColumn, to_stacked_device_batch
from .collectives import all_gather, pmax, pmin, psum

I64_MIN = -0x8000000000000000


@dataclass(frozen=True)
class RegionMesh:
    """A 1-D mesh: one shard per entry of `devices`, in shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def region_mesh(devices, n_devices: int | None = None) -> RegionMesh:
    """The mesh over the first `n_devices` of `devices` (all by default)."""
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} shards over {len(devs)} devices")
    return RegionMesh(tuple(devs[:n]))


def stack_region_batches(chunks: list[Chunk], capacity: int | None = None, n_total: int | None = None,
                         device="cuda") -> DeviceBatch:
    """Stack per-region chunks into one [R, cap] batch on `device`.

    All regions pad to a common capacity and common string widths; with
    `n_total` (>= len(chunks)) the region axis is padded with empty lanes
    so that it divides over the mesh. Delegates to the chunk layer's
    `to_stacked_device_batch`."""
    cap = capacity or max(1, max(c.num_rows() for c in chunks))
    fts = chunks[0].field_types()
    total = n_total or len(chunks)
    padded = list(chunks) + [Chunk.empty(fts) for _ in range(total - len(chunks))]
    return to_stacked_device_batch(padded, cap, device=device)


def move_batch(batch: DeviceBatch, device) -> DeviceBatch:
    """The batch on `device` (the same tensors when it is there already)."""
    def mv(t):
        return None if t is None else t.to(device)

    return DeviceBatch([DeviceColumn(mv(c.data), mv(c.null), mv(c.length), c.ft) for c in batch.cols],
                       mv(batch.row_valid), mv(batch.n_rows))


def shard_batch(stacked: DeviceBatch, devices) -> list[DeviceBatch]:
    """Split a region-stacked batch's leading axis into one block of
    lanes per shard, in shard order, each on its shard's device (a view
    when the device is the batch's own)."""
    R = int(stacked.row_valid.shape[0])
    D = len(devices)
    if R % D:
        raise ValueError(f"{R} region lanes do not divide over {D} shards")
    k = R // D

    def part(t, s):
        return None if t is None else t[s * k:(s + 1) * k].to(devices[s])

    return [DeviceBatch([DeviceColumn(part(c.data, s), part(c.null, s), part(c.length, s), c.ft)
                         for c in stacked.cols], part(stacked.row_valid, s), part(stacked.n_rows, s))
            for s in range(D)]


def gather_shard_outputs(per_shard: list, lead) -> list:
    """Per-shard flat output tuples [leaf..., overflow] -> one list whose
    leaves are concatenated on dim 0 in shard order on `lead` (the
    reference's out_specs P(REGION_AXIS)), the replicated overflow flag
    last."""
    n = len(per_shard[0])
    out = [torch.cat([ps[i].to(lead) for ps in per_shard]) for i in range(n - 1)]
    return out + [per_shard[0][-1].to(lead)]


def run_sharded_partial_agg(dag, stacked: DeviceBatch, mesh: RegionMesh):
    """Scalar-aggregation pushdown over a region-sharded mesh.

    DAG shape: TableScan [Selection] Aggregation(group_by=(), partial=True).
    Each shard runs the DAG's region-batched program over its lanes
    (exec/builder.py build_program(mesh_lanes=...)), then the partial
    states merge across the mesh (`merge_packed_states`). Returns the flat
    partial-state columns [(value[1], null[1]), ...] on the lead device."""
    from dataclasses import replace as _replace

    from ..distsql.planner import mesh_merge_kind
    from ..exec.builder import build_program
    from ..exec.dag import Aggregation as _Agg
    from ..exec.dag import current_schema_fts

    # every partial-state column comes back: widen the offsets to the full
    # partial schema (the merge plan is positional over the state columns)
    n_state = len(current_schema_fts(dag.executors))
    dag = _replace(dag, output_offsets=tuple(range(n_state)))
    last = dag.executors[-1]
    assert isinstance(last, _Agg) and not last.group_by, "sharded scalar agg only"
    if mesh_merge_kind(dag) != "scalar":
        raise NotImplementedError("string-valued gather aggregate (first_row/min/max) over the mesh")
    R = int(stacked.row_valid.shape[0])
    cap = int(stacked.row_valid.shape[1])
    prog = build_program(dag, (cap,), mesh_lanes=R, mesh_devices=mesh, mesh_kind="scalar")
    merged, _valid, _ex, _ovf, _esc = prog.fn(stacked)
    return [tuple(out) for out in merged]


# --------------------------------------------------------- the merge seam

def partial_merge_plan(aggs) -> list[tuple]:
    """Merge plan per aggregate over its partial state columns (expr/agg.py
    partial_fts: count->[cnt], sum->[sum], avg->[cnt,sum],
    first_row->[has,val], stddev/var->[cnt,sum,sumsq], ...).

    Column entries are ("col", op, unsigned): unsigned BIGINT min/max
    states are raw two's-complement int64, so they compare in the flipped
    domain. first_row's two state columns merge JOINTLY via the
    ("first_row",) entry."""
    plan: list[tuple] = []
    for desc in aggs:
        sfts = desc.partial_fts()
        if desc.name in ("count", "sum", "avg", "bit_xor", "stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            op = "sum" if desc.name != "bit_xor" else "xor"
            plan.extend(("col", op, False) for _ in sfts)
        elif desc.name in ("min", "max"):
            plan.extend(("col", desc.name, ft.is_unsigned() and ft.is_int()) for ft in sfts)
        elif desc.name in ("bit_and", "bit_or"):
            plan.extend(("col", "and" if desc.name == "bit_and" else "or", False) for _ in sfts)
        elif desc.name == "first_row":
            plan.append(("first_row",))
        else:
            raise TypeError(f"no mesh merge for aggregate {desc.name!r}")
    return plan


def _flat_state(out) -> bool:
    return len(out) == 2 and out[0].dim() == 2


def merge_packed_states(aggs, packed: list, devices) -> list[tuple]:
    """Merge the region-batched program's packed outputs across the mesh.
    packed[s] is shard s's output list: one (value[R_local, 1],
    null[R_local, 1]) pair per partial-state column, in
    `partial_merge_plan` order. Returns the merged [(value[1], null[1]),
    ...] on the lead device."""
    plan = partial_merge_plan(aggs)
    merged: list[tuple] = []
    k = 0
    for entry in plan:
        if entry[0] == "first_row":
            if not _flat_state(packed[0][k + 1]):
                raise NotImplementedError("string-valued gather aggregate (first_row/min/max) over the mesh")
            merged.extend(_merge_first_row([p[k] for p in packed], [p[k + 1] for p in packed], devices))
            k += 2
            continue
        _, op, unsigned = entry
        if not _flat_state(packed[0][k]):
            raise NotImplementedError("string-valued gather aggregate (first_row/min/max) over the mesh")
        merged.append(_merge_state(op, [p[k][0] for p in packed], [p[k][1] for p in packed], devices,
                                   unsigned=unsigned))
        k += 1
    return merged


_BIT_OPS = {"xor": torch.bitwise_xor, "or": torch.bitwise_or, "and": torch.bitwise_and}


def _bit_reduce(op, x):
    """Bitwise reduction over dim 0 (torch has no bitwise reduce op)."""
    return functools.reduce(_BIT_OPS[op], list(x.unbind(0)))


def _merge_state(op: str, vs: list, nls: list, devices, unsigned: bool = False):
    """Merge one partial-state column across each shard's lanes, then the
    mesh. vs[s]: [R_local, 1] values (NULL lanes zeroed), nls[s]: their
    null flags. NULL means "no rows seen in this region"; the merged state
    is NULL only if every region's is. Sum-like states reduce by a sum,
    min/max by their extremes, bit states by a gather and a local
    bitwise reduce. Unsigned min/max compare in the sign-flipped domain."""
    flip = None
    if unsigned and op in ("min", "max") and not vs[0].is_floating_point():
        flip = I64_MIN
        vs = [v.to(torch.int64) ^ flip for v in vs]
    dt = vs[0].dtype
    if op in ("sum", "xor", "or"):
        fill = 0
    elif op == "and":
        fill = -1
    elif op == "min":
        fill = float("inf") if dt.is_floating_point else torch.iinfo(dt).max
    elif op == "max":
        fill = float("-inf") if dt.is_floating_point else torch.iinfo(dt).min
    else:
        raise AssertionError(op)
    masked = [torch.where(nl, torch.tensor(fill, dtype=dt, device=v.device), v) for v, nl in zip(vs, nls)]
    if op == "sum":
        val = psum([m.sum(0, dtype=dt) for m in masked], devices)[0]
    elif op == "min":
        val = pmin([m.amin(0) for m in masked], devices)[0]
    elif op == "max":
        val = pmax([m.amax(0) for m in masked], devices)[0]
    else:  # xor / or / and: gather (tiny) then a local bitwise reduce
        val = _bit_reduce(op, all_gather([_bit_reduce(op, m) for m in masked], devices)[0])
    allnull = pmin([nl.all(0).to(torch.int32) for nl in nls], devices)[0] > 0
    if flip is not None:
        val = val ^ flip
    if op in ("min", "max"):
        val = torch.where(allnull, torch.zeros((), dtype=val.dtype, device=val.device), val)
    return val, allnull


def _merge_first_row(has_state: list, val_state: list, devices):
    """first_row's [has, value] states merge jointly: the first region in
    shard-major order (regions were stacked, then split in order) whose
    has > 0 supplies its (value, null) verbatim; a NULL first value is
    kept (ref: aggfuncs first_row takes the literal first row). Returns
    the two merged state columns [has, value]."""
    ghas = all_gather([h[0] for h in has_state], devices, tiled=True)[0]
    gv = all_gather([v[0] for v in val_state], devices, tiled=True)[0]
    gn = all_gather([v[1] for v in val_state], devices, tiled=True)[0]
    present = ghas > 0
    idx = present.to(torch.int8).argmax(0)  # the first present region
    any_has = present.any(0)
    val = torch.gather(gv, 0, idx[None])[0]
    null = torch.gather(gn, 0, idx[None])[0]
    val = torch.where(any_has & ~null, val, torch.zeros((), dtype=gv.dtype, device=gv.device))
    null = torch.where(any_has, null, True)
    return [(any_has.to(torch.int64), torch.zeros_like(null)), (val, null)]


def decode_group_mesh_outputs(outs, agg):
    """Host-side decode of the grouped exchange programs' gathered output
    list [group_valid, (value, null)*, overflow] (gather_shard_outputs
    concatenated the shards' group tables in shard order). Returns
    (chunk, overflow) in the Complete-mode layout [aggs..., group keys...]."""
    from ..exec.executor import decode_outputs

    group_valid = outs[0].reshape(-1)
    overflow = bool(outs[-1].reshape(-1)[0])
    flat_out = outs[1:-1]
    out_fts = [d.ft for d in agg.aggs] + [g.ft for g in agg.group_by]
    packed = [(flat_out[2 * i], flat_out[2 * i + 1].reshape(-1)) for i in range(len(out_fts))]
    return decode_outputs(packed, group_valid, out_fts), overflow
