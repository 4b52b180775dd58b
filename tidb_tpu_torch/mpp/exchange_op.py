"""The exchange operator — ExchangeSender / ExchangeReceiver as collectives
over a list of shards (port of tidb_tpu/mpp/exchange_op.py; ref:
unistore/cophandler/mpp_exec.go:609-841 exchSenderExec / exchRecvExec,
partition modes :669-719).

The reference's ExchangeSender hash-partitions rows by fnv64 over the
encoded partition keys into per-task tunnels, and ExchangeReceiver merges
the streams. Here the tunnels are one `all_to_all` over the shards
(parallel/collectives.py): each shard scatters its rows into P send
buckets by key hash, the collective transposes the buckets across shards,
and every shard ends up owning one hash partition; then local group
aggregation (or join build / probe) runs on owned rows only.

The JAX package writes each mesh program as one function under
`shard_map`. PyTorch has none, so every function here that spans the mesh
takes and returns LISTS with one entry per shard, in shard order, and runs
its phases as straight-line code over them: `[f(x) for x in shards]`,
then a collective, then the next phase. Functions of one shard's rows
(hash_partition_ids, scatter_to_buckets, gather_compvals,
local_partition_join) take plain tensors, as in the reference.

`local_partition_join` is the per-partition join the receivers feed: the
radix-partitioned join when its plan gate passes on a single-word
int-class key (a unique build through the probe kernel K4 where its shape
gate passes, a non-unique build through the expansion), the sort-merge
join otherwise.
"""

from __future__ import annotations

import torch

from ..expr.compile import CompVal, ExprCompiler, normalize_device_column
from ..ops import apply_selection
from ..ops.keys import sort_key_arrays
from ..ops.seg import _lsr, _to_i64

# parallel/ (the collectives, the mesh) is imported inside the functions:
# the operator has no import-time dependency on it (parallel/ re-exports
# this module)

FNV_OFFSET = _to_i64(0xCBF29CE484222325)
FNV_PRIME = 1099511628211
# murmur3 fmix64 constants (as int64). The FNV fold alone leaves
# `h mod 2^b` a function of `k mod 2^b` with a power-of-two n_parts; the
# xor-shift finalizer avalanches the high bits down.
FMIX_C1 = _to_i64(0xFF51AFD7ED558CCD)
FMIX_C2 = _to_i64(0xC4CEB9FE1A85EC53)

def hash_partition_ids(key_vals: list[CompVal], n_parts: int) -> torch.Tensor:
    """Row -> partition id in [0, n_parts) from an FNV-style fold over the
    normalized key words, finished with the murmur3 fmix64 avalanche (NULL
    hashes as its zeroed words: all NULLs land together). A real key word
    is hashed through an f32 bitcast, as the reference does: equal doubles
    hash equal. The shifts are logical (ops/seg.py _lsr)."""
    nl = key_vals[0].null
    h = torch.full(nl.shape, FNV_OFFSET, dtype=torch.int64, device=nl.device)
    for kv in key_vals:
        for w in sort_key_arrays(kv):
            if w.is_floating_point():
                w = w.to(torch.float32).view(torch.int32)
            h = (h ^ w.to(torch.int64)) * FNV_PRIME
    h = (h ^ _lsr(h, 33)) * FMIX_C1
    h = (h ^ _lsr(h, 33)) * FMIX_C2
    h = h ^ _lsr(h, 33)
    # torch's % takes the divisor's sign, as jnp's does
    return torch.abs(h % n_parts).to(torch.int32)


def scatter_to_buckets(cols: list, valid, part, n_parts: int, bucket_cap: int):
    """Pack rows into [n_parts, bucket_cap] send buffers by partition id.

    Position within a bucket = rank of the row among same-partition rows
    in row order. Returns (bucketed cols, bucket valid, overflow flag).
    Rows past a full bucket land on its last slot (the overflow flag is
    set, and the caller's ladder retries larger)."""
    n = valid.shape[0]
    dev = valid.device
    part = torch.where(valid, part.to(torch.int64), n_parts)  # invalid rows -> ghost bucket
    order = torch.sort(part, stable=True).indices
    # a fixed-size count (bincount sizes its output from the data's max,
    # which the host reads back)
    counts_all = torch.zeros(n_parts + 1, dtype=torch.int64, device=dev).index_add_(0, part, torch.ones_like(part))
    start = torch.cumsum(counts_all, 0) - counts_all
    pos_in_bucket = torch.empty(n, dtype=torch.int64, device=dev)
    pos_in_bucket[order] = torch.arange(n, dtype=torch.int64, device=dev) - start[part[order]]
    overflow = torch.any(counts_all[:n_parts] > bucket_cap)
    flat_pos = part * bucket_cap + torch.clamp(pos_in_bucket, max=bucket_cap - 1)
    total = (n_parts + 1) * bucket_cap
    out_valid = torch.zeros(total, dtype=torch.bool, device=dev)
    out_valid[flat_pos] = valid & (pos_in_bucket < bucket_cap)
    out_cols = []
    for c in cols:
        buf = torch.zeros((total,) + tuple(c.shape[1:]), dtype=c.dtype, device=dev)
        buf[flat_pos] = c
        out_cols.append(buf.reshape((n_parts + 1, bucket_cap) + tuple(c.shape[1:]))[:n_parts])
    return out_cols, out_valid.reshape(n_parts + 1, bucket_cap)[:n_parts], overflow


def exchange_arrays(arrays: list, valid: list, part: list, n_parts: int, bucket_cap: int, devices: list):
    """ExchangeSender Hash mode + ExchangeReceiver merge for raw arrays,
    over the shards: arrays[s] is shard s's list of [n] arrays, valid[s]
    and part[s] its row mask and partition ids. Every shard scatters its
    rows into per-destination buckets, all_to_all transposes them (dim 0:
    the destination going in, the source coming out) and each shard
    flattens its received [P, cap] tables back to rows. Returns (arrays,
    valid, overflow) per shard: every row of the shard's hash partition,
    from all peers, source shard major."""
    from ..parallel.collectives import all_to_all
    from ..util import tracing

    D = len(devices)
    if n_parts != D:
        raise ValueError(f"{n_parts} partitions over {D} shards")
    with tracing.span("mpp.exchange", shards=D, bucket_cap=bucket_cap) as sp:
        sent = [scatter_to_buckets(arrays[s], valid[s], part[s], n_parts, bucket_cap) for s in range(D)]
        n_arr = len(arrays[0])
        if sp is not None:
            # the send buckets, payload and flags, every shard's
            sp.set("bytes", sum(b.numel() * b.element_size() for bufs, bv, _ in sent for b in list(bufs) + [bv]))
        recv = [all_to_all([sent[s][0][k] for s in range(D)], devices) for k in range(n_arr)]
        rvalid = all_to_all([sent[s][1] for s in range(D)], devices)
    flat = [[recv[k][e].reshape((-1,) + tuple(recv[k][e].shape[2:])) for k in range(n_arr)] for e in range(D)]
    return flat, [rv.reshape(-1) for rv in rvalid], [sent[s][2] for s in range(D)]


def broadcast_exchange(devices: list, cols: list, valid: list):
    """Broadcast mode (ref: mpp_exec.go:669 Broadcast partition type):
    every shard receives EVERY row. cols[s] is shard s's list of columns;
    returns ([P*n]-shaped cols, valid) per shard, identical on all."""
    from ..parallel.collectives import all_gather

    D = len(devices)
    out_cols = [[] for _ in range(D)]
    for k in range(len(cols[0])):
        g = all_gather([cols[s][k] for s in range(D)], devices)  # [P, n, ...] per shard
        for s in range(D):
            out_cols[s].append(g[s].reshape((-1,) + tuple(cols[0][k].shape[1:])))
    gv = [g.reshape(-1) for g in all_gather(list(valid), devices)]
    return out_cols, gv


def passthrough_exchange(devices: list, cols: list, valid: list, target: int = 0):
    """PassThrough mode (ref: mpp_exec.go:669-719, the root gather): every
    shard's rows land on `target`; the other shards keep the buffers with
    all-False validity."""
    out_cols, gv = broadcast_exchange(devices, cols, valid)
    return out_cols, [v & (s == target) for s, v in enumerate(gv)]


def exchange_group_aggregate(devices: list, key_vals: list, agg_fn, cols: list, valid: list, n_parts: int,
                             bucket_cap: int):
    """Hash-exchange rows so each shard owns one hash partition, then run
    `agg_fn(owned_cols, owned_valid)` on each shard. Lists per shard in,
    (agg_fn results per shard, overflow per shard) out; the overflow is
    max-reduced over the shards."""
    from ..parallel.collectives import pmax

    part = [hash_partition_ids(key_vals[s], n_parts) for s in range(len(devices))]
    flat, fvalid, ovf = exchange_arrays(cols, valid, part, n_parts, bucket_cap, devices)
    overflow = [o > 0 for o in pmax([o.to(torch.int32) for o in ovf], devices)]
    return [agg_fn(flat[s], fvalid[s]) for s in range(len(devices))], overflow


def exchange_compvals(cvals: list, valid: list, part: list, n_parts: int, bucket_cap: int, devices: list):
    """`exchange_arrays` over typed columns: each CompVal rides as its
    (value, null) pair and is rebuilt on the receiver with its FieldType.
    cvals[s] is shard s's column list."""
    flat = [[a for c in cs for a in (c.value, c.null)] for cs in cvals]
    flat_r, rvalid, ovf = exchange_arrays(flat, valid, part, n_parts, bucket_cap, devices)
    out = [[CompVal(fr[2 * i], fr[2 * i + 1].to(torch.bool), c.ft) for i, c in enumerate(cvals[0])]
           for fr in flat_r]
    return out, rvalid, ovf


def gather_compvals(cols: list, idx) -> list:
    idx = idx.to(torch.int64)
    return [CompVal(c.value[idx], c.null[idx], c.ft) for c in cols]


def local_partition_join(build_keys, probe_keys, build_valid, probe_valid, out_capacity: int, join_type: str,
                         build_unique: bool):
    """The per-partition join above the receivers (ref: mpp_exec.go:844
    joinExec), routed on static shapes: the radix-partitioned join when its
    plan gate passes on a single-word int-class key, the sort-merge join
    everywhere else. Either gives the same JoinResult contract."""
    from ..ops.join import _key_matrix, hash_join
    from ..ops.radix_join import radix_hash_join, radix_plan
    from ..util import tracing

    nb = int(build_valid.shape[0])
    np_ = int(probe_valid.shape[0])
    plan = radix_plan(nb, np_, out_capacity)
    with tracing.span("mpp.local_join", nb=nb, np=np_, out_capacity=out_capacity) as sp:
        if plan is not None and len(build_keys) == 1 and len(probe_keys) == 1:
            bw, _bu = _key_matrix(build_keys, build_valid)
            pw, _pu = _key_matrix(probe_keys, probe_valid)
            if len(bw) == 1 and len(pw) == 1 and not bw[0].is_floating_point() and not pw[0].is_floating_point():
                if sp is not None:
                    sp.set("radix_plan", plan)  # (n_parts, part_cap, probe_cap, esc_cap)
                res, _escapes = radix_hash_join(build_keys, probe_keys, build_valid, probe_valid, join_type,
                                                out_capacity, plan, build_unique=build_unique,
                                                out_capacity=out_capacity)
                return res
        return hash_join(build_keys, probe_keys, build_valid, probe_valid, out_capacity=out_capacity,
                         join_type=join_type, build_unique=build_unique)


def _strip_raw(cols: list) -> list:
    """Only packed compare words cross the exchange: drop raw string bytes."""
    return [CompVal(c.value, c.null, c.ft) for c in cols]


def exchange_join_program(dag, mesh, group_capacity: int = 1024, scale: int = 1):
    """Build (don't run) the shuffle-join program for an eligible chain
    DAG: `fn(stacked_probe, *stacked_builds) -> per-shard group outputs`
    (parallel/grouped.py agg_exchange_phases' layout). Per stage: both
    sides hash-partition by the stage's join key and exchange, each shard
    joins its owned partition, and the widened probe schema goes on to the
    next stage; the GROUP BY above runs the agg exchange phases."""
    from ..parallel.grouped import _flatten_local, agg_exchange_phases
    from ..parallel.mesh import shard_batch
    from .fragment import split_join_dag

    parts = split_join_dag(dag)
    if parts is None:
        raise ValueError("not a shuffle-join DAG shape")
    probe_scan, pre_sels, stages, agg = parts
    pfts = [c.ft for c in probe_scan.columns]
    devices = list(mesh.devices)
    n_parts = D = len(devices)

    def prep(local, fts, sels, dev):
        cols, valid = _flatten_local(local)
        cv = [normalize_device_column(c) for c in cols]
        for ex in sels:
            valid = apply_selection(valid, ExprCompiler(fts, device=dev).run(list(ex.conditions), cv))
        return _strip_raw(cv), valid

    def fn(stacked_probe, *stacked_builds):
        lps = shard_batch(stacked_probe, devices)
        lbs = [shard_batch(sb, devices) for sb in stacked_builds]
        prepped = [prep(lps[s], pfts, pre_sels, devices[s]) for s in range(D)]
        cols = [p[0] for p in prepped]
        valid = [p[1] for p in prepped]
        schema = list(pfts)
        extra = [torch.zeros((), dtype=torch.bool, device=d) for d in devices]
        # expected VALID rows per shard (static): after an exchange each
        # shard owns ~total/n, and total stacked rows are n * lane rows, so
        # the fair share IS the shard's row count. Capacities derive from
        # it, not from the previous stage's padded slots; skew past the
        # headroom is the ladder's job (`scale`).
        est = int(valid[0].shape[0])
        for (join, post_sels), lb in zip(stages, lbs):
            bfts = [c.ft for c in join.build[0].columns]
            bprep = [prep(lb[s], bfts, join.build[1:], devices[s]) for s in range(D)]
            bc = [b[0] for b in bprep]
            bvalid = [b[1] for b in bprep]
            pkeys = [ExprCompiler(schema, device=devices[s]).run(list(join.probe_keys), cols[s]) for s in range(D)]
            bkeys = [ExprCompiler(bfts, device=devices[s]).run(list(join.build_keys), bc[s]) for s in range(D)]
            # 2.5x the fair share: partitioning is balanced per KEY, not
            # per row
            pcap = max(64, 5 * scale * est // (2 * n_parts))
            bcap_ = max(64, 5 * scale * int(bvalid[0].shape[0]) // (2 * n_parts))
            pp = [hash_partition_ids(pkeys[s], n_parts) for s in range(D)]
            bp = [hash_partition_ids(bkeys[s], n_parts) for s in range(D)]
            pc2, pvalid2, povf = exchange_compvals(cols, valid, pp, n_parts, pcap, devices)
            bc2, bvalid2, bovf = exchange_compvals(bc, bvalid, bp, n_parts, bcap_, devices)
            if join.join_type in ("semi", "anti"):
                out_cap = int(pvalid2[0].shape[0])  # probe-shaped output
            else:
                if not join.build_unique:
                    est = 4 * est  # duplicate-build fan-out headroom
                out_cap = max(128, 2 * scale * est)
            new_schema = schema
            if join.join_type not in ("semi", "anti"):
                new_schema = schema + ([f.clone_nullable() for f in bfts] if join.join_type == "left_outer"
                                       else bfts)
            for s in range(D):
                pkeys2 = ExprCompiler(schema, device=devices[s]).run(list(join.probe_keys), pc2[s])
                bkeys2 = ExprCompiler(bfts, device=devices[s]).run(list(join.build_keys), bc2[s])
                res = local_partition_join(bkeys2, pkeys2, bvalid2[s], pvalid2[s], out_capacity=out_cap,
                                           join_type=join.join_type, build_unique=join.build_unique)
                extra[s] = extra[s] | povf[s] | bovf[s] | res.overflow
                if join.join_type in ("semi", "anti"):
                    cols[s] = pc2[s]
                else:
                    nb = int(bvalid2[s].shape[0])
                    p_g = pc2[s] if res.probe_identity else gather_compvals(pc2[s], res.probe_idx)
                    b_g = gather_compvals(bc2[s], torch.clamp(res.build_idx, 0, nb - 1))
                    b_g = [CompVal(c.value, c.null | res.build_null, c.ft) for c in b_g]
                    cols[s] = p_g + b_g
                valid[s] = res.out_valid
                for ex in post_sels:
                    conds = ExprCompiler(new_schema, device=devices[s]).run(list(ex.conditions), cols[s])
                    valid[s] = apply_selection(valid[s], conds)
            schema = new_schema
        # the state exchange's buckets are data-sized like the join's
        return agg_exchange_phases(agg, schema, cols, valid, n_parts, group_capacity,
                                   max(64, 2 * scale * est // n_parts), devices, extra_overflow=extra)

    return fn


# built exchange programs, keyed by (wire-encoded DAG, mesh devices,
# capacities), as the reference keys its jitted programs; a bounded FIFO
_PROGRAM_CACHE: dict = {}
_PROGRAM_CACHE_CAP = 64


def cached_exchange_program(dag, mesh, build, *cap_key):
    """`build() -> fn`, cached under the DAG's wire identity."""
    from ..codec.wire import encode_dag

    key = (encode_dag(dag), tuple(str(d) for d in mesh.devices), *cap_key)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        if len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        fn = build()
        _PROGRAM_CACHE[key] = fn
    return fn


def run_exchange_join_agg(dag, stacked_probe, stacked_builds: list, mesh, group_capacity: int = 1024,
                          scale: int = 1):
    """Execute scan [sel] (JOIN(scan [sel]) [sel])+ GROUP BY over the mesh
    as ONE exchange program; returns (chunk, overflow flag). Output layout
    matches the single-device executor: [agg results..., group keys...].
    `scale` (grown by the caller's overflow ladder) multiplies every
    data-dependent capacity: exchange buckets and the join's out-capacity."""
    from ..parallel.mesh import decode_group_mesh_outputs, gather_shard_outputs
    from .fragment import split_join_dag

    if not isinstance(stacked_builds, (list, tuple)):
        stacked_builds = [stacked_builds]
    n_stages = len(split_join_dag(dag)[2])
    if len(stacked_builds) != n_stages:
        raise ValueError("one build batch per join stage")
    agg = dag.executors[-1]
    fn = cached_exchange_program(
        dag, mesh, lambda: exchange_join_program(dag, mesh, group_capacity=group_capacity, scale=scale),
        group_capacity, scale)
    return decode_group_mesh_outputs(gather_shard_outputs(fn(stacked_probe, *stacked_builds), mesh.lead), agg)
