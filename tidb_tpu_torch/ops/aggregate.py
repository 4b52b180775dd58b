"""Aggregation (port of tidb_tpu/ops/aggregate.py).

Group-by is hash-cluster based: normalize keys to int64 words
(ops/keys.py), mix them into ONE 63-bit hash word (ops/seg.py), sort by
that word (stable, so each segment's first row is its earliest input row),
and reduce each contiguous hash cluster with cumsum segment passes.
Collisions (different keys, equal 62-bit hash) are caught by a neighbour
compare on an independently salted second hash and surface as the
overflow flag; the retry driver's larger capacity re-salts both hashes.

Routes, in the JAX package's order (tidb_tpu/ops/aggregate.py
group_aggregate): input already sorted on the group keys takes the stream
kernel; a small-G hint <= 32 with an eligible aggregate mix takes the
one-pass CUDA kernel (ops/dense_agg.py); any other hinted GROUP BY whose
aggregates allow it takes the sort-free small-G route
(_group_aggregate_dense: a distinct-hash table from a row sample, each
row's slot from it, every reduction in original row order); the rest
takes the sort path. The two small-G routes raise the overflow flag when
the hint was wrong, and drive_program_info retries without the hint.

Two phases mirror the reference's partial/final split:
  raw phase    (Complete/Partial1)  raw rows in
  merge phase  (Partial2/Final)     partial-state columns in, reduced by
                                    state-specific merge (+, +, min, max...)
COUNT/SUM/AVG/VAR(DISTINCT) take a second sort by (group hash, arg hash)
(_distinct_states); they are not decomposable, so merge mode refuses them.
BIT_AND/OR/XOR reduce with a segmented doubling scan (ops/seg.py).
group_concat raises NotImplementedError: the row oracle evaluates it.

Partial states (expr/agg.py): count=[n], sum=[s], avg=[n,s], min/max=[v],
var/stddev=[n,s,q], bit_*=[v].
Output groups are ordered by first encounter (earliest contributing input
row), matching the row-at-a-time oracle's insertion order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..expr.agg import AggDesc
from ..expr.compile import CompVal, _round_div, _scale, div_exact
from ..kernels import count_launch
from .keys import segments_from_sorted, sort_key_arrays
from .seg import (
    I64_MAX,
    DenseCtx,
    DenseSumBatch,
    SegCtx,
    SumBatch,
    dense_first_match,
    group_hash,
    hash_words,
    make_segctx,
    seg_bitreduce,
    seg_first_match,
    seg_max,
    seg_min,
    seg_sum,
    sorted_positions,
)

I64_MIN_ = -0x8000000000000000


@dataclass
class GroupAggResult:
    """Fixed-capacity aggregation output.

    group_rep: int32 [G] earliest original input-row index per group.
    states: per agg, either a list of (value[G], null[G]) state/result
    columns or a GatherState (the caller gathers the agg's value column —
    and its raw string bytes — from the original batch).
    need: the true distinct-group count when the kernel knows it (the sort
    kernel's segment count); None = unknown."""

    group_rep: torch.Tensor
    group_valid: torch.Tensor
    n_groups: torch.Tensor
    overflow: torch.Tensor
    states: list
    need: torch.Tensor | None = None


@dataclass
class GatherState:
    """Per-group 'fetch this original row' aggregate state (first_row and
    string min/max)."""

    idx: torch.Tensor  # int32 [G] original row index (clipped; dead when ~has)
    has: torch.Tensor  # bool [G] group produced a state


_VAR_FUNCS = frozenset({"stddev_pop", "stddev_samp", "var_pop", "var_samp"})


def _as_f64(a: CompVal):
    """Value lane as float64 (stddev/var are always DOUBLE in MySQL)."""
    if a.eval_type == "real":
        return a.value
    if a.eval_type == "decimal":
        return div_exact(a.value.to(torch.float64), float(10 ** max(a.ft.decimal, 0)))
    return a.value.to(torch.float64)


def _zeros_bool(n: int, like: torch.Tensor):
    # new_zeros: a vmapped `like` (the region-batched program) gives a
    # buffer with its region axis
    return like.new_zeros(n, dtype=torch.bool)


def _shifted_ne(x: torch.Tensor) -> torch.Tensor:
    """[False, x[1:] != x[:-1]], out of place."""
    return torch.cat([torch.zeros_like(x[:1], dtype=torch.bool), x[1:] != x[:-1]])


def _shifted_eq(x: torch.Tensor) -> torch.Tensor:
    """[False, x[1:] == x[:-1]], out of place."""
    return torch.cat([torch.zeros_like(x[:1], dtype=torch.bool), x[1:] == x[:-1]])


def _pair_valid(valid_s: torch.Tensor) -> torch.Tensor:
    """Rows whose predecessor is valid too (row 0 has none)."""
    return valid_s & torch.cat([torch.zeros_like(valid_s[:1]), valid_s[:-1]])


_BIT_OPS = {
    "bit_and": (torch.bitwise_and, -1),  # identity all-ones (MySQL empty BIT_AND = 2^64-1)
    "bit_or": (torch.bitwise_or, 0),
    "bit_xor": (torch.bitwise_xor, 0),
}


def _agg_states_raw(desc: AggDesc, args: list[CompVal], valid, ctx: SegCtx):
    """Per-group partial states from raw rows."""
    name = desc.name
    nseg = ctx.nseg
    if name == "count":
        mask = valid
        for a in args:
            mask = mask & ~a.null
        return [(seg_sum(ctx, mask.to(torch.int64)), _zeros_bool(nseg, valid))]
    a = args[0]
    mask = valid & ~a.null
    cnt = seg_sum(ctx, mask.to(torch.int64))
    empty = cnt == 0
    if name in ("sum", "avg"):
        if a.eval_type == "real":
            s = seg_sum(ctx, torch.where(mask, a.value, 0.0))
        else:
            s = seg_sum(ctx, torch.where(mask, a.value.to(torch.int64), 0))
        if name == "sum":
            return [(s, empty)]
        return [(cnt, _zeros_bool(nseg, valid)), (s, empty)]
    if name in ("min", "max"):
        op = seg_min if name == "min" else seg_max
        if a.eval_type == "real":
            fill = float("inf") if name == "min" else float("-inf")
            v = op(ctx, torch.where(mask, a.value, fill))
        elif a.value.dim() == 2:
            raise AssertionError("string min/max is routed via GatherState")
        elif a.ft.is_unsigned() and a.eval_type == "int":
            av = a.value.to(torch.int64) ^ I64_MIN_
            fill = I64_MAX if name == "min" else I64_MIN_
            v = op(ctx, torch.where(mask, av, fill)) ^ I64_MIN_
        else:
            av = a.value.to(torch.int64)
            fill = I64_MAX if name == "min" else I64_MIN_
            v = op(ctx, torch.where(mask, av, fill))
        return [(v, empty)]
    if name == "first_row":
        raise AssertionError("first_row is routed via GatherState")
    if name in _VAR_FUNCS:
        # moment states [count, sum, sum_sq] — additive
        v = _as_f64(a)
        s = seg_sum(ctx, torch.where(mask, v, 0.0))
        q = seg_sum(ctx, torch.where(mask, v * v, 0.0))
        return [(cnt, _zeros_bool(nseg, valid)), (s, empty), (q, empty)]
    if name == "group_concat":
        raise NotImplementedError("group_concat on device (root-only, oracle-evaluated)")
    if name in _BIT_OPS:
        red, fill = _BIT_OPS[name]
        v = seg_bitreduce(ctx, red, torch.where(mask, a.value.to(torch.int64), fill), fill)
        # MySQL BIT_* never return NULL: an empty set yields the identity
        return [(v, _zeros_bool(nseg, valid))]
    raise NotImplementedError(f"aggregate {name} on device")


def _first_match_idx(mask_s, orig_s, ctx: SegCtx, n):
    """Per-segment earliest ORIGINAL row index among mask rows (the sort
    is stable, so the first masked sorted position is the earliest row).
    Returns (idx int32 [nseg], has bool [nseg])."""
    pos, has = seg_first_match(ctx, mask_s)
    idx = orig_s[pos.to(torch.int64)].to(torch.int32)
    return torch.clamp(idx, 0, n - 1), has


def _arg_extreme_mask(words_s, cand, ctx: SegCtx, maximize: bool):
    """Narrow `cand` (sorted order) to rows holding the per-segment
    lexicographic extreme of `words_s` ([n, K] int64, most significant
    word first): word-by-word radix arg-extreme."""
    seg = ctx.seg.to(torch.int64)
    for k in range(words_s.shape[1]):
        w = words_s[:, k]
        if maximize:
            best = seg_max(ctx, torch.where(cand, w, I64_MIN_))
        else:
            best = seg_min(ctx, torch.where(cand, w, I64_MAX))
        cand = cand & (w == best[seg])
    return cand


def _distinct_states(desc: AggDesc, args: list, row_valid, hp, nseg: int, salt: int):
    """COUNT/SUM/AVG/VAR(DISTINCT ...) states via a second sort by (group
    hash, arg hash): the first row of each distinct (group, args)
    combination contributes exactly once.

    The sort is two stable passes, by the arg hash and then by the group
    hash of that order, so rows cluster by group hash exactly as the main
    sort clusters them: segment ids are hash ranks in both, and the groups
    number alike. Returns (states, collision_flag): arg-hash collisions are
    caught by a neighbour compare on a second arg hash and clear on the
    salted retry."""
    argkeys: list = []
    amask = row_valid
    for a in args:
        amask = amask & ~a.null
        argkeys.extend(sort_key_arrays(a))
    ah = hash_words(argkeys, salt + 1)
    ah2 = hash_words(argkeys, salt + 2)
    need_val = desc.name != "count"
    a0 = args[0]
    if need_val and a0.value.dim() != 1:
        raise NotImplementedError(f"DISTINCT {desc.name} over string values")
    by_arg = torch.sort(ah, stable=True).indices
    perm = by_arg[torch.sort(hp[by_arg], stable=True).indices]
    hps, ahs, ah2s, amask_s = hp[perm], ah[perm], ah2[perm], amask[perm]
    valid2 = hps != I64_MAX
    seg2, _ = segments_from_sorted([hps], valid2)
    seg2 = torch.clamp(seg2, max=nseg - 1)
    ctx2 = make_segctx(seg2, nseg)
    same_run = _shifted_eq(hps) & _shifted_eq(ahs)
    collision = torch.any(same_run & _shifted_ne(ah2s) & _pair_valid(valid2))
    uniq = ~same_run & valid2 & amask_s
    cnt = seg_sum(ctx2, uniq.to(torch.int64))
    zeros = _zeros_bool(nseg, row_valid)
    if desc.name == "count":
        return [(cnt, zeros)], collision
    a2 = a0.value[perm]
    empty = cnt == 0
    if desc.name in _VAR_FUNCS:
        v2 = _as_f64(CompVal(a2, torch.zeros_like(amask_s), a0.ft))
        s = seg_sum(ctx2, torch.where(uniq, v2, 0.0))
        q = seg_sum(ctx2, torch.where(uniq, v2 * v2, 0.0))
        return [(cnt, zeros), (s, empty), (q, empty)], collision
    if a0.eval_type == "real":
        s = seg_sum(ctx2, torch.where(uniq, a2, 0.0))
    else:
        s = seg_sum(ctx2, torch.where(uniq, a2.to(torch.int64), 0))
    if desc.name == "sum":
        return [(s, empty)], collision
    return [(cnt, zeros), (s, empty)], collision


def _agg_states_merge(desc: AggDesc, args: list[CompVal], valid, ctx: SegCtx):
    """Merge partial-state columns (Partial2/Final): args are state cols."""
    name = desc.name
    nseg = ctx.nseg
    if name == "count":
        a = args[0]
        return [(seg_sum(ctx, torch.where(valid, a.value, 0)), _zeros_bool(nseg, valid))]
    if name in ("sum", "avg"):
        out = []
        for a in args:  # count then sum for avg; sum only for sum
            mask = valid & ~a.null
            present = seg_sum(ctx, mask.to(torch.int64)) > 0
            if a.eval_type == "real":
                s = seg_sum(ctx, torch.where(mask, a.value, 0.0))
            else:
                s = seg_sum(ctx, torch.where(mask, a.value.to(torch.int64), 0))
            out.append((s, ~present))
        if name == "avg":
            out[0] = (out[0][0], _zeros_bool(nseg, valid))  # the count state is never NULL
        return out
    if name in ("min", "max"):
        return _agg_states_raw(desc, args, valid, ctx)
    if name in _VAR_FUNCS:
        # additive moment states: sum each of [count, sum, sum_sq]
        cnt_a, s_a, q_a = args
        mask = valid & ~s_a.null
        cnt = seg_sum(ctx, torch.where(valid, cnt_a.value.to(torch.int64), 0))
        s = seg_sum(ctx, torch.where(mask, s_a.value, 0.0))
        q = seg_sum(ctx, torch.where(mask, q_a.value, 0.0))
        nn = cnt == 0
        return [(cnt, _zeros_bool(nseg, valid)), (s, nn), (q, nn)]
    if name == "first_row":
        raise AssertionError("first_row merge is routed via GatherState")
    if name in _BIT_OPS:
        # a reduce of reduces: the same segmented bitwise scan over the states
        return _agg_states_raw(desc, args, valid, ctx)
    raise NotImplementedError(f"merge of {name} on device")


def finalize_agg(desc: AggDesc, states: list, group_valid) -> tuple:
    """State columns -> final (value, null) result column."""
    name = desc.name
    if name == "avg":
        cnt, (s, snull) = states[0][0], states[1]
        if desc.ft.eval_type() == "real":
            out = s / torch.where(cnt == 0, 1, cnt).to(torch.float64)
            return out, snull | (cnt == 0)
        # decimal: scale(avg) = scale(sum) + 4 (div frac incr)
        sum_scale = _scale(desc.partial_fts()[1])
        tgt = _scale(desc.ft)
        num = s * (10 ** (tgt - sum_scale))
        out = _round_div(num, torch.where(cnt == 0, 1, cnt))
        return out, snull | (cnt == 0)
    if name == "first_row":
        has = states[0][0]
        v, nl = states[1]
        return v, nl | (has == 0)
    if name in _VAR_FUNCS:
        cnt = states[0][0]
        s, q = states[1][0], states[2][0]
        n = torch.clamp(cnt, min=1).to(torch.float64)
        mean = s / n
        if name.endswith("samp"):
            var = torch.clamp(q - n * mean * mean, min=0.0) / torch.clamp(n - 1.0, min=1.0)
            null = cnt < 2  # sample stats undefined for n < 2 (MySQL NULL)
        else:
            var = torch.clamp(q / n - mean * mean, min=0.0)
            null = cnt == 0
        out = torch.sqrt(var) if name.startswith("stddev") else var
        return out, null
    v, nl = states[0][0], states[0][1]
    return v, nl


def _gather_state_sorted(desc, sorted_avs, valid_s, ctx: SegCtx, perm, n, merge):
    """GatherState for first_row / string min-max, from SORTED args."""
    name = desc.name
    if name == "first_row":
        mask = valid_s
        if merge:
            mask = mask & (sorted_avs[0].value > 0)
        idx, has = _first_match_idx(mask, perm, ctx, n)
        return GatherState(idx, has)
    a = sorted_avs[-1]
    mask = valid_s & ~a.null
    cand = _arg_extreme_mask(a.value, mask, ctx, name == "max")
    idx, has = _first_match_idx(cand, perm, ctx, n)
    return GatherState(idx, has)


def _needs_gather_state(desc, arg_vals) -> bool:
    if desc.name == "first_row":
        return True
    return desc.name in ("min", "max") and bool(arg_vals) and arg_vals[-1].value.dim() == 2


def _is_distinct_special(desc, arg_vals, merge) -> bool:
    if desc.distinct and desc.name in ({"count", "sum", "avg"} | _VAR_FUNCS) and arg_vals:
        if merge:
            raise NotImplementedError(
                "DISTINCT aggregates are not decomposable into mergeable partials; "
                "plan them in Complete mode (ref: AggregationPushDownSolver skips distinct)"
            )
        return True
    return False


def _dense_eligible(aggs, merge) -> bool:
    """The sort-free small-G route handles everything except DISTINCT,
    string-valued min / max (their word-matrix machinery assumes the
    sorted layout) and group_concat."""
    for desc, avs in aggs:
        if desc.distinct:
            return False
        if desc.name in ("min", "max") and avs and avs[-1].value.dim() == 2:
            return False
        if desc.name == "group_concat":
            return False
    return True


# rows of the strided sample the distinct-hash table is read from
_DENSE_SAMPLE = 4096


def _dense_table(hp: torch.Tensor, g_cap: int):
    """The distinct-hash table of the JAX package's dense route: the
    g_cap smallest distinct valid hashes of a strided sample of hp, in
    ascending order, I64_MAX-padded; n_groups its valid entries; overflow
    when the sample holds more than g_cap distinct hashes. The JAX package
    extracts the minima with g_cap serial passes; one sort of the sample
    gives the same table with no loop and no host sync."""
    n = hp.shape[0]
    stride = max(n // _DENSE_SAMPLE, 1)
    s = torch.sort(hp[::stride]).values
    first = torch.cat([torch.ones_like(s[:1], dtype=torch.bool), s[1:] != s[:-1]]) & (s != I64_MAX)
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    n_distinct = first.sum()
    slot = torch.where(first & (rank < g_cap), rank, g_cap)
    # slot g_cap collects every row not placed; it is cut off
    tbl = s.new_full((g_cap + 1,), I64_MAX).scatter(0, slot, s)[:g_cap]
    return tbl, torch.clamp(n_distinct, max=g_cap).to(torch.int32), n_distinct > g_cap


def _group_aggregate_dense(group_bys, aggs, row_valid, g_cap: int, merge: bool):
    """Sort-free small-G aggregation (seg.DenseCtx), the JAX package's
    XLA route for hinted GROUP BYs that its one-pass kernel refuses.

    The distinct-hash table comes from a strided SAMPLE (_dense_table);
    two single-pass checks then make the result exact: every valid row's
    hash must be IN the table (a group the sample missed) and the
    secondary hash must be constant within a slot (a true hash
    collision). Either failure, or more distinct hashes than g_cap, raises
    the overflow flag and the driver retries without the hint — the
    contract a wrong NDV hint always had. Invalid rows fall in slot
    n_groups; the states' masks keep them out.
    `_group_aggregate_dense.launches` counts its runs (one per program
    run; a region-batched run counts once)."""
    count_launch(_group_aggregate_dense)
    n = row_valid.shape[0]
    dev = row_valid.device
    keys: list[torch.Tensor] = []
    for g in group_bys:
        keys.extend(sort_key_arrays(g))
    hp = group_hash(keys, row_valid, salt=g_cap)
    hv = hash_words(keys, g_cap + 0x9E3779B9)

    tbl, n_groups, overflow = _dense_table(hp, g_cap)
    # each row's slot: the table entries below its hash (invalid rows,
    # hp == I64_MAX, count every valid entry)
    gid = sorted_positions(tbl, hp).to(torch.int64)
    nseg = g_cap + 1
    ctx = DenseCtx(gid=gid, nseg=nseg)

    # exactness check 1: every valid row's hash is a table entry (a group
    # the sample missed would otherwise merge into a neighbour slot or
    # vanish in the invalid slot)
    padded = torch.cat([tbl, tbl.new_full((1,), I64_MAX)])
    overflow = overflow | torch.any(row_valid & (padded[gid] != hp))
    # exactness check 2: the secondary hash is constant within each slot
    # (different keys, equal primary hash)
    mx = seg_max(ctx, torch.where(row_valid, hv, I64_MIN_))
    mn = seg_min(ctx, torch.where(row_valid, hv, I64_MAX))
    overflow = overflow | torch.any((mx != mn) & (mx != I64_MIN_))

    group_rep_full, _ = dense_first_match(ctx, row_valid)
    group_rep = group_rep_full[:g_cap]
    group_valid = torch.arange(g_cap, dtype=torch.int32, device=dev) < n_groups

    # every integer per-group sum rides one matmul: record pass -> resolve
    # -> replay (seg.DenseSumBatch)
    fn = _agg_states_merge if merge else _agg_states_raw
    ctx.sums = DenseSumBatch(ctx)
    for desc, arg_vals in aggs:
        if not _needs_gather_state(desc, arg_vals):
            fn(desc, arg_vals, row_valid, ctx)
    ctx.sums.resolve()

    perm = torch.arange(n, dtype=torch.int32, device=dev)
    states = []
    for desc, arg_vals in aggs:
        if _needs_gather_state(desc, arg_vals):
            st = _gather_state_sorted(desc, arg_vals, row_valid, ctx, perm, n, merge)
            states.append(GatherState(st.idx[:g_cap], st.has[:g_cap] & group_valid))
            continue
        st = fn(desc, arg_vals, row_valid, ctx)
        states.append([(v[:g_cap], nl[:g_cap] | ~group_valid) for v, nl in st])
    ctx.sums = None

    order = torch.argsort(torch.where(group_valid, group_rep, n), stable=True)
    group_rep = group_rep[order]
    out_states: list = []
    for st in states:
        if isinstance(st, GatherState):
            out_states.append(GatherState(st.idx[order], st.has[order]))
        else:
            out_states.append([(v[order], nl[order]) for v, nl in st])
    return GroupAggResult(group_rep, group_valid, n_groups, overflow, out_states)


_group_aggregate_dense.launches = 0


def _group_aggregate_stream(group_bys, aggs, row_valid, group_capacity: int, merge: bool, compact: bool = True):
    """StreamAgg over input ALREADY sorted on the group keys: group
    boundaries are neighbour compares over the key words — no sort, no
    hash. Filtered rows stay inside their key run and are masked by the
    states; with `compact`, runs whose rows are all filtered drop out
    through the first-encounter reorder. compact=False returns the raw
    per-run has-flags as group_valid, in key order (ops/joinagg.py
    reorders itself)."""
    n = row_valid.shape[0]
    dev = row_valid.device
    keys: list[torch.Tensor] = []
    for g in group_bys:
        keys.extend(sort_key_arrays(g))
    diff = torch.ones(n, dtype=torch.bool, device=dev)
    if keys:
        # out of place: under torch.func.vmap the keys carry the region
        # axis and `diff` does not, so an in-place update cannot batch
        change = torch.zeros(n - 1, dtype=torch.bool, device=dev)
        for k in keys:
            change = change | (k[1:] != k[:-1])
        diff = torch.cat([diff[:1], change])
    seg = torch.cumsum(diff.to(torch.int32), 0, dtype=torch.int32) - 1
    # overflow only when a SURVIVING row lands past the capacity: key runs
    # whose rows are all filtered do not affect any output
    overflow = torch.any(row_valid & (seg >= group_capacity))
    nseg = group_capacity + 1
    seg = torch.clamp(seg, max=nseg - 1)
    ctx = make_segctx(seg, nseg)
    perm = torch.arange(n, dtype=torch.int32, device=dev)

    group_rep_full, has_rep = _first_match_idx(row_valid, perm, ctx, n)
    group_rep = group_rep_full[:group_capacity]
    has_g = has_rep[:group_capacity]
    n_groups = has_g.sum().to(torch.int32)

    states = []
    for desc, arg_vals in aggs:
        if _is_distinct_special(desc, arg_vals, merge):
            # DISTINCT needs the hash machinery's group-id alignment; the
            # planner never sets stream for distinct aggs (guard)
            raise NotImplementedError("DISTINCT aggregates in stream mode")
        if _needs_gather_state(desc, arg_vals):
            st = _gather_state_sorted(desc, arg_vals, row_valid, ctx, perm, n, merge)
            states.append(GatherState(st.idx[:group_capacity], st.has[:group_capacity] & has_g))
            continue
        fn = _agg_states_merge if merge else _agg_states_raw
        st = fn(desc, arg_vals, row_valid, ctx)
        states.append([(v[:group_capacity], nl[:group_capacity] | ~has_g) for v, nl in st])

    if not compact:
        return GroupAggResult(group_rep, has_g, n_groups, overflow, states)

    # compact: runs with >= 1 surviving row first, in first-encounter order
    order = torch.argsort(torch.where(has_g, group_rep, n), stable=True)
    group_rep = group_rep[order]
    group_valid = torch.arange(group_capacity, dtype=torch.int32, device=dev) < n_groups
    out_states: list = []
    for st in states:
        if isinstance(st, GatherState):
            out_states.append(GatherState(st.idx[order], st.has[order]))
        else:
            out_states.append([(v[order], nl[order]) for v, nl in st])
    return GroupAggResult(group_rep, group_valid, n_groups, overflow, out_states)


def group_aggregate(
    group_bys: list[CompVal],
    aggs: list,
    row_valid: torch.Tensor,
    group_capacity: int,
    merge: bool = False,
    small_groups: int | None = None,
    stream: bool = False,
):
    """Hash-cluster group aggregation.

    aggs: list of (AggDesc, [arg CompVals]). Returns GroupAggResult; groups
    in first-encounter order.
    small_groups: statistics-driven hint (planner NDV product) — with a
    hint <= 32 and an eligible agg mix the one-pass kernel runs, else the
    sort-free small-G route where the aggregates allow it; their overflow
    flag routes the driver back here.
    stream: input pre-sorted on the group keys (planner-proven, e.g. below
    a Sort): the boundary-scan stream kernel runs, no sort and no hash."""
    if stream and group_bys and not any(d.distinct for d, _ in aggs):
        return _group_aggregate_stream(group_bys, aggs, row_valid, group_capacity, merge)
    if small_groups and group_bys and small_groups <= 32:
        from .dense_agg import dense_agg_eligible, group_aggregate_dense

        if dense_agg_eligible(group_bys, aggs, merge):
            return group_aggregate_dense(group_bys, aggs, row_valid, small_groups)
    if small_groups and group_bys and _dense_eligible(aggs, merge):
        return _group_aggregate_dense(group_bys, aggs, row_valid, small_groups, merge)
    dev = row_valid.device
    n = row_valid.shape[0]
    keys: list[torch.Tensor] = []
    for g in group_bys:
        keys.extend(sort_key_arrays(g))
    # ONE sortable word: salted 62-bit hash, invalid rows pinned to the tail;
    # a second independently-salted hash rides along for collision detection
    hp = group_hash(keys, row_valid, salt=group_capacity)
    hv = hash_words(keys, group_capacity + 0x9E3779B9)

    h_s, perm = torch.sort(hp, stable=True)
    hv_s = hv[perm]
    valid_s = h_s != I64_MAX  # validity is IN the sort word
    seg, n_groups = segments_from_sorted([h_s], valid_s)
    overflow = n_groups > group_capacity
    nseg = group_capacity + 1
    seg = torch.clamp(seg, max=nseg - 1)
    ctx = make_segctx(seg, nseg)

    # exact-grouping check: equal primary hash but different secondary hash
    # anywhere inside a cluster => collision => overflow (salted retry)
    overflow = overflow | torch.any(_shifted_eq(h_s) & _shifted_ne(hv_s) & _pair_valid(valid_s))

    # earliest original row per group (deterministic oracle parity)
    group_rep_full, _ = _first_match_idx(valid_s, perm, ctx, n)
    group_rep = group_rep_full[:group_capacity]
    gids = torch.arange(group_capacity, dtype=torch.int32, device=dev)
    group_valid = gids < n_groups

    sorted_cache: dict = {}

    def resort(a: CompVal) -> CompVal:
        key = (id(a.value), id(a.null))
        if key not in sorted_cache:
            sorted_cache[key] = CompVal(a.value[perm], a.null[perm], a.ft)
        return sorted_cache[key]

    distinct = [_is_distinct_special(desc, arg_vals, merge) for desc, arg_vals in aggs]
    fn = _agg_states_merge if merge else _agg_states_raw

    # dry pass records every seg_sum request; resolve() batches them into
    # one [A, N] cumsum; the replay pass below gets the real results
    ctx.sums = SumBatch(ctx)
    for (desc, arg_vals), dis in zip(aggs, distinct):
        if dis or _needs_gather_state(desc, arg_vals):
            continue
        fn(desc, [resort(a) for a in arg_vals], valid_s, ctx)
    ctx.sums.resolve()

    states = []
    for (desc, arg_vals), dis in zip(aggs, distinct):
        if dis:
            st, coll_flag = _distinct_states(desc, arg_vals, row_valid, hp, nseg, group_capacity)
            overflow = overflow | coll_flag
        else:
            av_s = [resort(a) for a in arg_vals]
            if _needs_gather_state(desc, arg_vals):
                st = _gather_state_sorted(desc, av_s, valid_s, ctx, perm, n, merge)
                states.append(GatherState(st.idx[:group_capacity], st.has[:group_capacity] & group_valid))
                continue
            st = fn(desc, av_s, valid_s, ctx)
        states.append([(v[:group_capacity], nl[:group_capacity] | ~group_valid) for v, nl in st])
    ctx.sums = None

    # groups come out hash-ordered; reorder by earliest contributing row so
    # the output order matches the oracle's first-encounter insertion order
    order = torch.argsort(torch.where(group_valid, group_rep, n), stable=True)
    group_rep = group_rep[order]
    out_states: list = []
    for st in states:
        if isinstance(st, GatherState):
            out_states.append(GatherState(st.idx[order], st.has[order]))
        else:
            out_states.append([(v[order], nl[order]) for v, nl in st])
    return GroupAggResult(group_rep, group_valid, torch.clamp(n_groups, max=group_capacity), overflow,
                          out_states, need=n_groups.to(torch.int64))


def scalar_aggregate(aggs: list, row_valid: torch.Tensor, merge: bool = False, salt: int = 1):
    """Aggregation without GROUP BY: always exactly one output row.

    One segment spanning the batch. States come back [1]-shaped; first_row
    and string min/max come back as a GatherState. Returns (states,
    overflow): overflow only from DISTINCT arg-hash collisions, cleared by
    the salted retry."""
    n = row_valid.shape[0]
    dev = row_valid.device
    ctx = SegCtx(
        seg=torch.zeros(n, dtype=torch.int32, device=dev),
        nseg=1,
        starts=torch.zeros(1, dtype=torch.int32, device=dev),
        ends=torch.full((1,), n - 1, dtype=torch.int32, device=dev),
        counts=torch.full((1,), n, dtype=torch.int64, device=dev),
    )
    perm = torch.arange(n, dtype=torch.int32, device=dev)
    hp = torch.where(row_valid, 0, I64_MAX)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    states = []
    for desc, arg_vals in aggs:
        if _is_distinct_special(desc, arg_vals, merge):
            st, coll_flag = _distinct_states(desc, arg_vals, row_valid, hp, 2, salt)
            overflow = overflow | coll_flag
            states.append([(v[:1], nl[:1]) for v, nl in st])
        elif _needs_gather_state(desc, arg_vals):
            st = _gather_state_sorted(desc, arg_vals, row_valid, ctx, perm, n, merge)
            states.append(GatherState(st.idx[:1], st.has[:1]))
        else:
            fn = _agg_states_merge if merge else _agg_states_raw
            states.append(fn(desc, arg_vals, row_valid, ctx))
    return states, overflow
