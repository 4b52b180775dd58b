"""Fused sort-merge join + stream aggregation — the TPC-H Q3 shape (port
of tidb_tpu/ops/joinagg.py).

When a unique-build inner join feeds a GROUP BY on exactly the probe-side
join key, the join's merge sort already clusters rows by the group key, so
ONE sort (build and probe keys interleaved, the aggregate arguments riding
along) performs the probe AND the grouping; a stream-agg boundary scan
then runs on the merge order (join_stream_agg).

Matching mirrors ops/join.py's unique-build inner join: NULL keys never
match, a build fan-out > 1 raises the join-overflow flag (the driver
retries on the general kernel), group capacity overflow raises the group
flag. Output group order is the oracle's first-encounter order (earliest
contributing probe row), recovered by riding the original probe index
through the sort.

The packed fast path (packed_join_groupsum, membership_chain) takes
bounded-range int keys and sum/count/avg over int32-wide arguments: the
key and its side pack into one int32 word, pk = key << 1 | side, and one
stable sort by it clusters each key's hay (even) rows before its probe
(odd) rows. The post-sort passes are the CUDA kernels of ops/joinscan.py:
membership_chain always runs K3, and packed_join_groupsum runs K2 for at
most two value lanes (the JAX package's routing, with "a kernel exists"
always true here); wider lane counts take the torch scan branch below.
Keys or values outside the packed range raise the join-overflow flag, and
the retry lands on the general kernel.
"""

from __future__ import annotations

import torch

from ..expr.compile import CompVal
from ..types import Flag
from .aggregate import GatherState, _group_aggregate_stream
from .join import _key_matrix
from .joinscan import membership_segscan, postsort_segscan
from .keys import lexsort
from .seg import I64_MAX

# aggregate names the stream kernel evaluates without raw-byte payloads or
# the DISTINCT machinery
FUSABLE_AGGS = frozenset({
    "count", "sum", "avg", "min", "max", "first_row",
    "bit_and", "bit_or", "bit_xor",
    "stddev_pop", "stddev_samp", "var_pop", "var_samp",
})

I32_MAX = (1 << 31) - 1


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def join_stream_agg(
    build_keys: list[CompVal],
    probe_keys: list[CompVal],
    build_valid,
    probe_valid,
    aggs: list,
    group_capacity: int,
):
    """One-sort unique-build inner join + GROUP BY probe key.

    aggs: (AggDesc, [probe-row-order arg CompVals]); every arg is
    single-word (dim 1, no raw bytes) — the caller checks. Returns
    (GroupAggResult, sorted_arg_lists, group_out CompVal, join_overflow,
    join_rows); res.group_rep indexes the SORTED row space, aligned with
    sorted_arg_lists and group_out."""
    bw_l, b_usable = _key_matrix(build_keys, build_valid)
    pw_l, p_usable = _key_matrix(probe_keys, probe_valid)
    if len(bw_l) != 1 or len(pw_l) != 1:
        raise ValueError("joinagg needs single-word keys")
    bw, pw = bw_l[0], pw_l[0]
    dev = bw.device
    nb, np_ = bw.shape[0], pw.shape[0]
    n = nb + np_
    top = float("inf") if bw.is_floating_point() else I64_MAX
    vals = torch.cat([torch.where(b_usable, bw, top), torch.where(p_usable, pw, top)])
    # second sort key: build rows first within an equal-key run; the sort is
    # stable, so probe rows keep ascending original order inside a run
    side = torch.cat([torch.zeros(nb, dtype=torch.int8, device=dev),
                      torch.ones(np_, dtype=torch.int8, device=dev)])
    perm = lexsort([vals, side])
    sv, ss = vals[perm], side[perm]

    carried: dict = {}

    def carry(hay_fill, arr: torch.Tensor) -> torch.Tensor:
        key = (id(arr), repr(hay_fill))
        if key not in carried:
            full = torch.cat([torch.full((nb,), hay_fill, dtype=arr.dtype, device=dev), arr])
            carried[key] = full[perm]
        return carried[key]

    # original probe index (first-encounter output order + group_rep remap)
    orig_s = torch.cat([torch.full((nb,), n, dtype=torch.int32, device=dev),
                        torch.arange(np_, dtype=torch.int32, device=dev)])[perm]
    gkey_s = carry(0, probe_keys[0].value)
    usable_s = torch.cat([b_usable, p_usable])[perm]
    is_hay = ss == 0
    hay_u = is_hay & usable_s

    diff = torch.ones(n, dtype=torch.bool, device=dev)
    diff[1:] = sv[1:] != sv[:-1]
    hcnt = torch.cumsum(hay_u.to(torch.int32), 0, dtype=torch.int32)
    # usable-hay count strictly before my run (run-start propagation: the
    # marked values are nondecreasing, so a forward cummax broadcasts each
    # run head's value across its run)
    base = torch.cummax(torch.where(diff, hcnt - hay_u.to(torch.int32), -1), 0).values
    matched = (hcnt - base) > 0
    # the run's total usable hay: hcnt at the run END, propagated backward
    emark = torch.ones(n, dtype=torch.bool, device=dev)
    emark[:-1] = diff[1:]
    endv = _reverse_cummin(torch.where(emark, hcnt, I32_MAX))
    run_hay = endv - base
    contrib = ~is_hay & usable_s & matched
    # unique-build contract: any probe matching a >1-row build run
    join_overflow = torch.any((run_hay > 1) & contrib)

    key_ft = probe_keys[0].ft
    sorted_aggs = [
        (desc, [CompVal(carry(0, a.value), carry(True, a.null), a.ft) for a in avs])
        for desc, avs in aggs
    ]
    res = _group_aggregate_stream(
        [CompVal(sv, torch.zeros(n, dtype=torch.bool, device=dev), key_ft)],
        sorted_aggs, contrib, group_capacity, merge=False, compact=False,
    )

    # compact=False: group_valid holds the raw has-flags in key order. One
    # stable argsort on the earliest ORIGINAL probe index both compacts the
    # contributing groups to the front and restores first-encounter order.
    gc = res.group_rep.shape[0]
    rep = torch.clamp(res.group_rep.to(torch.int64), 0, n - 1)
    orig_first = torch.where(res.group_valid, orig_s[rep], n)
    order = torch.argsort(orig_first, stable=True)
    res.group_rep = res.group_rep[order]
    res.group_valid = torch.arange(gc, dtype=torch.int32, device=dev) < res.n_groups
    states2 = []
    for st in res.states:
        if isinstance(st, GatherState):
            states2.append(GatherState(st.idx[order], st.has[order]))
        else:
            states2.append([(v[order], nl[order]) for v, nl in st])
    res.states = states2

    group_out = CompVal(gkey_s, torch.zeros(n, dtype=torch.bool, device=dev), key_ft)
    join_rows = contrib.sum()
    return res, sorted_aggs, group_out, join_overflow, join_rows


# --------------------------------------------------------------------------
# packed-key fast path: bounded-range int keys, sum/count/avg only
# --------------------------------------------------------------------------

_PACKED_AGGS = frozenset({"sum", "count", "avg"})
_PK_RANGE = 1 << 30  # |key| must stay under 2^30 - 2 (plus the side bit)
# unusable-row sentinels: above every packed key; hay (even) and probe
# (odd, = _PIN_HAY | 1) pins keep is_hay = ~(pk & 1) true even for pins
_PIN_HAY = (1 << 31) - 4
_PIN_PROBE = (1 << 31) - 3
I32_SHIFT = 1 << 31  # non-negativity bias per addend (the scan branch)


def _pack_keys(both: torch.Tensor, ok: torch.Tensor, side: torch.Tensor):
    """key << 1 | side as int32; unusable rows pin above all real keys.
    Returns (pk, bad_lane): usable keys outside |key| < 2^30 - 2 pin AND
    mark the bad lane (-> the join-overflow retry). The range check stays
    in int64: abs() of INT32_MIN wraps in int32, which would let key -2^31
    pack to pk 0 and join as a phantom key 0."""
    k32 = both.to(torch.int32)  # truncates, as astype does
    in_range = (both == k32.to(torch.int64)) & (torch.abs(both) < (_PK_RANGE - 2))
    usable = ok & in_range
    pin = torch.where(side == 0, _PIN_HAY, _PIN_PROBE).to(torch.int32)
    pk = torch.where(usable, (k32 << 1) | side, pin)
    return pk, ok & ~in_range


def membership_lanes(outer_key, outer_ok, inner_key, inner_ok, payload):
    """K3's inputs as membership_chain builds them: (spk int32 sorted
    packed keys, spay int32 payload in the same order, wbad bool unsorted
    overflow bits)."""
    dev = outer_key.device
    no, nc = outer_key.shape[0], inner_key.shape[0]
    both = torch.cat([inner_key.to(torch.int64), outer_key.to(torch.int64)])
    ok = torch.cat([inner_ok, outer_ok])
    side = torch.cat([torch.zeros(nc, dtype=torch.int32, device=dev),
                      torch.ones(no, dtype=torch.int32, device=dev)])
    pk, kbad = _pack_keys(both, ok, side)
    pay32 = payload.to(torch.int32)
    wbad = (outer_ok & (payload.to(torch.int64) != pay32.to(torch.int64))) | kbad[nc:]
    wbad = torch.cat([kbad[:nc], wbad])
    pay = torch.cat([torch.zeros(nc, dtype=torch.int32, device=dev), pay32])
    spk, perm = torch.sort(pk, stable=True)
    return spk, pay[perm], wbad


def membership_chain(outer_key, outer_ok, inner_key, inner_ok, payload):
    """Unique-build membership join whose OUTPUT ORDER is free.

    Outer rows (e.g. orders) probe inner rows (e.g. customers) on an int
    key; returns (payload_out int64, ok_out, overflow) of length
    n_inner + n_outer, where ok_out marks outer rows that matched a usable
    inner row — in inner-key sort order, which packed_join_groupsum takes
    as it is. payload: per-outer-row int value carried through (the next
    join's key); values outside int32 overflow (-> general kernel)."""
    spk, spay, wbad = membership_lanes(outer_key, outer_ok, inner_key, inner_ok, payload)
    ok_out, overflow = membership_segscan(spk, wbad)
    return spay.to(torch.int64), ok_out, overflow


def packed_groupsum_lanes(hay_key, hay_ok, probe_key, probe_ok, aggs):
    """K2's inputs as packed_join_groupsum builds them: ONE stable sort by
    the packed key carries one int32 lane per distinct (value, null)
    argument combo (nulls and hay rows pre-masked to 0) and a uint8 word of
    null bits for the nullable ones; NOT NULL arguments (FieldType flag)
    skip the null machinery. Returns (spk, lanes_s, bad_all, nw_s | None,
    nn_bits per lane (-1 = NOT NULL), combo key per lane)."""
    dev = probe_key.value.device
    nb, np_ = hay_key.shape[0], probe_key.value.shape[0]
    n = nb + np_
    both = torch.cat([hay_key.to(torch.int64), probe_key.value.to(torch.int64)])
    ok = torch.cat([hay_ok, probe_ok])
    side = torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                      torch.ones(np_, dtype=torch.int32, device=dev)])
    pk, kbad = _pack_keys(both, ok, side)

    lanes: list = []
    combo_keys: list = []
    nullbit_of: dict = {}
    nbits: list = []
    width_bad = torch.zeros(np_, dtype=torch.bool, device=dev)
    for _desc, avs in aggs:
        for a in avs:
            key = (id(a.value), id(a.null))
            if key not in combo_keys:
                combo_keys.append(key)
                v32 = a.value.to(torch.int32)
                width_bad = width_bad | (probe_ok & ~a.null & (a.value.to(torch.int64) != v32.to(torch.int64)))
                vm = torch.where(a.null, 0, v32)
                lanes.append(torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev), vm]))
            if a.ft.flag & Flag.NotNull:
                nullbit_of[id(a.null)] = -1  # alias of the contributing count
            elif id(a.null) not in nullbit_of:
                nullbit_of[id(a.null)] = len(nbits)
                nbits.append(torch.cat([torch.ones(nb, dtype=torch.bool, device=dev), a.null]))
    if len(nbits) > 8:
        raise ValueError("more than 8 nullable argument lanes")
    spk, perm = torch.sort(pk, stable=True)
    lanes_s = [lane[perm] for lane in lanes]
    nw_s = None
    if nbits:
        nword = torch.zeros(n, dtype=torch.uint8, device=dev)
        for k, b in enumerate(nbits):
            nword = nword | (b.to(torch.uint8) << k)
        nw_s = nword[perm]
    bad_all = kbad | torch.cat([torch.zeros(nb, dtype=torch.bool, device=dev), width_bad])
    nn_bits = [nullbit_of[k[1]] for k in combo_keys]
    return spk, lanes_s, bad_all, nw_s, nn_bits, combo_keys


def _states(aggs, by_combo, cnt, zeros):
    """Per-agg partial states from per-combo (sum, non-null count)."""
    states = []
    for desc, avs in aggs:
        if desc.name == "count":
            if avs:
                _, nn = by_combo[(id(avs[0].value), id(avs[0].null))]
                states.append([(nn, zeros)])
            else:
                states.append([(cnt, zeros)])
            continue
        s, nn = by_combo[(id(avs[0].value), id(avs[0].null))]
        empty = nn == 0
        if desc.name == "sum":
            states.append([(s, empty)])
        else:  # avg: [count, sum] (expr/agg.py partial schema)
            states.append([(nn, zeros), (s, empty)])
    return states


def packed_join_groupsum(hay_key, hay_ok, probe_key, probe_ok, aggs):
    """Unique-build inner join + GROUP BY probe key (int class), aggregates
    restricted to sum/count/avg over int/decimal args that fit int32.

    aggs: [(AggDesc, [arg CompVals in probe row order])]. Returns
    (states per agg, group_valid, key_out CompVal, overflow, join_rows);
    everything is in the sorted [nb + np] row space under the group_valid
    mask. overflow (-> the join-overflow retry on the general kernel): key
    range over 2^30, duplicate usable hay keys, or an argument outside
    int32."""
    dev = probe_key.value.device
    n = hay_key.shape[0] + probe_key.value.shape[0]
    spk, lanes_s, bad_all, nw_s, nn_bits, combo_keys = packed_groupsum_lanes(
        hay_key, hay_ok, probe_key, probe_ok, aggs)
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)

    if len(lanes_s) <= 2:
        # K2: one segmented scan replaces every post-sort pass
        gv, cnt, key32, sums, nns, ovf, _jr = postsort_segscan(
            spk, lanes_s, bad_all, nw_s=nw_s, nn_bits=nn_bits)
        by_combo = {k: (sums[i], nns[i]) for i, k in enumerate(combo_keys)}
        key_out = CompVal(torch.where(gv, (key32 >> 1).to(torch.int64), 0), zeros, probe_key.ft)
        return _states(aggs, by_combo, cnt, zeros), gv, key_out, ovf, cnt

    # more than two lanes: the scan branch, in torch ops. Results sit at
    # each run's first probe row.
    is_hay = (spk & 1) == 0
    is_real = spk < _PIN_HAY
    prev_pk = torch.empty_like(spk)
    prev_pk[0:1] = -(1 << 31)  # below every real pk
    prev_pk[1:] = spk[:-1]
    dup_hay = is_hay & is_real & (spk == prev_pk)
    overflow = torch.any(dup_hay) | torch.any(bad_all)
    keydiff = (spk | 1) != (prev_pk | 1)
    # first probe row of its key run; matched iff the previous row is the
    # hay of MY key
    pbnd = ~is_hay & is_real & (keydiff | ((prev_pk & 1) == 0))
    matched = pbnd & (prev_pk == spk - 1)
    emark = torch.ones(n, dtype=torch.bool, device=dev)
    emark[:-1] = keydiff[1:]
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    end_pos = _reverse_cummin(torch.where(emark, iota, n))
    extent_cnt = (end_pos - iota + 1).to(torch.int64)  # rows self..run end

    def _extent(addends):
        """Sum of `addends` (int64, non-negative) over [self..run end]."""
        c = torch.cumsum(addends, 0)
        ev = _reverse_cummin(torch.where(emark, c, I64_MAX))
        return ev - (c - addends)

    by_combo = {}
    for i, key in enumerate(combo_keys):
        shifted = lanes_s[i].to(torch.int64) + I32_SHIFT
        s = _extent(shifted) - extent_cnt * I32_SHIFT
        if nn_bits[i] < 0:
            nn = extent_cnt
        else:
            nn = _extent((((nw_s.to(torch.int32) >> nn_bits[i]) & 1) == 0).to(torch.int64))
        by_combo[key] = (s, nn)

    group_valid = pbnd & matched
    key_out = CompVal(torch.where(is_real, (spk >> 1).to(torch.int64), 0), zeros, probe_key.ft)
    return _states(aggs, by_combo, extent_cnt, zeros), group_valid, key_out, overflow, extent_cnt
