"""Radix-partitioned hash join (port of tidb_tpu/ops/radix_join.py, the
unique-build half).

Both sides partition by radix bits of the salted key hash into P
independent sub-joins, each against a fixed-capacity build table:

  1. partition ids from the key hash's low bits (ops/seg.py hash_words,
     salted by the join-capacity rung so a ladder retry re-shuffles a
     pathological clustering); unusable rows pin to P and sort last;
  2. placement by one stable sort of the partition ids per side: the
     sorted order is partition-major, so the [P, cap] tables are
     clipped-window gathers;
  3. the per-partition probe, routed by shape alone (probe_strategy): the
     CUDA kernel of ops/join_probe.py ("kernel", its plain version on the
     CPU) where the TPU kernel's shape gate passes, else a binary search of
     the sorted build side per probe ("search");
  4. a skew escape hatch: a partition whose build side outgrows part_cap
     or whose probe side outgrows probe_cap leaves the tables, and its rows
     are compacted into fixed escape buffers that the general sorted-merge
     probe (ops/join.py merge_lo_hi) joins at esc_cap size; escape
     overflow raises the join-overflow flag with a NEED hint so the retry
     driver re-dispatches the rung that clears it.

Only the single-word int-class equi-join rides this path (inner /
left_outer / semi / anti), and only when the probe side dominates (build
* 8 <= probe capacity). Under a planner-proven unique build the contract
is verified at run time: a match fan-out > 1 raises overflow. NULL keys
never match.

A NON-unique build (build_unique=False: the exchange join's shape,
mpp/exchange_op.py local_partition_join) takes the prefix-sum output
expansion of ops/join.py's general path: per probe row a match count,
cumsum offsets, and for each static output slot its (probe row, nth
match). The "search" mode counts with sorted-build extents
(_expand_search); the "kernel" mode counts over the partitioned tables
with a dense broadcast-compare in plain torch (_expand_partitioned, the
JAX package's "dense" form): the probe kernel reduces each probe to its
FIRST match, so it never serves fan-out. The JAX package's TPU-only
"dense" first-match probe is not ported.
"""

from __future__ import annotations

import torch

from ..expr.compile import CompVal
from .join import JoinResult, _key_matrix, merge_lo_hi
from .join_probe import probe_kernel_eligible, probe_tables
from .keys import lexsort
from .seg import I64_MAX, hash_words, merge_searchsorted

# plan knobs (static; every program is keyed by the derived plan via its
# capacities and join-capacity rung)
MAX_PARTS = 1 << 16
PART_CAP_MIN = 128
PROBE_CAP_MIN = 8
ESC_CAP_MIN = 1024
ESC_DIV = 16          # esc_cap = join_capacity // ESC_DIV (rung-scaled)
BUILD_RATIO = 8       # eligible when nb_cap * BUILD_RATIO <= np_cap


def _pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def radix_plan(nb_cap: int, np_cap: int, join_capacity: int):
    """(n_parts, part_cap, probe_cap, esc_cap) from the batch capacities
    and the join-capacity rung, or None when the shape is build-heavy (the
    monolithic kernel takes it)."""
    if nb_cap * BUILD_RATIO > np_cap:
        return None
    # ~32 build rows per partition (4x slack under PART_CAP_MIN), bounded
    # so the probe table keeps >= 8 slots per partition
    p_hi = min(MAX_PARTS, max(_pow2(np_cap // PROBE_CAP_MIN + 1) // 2, 2))
    n_parts = min(max(_pow2(max(nb_cap, 1) // 32), 2), p_hi)
    part_cap = max(PART_CAP_MIN, _pow2(-(-4 * nb_cap // n_parts)))
    probe_cap = max(PROBE_CAP_MIN, _pow2(-(-2 * np_cap // n_parts)))
    esc_cap = min(_pow2(max(nb_cap, np_cap)), max(ESC_CAP_MIN, join_capacity // ESC_DIV))
    return n_parts, part_cap, probe_cap, esc_cap


def _partition(pid, n_parts: int, cap: int, n: int):
    """Cluster rows by partition id with one stable sort; returns
    (tbl_idx [P, cap] int32 row indices, in_part mask, count [P] int32,
    order_pid, order_idx int32, start [P+1] int32). Rows with pid ==
    n_parts (unusable) sort last and never enter a table."""
    dev = pid.device
    order_pid, order_idx = torch.sort(pid, stable=True)
    order_idx = order_idx.to(torch.int32)
    bounds = torch.arange(n_parts + 1, dtype=torch.int32, device=dev)
    start = torch.searchsorted(order_pid.contiguous(), bounds).to(torch.int32)
    count = start[1:] - start[:-1]
    lanes = torch.arange(cap, dtype=torch.int32, device=dev)
    rows = start[:-1, None] + lanes[None, :]
    in_part = lanes[None, :] < count[:, None]
    tbl_idx = order_idx[torch.clamp(rows, 0, n - 1).to(torch.int64)]
    return tbl_idx, in_part, count, order_pid, order_idx, start


def _escape_rows(order_idx, start, count, esc_part, n_parts: int, esc_cap: int, n: int):
    """Compact the rows of escaped partitions (contiguous runs of the
    partition-sorted order) into a fixed [esc_cap] buffer; buffer slot k
    maps back through a search over the P+1 escape offsets. Returns
    (buf_idx int32 original-row indices, slot_ok, n_esc int32)."""
    dev = order_idx.device
    esc_cnt = torch.where(esc_part, count, 0).to(torch.int32)
    off = esc_cnt.new_zeros(n_parts + 1)  # esc_cnt's region axis under vmap
    off[1:] = torch.cumsum(esc_cnt, 0, dtype=torch.int32)
    n_esc = off[-1]
    k = torch.arange(esc_cap, dtype=torch.int32, device=dev)
    p_of = torch.clamp(torch.searchsorted(off, k, side="right").to(torch.int32) - 1, 0, n_parts - 1)
    p_of = p_of.to(torch.int64)
    pos = start[p_of] + (k - off[p_of])
    slot_ok = k < n_esc
    buf_idx = order_idx[torch.clamp(pos, 0, n - 1).to(torch.int64)]
    return buf_idx, slot_ok, n_esc


def probe_strategy(n_parts: int, part_cap: int, probe_cap: int) -> str:
    """The probe strategy, decided by shape alone (never by device):
    "kernel" where the probe kernel's gate passes (the CUDA kernel on a
    card, its plain version on the CPU), else "search"."""
    return "kernel" if probe_kernel_eligible(n_parts, part_cap, probe_cap) else "search"


def _probe_search(bw, b_usable, pw, p_usable, nb: int):
    """Sort the small build side once, then binary-search every probe key
    against it; probe rows stay in place. Returns (build_idx int32 [np]
    (-1 = none), dup flag)."""
    bk_m = torch.where(b_usable, bw, I64_MAX)
    perm = lexsort([bk_m], extra_key=(~b_usable).to(torch.int64))
    sw = bk_m[perm].contiguous()
    nb_usable = b_usable.sum().to(torch.int32)
    pwc = pw.contiguous()
    lo = torch.searchsorted(sw, pwc, side="left").to(torch.int32)
    hi = torch.searchsorted(sw, pwc, side="right").to(torch.int32)
    hi = torch.minimum(hi, nb_usable)  # the unusable tail never matches
    matched = (hi > lo) & p_usable
    dup = torch.any(((hi - lo) > 1) & matched)
    build_idx = torch.where(matched, perm[torch.clamp(lo, 0, nb - 1).to(torch.int64)].to(torch.int32), -1)
    return build_idx, dup


def _radix_tables(bw, b_usable, pw, p_usable, plan: tuple, join_capacity: int):
    """Radix-cluster both sides into the per-partition tables. Returns
    (b_tbl_idx, b_count, b_oidx, b_start, p_count, p_opid, p_oidx, p_start,
    esc_part, b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok); the last four
    are the probe kernel's inputs."""
    n_parts, part_cap, probe_cap, _esc_cap = plan
    nb, np_ = bw.shape[0], pw.shape[0]
    P = n_parts
    # partition ids from the salted hash; unusable rows pin to P (sort last)
    salt = join_capacity
    b_pid = torch.where(b_usable, (hash_words([bw], salt) & (P - 1)).to(torch.int32), P)
    p_pid = torch.where(p_usable, (hash_words([pw], salt) & (P - 1)).to(torch.int32), P)
    b_tbl_idx, b_in, b_count, _b_opid, b_oidx, b_start = _partition(b_pid, P, part_cap, nb)
    p_tbl_idx, p_in, p_count, p_opid, p_oidx, p_start = _partition(p_pid, P, probe_cap, np_)
    # the skew escape hatch: an over-full partition (either side) leaves
    # the tables and rides the general probe
    esc_part = (b_count > part_cap) | (p_count > probe_cap)
    b_slot_ok = b_in & ~esc_part[:, None]
    p_slot_ok = p_in & ~esc_part[:, None]
    b_key_tbl = bw[b_tbl_idx.to(torch.int64)]
    p_key_tbl = pw[p_tbl_idx.to(torch.int64)]
    return (b_tbl_idx, b_count, b_oidx, b_start, p_count, p_opid, p_oidx, p_start,
            esc_part, b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok)


def probe_kernel_inputs(bw, b_usable, pw, p_usable, plan: tuple, join_capacity: int):
    """The probe kernel's inputs as the partitioned probe builds them:
    (b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok)."""
    return _radix_tables(bw, b_usable, pw, p_usable, plan, join_capacity)[-4:]


def _probe_partitioned(bw, b_usable, pw, p_usable, plan: tuple, join_capacity: int):
    """The partitioned-table probe: radix-cluster both sides, probe each
    partition against its fixed-capacity build table (ops/join_probe.py),
    and route over-full partitions through the escape hatch. Returns
    (build_idx [np] original order, matched, dup, esc_over, need, escapes);
    `dup` (fan-out > 1 seen) is reported apart from the escape-overflow
    flag: it only violates the unique-build contract."""
    n_parts, part_cap, probe_cap, esc_cap = plan
    nb, np_ = bw.shape[0], pw.shape[0]
    P = n_parts
    dev = bw.device
    (b_tbl_idx, b_count, b_oidx, b_start, p_count, p_opid, p_oidx, p_start,
     esc_part, b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok) = _radix_tables(bw, b_usable, pw, p_usable, plan, join_capacity)
    bpos, dup = probe_tables(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok)
    b_orig_tbl = torch.gather(b_tbl_idx, 1, torch.clamp(bpos, 0, part_cap - 1).to(torch.int64))
    matched_tbl = (bpos < part_cap) & p_slot_ok

    # ---- escape sub-join: general sorted-merge probe at esc_cap size ----
    b_buf, b_ok_e, nbe = _escape_rows(b_oidx, b_start, b_count, esc_part, P, esc_cap, nb)
    p_buf, p_ok_e, npe = _escape_rows(p_oidx, p_start, p_count, esc_part, P, esc_cap, np_)
    bke = torch.where(b_ok_e, bw[b_buf.to(torch.int64)], I64_MAX)
    perm = lexsort([bke], extra_key=(~b_ok_e).to(torch.int64))
    sw = bke[perm]
    usable_sorted = torch.arange(esc_cap, dtype=torch.int32, device=dev) < torch.clamp(nbe, max=esc_cap)
    pke = pw[p_buf.to(torch.int64)]
    lo, hi = merge_lo_hi(sw, usable_sorted, pke)
    m_e = (hi > lo) & p_ok_e
    dup_e = torch.any(((hi - lo) > 1) & m_e)
    b_orig_e = b_buf[perm[torch.clamp(lo, 0, esc_cap - 1).to(torch.int64)]]

    esc_over = (nbe > esc_cap) | (npe > esc_cap)
    escapes = (torch.clamp(nbe, max=esc_cap) + torch.clamp(npe, max=esc_cap)).to(torch.int64)
    # the rung that sizes esc_cap past the observed escape count
    need = torch.where(esc_over, torch.maximum(nbe, npe).to(torch.int64) * ESC_DIV, 0)

    # ---- back to original probe order -----------------------------------
    # the row at sorted position s sits in table slot (pid, s - start[pid])
    # unless its partition escaped
    s = torch.arange(np_, dtype=torch.int32, device=dev)
    pid_c = torch.clamp(p_opid, 0, P - 1).to(torch.int64)
    r = s - p_start[pid_c]
    in_tbl = (p_opid < P) & (r < probe_cap) & ~esc_part[pid_c]
    flat = pid_c * probe_cap + torch.clamp(r, 0, probe_cap - 1).to(torch.int64)
    res_sorted = torch.where(in_tbl & matched_tbl.reshape(-1)[flat], b_orig_tbl.reshape(-1)[flat], -1)
    # inverse permutation restores the probe-identity layout
    build_idx = res_sorted.new_empty(np_, dtype=torch.int32)  # res_sorted's region axis under vmap
    build_idx[p_oidx.to(torch.int64)] = res_sorted.to(torch.int32)
    # escape overlay: distinct targets; unused slots write a spare slot past
    # the end that is cut off (no boolean-mask index: a fixed shape, so the
    # region-batched program maps it)
    esc_val = torch.where(m_e, b_orig_e, -1).to(torch.int32)
    spill = torch.cat([build_idx, build_idx[:1]])
    spill[torch.where(p_ok_e, p_buf, np_).to(torch.int64)] = esc_val
    build_idx = spill[:np_]

    matched = build_idx >= 0
    return build_idx, matched, dup | dup_e, esc_over, need, escapes


def _expand_counts(counts_match, get_kth, probe_valid, out_capacity: int, join_type: str, base_overflow,
                   base_need):
    """The prefix-sum output expansion both non-unique modes share (the
    general path of ops/join.py): match counts -> cumsum offsets -> one
    search gives each static output slot its (probe row, nth match), and
    `get_kth` recovers the build row."""
    np_ = probe_valid.shape[0]
    dev = probe_valid.device
    counts = counts_match.to(torch.int64)
    if join_type == "left_outer":
        counts = torch.where(probe_valid, torch.clamp(counts, min=1), 0)
    offsets = torch.cumsum(counts, 0) - counts  # start slot per probe row
    total = counts.sum()
    overflow = base_overflow | (total > out_capacity)
    # out-capacity need: exact; the escape-buffer need folds in
    need = torch.maximum(torch.where(total > out_capacity, total, 0), base_need)
    slot = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    probe_of = merge_searchsorted(offsets + counts, slot, side="right").to(torch.int64)
    probe_of = torch.clamp(probe_of, max=np_ - 1)
    nth = slot - offsets[probe_of]
    build_idx = get_kth(probe_of, nth)
    out_valid = slot < total
    build_null = ~(counts_match[probe_of] > 0)  # only under left_outer fill
    build_idx = torch.where(build_null, -1, build_idx)
    return JoinResult(
        probe_idx=probe_of.to(torch.int32),
        build_idx=build_idx,
        build_null=build_null & out_valid,
        out_valid=out_valid,
        n_out=total,
        overflow=overflow,
        need=need,
    )


def _expand_search(bw, b_usable, pw, p_usable, probe_valid, join_type: str, out_capacity: int):
    """Non-unique fan-out by sorted-build extents: hi - lo is the match
    count of a probe row, and its k-th match is the k-th row of its run in
    the stable sort (build rows in original order)."""
    nb = bw.shape[0]
    dev = bw.device
    bk_m = torch.where(b_usable, bw, I64_MAX)
    perm = lexsort([bk_m], extra_key=(~b_usable).to(torch.int64))
    sw = bk_m[perm].contiguous()
    nb_usable = b_usable.sum().to(torch.int32)
    pwc = pw.contiguous()
    lo = torch.searchsorted(sw, pwc, side="left").to(torch.int32)
    hi = torch.minimum(torch.searchsorted(sw, pwc, side="right").to(torch.int32), nb_usable)
    counts_match = torch.where(p_usable, torch.clamp(hi - lo, min=0), 0)

    def get_kth(probe_of, nth):
        pos = torch.clamp(lo[probe_of].to(torch.int64) + nth, 0, nb - 1)
        return perm[pos].to(torch.int32)

    return _expand_counts(counts_match, get_kth, probe_valid, out_capacity, join_type,
                          torch.zeros((), dtype=torch.bool, device=dev),
                          torch.zeros((), dtype=torch.int64, device=dev))


def _expand_partitioned(bw, b_usable, pw, p_usable, probe_valid, plan: tuple, join_capacity: int,
                        join_type: str, out_capacity: int):
    """Non-unique fan-out over the partitioned tables: the dense
    broadcast-compare's row sum is a probe slot's match count, and its
    k-th matching build slot falls out of a cumsum over its compare row.
    Escaped partitions count and expand through the sorted-merge extents
    at esc_cap size, as the first-match overlay does."""
    n_parts, part_cap, probe_cap, esc_cap = plan
    nb, np_ = bw.shape[0], pw.shape[0]
    P = n_parts
    dev = bw.device
    salt = join_capacity
    b_pid = torch.where(b_usable, (hash_words([bw], salt) & (P - 1)).to(torch.int32), P)
    p_pid = torch.where(p_usable, (hash_words([pw], salt) & (P - 1)).to(torch.int32), P)
    b_tbl_idx, b_in, b_count, _b_opid, b_oidx, b_start = _partition(b_pid, P, part_cap, nb)
    p_tbl_idx, p_in, p_count, _p_opid, p_oidx, p_start = _partition(p_pid, P, probe_cap, np_)
    esc_part = (b_count > part_cap) | (p_count > probe_cap)
    b_slot_ok = b_in & ~esc_part[:, None]
    p_slot_ok = p_in & ~esc_part[:, None]
    b_key_tbl = bw[b_tbl_idx.to(torch.int64)]
    p_key_tbl = pw[p_tbl_idx.to(torch.int64)]
    # every match, not the first: the dense compare
    eq = (p_key_tbl[:, :, None] == b_key_tbl[:, None, :]) & b_slot_ok[:, None, :] & p_slot_ok[:, :, None]
    nmatch_tbl = eq.sum(dim=-1, dtype=torch.int32)  # [P, probe_cap]

    # ---- escape sub-join extents (general sorted-merge at esc_cap) ------
    b_buf, b_ok_e, nbe = _escape_rows(b_oidx, b_start, b_count, esc_part, P, esc_cap, nb)
    p_buf, p_ok_e, npe = _escape_rows(p_oidx, p_start, p_count, esc_part, P, esc_cap, np_)
    bke = torch.where(b_ok_e, bw[b_buf.to(torch.int64)], I64_MAX)
    perm_e = lexsort([bke], extra_key=(~b_ok_e).to(torch.int64))
    swe = bke[perm_e]
    usable_sorted = torch.arange(esc_cap, dtype=torch.int32, device=dev) < torch.clamp(nbe, max=esc_cap)
    pke = pw[p_buf.to(torch.int64)]
    lo_e, hi_e = merge_lo_hi(swe, usable_sorted, pke)
    cnt_e = torch.where(p_ok_e, torch.clamp(hi_e - lo_e, min=0), 0)
    esc_over = (nbe > esc_cap) | (npe > esc_cap)
    escapes = (torch.clamp(nbe, max=esc_cap) + torch.clamp(npe, max=esc_cap)).to(torch.int64)
    base_need = torch.where(esc_over, torch.maximum(nbe, npe).to(torch.int64) * ESC_DIV, 0)

    # ---- each original probe row's table slot or escape slot ------------
    s_pos = torch.empty(np_, dtype=torch.int32, device=dev)
    s_pos[p_oidx.to(torch.int64)] = torch.arange(np_, dtype=torch.int32, device=dev)
    pid_c = torch.clamp(p_pid, 0, P - 1).to(torch.int64)
    r = s_pos - p_start[pid_c]  # slot within the partition's sorted run
    escaped = esc_part[pid_c] & (p_pid < P)
    in_tbl = (p_pid < P) & ~escaped & (r < probe_cap)
    flat = pid_c * probe_cap + torch.clamp(r, 0, probe_cap - 1).to(torch.int64)
    cnt_tbl_i = nmatch_tbl.reshape(-1)[flat]
    # the row's escape-buffer position (the offsets _escape_rows packed
    # by); rows past esc_cap count 0, esc_over already discards them
    esc_cnt_p = torch.where(esc_part, p_count, 0).to(torch.int32)
    p_off = torch.cat([esc_cnt_p.new_zeros(1), torch.cumsum(esc_cnt_p, 0, dtype=torch.int32)])[:-1]
    e_i = p_off[pid_c] + r
    e_ok = escaped & (e_i >= 0) & (e_i < esc_cap)
    e_c = torch.clamp(e_i, 0, esc_cap - 1).to(torch.int64)
    counts_match = torch.where(in_tbl, cnt_tbl_i, torch.where(e_ok, cnt_e[e_c], 0))
    slots = torch.arange(part_cap, dtype=torch.int32, device=dev)

    def get_kth(probe_of, nth):
        pidj = pid_c[probe_of]
        rj = torch.clamp(r[probe_of], 0, probe_cap - 1).to(torch.int64)
        eq_rows = eq[pidj, rj]  # [out_cap, part_cap]
        cum = torch.cumsum(eq_rows.to(torch.int32), dim=-1)
        slotv = torch.where(eq_rows & (cum == (nth[:, None] + 1)), slots[None, :], part_cap)
        bslot = torch.clamp(slotv.amin(dim=-1), 0, part_cap - 1).to(torch.int64)
        idx_tbl = b_tbl_idx[pidj, bslot].to(torch.int32)
        pos_e = torch.clamp(lo_e[e_c[probe_of]].to(torch.int64) + nth, 0, esc_cap - 1)
        idx_esc = b_buf[perm_e[pos_e]].to(torch.int32)
        return torch.where(in_tbl[probe_of], idx_tbl, idx_esc)

    return _expand_counts(counts_match, get_kth, probe_valid, out_capacity, join_type, esc_over,
                          base_need), escapes


def radix_hash_join(
    build_keys: list[CompVal],
    probe_keys: list[CompVal],
    build_valid,
    probe_valid,
    join_type: str,
    join_capacity: int,
    plan: tuple,
    strategy: str | None = None,
    build_unique: bool = True,
    out_capacity: int | None = None,
):
    """Equi-join over the radix-partitioned tables.

    build_unique=True (the planner-proven shape): the output contract of
    ops/join.py's unique-build branch (probe_identity layout: output slot
    j IS probe row j). build_unique=False (the exchange join's shape):
    inner / left_outer take the prefix-sum expansion, the contract of
    ops/join.py's general path, in an `out_capacity` table (required);
    semi / anti take the first-match probe, where fan-out is expected.
    `strategy` overrides probe_strategy's choice. Returns
    (JoinResult, escapes int64): escapes is the escaped-row count the
    attribution reports; the JoinResult's `need` carries the
    join-capacity rung that clears an escape overflow (0 = growth will not
    help: a violated unique-build contract, and the driver drops the
    hint)."""
    n_parts, part_cap, probe_cap, _esc_cap = plan
    bkeys, b_usable = _key_matrix(build_keys, build_valid)
    pkeys, p_usable = _key_matrix(probe_keys, probe_valid)
    if len(bkeys) != 1 or len(pkeys) != 1:
        raise ValueError("radix join needs single-word keys")
    bw, pw = bkeys[0], pkeys[0]
    if bw.is_floating_point():
        raise ValueError("radix join is int-class only")
    dev = bw.device
    nb, np_ = bw.shape[0], pw.shape[0]
    mode = strategy or probe_strategy(n_parts, part_cap, probe_cap)

    if not build_unique and join_type in ("inner", "left_outer"):
        if out_capacity is None:
            raise ValueError("a non-unique radix join needs out_capacity")
        if mode == "search":
            return (_expand_search(bw, b_usable, pw, p_usable, probe_valid, join_type, out_capacity),
                    torch.zeros((), dtype=torch.int64, device=dev))
        return _expand_partitioned(bw, b_usable, pw, p_usable, probe_valid, plan, join_capacity, join_type,
                                   out_capacity)

    if mode == "search":
        build_idx, dup = _probe_search(bw, b_usable, pw, p_usable, nb)
        matched = build_idx >= 0
        hard_over = torch.zeros((), dtype=torch.bool, device=dev)
        need = torch.zeros((), dtype=torch.int64, device=dev)
        escapes = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        build_idx, matched, dup, hard_over, need, escapes = _probe_partitioned(
            bw, b_usable, pw, p_usable, plan, join_capacity)
    # a fan-out > 1 violates the unique-build contract; under a non-unique
    # build (semi / anti here) it is expected
    overflow = (hard_over | dup) if build_unique else hard_over
    iota = torch.arange(np_, dtype=torch.int32, device=dev)

    if join_type in ("semi", "anti"):
        keep = probe_valid & (matched if join_type == "semi" else ~matched)
        return JoinResult(
            probe_idx=iota,
            build_idx=torch.full((np_,), -1, dtype=torch.int32, device=dev),
            build_null=torch.ones(np_, dtype=torch.bool, device=dev),
            out_valid=keep, n_out=keep.sum(), overflow=overflow, need=need,
        ), escapes

    out_valid = (probe_valid & matched) if join_type == "inner" else probe_valid
    build_null = ~matched
    return JoinResult(
        probe_idx=iota,
        build_idx=build_idx,
        build_null=build_null & out_valid,
        out_valid=out_valid,
        n_out=out_valid.sum(),
        overflow=overflow,
        need=need,
        probe_identity=True,
    ), escapes
