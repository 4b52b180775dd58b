"""Equi hash join (port of tidb_tpu/ops/join.py).

Sort + binary search: the build side is sorted by its join key, and each
probe row's matching run [lo, hi) comes from a lower / upper bound search.
Single-word keys (ints, dates, decimals) sort on the key itself, which is
exact. Multi-word keys (strings, composites) mix into ONE salted 63-bit
hash word (ops/seg.py), and exactness comes back through two word-level
checks — every build run must be internally uniform, and every hash-hit
probe must word-match its run head — whose failure (a hash collision)
raises the overflow flag; the retry's larger capacity re-salts the hash.

Output expansion (dynamic fan-out) lands in a static `out_capacity` table:
a prefix sum over match counts assigns each output slot a (probe,
nth-match) pair, recovered with one more search. The unique-build layout
(planner-proven one match per probe) skips the expansion: output slot j is
probe row j, and a fan-out > 1 raises overflow. NULL keys never match.

Every join-overflow retry that drops the unique / radix hints lands here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..expr.compile import CompVal
from .keys import lexsort, sort_key_arrays
from .seg import I64_MAX, MAX63, hash_words, merge_searchsorted, run_head_pos, sort_by_word


@dataclass
class JoinResult:
    """Index-pair form: gather output columns from both sides.

    build_idx / probe_idx: int32 [out_capacity] row indices into the
    original batches; for outer-join null-extended rows, build_idx is -1
    and build_null True. probe_identity=True: probe_idx is the identity
    (unique-build layout) and the builder skips the probe-side gathers.
    need: the join capacity that clears a pure out-capacity overflow, 0 when
    growth will not help (collision / violated unique-build hint), None when
    the kernel cannot tell."""

    probe_idx: torch.Tensor
    build_idx: torch.Tensor
    build_null: torch.Tensor
    out_valid: torch.Tensor
    n_out: torch.Tensor
    overflow: torch.Tensor
    probe_identity: bool = False
    need: torch.Tensor | None = None


def _i64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64)


def merge_lo_hi(sorted_hay, hay_counted, queries):
    """(lo, hi) int32 match extents of every query against the counted hay
    rows: lo = counted hay < query, hi = counted hay <= query, so lo..hi-1
    index the counted prefix of the hay order.

    hay_counted MUST occupy a prefix of the hay sort order (callers mask
    unusable rows to the top sentinel with an unusable-last tiebreak); the
    uncounted tail then never sits below a counted value, and clamping the
    plain searches at the counted count gives the extents."""
    n_counted = hay_counted.sum().to(torch.int32)
    lo = torch.minimum(merge_searchsorted(sorted_hay, queries, side="left"), n_counted)
    hi = torch.minimum(merge_searchsorted(sorted_hay, queries, side="right"), n_counted)
    return lo, hi


def _key_matrix(vals: list[CompVal], valid):
    """Normalized key arrays; rows with any NULL key are excluded via the
    returned `usable` mask (NULL never equi-matches)."""
    keys = []
    usable = valid
    for v in vals:
        usable = usable & ~v.null
        keys.extend(sort_key_arrays(v)[1:])  # drop the null-flag word
    return keys, usable


def hash_join(
    build_keys: list[CompVal],
    probe_keys: list[CompVal],
    build_valid,
    probe_valid,
    out_capacity: int,
    join_type: str = "inner",
    build_unique: bool = False,
) -> JoinResult:
    """join_type: inner | left_outer (probe side preserved) | semi | anti.

    build_unique: planner-proven one-match-per-probe; the output keeps the
    probe layout and the expansion is skipped. Runtime-verified: fan-out
    > 1 raises the overflow flag."""
    bkeys, b_usable = _key_matrix(build_keys, build_valid)
    pkeys, p_usable = _key_matrix(probe_keys, probe_valid)
    dev = probe_valid.device
    nb = build_valid.shape[0]
    np_ = probe_valid.shape[0]
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    nb_usable = b_usable.sum().to(torch.int32)

    if len(bkeys) == 1:
        # exact single-word path. Unusable build rows mask to +max with an
        # unusable-last tiebreak, so they occupy exactly the tail even
        # behind a legitimate +max key.
        bk, pk = bkeys[0], pkeys[0]
        top = float("inf") if bk.is_floating_point() else I64_MAX
        bk_m = torch.where(b_usable, bk, top)
        bperm = lexsort([bk_m], extra_key=_i64(~b_usable))
        sorted_word = bk_m[bperm]
        probe_word = pk
    else:
        # multi-word keys: one salted hash word per side; unusable rows pin
        # to the (odd, never-hashable) I64_MAX sentinel and sort last
        salt = out_capacity
        bh = torch.where(b_usable, hash_words(bkeys, salt) & MAX63, I64_MAX)
        ph = torch.where(p_usable, hash_words(pkeys, salt) & MAX63, I64_MAX)
        sorted_word, bperm = sort_by_word(bh)
        bperm = _i64(bperm)
        probe_word = ph

    usable_sorted = torch.arange(nb, dtype=torch.int32, device=dev) < nb_usable
    lo, hi = merge_lo_hi(sorted_word, usable_sorted, probe_word)
    lo_c = _i64(torch.clamp(lo, 0, nb - 1))
    matched = (hi > lo) & p_usable
    hi = torch.where(matched, hi, lo)

    if len(bkeys) > 1:
        # exactness check 1: every build hash run is internally uniform
        diffb = torch.ones(nb, dtype=torch.bool, device=dev)
        diffb[1:] = sorted_word[1:] != sorted_word[:-1]
        headb = _i64(run_head_pos(diffb))
        bcoll = torch.zeros(nb, dtype=torch.bool, device=dev)
        for w in bkeys:
            ws = w[bperm]
            bcoll = bcoll | (ws != ws[headb])
        overflow = overflow | torch.any(bcoll & b_usable[bperm])
        # exactness check 2: every hash-hit probe word-matches its run head
        head_idx = bperm[lo_c]
        pmism = torch.zeros(np_, dtype=torch.bool, device=dev)
        for bw, pw in zip(bkeys, pkeys):
            pmism = pmism | (bw[head_idx] != pw)
        overflow = overflow | torch.any(pmism & matched)

    counts = torch.where(p_usable, hi - lo, 0)
    matched = counts > 0
    iota = torch.arange(np_, dtype=torch.int32, device=dev)

    if join_type in ("semi", "anti"):
        keep = probe_valid & (matched if join_type == "semi" else ~matched)
        return JoinResult(
            probe_idx=iota,
            build_idx=torch.full((np_,), -1, dtype=torch.int32, device=dev),
            build_null=torch.ones(np_, dtype=torch.bool, device=dev),
            out_valid=keep,
            n_out=keep.sum(),
            overflow=overflow,
        )

    if build_unique and join_type in ("inner", "left_outer"):
        # one match per probe: output slot j IS probe row j; any run longer
        # than one build row flips overflow (the retry drops the hint)
        overflow = overflow | torch.any(counts > 1)
        build_idx = bperm[lo_c].to(torch.int32)
        out_valid = (probe_valid & matched) if join_type == "inner" else probe_valid
        build_null = ~matched
        build_idx = torch.where(build_null, -1, build_idx)
        return JoinResult(
            probe_idx=iota,
            build_idx=build_idx,
            build_null=build_null & out_valid,
            out_valid=out_valid,
            n_out=out_valid.sum(),
            overflow=overflow,
            probe_identity=True,
        )

    if join_type == "left_outer":
        counts = torch.where(probe_valid, torch.clamp(counts, min=1), 0)

    counts = _i64(counts)
    offsets = torch.cumsum(counts, 0) - counts  # start slot per probe row
    total = counts.sum()
    overflow = overflow | (total > out_capacity)
    # out-capacity need: exact; zero when the overflow came from a
    # collision check above
    need = torch.where(total > out_capacity, total, 0)

    slot = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    probe_of = _i64(merge_searchsorted(offsets + counts, slot, side="right"))
    probe_of = torch.clamp(probe_of, max=np_ - 1)
    nth = slot - offsets[probe_of]
    b_sorted_pos = torch.clamp(_i64(lo)[probe_of] + nth, 0, nb - 1)
    build_idx = bperm[b_sorted_pos].to(torch.int32)
    out_valid = slot < total
    real_match = p_usable[probe_of] & ((hi - lo)[probe_of] > 0)
    build_null = ~real_match  # only possible under left_outer fill
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
