"""Segment machinery for group-by (port of tidb_tpu/ops/seg.py).

  * group keys hash into ONE int64 word (splitmix64 over the normalized key
    words from ops/keys.py), so grouping costs one single-key sort no matter
    how many GROUP BY columns there are;
  * segment reductions over the hash-sorted rows are cumsum passes plus
    gathers at segment boundaries;
  * hash collisions (different keys, equal hash) are detected by the caller
    on an independently salted second hash and surface as the overflow flag;
  * the small-G route (DenseCtx) keeps the rows in their original order and
    reduces each group slot directly: no sort at all.

The hashes are bit-equal to the JAX package's: group order and overflow
decisions follow from them. torch's `>>` on int64 is arithmetic, so the
logical shift is the same mask form; int64 multiply wraps, as XLA's does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch

I64_MAX = 0x7FFFFFFFFFFFFFFF
# valid-hash space: top bit clear AND low bit clear — a masked hash is even,
# so it can never equal the (odd) I64_MAX invalid sentinel
MAX63 = 0x7FFFFFFFFFFFFFFE

_M64 = (1 << 64) - 1
# splitmix64 finalizer constants (public domain; two's-complement int64)
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_C2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def _to_i64(x: int) -> int:
    """Python int -> its two's-complement int64 value."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right on int64 (arithmetic shift + mask)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _lsr(x, 30)) * _C1
    x = (x ^ _lsr(x, 27)) * _C2
    return x ^ _lsr(x, 31)


def _mix64_int(x: int) -> int:
    """_mix64 on a Python int (the salt's seed word), bit-equal."""
    x &= _M64
    x = ((x ^ (x >> 30)) * (_C1 & _M64)) & _M64
    x = ((x ^ (x >> 27)) * (_C2 & _M64)) & _M64
    return _to_i64(x ^ (x >> 31))


def _word_as_i64(w: torch.Tensor) -> torch.Tensor:
    """Key word -> int64 bit material. Float words are bit-cast, with the
    two 32-bit halves swapped: the JAX package assembles the word from its
    int32 halves in little-endian order, and the hashes must stay
    bit-equal to it."""
    if w.is_floating_point():
        bits = w.to(torch.float64).contiguous().view(torch.int64)
        return (bits << 32) | _lsr(bits, 32)
    return w.to(torch.int64)


def hash_words(words: list[torch.Tensor], salt: int) -> torch.Tensor:
    """Mix a list of [N] key words into one well-distributed int64 [N]."""
    h0 = _mix64_int(_to_i64(salt * _GOLDEN + 1))
    if not words:
        return torch.tensor(h0, dtype=torch.int64)
    h = torch.full(words[0].shape, h0, dtype=torch.int64, device=words[0].device)
    for w in words:
        h = _mix64(h ^ _word_as_i64(w))
    return h


def group_hash(words: list[torch.Tensor], valid: torch.Tensor, salt: int) -> torch.Tensor:
    """Single sortable grouping word: valid rows get their 63-bit hash
    (top bit clear), invalid rows get I64_MAX — one sort then clusters
    equal keys and pushes invalid rows to the tail."""
    h = hash_words(words, salt) & MAX63
    return torch.where(valid, h, I64_MAX)


def sort_by_word(word: torch.Tensor):
    """(sorted_word, perm int32) via one stable sort: equal words keep
    input order, so segment heads are the earliest original rows."""
    sw, perm = torch.sort(word, stable=True)
    return sw, perm.to(torch.int32)


def merge_searchsorted(sorted_hay, queries, side: str = "left"):
    """searchsorted, int32: side='left' counts hay strictly less than each
    query, side='right' hay <= it (the JAX package computes the same
    positions with two plain sorts, its TPU-shaped form)."""
    dt = torch.promote_types(sorted_hay.dtype, queries.dtype)
    hay = sorted_hay.to(dt).contiguous()
    return torch.searchsorted(hay, queries.to(dt).contiguous(), side=side).to(torch.int32)


def sorted_positions(sorted_hay, queries, side: str = "left"):
    """searchsorted, int32 (the JAX package picks a binary search or its
    two-sort merge by query count; both give these positions)."""
    return merge_searchsorted(sorted_hay, queries, side)


def run_head_pos(diff: torch.Tensor) -> torch.Tensor:
    """Per-row position of the start of its equal-key run, given the
    boundary mask (diff[0] must be True): a cummax over marked positions."""
    pos = torch.arange(diff.shape[0], dtype=torch.int32, device=diff.device)
    return torch.cummax(torch.where(diff, pos, 0), 0).values


@dataclass
class SegCtx:
    """Boundary view of sorted segment ids.

    seg: int32 [N] ascending; nseg static; starts/ends int32 [nseg]
    (ends inclusive; empty segment has ends < starts); counts int64 [nseg].
    sums: optional SumBatch — when set, seg_sum calls are recorded and later
    resolved as ONE batched [A, N] cumsum instead of A separate ones.
    """

    seg: torch.Tensor
    nseg: int
    starts: torch.Tensor
    ends: torch.Tensor
    counts: torch.Tensor
    sums: object = None


class SumBatch:
    """Record/replay batcher for seg_sum.

    An aggregation needs many per-segment sums; stacked [A, N] they ride
    ONE cumsum launch. Protocol: a dry pass records every requested tensor
    (returning zeros), resolve() computes the batched result, then an
    identical replay pass receives the real tensors in the same order."""

    def __init__(self, ctx: "SegCtx"):
        self.ctx = ctx
        self.reqs: list = []
        self.results: list | None = None
        self.replay_i = 0

    def add(self, v: torch.Tensor) -> torch.Tensor:
        if self.results is None:
            self.reqs.append(v)
            return torch.zeros((self.ctx.nseg,), dtype=v.dtype, device=v.device)
        r = self.results[self.replay_i]
        self.replay_i += 1
        return r

    def resolve(self):
        ctx = self.ctx
        n = ctx.seg.shape[0]
        lo = torch.clamp(ctx.starts, 0, n - 1).to(torch.int64)
        hi = torch.clamp(ctx.ends, 0, n - 1).to(torch.int64)
        by_dtype: dict = {}
        for i, v in enumerate(self.reqs):
            by_dtype.setdefault(v.dtype, []).append((i, v))
        results: list = [None] * len(self.reqs)
        for dt, items in by_dtype.items():
            s = torch.stack([v for _, v in items], 0)  # [A, N]
            c = torch.cumsum(s, dim=1)
            out = c[:, hi] - c[:, lo] + s[:, lo]
            out = torch.where(ctx.counts[None, :] > 0, out, torch.zeros((), dtype=dt, device=out.device))
            for j, (i, _) in enumerate(items):
                results[i] = out[j]
        self.results = results
        self.replay_i = 0


def make_segctx(seg: torch.Tensor, nseg: int) -> SegCtx:
    """seg must be DENSE ascending (consecutive ids 0..K then constant):
    run k starts segment k. Small nseg: binary search; large: one stable
    stream-compaction sort of the boundary rows."""
    n = seg.shape[0]
    dev = seg.device
    if nseg <= 2048 or nseg < n // 64:
        q = torch.arange(nseg, dtype=seg.dtype, device=dev)
        starts = torch.searchsorted(seg.contiguous(), q).to(torch.int32)
    else:
        # out of place (a vmapped batch's region axis rides through cat)
        bnd = torch.cat([torch.ones_like(seg[:1], dtype=torch.bool), seg[1:] != seg[:-1]])
        pos = torch.argsort((~bnd).to(torch.int8), stable=True).to(torch.int32)
        n_runs = seg[-1].to(torch.int32) + 1
        if nseg > n:
            pos = torch.cat([pos, torch.full((nseg - n,), n, dtype=torch.int32, device=dev)])
        g = torch.arange(nseg, dtype=torch.int32, device=dev)
        starts = torch.where(g < n_runs, pos[:nseg], n).to(torch.int32)
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int32, device=dev)]) - 1
    counts = torch.clamp((ends - starts + 1).to(torch.int64), min=0)
    return SegCtx(seg, nseg, starts, ends, counts)


# ---------------------------------------------------------------------------
# the small-G route: rows in original order, one slot per group
# ---------------------------------------------------------------------------

# The most bytes any [rows, G] intermediate of the dense route may hold
# (8 bytes an element counted). XLA fuses the JAX package's [N, G] masks
# into their reductions; eager torch materialises them, so they are built
# a block of rows at a time. Under torch.func.vmap the region lanes share
# the budget (exec/builder.py _region_batched sets their count).
DENSE_BLOCK_BYTES = 256 << 20
# rows of one limb-product block: 8-bit limbs summed over at most 2^16
# rows stay below 2^24 (255 * 65536 < 2^24), exact in float32
_LIMB_ROWS = 1 << 16
_lanes = threading.local()


@contextmanager
def dense_lanes(lanes: int):
    """Region lanes that share DENSE_BLOCK_BYTES inside the block (this
    thread's calls only; the pool tier runs programs on several)."""
    prev = getattr(_lanes, "n", 1)
    _lanes.n = max(int(lanes), 1)
    try:
        yield
    finally:
        _lanes.n = prev


def dense_block_rows(nseg: int) -> int:
    """Rows of one [rows, nseg] block: a multiple of 256, at least 256."""
    rows = DENSE_BLOCK_BYTES // getattr(_lanes, "n", 1) // (8 * nseg)
    return max(rows // 256, 1) * 256


@dataclass
class DenseCtx:
    """Small-G group context over rows in ORIGINAL order (no sort at all).

    gid: int64 [N] each row's slot, from its primary hash's place in the
    distinct-hash table (ops/aggregate.py _group_aggregate_dense); rows
    whose hash is not a table entry and invalid rows fall in slots the
    states' masks or the overflow flag take care of. nseg = g_cap + 1.
    sums: a DenseSumBatch while armed."""

    gid: torch.Tensor
    nseg: int
    sums: object = None


class DenseSumBatch:
    """Record/replay batcher for DENSE seg_sum: every integer per-group sum
    rides one one-hot matmul (the protocol is SumBatch's).

    Exactness: int64 values split into eight 8-bit limbs; a float32 product
    of the one-hot against the limbs over at most 2^16 rows sums to below
    2^24, exact; the blocks' totals accumulate in int64, which wraps as the
    plain int64 sum would. The JAX package takes 4 x 16-bit limbs over
    256-row chunks at Precision.HIGHEST; 8-bit limbs are exact in every
    float32 matmul mode the card has (a TF32 input keeps 10 mantissa bits,
    bf16 8), so the product reads no global setting
    (torch.set_float32_matmul_precision) and sets none. The matmul runs
    where the JAX package's does (N % 256 == 0); other sums, and every
    float sum, are blocked masked reductions."""

    def __init__(self, ctx: "DenseCtx"):
        self.ctx = ctx
        self.reqs: list = []
        self.results: list | None = None
        self.replay_i = 0

    @property
    def recording(self) -> bool:
        return self.results is None

    def add(self, v: torch.Tensor) -> torch.Tensor:
        if self.results is None:
            self.reqs.append(v)
            return torch.zeros((self.ctx.nseg,), dtype=v.dtype, device=v.device)
        r = self.results[self.replay_i]
        self.replay_i += 1
        return r

    def resolve(self):
        ctx = self.ctx
        n = ctx.gid.shape[0]
        ints = [(i, v) for i, v in enumerate(self.reqs)
                if not v.is_floating_point() and v.dtype != torch.bool and n % 256 == 0]
        results: list = [None] * len(self.reqs)
        if ints:
            s = torch.stack([v.to(torch.int64) for _, v in ints], 1)  # [N, A]
            shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=s.device)
            iota = torch.arange(ctx.nseg, dtype=ctx.gid.dtype, device=s.device)
            tot = torch.zeros((ctx.nseg, s.shape[1] * 8), dtype=torch.int64, device=s.device)
            blk = min(dense_block_rows(ctx.nseg), _LIMB_ROWS)
            for lo in range(0, n, blk):
                oh = (ctx.gid[lo:lo + blk, None] == iota[None, :]).to(torch.float32)  # [rows, G]
                limbs = ((s[lo:lo + blk, :, None] >> shifts) & 0xFF).to(torch.float32)  # [rows, A, 8]
                part = torch.mm(oh.T, limbs.reshape(limbs.shape[0], -1))  # [G, A * 8], exact
                tot = tot + part.to(torch.int64)
            tot = (tot.reshape(ctx.nseg, -1, 8) << shifts).sum(2)  # [G, A], wrapping
            for j, (i, v) in enumerate(ints):
                results[i] = tot[:, j].to(v.dtype)
        for i, v in enumerate(self.reqs):
            if results[i] is None:
                results[i] = _dense_reduce(ctx, v, 0, _sum_rows, torch.add)
        self.results = results
        self.replay_i = 0


def _dense_mask(ctx: DenseCtx, lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """[rows, G] slot-membership mask of rows lo..hi."""
    iota = torch.arange(ctx.nseg, dtype=ctx.gid.dtype, device=ctx.gid.device)
    return ctx.gid[lo:hi, None] == iota[None, :]


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0, dtype=x.dtype)


def _dense_reduce(ctx: DenseCtx, vals: torch.Tensor, fill, reduce_rows, combine) -> torch.Tensor:
    """[G] per-slot reduce of vals: the [rows, G] masked matrix a block of
    rows at a time (dense_block_rows), each block reduced over its rows
    and the blocks combined in row order; empty slots keep `fill`."""
    n = vals.shape[0]
    out = torch.full((ctx.nseg,), fill, dtype=vals.dtype, device=vals.device)
    blk = dense_block_rows(ctx.nseg)
    for lo in range(0, n, blk):
        m = _dense_mask(ctx, lo, lo + blk)
        out = combine(out, reduce_rows(torch.where(m, vals[lo:lo + blk, None], fill)))
    return out


def _fold_rows(red):
    """Reduce a [rows, G] block over its rows with a binary op `red` (the
    bitwise ops have no reduction of their own): halve until one row."""

    def fold(x: torch.Tensor) -> torch.Tensor:
        while x.shape[0] > 1:
            h = x.shape[0] // 2
            y = red(x[:h], x[h:2 * h])
            x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
        return x[0]

    return fold


def _dense_scatter(ctx: DenseCtx, vals: torch.Tensor, reduce: str, fill) -> torch.Tensor:
    """Per-slot min / max: one scatter-reduce into nseg slots seeded with
    the fill (exact in any order, so no [rows, G] matrix is needed)."""
    out = torch.full((ctx.nseg,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ctx.gid, vals, reduce=reduce, include_self=True)


def _recording(ctx) -> bool:
    """True in DenseSumBatch's record pass: its states are thrown away, so
    the dense branches return placeholders instead of reducing (XLA merges
    the JAX package's two traced copies; eager torch would run both)."""
    return ctx.sums is not None and ctx.sums.recording


def dense_first_match(ctx: DenseCtx, mask: torch.Tensor):
    """Per-slot ORIGINAL position of the first mask row (int32 [nseg]) and
    a has-any flag: dense rows are unsorted, so 'first' is the smallest
    original index."""
    n = mask.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    fi = _dense_scatter(ctx, torch.where(mask, iota, n), "amin", n)
    has = fi < n
    return torch.where(has, fi, 0), has


def seg_sum(ctx, vals: torch.Tensor, dtype=None) -> torch.Tensor:
    """Per-segment sum via cumsum + boundary gathers (empty segments -> 0).
    Callers pre-mask invalid lanes to 0. Routed through ctx.sums (one
    batched cumsum, or the dense route's one matmul) when a batcher is
    armed; a DenseCtx otherwise takes a blocked masked sum."""
    v = vals if dtype is None else vals.to(dtype)
    if isinstance(ctx, DenseCtx):
        if ctx.sums is not None:
            return ctx.sums.add(v)
        return _dense_reduce(ctx, v, 0, _sum_rows, torch.add)
    if ctx.nseg == 1:
        return torch.sum(v, dim=0, keepdim=True, dtype=v.dtype)
    if ctx.sums is not None:
        return ctx.sums.add(v)
    n = v.shape[0]
    c = torch.cumsum(v, dim=0)
    lo = torch.clamp(ctx.starts, 0, n - 1).to(torch.int64)
    hi = torch.clamp(ctx.ends, 0, n - 1).to(torch.int64)
    out = c[hi] - c[lo] + v[lo]
    return torch.where(ctx.counts > 0, out, torch.zeros((), dtype=v.dtype, device=v.device))


def _seg_reduce(ctx: SegCtx, vals: torch.Tensor, reduce: str, fill) -> torch.Tensor:
    """Per-segment min/max: one scatter-reduce into nseg slots seeded with
    the fill (empty segments keep it)."""
    out = torch.full((ctx.nseg,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ctx.seg.to(torch.int64), vals, reduce=reduce, include_self=True)


def _fill(vals: torch.Tensor, lowest: bool):
    if vals.is_floating_point():
        return float("-inf") if lowest else float("inf")
    info = torch.iinfo(vals.dtype)
    return info.min if lowest else info.max


def seg_min(ctx, vals: torch.Tensor) -> torch.Tensor:
    if isinstance(ctx, DenseCtx):
        if _recording(ctx):
            return torch.zeros((ctx.nseg,), dtype=vals.dtype, device=vals.device)
        return _dense_scatter(ctx, vals, "amin", _fill(vals, lowest=False))
    if ctx.nseg == 1:
        return torch.amin(vals, dim=0, keepdim=True)
    return _seg_reduce(ctx, vals, "amin", _fill(vals, lowest=False))


def seg_max(ctx, vals: torch.Tensor) -> torch.Tensor:
    if isinstance(ctx, DenseCtx):
        if _recording(ctx):
            return torch.zeros((ctx.nseg,), dtype=vals.dtype, device=vals.device)
        return _dense_scatter(ctx, vals, "amax", _fill(vals, lowest=True))
    if ctx.nseg == 1:
        return torch.amax(vals, dim=0, keepdim=True)
    return _seg_reduce(ctx, vals, "amax", _fill(vals, lowest=True))


def seg_first_match(ctx, mask_s: torch.Tensor):
    """Per-segment sorted position of the FIRST mask row (int32 [nseg]),
    plus a has-any flag. A reverse cummin over (mask ? position : n) gives
    every position its nearest masked position at-or-after; reading it at
    the segment start yields the first masked row IN the segment — or a
    leak into a later segment, rejected by the extent check. With a stable
    sort, that is also the masked row with the smallest original index.
    (DenseCtx rows are unsorted; positions are original indices.)"""
    if isinstance(ctx, DenseCtx):
        return dense_first_match(ctx, mask_s)
    n = mask_s.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=mask_s.device)
    m = torch.where(mask_s, iota, n)
    rcm = torch.flip(torch.cummin(torch.flip(m, (0,)), 0).values, (0,))
    first = rcm[torch.clamp(ctx.starts, 0, n - 1).to(torch.int64)]
    has = (ctx.counts > 0) & (first <= ctx.ends)
    return torch.where(has, torch.clamp(first, 0, n - 1), 0).to(torch.int32), has


def _seg_scan_reduce(ctx: SegCtx, vals: torch.Tensor, combine, neutral, empty_fill) -> torch.Tensor:
    """Per-segment reduce of an associative `combine` via a Hillis-Steele
    doubling scan: log2(N) steps of a shifted cat and a where, each row
    combining with the row d before it when both lie in one segment. Built
    out of place, so it stays legal under torch.func.vmap."""
    n = vals.shape[0]
    v = vals
    s = ctx.seg
    d = 1
    while d < n:
        pv = torch.cat([torch.full_like(v[:d], neutral), v[:-d]])
        ps = torch.cat([torch.full_like(s[:d], -1), s[:-d]])
        v = torch.where(s == ps, combine(v, pv), v)
        d *= 2
    out = v[torch.clamp(ctx.ends, 0, n - 1).to(torch.int64)]
    return torch.where(ctx.counts > 0, out, empty_fill)


def seg_bitreduce(ctx, red, vals: torch.Tensor, fill: int) -> torch.Tensor:
    """Segmented bitwise and / or / xor (torch has no scatter_reduce for
    them; callers pre-mask invalid lanes to the identity `fill`). The
    doubling scan handles nseg == 1 too: one segment is a plain scan whose
    last element is the total. A DenseCtx folds blocked [rows, G] masks."""
    if isinstance(ctx, DenseCtx):
        if _recording(ctx):
            return torch.zeros((ctx.nseg,), dtype=vals.dtype, device=vals.device)
        return _dense_reduce(ctx, vals, fill, _fold_rows(red), red)
    return _seg_scan_reduce(ctx, vals, red, fill, fill)
