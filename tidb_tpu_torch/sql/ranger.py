"""Predicate -> key ranges (ref: pkg/util/ranger — range building from
WHERE conjuncts for the planner's access-path selection).

Extracts intervals on a single column from eq/lt/le/gt/ge/BETWEEN/IN
conjuncts, intersects them, and renders either integer handle ranges
(primary-key pruning: scan fewer rows) or memcomparable index key ranges.

Copy of `tidb_tpu/sql/ranger.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..codec import tablecodec
from ..codec.datum_codec import encode_datum
from ..parser import ast as A
from ..types import Datum, DatumKind

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


@dataclass
class Interval:
    """One [low, high] interval over Datums; None bound = unbounded."""

    low: object = None  # Datum | None
    high: object = None
    low_inc: bool = True
    high_inc: bool = True


def _is_col(e, name: str) -> bool:
    return isinstance(e, A.ColumnName) and e.name.lower() == name


def _const_datum(e, eval_const) -> Datum | None:
    if isinstance(e, A.Literal) and e.kind != "null":
        return eval_const(e)  # may be None: lossy coercion declined
    return None


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def intervals_for_column(conjuncts: list, col_name: str, eval_const) -> list | None:
    """Intervals implied by the conjuncts on `col_name`, or None when the
    conjuncts don't constrain it. eval_const: Literal AST -> Datum.

    Each usable conjunct contributes an interval set; sets intersect.
    Non-matching conjuncts are ignored (they remain as filters)."""
    sets: list[list[Interval]] = []
    for c in conjuncts:
        got = _conjunct_intervals(c, col_name, eval_const)
        if got is not None:
            sets.append(got)
    if not sets:
        return None
    out = sets[0]
    for s in sets[1:]:
        out = _intersect(out, s)
        if not out:
            return []  # provably empty
    return _merge(out)


def _merge(ivs: list) -> list:
    """Sort and merge overlapping intervals so no key range is emitted
    twice (IN (5,5) must not scan the row twice)."""

    # sort: unbounded lows first, then by low value, inclusive before exclusive
    def sort_key(iv):
        if iv.low is None:
            return (0, 0, 0)
        return (1, _SortDatum(iv.low), 0 if iv.low_inc else 1)

    ivs = sorted(ivs, key=sort_key)
    out: list = [ivs[0]]
    for iv in ivs[1:]:
        last = out[-1]
        # does iv start within (or adjacent-inclusively to) last?
        overlaps = last.high is None
        if not overlaps and iv.low is not None:
            c = _cmp(iv.low, last.high)
            overlaps = c < 0 or (c == 0 and (iv.low_inc or last.high_inc))
        elif not overlaps:
            overlaps = True  # iv.low unbounded
        if overlaps:
            # extend last.high if iv reaches further
            if last.high is not None and (
                iv.high is None or _cmp(iv.high, last.high) > 0 or (_cmp(iv.high, last.high) == 0 and iv.high_inc)
            ):
                out[-1] = Interval(last.low, iv.high, last.low_inc, iv.high_inc)
        else:
            out.append(iv)
    return out


class _SortDatum:
    """Orderable wrapper over Datum for interval sorting."""

    __slots__ = ("d",)

    def __init__(self, d):
        self.d = d

    def __lt__(self, other):
        return _cmp(self.d, other.d) < 0

    def __eq__(self, other):
        return _cmp(self.d, other.d) == 0


def _conjunct_intervals(c, col_name: str, eval_const) -> list | None:
    if isinstance(c, A.BinaryOp) and c.op in _FLIP:
        if _is_col(c.left, col_name):
            d = _const_datum(c.right, eval_const)
            op = c.op
        elif _is_col(c.right, col_name):
            d = _const_datum(c.left, eval_const)
            op = _FLIP[c.op]
        else:
            return None
        if d is None:
            return None
        if op == "eq":
            return [Interval(d, d)]
        if op == "lt":
            return [Interval(None, d, high_inc=False)]
        if op == "le":
            return [Interval(None, d)]
        if op == "gt":
            return [Interval(d, None, low_inc=False)]
        return [Interval(d, None)]
    if isinstance(c, A.Between) and not c.negated and _is_col(c.expr, col_name):
        lo, hi = _const_datum(c.low, eval_const), _const_datum(c.high, eval_const)
        if lo is None or hi is None:
            return None
        return [Interval(lo, hi)]
    if isinstance(c, A.InList) and not c.negated and _is_col(c.expr, col_name):
        ds = [_const_datum(i, eval_const) for i in c.items]
        if any(d is None for d in ds):
            return None
        return [Interval(d, d) for d in ds]
    return None


def _cmp(a: Datum, b: Datum) -> int:
    from ..expr.eval_ref import compare

    return compare(a, b)


def _tighter_low(l1, i1, l2, i2):
    if l1 is None:
        return l2, i2
    if l2 is None:
        return l1, i1
    c = _cmp(l2, l1)
    if c > 0:
        return l2, i2
    if c < 0:
        return l1, i1
    return l1, i1 and i2


def _tighter_high(h1, i1, h2, i2):
    if h1 is None:
        return h2, i2
    if h2 is None:
        return h1, i1
    c = _cmp(h2, h1)
    if c < 0:
        return h2, i2
    if c > 0:
        return h1, i1
    return h1, i1 and i2


def _intersect(xs: list, ys: list) -> list:
    out = []
    for x in xs:
        for y in ys:
            lo, lo_inc = _tighter_low(x.low, x.low_inc, y.low, y.low_inc)
            hi, hi_inc = _tighter_high(x.high, x.high_inc, y.high, y.high_inc)
            if lo is not None and hi is not None:
                c = _cmp(lo, hi)
                if c > 0 or (c == 0 and not (lo_inc and hi_inc)):
                    continue
            out.append(Interval(lo, hi, lo_inc, hi_inc))
    return out


def handle_ranges_from_intervals(table_id: int, intervals: list) -> list:
    """Integer intervals -> row-key ranges (PK handle pruning)."""
    from ..store.store import KeyRange

    out = []
    for iv in intervals:
        lo = I64_MIN
        if iv.low is not None:
            lo = int(iv.low.val) + (0 if iv.low_inc else 1)
        hi = I64_MAX
        if iv.high is not None:
            hi = int(iv.high.val) - (0 if iv.high_inc else 1)
        if lo > hi:
            continue
        out.append(KeyRange(tablecodec.encode_row_key(table_id, lo), tablecodec.encode_row_key(table_id, hi) + b"\x00"))
    return out


def index_ranges_from_intervals(table_id: int, index_id: int, intervals: list) -> list:
    """First-index-column intervals -> index key ranges. Exclusive bounds
    append 0xff past the encoded datum (encoded datums are self-delimiting,
    and any key continuing an equal first column sorts below it)."""
    from ..store.store import KeyRange

    prefix = tablecodec.encode_index_key(table_id, index_id, [])
    out = []
    for iv in intervals:
        if iv.low is None:
            start = prefix
        else:
            start = prefix + encode_datum(iv.low) + (b"" if iv.low_inc else b"\xff")
        if iv.high is None:
            end = prefix + b"\xff"
        else:
            end = prefix + encode_datum(iv.high) + (b"\xff" if iv.high_inc else b"")
        if start < end:
            out.append(KeyRange(start, end))
    return out
