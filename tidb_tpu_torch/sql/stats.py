"""Table/column statistics: equi-depth histograms + TopN + NDV, built by
ANALYZE and consumed by the planner's cardinality estimates
(ref: pkg/statistics — histogram.go equi-depth buckets, cmsketch.go TopN,
builder.go BuildColumn; store-side collection cophandler/analyze.go).

The reference samples on the store side and sketches NDV with FMSketch;
in-process the full column is available, so NDV and TopN are exact and the
histogram is built from one sorted pass. The *consumer* contract matches:
  est_rows(column, intervals) -> estimated matching rows
with TopN answering point hits exactly, buckets interpolating ranges.

Port of `tidb_tpu/sql/stats.py` (imports rewritten; it imports nothing of
tidb_tpu). One repair: `_as_float` reads a time bound's packed value, where
the reference calls `MyTime.to_packed()`, which does not exist (a range
estimate over an analyzed date column raised AttributeError).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..expr.eval_ref import compare
from ..types import Datum, DatumKind
from .ranger import Interval

DEFAULT_BUCKETS = 64
DEFAULT_TOPN = 16
CM_DEPTH = 5
CM_WIDTH = 2048


class CMSketch:
    """Count-Min sketch over datum group keys (ref: pkg/statistics/
    cmsketch.go — d x w counters, point frequency = min over rows; TopN
    values are kept OUT of the sketch, exactly like the reference splits
    CMSketchAndTopN)."""

    __slots__ = ("depth", "width", "rows")

    def __init__(self, depth: int = CM_DEPTH, width: int = CM_WIDTH):
        self.depth = depth
        self.width = width
        self.rows = [[0] * width for _ in range(depth)]

    @staticmethod
    def _key(d: Datum):
        from ..exec.executor import datum_group_key

        return datum_group_key(d)

    def insert(self, d: Datum, count: int = 1):
        k = hash(self._key(d))
        for i in range(self.depth):
            h = hash((i * 0x9E3779B97F4A7C15, k)) % self.width
            self.rows[i][h] += count

    def query(self, d: Datum) -> int:
        k = hash(self._key(d))
        return min(
            self.rows[i][hash((i * 0x9E3779B97F4A7C15, k)) % self.width]
            for i in range(self.depth)
        )


@dataclass
class Bucket:
    """(ref: statistics.Bucket — lower/upper inclusive, cumulative count)."""

    lower: Datum
    upper: Datum
    count: int  # rows in this bucket (not cumulative)
    repeats: int  # occurrences of `upper`
    ndv: int  # distinct values in the bucket


@dataclass
class ColumnStats:
    null_count: int = 0
    ndv: int = 0
    total: int = 0  # non-null rows
    topn: list = field(default_factory=list)  # [(Datum, count)] most frequent
    buckets: list = field(default_factory=list)  # [Bucket] ascending
    cmsketch: CMSketch | None = None  # point frequencies for non-TopN values


@dataclass
class TableStats:
    row_count: int = 0
    version: int = 0  # TSO at ANALYZE time
    columns: dict = field(default_factory=dict)  # col name -> ColumnStats


def build_column_stats(values: list, n_buckets: int = DEFAULT_BUCKETS,
                       n_topn: int = DEFAULT_TOPN) -> ColumnStats:
    """One sorted pass over the column's datums (ref: builder.go
    BuildColumnHist + the TopN extraction in cmsketch.go)."""
    import functools

    nonnull = [d for d in values if not d.is_null()]
    cs = ColumnStats(null_count=len(values) - len(nonnull), total=len(nonnull))
    if not nonnull:
        return cs
    nonnull.sort(key=functools.cmp_to_key(compare))
    groups: list[tuple[Datum, int]] = []
    for d in nonnull:
        if groups and compare(groups[-1][0], d) == 0:
            groups[-1] = (groups[-1][0], groups[-1][1] + 1)
        else:
            groups.append((d, 1))
    cs.ndv = len(groups)
    # TopN: most frequent values that repeat (point queries answer exactly)
    frequent = sorted((g for g in groups if g[1] > 1), key=lambda g: -g[1])[:n_topn]
    topn_vals = {id(g[0]) for g in frequent}
    cs.topn = [(d, c) for d, c in frequent]
    rest = [g for g in groups if id(g[0]) not in topn_vals]
    if not rest:
        return cs
    cs.cmsketch = CMSketch()
    for d, c in rest:
        cs.cmsketch.insert(d, c)
    depth = max(sum(c for _, c in rest) // n_buckets + 1, 1)
    cur: Bucket | None = None
    for d, c in rest:
        if cur is None or cur.count >= depth:
            cur = Bucket(lower=d, upper=d, count=c, repeats=c, ndv=1)
            cs.buckets.append(cur)
        else:
            cur.upper, cur.repeats = d, c
            cur.count += c
            cur.ndv += 1
    return cs


def _as_float(d: Datum) -> float | None:
    from ..types import MyDecimal, MyTime

    if d.kind in (DatumKind.Int64, DatumKind.Uint64):
        return float(d.val)
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        return float(d.val)
    if d.kind == DatumKind.MysqlDecimal:
        return d.val.to_float()
    if d.kind == DatumKind.MysqlTime:
        return float(d.val.packed)  # the reference calls a to_packed() MyTime lacks
    return None


def _in_interval(d: Datum, iv: Interval) -> bool:
    if iv.low is not None:
        c = compare(d, iv.low)
        if c < 0 or (c == 0 and not iv.low_inc):
            return False
    if iv.high is not None:
        c = compare(d, iv.high)
        if c > 0 or (c == 0 and not iv.high_inc):
            return False
    return True


def est_interval_rows(cs: ColumnStats, iv: Interval) -> float:
    """Estimated rows matching one interval (ref: histogram.go
    BetweenRowCount/equalRowCount + TopN adjustments)."""
    hit = sum(c for d, c in cs.topn if _in_interval(d, iv))
    is_point = (
        iv.low is not None and iv.high is not None
        and iv.low_inc and iv.high_inc and compare(iv.low, iv.high) == 0
    )
    if is_point:
        if any(compare(d, iv.low) == 0 for d, _ in cs.topn):
            return hit  # TopN answers exactly; buckets exclude TopN values
        # equality not answered by TopN: the CM sketch answers point
        # frequency (ref: cmsketch.go queryValue); the bucket average is
        # the no-sketch fallback (histogram.go equalRowCount)
        if cs.cmsketch is not None:
            return hit + cs.cmsketch.query(iv.low)
        for b in cs.buckets:
            if compare(iv.low, b.lower) >= 0 and compare(iv.low, b.upper) <= 0:
                if compare(iv.low, b.upper) == 0:
                    return hit + b.repeats
                return hit + b.count / max(b.ndv, 1)
        return hit
    for b in cs.buckets:
        lo_in = iv.low is None or compare(b.lower, iv.low) >= 0
        hi_in = iv.high is None or compare(b.upper, iv.high) <= 0
        if lo_in and hi_in:
            # entire bucket inside (ignoring open-endpoint slivers)
            hit += b.count
            continue
        # bucket straddles a boundary: linear interpolation on numerics,
        # half-bucket otherwise (the reference's out-of-range heuristic)
        blo, bhi = _as_float(b.lower), _as_float(b.upper)
        if blo is None or bhi is None or bhi <= blo:
            overlap_lo = iv.low is not None and _in_interval(b.upper, iv)
            overlap_hi = iv.high is not None and _in_interval(b.lower, iv)
            if overlap_lo or overlap_hi:
                hit += b.count / 2
            continue
        flo = None if iv.low is None else _as_float(iv.low)
        fhi = None if iv.high is None else _as_float(iv.high)
        lo = blo if flo is None else flo
        hi = bhi if fhi is None else fhi
        lo, hi = max(lo, blo), min(hi, bhi)
        if hi >= lo:
            hit += b.count * (hi - lo) / (bhi - blo)
    return hit


def est_selectivity(cs: ColumnStats, intervals: list) -> float:
    """Selectivity of a union of disjoint intervals over one column."""
    if cs.total + cs.null_count == 0:
        return 1.0
    rows = sum(est_interval_rows(cs, iv) for iv in intervals)
    return min(max(rows / max(cs.total + cs.null_count, 1), 0.0), 1.0)
