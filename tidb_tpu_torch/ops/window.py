"""Window functions (port of tidb_tpu/ops/window.py; ref: pkg/executor/
window.go + pipelined_window.go, tipb.Window; per-function semantics
pkg/executor/aggfuncs/func_{rank,row_number,lead_lag,first_value,...}.go).

The whole batch is on the device, so one stable lexsort by (partition keys,
order keys) turns every supported window into a segmented scan or a gather
in sorted space, scattered back to input order:

  row_number / rank / dense_rank    index arithmetic on segment starts
  percent_rank / cume_dist / ntile  + partition sizes (gathered ends)
  sum / count / avg                 segmented inclusive cumsum, read at the
                                    current row's peer-group end: MySQL's
                                    default frame (RANGE UNBOUNDED
                                    PRECEDING..CURRENT ROW includes peers);
                                    without ORDER BY the frame is the whole
                                    partition (read at the partition end)
  min / max                         segmented running max / min (log-step
                                    doubling bounded by the segment start)
  first_value / last_value /        gathers at the partition start, the
  nth_value / lead / lag            peer end, or fixed offsets within the
                                    partition

Explicit ROWS / RANGE frames are not supported (the planner routes those to
the row-at-a-time oracle); string SUM / AVG / MIN / MAX and string LEAD /
LAG defaults raise NotImplementedError, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..expr.compile import I64_MIN, CompVal, _round_div
from .keys import lexsort, sort_key_arrays
from .seg import I64_MAX

# the window functions window_cols handles, by family (the SQL planner
# checks a call's name against WINDOW_FUNCS)
RANK_FUNCS = frozenset({"row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile"})
GATHER_FUNCS = frozenset({"first_value", "last_value", "nth_value", "lead", "lag"})
AGG_FUNCS = frozenset({"sum", "avg", "count", "min", "max"})
WINDOW_FUNCS = RANK_FUNCS | GATHER_FUNCS | AGG_FUNCS


def _seg_running_sum(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum within segments; `start` = each row's segment
    start index (monotone)."""
    c = torch.cumsum(x, 0)
    excl = c - x  # exclusive prefix
    return c - excl[start]


def _seg_scan_extreme(x: torch.Tensor, start: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Segmented inclusive running max / min over partition-sorted rows.
    Log-step doubling: after the step of distance d, row i holds the
    extreme of rows [i - 2d + 1, i] within its segment (a row takes row
    i - d only when i - d >= start[i]). Exact for int64 and float64, with
    no offset of the values by segment, so int64 keeps its full range."""
    n = x.shape[0]
    pick = torch.maximum if is_max else torch.minimum
    arange = torch.arange(n, device=x.device)
    d = 1
    while d < n:
        prev = torch.empty_like(x)
        prev[d:] = x[:-d]
        prev[:d] = x[:d]
        x = torch.where(arange - d >= start, pick(x, prev), x)
        d *= 2
    return x


def _seg_bounds(seg_id: torch.Tensor):
    """Each row's segment (first row, last row) from the running count of
    segment starts (nondecreasing): the first and last rows whose count
    equals its own. Two binary searches per row, whatever the segment
    sizes (a cummax / reversed cummin with indices costs more on the
    card)."""
    return (torch.searchsorted(seg_id, seg_id, side="left"),
            torch.searchsorted(seg_id, seg_id, side="right") - 1)


def _gather_cv(cv: CompVal, idx: torch.Tensor, extra_null: torch.Tensor) -> CompVal:
    raw = None
    if cv.raw is not None:
        raw = (cv.raw[0][idx], cv.raw[1][idx])
    return CompVal(cv.value[idx], cv.null[idx] | extra_null, cv.ft, raw=raw)


def window_cols(part_vals: list, order_pairs: list, funcs: list, valid: torch.Tensor) -> list[CompVal]:
    """Window columns in original row order.

    part_vals: [CompVal] partition keys; order_pairs: [(CompVal, desc)];
    funcs: [(WinDesc, [CompVal arg columns])]; valid: row mask.
    Returns one CompVal per WinDesc."""
    n = valid.shape[0]
    dev = valid.device
    arange = torch.arange(n, device=dev)
    # the validity key counts as a partition key: padding rows (sorted
    # last) never merge into the last valid partition even when their
    # zeroed key lanes equal its keys
    keys = [(~valid).to(torch.int64)]
    for v in part_vals:
        keys.extend(sort_key_arrays(v))
    n_pkey_arrays = len(keys)
    for v, desc in order_pairs:
        keys.extend(sort_key_arrays(v, desc=desc))
    perm = lexsort(keys, extra_key=arange)

    def diff_of(vals_keys):
        # the buffer takes perm's region axis under vmap, so the writes stay legal
        d = torch.zeros_like(perm, dtype=torch.bool)
        d[0] = True
        for k in vals_keys:
            ks = k[perm]
            d[1:] |= ks[1:] != ks[:-1]
        return d

    pkeys = keys[:n_pkey_arrays]
    okeys = keys[n_pkey_arrays:]
    new_part = diff_of(pkeys)
    new_peer = new_part | diff_of(okeys) if okeys else new_part
    has_order = bool(order_pairs)

    part_id = torch.cumsum(new_part.to(torch.int64), 0)
    peer_id = torch.cumsum(new_peer.to(torch.int64), 0)
    start, part_end = _seg_bounds(part_id)
    peer_start, peer_end = _seg_bounds(peer_id)
    # the read point of the default frame: the last peer with ORDER BY,
    # else the whole partition
    frame_end = peer_end if has_order else part_end
    cnt = part_end - start + 1
    pos0 = arange - start  # 0-based row index in the partition

    sv = valid[perm]

    # the scatter buffers are made from perm, so under vmap they carry its
    # region axis and the index writes stay legal
    def scatter(v_sorted, null_sorted, ft) -> CompVal:
        value = perm.new_zeros(n, dtype=v_sorted.dtype)
        value[perm] = v_sorted
        null = perm.new_ones(n, dtype=torch.bool)
        null[perm] = null_sorted
        return CompVal(value, null, ft)

    def gather_result(cv: CompVal, j_sorted, src_null_sorted) -> CompVal:
        """Sorted-space source index -> original-order gathered CompVal."""
        src_orig = perm.new_zeros(n, dtype=torch.int64)
        src_orig[perm] = perm[torch.clamp(j_sorted, 0, n - 1)]
        xnull = perm.new_ones(n, dtype=torch.bool)
        xnull[perm] = src_null_sorted
        return _gather_cv(cv, src_orig, xnull)

    out: list[CompVal] = []
    for desc, argvals in funcs:
        name = desc.name
        if name == "row_number":
            out.append(scatter(pos0 + 1, ~sv, desc.ft))
        elif name == "rank":
            out.append(scatter(peer_start - start + 1, ~sv, desc.ft))
        elif name == "dense_rank":
            out.append(scatter(peer_id - peer_id[start] + 1, ~sv, desc.ft))
        elif name == "percent_rank":
            rank = (peer_start - start).to(torch.float64)
            denom = torch.clamp(cnt - 1, min=1).to(torch.float64)
            out.append(scatter(torch.where(cnt <= 1, 0.0, rank / denom), ~sv, desc.ft))
        elif name == "cume_dist":
            covered = (peer_end - start + 1).to(torch.float64)
            out.append(scatter(covered / cnt.to(torch.float64), ~sv, desc.ft))
        elif name == "ntile":
            k = int(desc.offset)
            base, rem = cnt // k, cnt % k
            cut = rem * (base + 1)
            bucket = torch.where(
                pos0 < cut,
                pos0 // torch.clamp(base + 1, min=1),
                rem + (pos0 - cut) // torch.clamp(base, min=1),
            )
            out.append(scatter(bucket + 1, ~sv, desc.ft))
        elif name == "count":
            ones = sv & ~argvals[0].null[perm] if argvals else sv
            run = _seg_running_sum(ones.to(torch.int64), start)
            out.append(scatter(run[frame_end], ~sv, desc.ft))
        elif name in ("sum", "avg"):
            a = argvals[0]
            if a.value.dim() == 2:
                raise NotImplementedError("string SUM/AVG windows run on the oracle")
            av, anull = a.value[perm], a.null[perm]
            live = sv & ~anull
            if a.eval_type == "real":
                x = torch.where(live, av.to(torch.float64), 0.0)
            else:
                x = torch.where(live, av.to(torch.int64), 0)
            rsum = _seg_running_sum(x, start)[frame_end]
            rcnt = _seg_running_sum(live.to(torch.int64), start)[frame_end]
            null = ~sv | (rcnt == 0)
            if name == "sum":
                out.append(scatter(rsum, null, desc.ft))
            elif a.eval_type == "real":
                out.append(scatter(rsum / torch.clamp(rcnt, min=1).to(torch.float64), null, desc.ft))
            else:
                # decimal avg: scale(out) = scale(arg) + 4 (div frac incr),
                # rounded half away from zero, as finalize_agg does
                src_scale = max(a.ft.decimal, 0) if a.eval_type == "decimal" else 0
                tgt = max(desc.ft.decimal, 0)
                num = rsum * 10 ** (tgt - src_scale)
                out.append(scatter(_round_div(num, torch.clamp(rcnt, min=1)), null, desc.ft))
        elif name in ("min", "max"):
            a = argvals[0]
            if a.value.dim() == 2:
                raise NotImplementedError("string MIN/MAX windows run on the oracle")
            av, anull = a.value[perm], a.null[perm]
            live = sv & ~anull
            unsigned = a.eval_type == "int" and a.ft.is_unsigned()
            if a.eval_type == "real":
                ident = float("-inf") if name == "max" else float("inf")
                x = torch.where(live, av.to(torch.float64), ident)
            else:
                # full-range identities: extremes the scan cannot beat, and
                # a value equal to the identity is itself the answer.
                # Unsigned values flip the sign bit (an order-preserving
                # u64 -> s64 bijection), flipped back after the scan
                xi = av.to(torch.int64)
                if unsigned:
                    xi = xi ^ I64_MIN
                x = torch.where(live, xi, I64_MIN if name == "max" else I64_MAX)
            run = _seg_scan_extreme(x, start, name == "max")
            rcnt = _seg_running_sum(live.to(torch.int64), start)[frame_end]
            v = run[frame_end]
            if unsigned:
                v = v ^ I64_MIN
            out.append(scatter(v, ~sv | (rcnt == 0), desc.ft))
        elif name == "first_value":
            out.append(gather_result(argvals[0], start, ~sv))
        elif name == "last_value":
            out.append(gather_result(argvals[0], frame_end, ~sv))
        elif name == "nth_value":
            j = start + int(desc.offset) - 1
            miss = ~sv | (j > frame_end)
            out.append(gather_result(argvals[0], j, miss))
        elif name in ("lead", "lag"):
            off = desc.offset if name == "lead" else -desc.offset
            j = arange + off
            inb = (j >= 0) & (j < n)
            jc = torch.clamp(j, 0, n - 1)
            same = inb & (part_id[jc] == part_id) & sv & sv[jc]
            res = gather_result(argvals[0], jc, ~same)
            if len(argvals) > 1:
                if res.raw is not None:
                    raise NotImplementedError("string LEAD/LAG defaults run on the oracle")
                d = argvals[1]
                dnull = perm.new_ones(n, dtype=torch.bool)
                dnull[perm] = ~same
                out.append(CompVal(torch.where(dnull, d.value, res.value),
                                   torch.where(dnull, d.null, res.null), desc.ft))
            else:
                out.append(res)
        else:
            raise NotImplementedError(f"window function {name!r}")
    return out
