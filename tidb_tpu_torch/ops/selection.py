"""Selection (port of tidb_tpu/ops/selection.py): a filter is a mask
intersection — no row movement. Downstream kernels consume `row_valid`."""

from __future__ import annotations

from ..expr.compile import CompVal, parse_f64_prefix, string_bytes


def apply_selection(row_valid, conds: list[CompVal]):
    """AND of condition truthiness; NULL and false both drop the row.

    A bare string condition follows MySQL truthiness: its numeric prefix,
    parsed as a double (parse_f64_prefix), must be non-zero."""
    out = row_valid
    for c in conds:
        if c.value.dim() == 2:
            data, length = string_bytes(c)
            t = parse_f64_prefix(data, length) != 0.0
        elif c.eval_type == "real":
            t = c.value != 0.0
        else:
            t = c.value != 0
        out = out & t & ~c.null
    return out
