"""Selection (port of tidb_tpu/ops/selection.py): a filter is a mask
intersection — no row movement. Downstream kernels consume `row_valid`."""

from __future__ import annotations

from ..expr.compile import CompVal


def apply_selection(row_valid, conds: list[CompVal]):
    """AND of condition truthiness; NULL and false both drop the row.

    A bare string condition needs MySQL's numeric-prefix parse, a string op
    this port does not run yet: it raises NotImplementedError."""
    out = row_valid
    for c in conds:
        if c.value.dim() == 2:
            raise NotImplementedError("string truthiness in WHERE not on device")
        if c.eval_type == "real":
            t = c.value != 0.0
        else:
            t = c.value != 0
        out = out & t & ~c.null
    return out
