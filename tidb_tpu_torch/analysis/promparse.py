"""The Prometheus metric-name / label grammar the port's `metrics` vet
pass validates registrations and `.labels()` call sites with (the same
grammar `util/metrics.py`'s exposition follows).

Copy of `tidb_tpu/analysis/promparse.py` for the PyTorch port.

Grammar (the text-exposition v0.0.4 subset):
  metric name  [a-zA-Z_:][a-zA-Z0-9_:]*
  label name   [a-zA-Z_][a-zA-Z0-9_]*
  label set    k="v" pairs, comma separated, backslash escapes in values
"""

from __future__ import annotations

import re

METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
EXPOSITION_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}

# naming conventions the registry adheres to (prometheus.io/docs/practices/
# naming): cumulative counters end `_total`; base units are suffixed
# (`_seconds`, `_bytes`); gauges never claim `_total`.
COUNTER_SUFFIX = "_total"
UNIT_SUFFIXES = ("_seconds", "_bytes", "_total", "_count")


def valid_metric_name(name: str) -> bool:
    return bool(METRIC_NAME.match(name))


def valid_label_name(name: str) -> bool:
    return bool(LABEL_NAME.match(name))


def parse_labels(s: str, errs: list, ln: int) -> dict:
    """`k="v",k2="v2"` -> dict; appends errors instead of raising."""
    out: dict = {}
    i = 0
    while i < len(s):
        m = re.match(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"', s[i:])
        if not m:
            errs.append(f"line {ln}: bad label syntax at {s[i:]!r}")
            return out
        key = m.group(1)
        i += m.end()
        buf = []
        while i < len(s):
            c = s[i]
            if c == "\\":
                if i + 1 >= len(s):
                    errs.append(f"line {ln}: dangling escape in label value")
                    return out
                nxt = s[i + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            buf.append(c)
            i += 1
        else:
            errs.append(f"line {ln}: unterminated label value for {key!r}")
            return out
        out[key] = "".join(buf)
        if i < len(s) and s[i] == ",":
            i += 1
    return out
