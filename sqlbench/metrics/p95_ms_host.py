"""p95_ms.host: the 95th percentile of the latencies of the statements that
ended in the traced window, from the session's issue to the last row
(the end-to-end p95_ms's reading, kept as a per-layer number where the
host's speed spreads it too wide to bound: the card idles most of the
window)."""

import statistics


def read(ctx):
    lat = [(r.end - r.start) * 1e3 for r in ctx.window.in_window()]
    if len(lat) < 2:
        return None
    return float(statistics.quantiles(lat, n=20, method="inclusive")[18])
