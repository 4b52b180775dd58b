"""Top SQL — per-digest resource attribution (ref: pkg/util/topsql).

The reference samples CPU on a timer and attributes samples to the SQL /
plan digest stored in goroutine labels, then a reporter aggregates the
samples into fixed windows of top-N digests. In-process we can do better
than statistical sampling: every layer that already measures (thread CPU
deltas at the session boundary and over each pool task, the
fused-program clock in the store, the Backoffer's slept intervals, the
admission gate's queue wait) records its EXACT measurement onto an
ambient per-statement resource tag, and the reporter folds finished
statements into windows.

Three pieces:

  tag.py      the contextvar resource tag `(sql_digest, plan_digest)` +
              the attribution sinks layers call (no-ops when no tag is
              ambient, so untagged/background work costs one dict read)
  reporter.py the windowed top-K collector (bounded ring, "others"
              fold), per-digest EWMA cost classes (point/small/scan/
              heavy) the admission gate weighs in-flight statements by

`COLLECTOR` is the process singleton, the same shape as
`util.metrics.REGISTRY`: every session/store of the process reports
into one ledger, exactly like the reference's single topsql reporter
per tidb-server.

A copy of the JAX package's tidb_tpu/topsql/ (stdlib and util.metrics
only). The port's store does not report device time into it yet.
"""

from __future__ import annotations

from .reporter import (  # noqa: F401
    CLASS_WEIGHTS,
    COLLECTOR,
    DEFAULT_CLASS,
    OTHERS_DIGEST,
    TopSQLCollector,
    split_by_rows,
)
from .tag import (  # noqa: F401
    ResourceTag,
    activate,
    adopt,
    current_tag,
    deactivate,
    record_backoff,
    record_cop_cache_hit,
    record_device,
    record_queue_wait,
)
