"""True-positive fixture for the port's `metrics` pass: duplicate
registration, naming-convention breaks, label-arity mismatch, vec
addressed without .labels(), plain counter addressed with .labels().
NEVER imported — scanned as text by tests/test_torch_vet.py."""

from tidb_tpu_torch.util import metrics
from tidb_tpu_torch.util.metrics import Registry

REG = Registry()

FIX_A = REG.counter("vetfix_requests_total")
FIX_DUP = REG.counter("vetfix_requests_total")  # VIOLATION: registered twice
FIX_NO_SUFFIX = REG.counter("vetfix_requests")  # VIOLATION: counter sans _total
FIX_BAD_NAME = REG.gauge("vetfix-bad-name")  # VIOLATION: invalid charset
FIX_GAUGE_TOTAL = REG.gauge("vetfix_open_total")  # VIOLATION: gauge claims _total
FIX_VEC = REG.counter_vec("vetfix_tasks_total", "per-store tasks",
                          labelnames=("store",))


def use_sites():
    metrics.FIX_VEC.labels("0", "extra").inc()  # VIOLATION: arity mismatch
    metrics.FIX_VEC.inc()  # VIOLATION: vec without .labels
    metrics.FIX_A.labels("x").inc()  # VIOLATION: plain counter has no labels
    metrics.FIX_TYPO_TOTAL.inc()  # VIOLATION: never registered
