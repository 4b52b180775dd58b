"""Utilities copied from the JAX package's JAX-free `tidb_tpu/util/`:
`metrics` (the registry and its families), `failpoint`, `memory`,
`tracing` and `backoff`. The package exports what the reference's does."""

from . import failpoint
from .memory import MemTracker, QuotaExceeded
from .metrics import REGISTRY

__all__ = ["failpoint", "MemTracker", "QuotaExceeded", "REGISTRY"]
