"""Distributed SQL over the port's store (port of tidb_tpu/distsql/): the
region dispatch loop (dispatch.py: tiers, paging, region-error retry,
breakers, backoff), its planner (planner.py), the runaway checker
(runaway.py) and the root executor (root.py: split_dag, execute_root)."""

from .dispatch import (
    BreakerBoard,
    CircuitBreaker,
    CopInternalError,
    KVRequest,
    RegionUnavailableError,
    SelectResult,
    select,
    select_stream,
    full_table_ranges,
    handle_ranges,
)
from .root import RootPlan, execute_root, split_dag

__all__ = [
    "KVRequest",
    "SelectResult",
    "select",
    "select_stream",
    "full_table_ranges",
    "handle_ranges",
    "RootPlan",
    "execute_root",
    "split_dag",
    "BreakerBoard",
    "CircuitBreaker",
    "RegionUnavailableError",
    "CopInternalError",
]
