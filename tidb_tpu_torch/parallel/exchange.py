"""The exchange operator's historical import path (port of
tidb_tpu/parallel/exchange.py): it lives in mpp/exchange_op.py, the one
home of the hash partitioner, the scatter / all_to_all / flatten sequence
and the exchange modes (hash / broadcast / passthrough)."""

from __future__ import annotations

from ..mpp.exchange_op import (  # noqa: F401 — re-exports
    FNV_OFFSET,
    FNV_PRIME,
    broadcast_exchange,
    exchange_arrays,
    exchange_compvals,
    exchange_group_aggregate,
    hash_partition_ids,
    passthrough_exchange,
    scatter_to_buckets,
)

__all__ = [
    "FNV_OFFSET",
    "FNV_PRIME",
    "broadcast_exchange",
    "exchange_arrays",
    "exchange_compvals",
    "exchange_group_aggregate",
    "hash_partition_ids",
    "passthrough_exchange",
    "scatter_to_buckets",
]
