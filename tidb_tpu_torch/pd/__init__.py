"""Placement Driver — the control plane over the region data plane
(ref: tikv/pd — server/cluster coordinator, statistics/hot_peer_cache.go,
schedule/operator + checker/split_checker, merge_checker, and the
balance-region / hot-region schedulers; mock seam: unistore/pd.go).

Placement is not a static round-robin `Cluster.scatter()`; this package
runs the reference's feedback loop:

  flow.py        per-region read/write flow recorded by the store's
                 coprocessor and txn write paths, drained as heartbeat
                 snapshots (ref: pdpb.RegionHeartbeatRequest fields
                 bytes_read/bytes_written/keys_read/keys_written,
                 approximate_size/approximate_keys)
  core.py        the PD itself: decaying hot-peer caches, a bounded
                 operator queue, the Timer-driven tick loop, and the
                 views behind /pd/api/v1/* and SHOW PLACEMENT
  schedulers.py  split-checker, merge-checker, balance-region and
                 hot-region schedulers proposing operators each tick

Placement is authoritative here: `Cluster.store_of()` misses route through
`PlacementDriver.place_region()` instead of a silent `region_id % n_stores`
guess.

Copy of `tidb_tpu/pd/` for the PyTorch port (imports rewritten; it imports
nothing of tidb_tpu). The tick's pd.pitr phase runs `br.pitr_tick`.
"""

from .core import Operator, OperatorQueue, PDConfig, PlacementDriver
from .flow import FlowRecorder, RegionFlow, RegionHeartbeat

__all__ = [
    "FlowRecorder",
    "Operator",
    "OperatorQueue",
    "PDConfig",
    "PlacementDriver",
    "RegionFlow",
    "RegionHeartbeat",
]
