"""Region replication — the raft-lite overlay that gives every region a
peer set (one leader + followers), quorum-acked writes, and per-peer
`safe_ts` watermarks that gate replica reads.

Copy of `tidb_tpu/replication/` for the PyTorch port (imports rewritten; it
imports nothing of tidb_tpu)."""

from .raftlite import QUORUM_SAFE_TS_MAX, ReplicaManager, ReplicationGroup

__all__ = ["ReplicaManager", "ReplicationGroup", "QUORUM_SAFE_TS_MAX"]
