"""Raft-lite region replication (ref: TiKV's raftstore, scaled to the
in-process store: every region is a raft group of peers — one leader, N-1
followers — kvproto metapb.Peer + raft_serverpb; the resolved-ts worker
advances a per-peer `safe_ts` that gates follower/stale reads, and
client-go's `tidb_replica_read` rides it).

What is REAL here and what is simulated, stated plainly:

  * There is ONE physical MVCC KV (`MemKV`) shared by every logical
    placement store — replication does not copy bytes. What the subsystem
    maintains is the *visibility contract*: a follower peer may serve a
    read at `start_ts` only when its `safe_ts >= start_ts`, exactly the
    check TiKV's replica read performs against the resolved-ts
    (components/resolved_ts). Because the KV is shared, a gated read is
    byte-identical to the leader's — the gate itself is what the chaos
    and stale-read tests verify.
  * Writes PROPOSE to the leader's per-region log: each commit appends an
    entry (the commit ts), followers ack it, and the entry commits on
    quorum (len(peers)//2 + 1). The `replica/drop-ack` failpoint drops a
    follower's ack (a partitioned peer); losing quorum is surfaced on the
    `tidb_tpu_replica_quorum_fail_total` counter and flips the group's
    `quorum_ok` — the PD's failover consults liveness for the same
    decision (leader transfer among live peers vs placement move).
  * Followers apply asynchronously: an acked entry advances the
    follower's `applied_ts` (== its safe_ts) unless `replica/apply-lag`
    is armed for its store — a lagging apply loop. The PD tick's
    replication phase is the catch-up driver (the resolved-ts worker
    analog): unarmed followers advance to the leader's committed
    watermark there, and per-store lag lands on the
    `tidb_tpu_replica_safe_ts_lag{store=}` gauge.

Lock order: Cluster._mu -> ReplicaManager._mu (split/merge/transfer
notify under the cluster lock). ReplicaManager therefore NEVER calls back
into Cluster while holding _mu — peer sets are snapshotted first.

Copy of `tidb_tpu/replication/raftlite.py` for the PyTorch port (imports
rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

# a leader always serves its own reads: its safe_ts is the group's
# committed watermark by definition, representable as "no gate"
QUORUM_SAFE_TS_MAX = 1 << 62


@dataclass
class ReplicationGroup:
    """One region's replication state (ref: raftstore PeerFsm + the
    resolved-ts region state). `applied_ts` carries FOLLOWER stores only;
    the leader's watermark is `committed_ts` itself."""

    region_id: int
    committed_ts: int = 0
    applied_ts: dict[int, int] = field(default_factory=dict)
    quorum_ok: bool = True
    log_len: int = 0  # committed entries proposed through this group


class ReplicaManager:
    """Replication state for every region of one TPUStore. The cluster
    owns the TOPOLOGY (who the peers are); this owns the DYNAMICS (what
    each peer has applied). `cluster.replica` points back here so
    split/merge/transfer propagate state like `pd.flow` does for stats."""

    def __init__(self, store):
        self.store = store
        self.cluster = store.cluster
        self._mu = threading.Lock()
        self._groups: dict[int, ReplicationGroup] = {}  # guarded_by: _mu
        self._reads: dict[int, int] = {}  # per-store routed reads; guarded_by: _mu
        self.cluster.replica = self

    # -- failpoint arming (non-consuming probes: a storm stays armed) -------
    def _lagging(self, store_id: int) -> bool:
        """True when `store_id`'s apply loop is wedged by failpoint
        (`replica/apply-lag`) — its safe_ts must not advance."""
        from ..store.store import _fault_matches
        from ..util import failpoint

        return _fault_matches(failpoint.peek("replica/apply-lag"), store_id)

    def _ack_dropped(self, store_id: int) -> bool:
        """True when `store_id`'s ack is dropped by failpoint
        (`replica/drop-ack`) — a partitioned follower for quorum math."""
        from ..store.store import _fault_matches
        from ..util import failpoint

        return _fault_matches(failpoint.peek("replica/drop-ack"), store_id)

    # -- group state --------------------------------------------------------
    def _group(self, region_id: int, followers: list[int]) -> ReplicationGroup:  # requires: _mu
        """Lazily bootstrap a group as FULLY replicated at the store's
        current commit watermark (snapshot replication: a fresh peer set
        starts from a snapshot, not an empty log). A follower this group
        has not MATERIALIZED yet has been replicating since the peer set
        formed — it joins caught up; real lag accrues only from proposals
        made while its apply loop is wedged."""
        g = self._groups.get(region_id)
        if g is None:
            now = self.store.kv.max_committed()
            g = self._groups[region_id] = ReplicationGroup(
                region_id, committed_ts=now,
                applied_ts={f: now for f in followers},
            )
        else:
            for f in followers:
                g.applied_ts.setdefault(f, g.committed_ts)
        return g

    def propose(self, region_id: int, ts: int,
                placement: tuple | None = None,
                entries: list | None = None) -> bool:
        """One committed write batch against `region_id` at `ts`: append
        to the leader's log, collect follower acks, commit on quorum, and
        advance every non-lagging follower's applied watermark (the
        common case applies synchronously — healthy raft on a fast LAN).
        `placement` is an optional pre-fetched (leader, peers) snapshot
        (the per-key write path already looked it up — don't take the
        cluster lock again). `entries` is the batch's change payload —
        [(key, value|None)] — handed to the CDC hub AFTER the group state
        settles (the changefeed puller rides this log exactly like TiCDC
        rides the raft log). Returns False when quorum was NOT reached
        (the write is still durable on the shared KV; the flag is what
        failover consults)."""
        return self.propose_group(region_id, [(ts, entries)],
                                  placement=placement)

    def propose_group(self, region_id: int, groups: list,
                      placement: tuple | None = None) -> bool:
        """Group commit: ONE log append / ack round / quorum
        decision covering several commits against `region_id`, each at its
        OWN timestamp — N coalesced sessions cost one raft-lite round
        instead of N. `groups` is [(commit_ts, entries|None)]; entries are
        delivered to the CDC hub per commit in ascending ts order, so the
        changefeed sees exactly the per-key event sequence N separate
        proposals would have produced."""
        from ..util import metrics

        if not groups:
            return True
        groups = sorted(groups, key=lambda g: g[0])
        first_ts = groups[0][0]
        last_ts = groups[-1][0]
        if placement is not None:
            leader, peers = placement
        else:
            leader = self.cluster.leader_of(region_id)
            peers = self.cluster.peers_of(region_id)
        followers = [p for p in peers if p != leader]
        quorum = len(peers) // 2 + 1
        with self._mu:
            g = self._group(region_id, followers)
            prev_committed = g.committed_ts
            g.committed_ts = max(g.committed_ts, last_ts)
            g.log_len += 1
            acks = 1  # the leader's own append
            for f in followers:
                dropped = self._ack_dropped(f)
                if not dropped:
                    acks += 1
                if not dropped and not self._lagging(f):
                    g.applied_ts[f] = g.committed_ts
                    continue
                # wedged follower: if it held the FULL log before this
                # entry, everything strictly below the new entry's ts
                # stays servable — but it must NEVER be credited with the
                # entry itself, so its watermark pins at ts - 1 (raft:
                # safe_ts = first-unapplied-entry's ts - 1). For a grouped
                # append the pin sits below the EARLIEST commit in the
                # batch — crediting any later lane would let a wedged
                # follower serve reads it never applied. The pin also
                # clamps the lazy-bootstrap over-credit when this very
                # proposal materialized the group (kv.max_committed()
                # already included the write).
                have = g.applied_ts.get(f, 0)
                if have >= prev_committed or have >= first_ts:
                    g.applied_ts[f] = first_ts - 1
            g.quorum_ok = acks >= quorum
            if not g.quorum_ok:
                metrics.REPLICA_QUORUM_FAILS.inc()
            ok = g.quorum_ok
        # CDC delivery OUTSIDE _mu (lock order: the hub's feed locks are
        # leaves; a subscriber must never nest inside replication state),
        # one on_proposal per lane so every event wears its own commit ts
        hub = getattr(self.store, "cdc", None)
        if hub is not None:
            for ts, entries in groups:
                if entries:
                    hub.on_proposal(region_id, ts, entries)
        return ok

    def check_write_quorum(self, region_id: int,
                           placement: tuple | None = None) -> None:
        """Live quorum roll call BEFORE a write applies (a write against a
        quorum-lost region must be REFUSED, not silently durable on the shared KV). Same roll call the PD
        tick's catch-up takes: the leader always acks its own append; a
        follower whose ack the `replica/drop-ack` failpoint drops is a
        partitioned peer. Raises the typed QuorumLostError (MySQL 9005 at
        the session boundary) and keeps the quorum-fail counter honest —
        a refused write is still a failed proposal attempt."""
        from ..store.errors import QuorumLostError
        from ..util import metrics

        if placement is not None:
            leader, peers = placement
        else:
            leader, peers = self.cluster.placement_of(region_id)
        followers = [p for p in peers if p != leader]
        quorum = len(peers) // 2 + 1
        acks = 1 + sum(1 for f in followers if not self._ack_dropped(f))
        if acks >= quorum:
            return
        metrics.REPLICA_QUORUM_FAILS.inc()
        with self._mu:
            g = self._groups.get(region_id)
            if g is not None:
                g.quorum_ok = False  # failover consults the latched flag
        raise QuorumLostError(region_id, acks, quorum)

    def safe_ts(self, region_id: int, store_id: int) -> int:
        """The watermark `store_id` may serve reads at for `region_id`
        (ref: resolved-ts; the store-side replica-read gate compares this
        against the request's start_ts). The leader always serves. A
        FULLY-APPLIED follower also serves any snapshot — it holds every
        committed version of the region, the reference's resolved-ts
        advancing with the clock between writes; only a follower whose
        apply trails the leader's committed watermark is pinned to what
        it has actually applied."""
        leader, peers = self.cluster.placement_of(region_id)
        if leader == store_id:
            return QUORUM_SAFE_TS_MAX
        if store_id not in peers:
            # not a peer (e.g. an in-flight request raced a re_place that
            # evicted this store): it holds nothing it may serve, and it
            # must not materialize a phantom watermark entry
            return 0
        with self._mu:
            g = self._groups.get(region_id)
            if g is None:
                # no proposals ever: the bootstrap snapshot covers all
                return QUORUM_SAFE_TS_MAX
            have = g.applied_ts.get(store_id)
            if have is None:
                # first sight of this peer: it has been replicating since
                # the peer set formed and has missed no tracked proposal
                have = g.applied_ts[store_id] = g.committed_ts
            return QUORUM_SAFE_TS_MAX if have >= g.committed_ts else have

    def quorum_ok(self, region_id: int) -> bool:
        with self._mu:
            g = self._groups.get(region_id)
            return g.quorum_ok if g is not None else True

    def best_transfer_target(self, region_id: int, candidates: list[int],
                             loads: dict | None = None) -> int:
        """Pick the leadership-transfer target among `candidates` (raft:
        only an up-to-date peer may win the election): fully-applied
        peers first, least-loaded among them; with none fully applied,
        the MOST-applied candidate (the reference's most-up-to-date-wins
        vote)."""
        loads = loads or {}
        up = [p for p in candidates
              if self.safe_ts(region_id, p) == QUORUM_SAFE_TS_MAX]
        if up:
            return min(up, key=lambda p: (loads.get(p, 0), p))
        return max(candidates, key=lambda p: (self.safe_ts(region_id, p), -p))

    # -- catch-up + observability (the PD tick's replication phase) ---------
    def catch_up(self) -> int:
        """Advance every unwedged follower to its leader's committed
        watermark (the resolved-ts worker's periodic advance) and refresh
        the per-store lag gauges. Returns the number of followers that
        moved."""
        from ..util import metrics

        regions = [r.region_id for r in self.cluster.regions()]
        topo = {rid: (self.cluster.leader_of(rid), self.cluster.peers_of(rid))
                for rid in regions}
        moved = 0
        lag_by_store: dict[int, int] = {s: 0 for s in range(self.cluster.n_stores)}
        with self._mu:
            # NO pruning against `topo` here: the snapshot above was read
            # outside _mu, so a region split concurrently with this tick
            # could look absent and lose its group — erasing a wedged
            # follower's watermark pin. Absorbed regions
            # are popped by on_merge under the cluster lock instead.
            for rid, (leader, peers) in topo.items():
                g = self._groups.get(rid)
                if g is None:
                    continue
                followers = [p for p in peers if p != leader]
                for f in followers:
                    have = g.applied_ts.get(f)
                    if have is None:
                        have = g.applied_ts[f] = g.committed_ts
                    if have < g.committed_ts and not self._lagging(f) \
                            and not self._ack_dropped(f):
                        g.applied_ts[f] = g.committed_ts
                        moved += 1
                    lag = max(g.committed_ts - g.applied_ts[f], 0)
                    lag_by_store[f] = max(lag_by_store.get(f, 0), lag)
                # re-take the quorum roll call: quorum_ok latched by the
                # LAST proposal would otherwise stay False forever on a
                # read-only workload after the ack-dropping storm clears,
                # degrading a healthy group's failover to a placement move
                g.quorum_ok = 1 + sum(
                    1 for f in followers if not self._ack_dropped(f)
                ) >= len(peers) // 2 + 1
        for sid, lag in lag_by_store.items():
            metrics.REPLICA_SAFE_TS_LAG.labels(str(sid)).set(lag)
        return moved

    def lag_view(self) -> dict[int, int]:
        """store_id -> worst follower safe_ts lag (ts units), for
        /pd/api/v1/stores and SHOW PLACEMENT."""
        out: dict[int, int] = {s: 0 for s in range(self.cluster.n_stores)}
        with self._mu:
            for g in self._groups.values():
                for f, have in g.applied_ts.items():
                    out[f] = max(out.get(f, 0), max(g.committed_ts - have, 0))
        return out

    # -- read routing load (closest-replica's tiebreak) ---------------------
    def note_read(self, store_id: int) -> None:
        with self._mu:
            self._reads[store_id] = self._reads.get(store_id, 0) + 1

    def read_counts(self) -> dict[int, int]:
        with self._mu:
            return dict(self._reads)

    # -- topology-change bookkeeping (called UNDER Cluster._mu) -------------
    def on_assign(self, region_id: int, peers: list[int], leader: int) -> None:
        """The peer set was (re)assigned (scatter, placement miss, move):
        materialize the new followers caught up at the committed
        watermark and drop state for peers that left the set."""
        with self._mu:
            g = self._groups.get(region_id)
            if g is None:
                return  # lazy bootstrap covers a group with no history
            for f in [p for p in peers if p != leader]:
                g.applied_ts.setdefault(f, g.committed_ts)
            for f in [f for f in list(g.applied_ts) if f not in peers or f == leader]:
                del g.applied_ts[f]

    def on_split(self, parent_id: int, child_id: int) -> None:
        """The child region inherits the parent's replication watermarks —
        peers stay put on a split, so what a follower had applied of the
        parent covers the child's keyspace too."""
        with self._mu:
            p = self._groups.get(parent_id)
            if p is None:
                return
            self._groups[child_id] = ReplicationGroup(
                child_id, committed_ts=p.committed_ts,
                applied_ts=dict(p.applied_ts), quorum_ok=p.quorum_ok,
                log_len=p.log_len,
            )

    def on_merge(self, left_id: int, right_id: int,
                 peers: list[int] | None = None, leader: int = -1) -> None:
        """The survivor's watermark must cover BOTH inputs: a follower
        serves the merged range only at ts it has applied for each half.
        A follower one side never tracked has no gap on that side — it
        counts as applied at that side's committed watermark, NOT at 0
        (a 0 default would manufacture phantom lag). The
        merged group keeps only the SURVIVOR's peer set."""
        with self._mu:
            right = self._groups.pop(right_id, None)
            left = self._groups.get(left_id)
            if right is None or left is None:
                return
            lc, rc = left.committed_ts, right.committed_ts
            for f in set(left.applied_ts) | set(right.applied_ts):
                left.applied_ts[f] = min(left.applied_ts.get(f, lc),
                                         right.applied_ts.get(f, rc))
            left.committed_ts = max(lc, rc)
            left.quorum_ok = left.quorum_ok and right.quorum_ok
            if peers is not None:
                for f in [f for f in list(left.applied_ts)
                          if f not in peers or f == leader]:
                    del left.applied_ts[f]

    def on_transfer(self, region_id: int, old_leader: int, new_leader: int) -> None:
        """Leadership moved (ref: raft TransferLeader — only an up-to-date
        peer may win): the new leader serves from the committed watermark
        by construction; the old leader becomes a fully-applied follower
        (it WAS the leader — it has everything)."""
        with self._mu:
            g = self._groups.get(region_id)
            if g is None:
                return
            g.applied_ts.pop(new_leader, None)
            g.applied_ts[old_leader] = g.committed_ts

    def on_replace(self, region_id: int, peers: list[int], leader: int) -> None:
        """The peer set was rebuilt (quorum-loss placement move): state
        restarts from a fresh snapshot on the new peers."""
        with self._mu:
            now = self.store.kv.max_committed()
            self._groups[region_id] = ReplicationGroup(
                region_id, committed_ts=now,
                applied_ts={p: now for p in peers if p != leader},
            )
