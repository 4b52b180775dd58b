"""Range-sharded regions (ref: unistore cluster.go:45 Cluster, mockstore
region splitting).

Regions are the unit of data parallelism: the distsql layer splits a scan
into per-region tasks (ref: copr/coprocessor.go:331 buildCopTasks) and the
mesh layer maps regions onto TPU devices (SURVEY.md §2.5). Epochs support
the region-error/retry path: a split bumps the epoch, in-flight tasks with
the stale epoch get EpochNotMatch and re-split, mirroring
copr/coprocessor.go:1424 handleCopResponse. Merges bump the
surviving epoch and delete the absorbed region, so stale tasks surface
either EpochNotMatch or region-not-found — both re-split cleanly.

Placement (region -> store) lives in an authoritative map owned by the
placement driver (`tidb_tpu/pd`): a split child inherits its parent's
store (peers stay put, like TiKV), and a lookup miss is routed through
`PlacementDriver.place_region()` — a recorded least-loaded decision, not
a silent `region_id % n_stores` guess. All cluster state is
lock-protected: the PD tick mutates topology from a background Timer
thread while cop dispatch reads it.

Every region also carries a PEER SET (ref: metapb.Region's
peers — one leader + up to `max_replicas - 1` followers): `_store_of`
remains the LEADER view (back-compat: `store_of == leader_of`), `_peers`
holds the full set, and every placement decision — bootstrap, scatter,
split inheritance, miss placement, moves — routes through ONE shared
helper (`_assign_locked`/`_inherit_locked`) so leader map and peer sets
can never drift apart. `transfer_leader` moves leadership WITHIN the peer
set without an epoch bump (raft leadership is not a topology change;
in-flight tasks get NotLeader with a usable hint instead of a re-split).

Copy of `tidb_tpu/store/region.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field, replace

KEY_MAX = b"\xff" * 32


@dataclass
class Region:
    region_id: int
    start_key: bytes
    end_key: bytes
    epoch: int = 1

    def contains(self, key: bytes) -> bool:
        return self.start_key <= key < (self.end_key or KEY_MAX)


class Cluster:
    """All regions, sorted by start key, covering [b'', KEY_MAX).

    Region->store placement (stores are the TPU-chip analog of
    TiKV/TiFlash stores) is authoritative: `scatter()` is the bootstrap
    round-robin (ref: PD scatter-region), after which the PD's
    schedulers own every change via `set_store`/`split`/`merge`."""

    def __init__(self, n_stores: int = 1, max_replicas: int = 3):
        self._regions: list[Region] = [Region(1, b"", KEY_MAX)]  # guarded_by: _mu
        self._next_id = 2  # guarded_by: _mu
        self.n_stores = max(n_stores, 1)
        self.max_replicas = max(max_replicas, 1)  # replication.max_replicas
        self._store_of: dict[int, int] = {}  # LEADER view; guarded_by: _mu
        self._peers: dict[int, list[int]] = {}  # full peer sets; guarded_by: _mu
        self._mu = threading.RLock()
        self.pd = None  # PlacementDriver; owns placement misses when attached
        self.replica = None  # ReplicaManager; tracks per-peer safe_ts
        self.cdc = None  # ChangefeedHub; resolved-ts watermarks follow
        # splits/merges the same way flow stats and replica watermarks do
        with self._mu:
            self._assign_locked(1, 0)

    def set_stores(self, n: int):
        with self._mu:
            self.n_stores = max(n, 1)
        self.scatter()

    # -- the ONE placement primitive -----------------------------------------
    def _replica_count(self) -> int:  # requires: _mu
        return min(self.max_replicas, self.n_stores)

    def _assign_locked(self, region_id: int, leader: int) -> None:  # requires: _mu
        """THE shared placement helper: record `leader` and derive the
        peer set (leader + the next replica-count-1 stores round-robin,
        the scatter-time peer layout). Bootstrap (`__init__`), `scatter`,
        miss placement and moves all route through here so the leader map
        and the peer sets cannot drift apart."""
        leader = leader % self.n_stores
        self._store_of[region_id] = leader
        r = self._replica_count()
        self._peers[region_id] = [(leader + k) % self.n_stores for k in range(r)]
        if self.replica is not None:
            self.replica.on_assign(region_id, self._peers[region_id], leader)

    def _inherit_locked(self, parent_id: int, child_id: int) -> None:  # requires: _mu
        """Split inheritance: the child keeps the parent's leader AND peer
        set verbatim — peers stay put on a split; rebalancing is a
        separate PD decision."""
        self._store_of[child_id] = self._store_of.get(parent_id, 0)
        self._peers[child_id] = list(self._peers.get(
            parent_id, [self._store_of.get(parent_id, 0)]))

    def store_of(self, region_id: int) -> int:
        """Authoritative placement lookup — the LEADER view (back-compat
        alias of `leader_of`). A miss is NOT answered with a modulo
        guess: it routes through the PD (recorded least-loaded placement)
        so every subsequent lookup agrees."""
        with self._mu:
            sid = self._store_of.get(region_id)
        if sid is not None:
            return sid
        if self.pd is not None:
            return self.pd.place_region(region_id)
        return self.place_least_loaded(region_id)

    def leader_of(self, region_id: int) -> int:
        """The region's leader store (what `store_of` has always meant)."""
        return self.store_of(region_id)

    def peers_of(self, region_id: int) -> list[int]:
        """The region's full peer set, leader included (ref:
        metapb.Region peers). A miss places first (same authority chain
        as `store_of`)."""
        with self._mu:
            peers = self._peers.get(region_id)
            if peers is not None:
                return list(peers)
        self.store_of(region_id)  # drives the placement decision
        with self._mu:
            return list(self._peers.get(region_id, [self._store_of.get(region_id, 0)]))

    def followers_of(self, region_id: int) -> list[int]:
        leader = self.leader_of(region_id)
        return [p for p in self.peers_of(region_id) if p != leader]

    def locate_placement(self, key: bytes) -> tuple[int, int, list[int]]:
        """(region_id, leader, peers) of the region holding `key` in ONE
        lock acquisition — the per-key write path's lookup (locate +
        leader_of + peers_of would take the lock three times per put)."""
        with self._mu:
            rid = self._regions[self._locate(key)].region_id
            leader = self._store_of.get(rid, 0)
            return rid, leader, list(self._peers.get(rid, [leader]))

    def placement_of(self, region_id: int) -> tuple[int, list[int]]:
        """(leader, peers) of one region in ONE lock acquisition (the
        safe_ts gate's lookup). Falls back to (0, [0]) for an unknown
        region WITHOUT driving a placement decision — gate queries must
        stay read-only."""
        with self._mu:
            leader = self._store_of.get(region_id, 0)
            return leader, list(self._peers.get(region_id, [leader]))

    def regions_of_keys(self, keys) -> set:
        """Region ids covering `keys` in ONE lock acquisition — the bulk
        commit path's replication-proposal grouping (a locate() per key
        would take the lock N times)."""
        with self._mu:
            return {self._regions[self._locate(k)].region_id for k in keys}

    def group_keys_by_region(self, keys) -> dict:
        """region_id -> [keys] in ONE lock acquisition — the bulk commit
        path's per-region change batching (each region's replication
        proposal carries exactly its own keys, so the CDC puller sees the
        log sharded the way the raft log is)."""
        out: dict[int, list] = {}
        with self._mu:
            for k in keys:
                out.setdefault(self._regions[self._locate(k)].region_id, []).append(k)
        return out

    def placements_of_keys(self, keys) -> dict:
        """region_id -> (leader, peers) for every region covering `keys`
        in ONE lock acquisition — the write-quorum gate's lookup (a
        placement_of() per touched region would re-take the lock N
        times on the hot commit path)."""
        out: dict[int, tuple] = {}
        with self._mu:
            for k in keys:
                rid = self._regions[self._locate(k)].region_id
                if rid not in out:
                    leader = self._store_of.get(rid, 0)
                    out[rid] = (leader, list(self._peers.get(rid, [leader])))
        return out

    def place_least_loaded(self, region_id: int) -> int:
        """Place one region on the store with the fewest leaders and
        record the decision (the PD's placement primitive; also the
        standalone-Cluster fallback when no PD is attached)."""
        with self._mu:
            counts = {i: 0 for i in range(self.n_stores)}
            for r in self._regions:
                sid = self._store_of.get(r.region_id)
                if sid is not None:
                    counts[sid] = counts.get(sid, 0) + 1
            target = min(range(self.n_stores), key=lambda i: counts.get(i, 0))
            if any(r.region_id == region_id for r in self._regions):
                self._assign_locked(region_id, target)
            return target

    def set_store(self, region_id: int, store_id: int) -> None:
        """Move a region's leader placement (the PD move-operator
        primitive). A move to an existing peer is a leader change within
        the set; a move elsewhere swaps the old leader peer out for the
        target (the add-then-remove peer dance collapsed to one step)."""
        with self._mu:
            old = self._store_of.get(region_id)
            self._store_of[region_id] = store_id
            peers = self._peers.get(region_id)
            if peers is None:
                self._assign_locked(region_id, store_id)
            else:
                if store_id not in peers:
                    self._peers[region_id] = [
                        store_id if p == old else p for p in peers
                    ] if old in peers else [store_id] + peers[1:]
                if self.replica is not None and store_id != old:
                    # the new leader's follower watermark must not linger
                    # (it would read as phantom safe_ts lag forever) and
                    # the old leader joins as a follower
                    self.replica.on_assign(region_id, self._peers[region_id],
                                           store_id)

    def transfer_leader(self, region_id: int, store_id: int) -> bool:
        """Move leadership WITHIN the peer set (ref: raft TransferLeader
        via pd's transfer-leader operator). No epoch bump — leadership is
        not a topology change; in-flight tasks at the old leader get
        NotLeader with the new leader as a usable hint. Returns False
        when `store_id` is not a peer (or already leads)."""
        with self._mu:
            peers = self._peers.get(region_id)
            old = self._store_of.get(region_id)
            if peers is None or store_id not in peers or old == store_id:
                return False
            self._store_of[region_id] = store_id
            if self.replica is not None:
                self.replica.on_transfer(region_id, old, store_id)
            return True

    def re_place(self, region_id: int, leader: int, avoid=frozenset()) -> None:
        """Rebuild a region's peer set from scratch around `leader`,
        avoiding `avoid` stores — the quorum-loss escape hatch (majority
        of peers dead: no leader transfer can win, so the PD re-places
        the whole group on healthy stores, a fresh-snapshot bootstrap)."""
        with self._mu:
            healthy = [s for s in range(self.n_stores)
                       if s != leader and s not in avoid]
            r = self._replica_count()
            peers = [leader] + healthy[: max(r - 1, 0)]
            self._store_of[region_id] = leader
            self._peers[region_id] = peers
            if self.replica is not None:
                self.replica.on_replace(region_id, peers, leader)

    def counts_per_store(self) -> dict[int, int]:
        """Leaders per store (the historical region count — a region
        'lives' where it leads)."""
        with self._mu:
            counts = {i: 0 for i in range(self.n_stores)}
            for r in self._regions:
                sid = self._store_of.get(r.region_id)
                if sid is not None:
                    counts[sid] = counts.get(sid, 0) + 1
            return counts

    def peer_counts_per_store(self) -> dict[int, int]:
        """Peers (leader + follower replicas) per store."""
        with self._mu:
            counts = {i: 0 for i in range(self.n_stores)}
            for r in self._regions:
                for p in self._peers.get(r.region_id, ()):
                    counts[p] = counts.get(p, 0) + 1
            return counts

    def scatter(self):
        """Round-robin region->store placement (ref: PD scatter-region;
        bootstrap-time only — steady state belongs to the schedulers).
        Routes through the shared helper, so peer sets scatter with the
        leaders."""
        with self._mu:
            for i, r in enumerate(self._regions):
                self._assign_locked(r.region_id, i % self.n_stores)

    def regions(self) -> list[Region]:
        with self._mu:
            return list(self._regions)

    def region_by_id(self, rid: int) -> Region | None:
        with self._mu:
            for r in self._regions:
                if r.region_id == rid:
                    return r
            return None

    def region_snapshot(self, rid: int) -> Region | None:
        """A copy of the region as it stands, taken under the lock. A
        split or merge mutates its Region in place, so a request that
        checked its epoch against the live object could then read the
        bounds of a later epoch (half its range). The store checks and
        reads one snapshot instead."""
        with self._mu:
            r = self.region_by_id(rid)
            return None if r is None else replace(r)

    def split(self, key: bytes) -> Region:
        """Split the region containing `key` at `key`; bumps both epochs
        (ref: mockstore SplitKeys). The child inherits the parent's store
        — a split keeps peers in place; rebalancing is a separate PD
        decision (ref: TiKV split + balance-region)."""
        with self._mu:
            i = self._locate(key)
            r = self._regions[i]
            if r.start_key == key:
                return r
            new = Region(self._next_id, key, r.end_key, epoch=r.epoch + 1)
            self._next_id += 1
            r.end_key = key
            r.epoch += 1
            self._regions.insert(i + 1, new)
            self._inherit_locked(r.region_id, new.region_id)
            if self.pd is not None:  # stats follow the topology, whoever
                # initiated the split (PD operator, DDL pre-split, tests)
                self.pd.flow.on_split(r.region_id, new.region_id)
            if self.replica is not None:  # watermarks follow peers
                self.replica.on_split(r.region_id, new.region_id)
            if self.cdc is not None:  # the child's resolved watermark
                # inherits the parent's (the sorter hand-off on a split)
                self.cdc.on_split(r.region_id, new.region_id)
            return new

    def merge(self, left_id: int, right_id: int | None = None) -> Region | None:
        """Fold the region right of `left_id` into it (ref: pd
        merge-checker -> TiKV PrepareMerge/CommitMerge collapsed to one
        step). The survivor keeps the left placement and bumps its epoch
        past both inputs; the absorbed region disappears, so stale tasks
        on it get region-not-found and re-split. When `right_id` is
        given, the merge only proceeds if it still names the immediate
        right neighbor (operator-staleness guard). Returns the merged
        region, or None if the merge cannot happen."""
        with self._mu:
            for i, r in enumerate(self._regions):
                if r.region_id == left_id:
                    break
            else:
                return None
            if i + 1 >= len(self._regions):
                return None  # rightmost region has no merge partner
            right = self._regions[i + 1]
            if right_id is not None and right.region_id != right_id:
                return None
            r.end_key = right.end_key
            r.epoch = max(r.epoch, right.epoch) + 1
            del self._regions[i + 1]
            self._store_of.pop(right.region_id, None)
            self._peers.pop(right.region_id, None)
            if self.pd is not None:
                self.pd.flow.on_merge(r.region_id, right.region_id)
            if self.replica is not None:  # survivor watermark = min of both
                self.replica.on_merge(
                    r.region_id, right.region_id,
                    peers=list(self._peers.get(r.region_id, ())),
                    leader=self._store_of.get(r.region_id, -1))
            if self.cdc is not None:  # survivor resolved watermark covers
                # BOTH inputs — min of the two (the sorter hand-off)
                self.cdc.on_merge(r.region_id, right.region_id)
            return r

    def split_n(self, start: bytes, end: bytes, n: int, keyfn):
        """Split [start, end) into n regions using keyfn(i) boundaries."""
        for i in range(1, n):
            self.split(keyfn(i))

    def _locate(self, key: bytes) -> int:  # requires: _mu
        starts = [r.start_key for r in self._regions]
        i = bisect.bisect_right(starts, key) - 1
        return max(i, 0)

    def locate(self, key: bytes) -> Region:
        with self._mu:
            return self._regions[self._locate(key)]

    def regions_in_range(self, start: bytes, end: bytes) -> list[Region]:
        out = []
        with self._mu:
            for r in self._regions:
                if (r.end_key or KEY_MAX) <= start:
                    continue
                if r.start_key >= end:
                    break
                out.append(r)
        return out
