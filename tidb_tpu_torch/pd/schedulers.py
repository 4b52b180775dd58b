"""PD checkers and schedulers — each proposes operators from the current
statistics; the PD tick owns admission (bounded queue, one operator per
region) and execution (ref: pd schedule/checker/{split,merge}_checker.go
and schedulers/{balance_region,hot_region}.go; each scheduler's
Schedule() returns a small batch of operators per round).

Copy of `tidb_tpu/pd/schedulers.py` for the PyTorch port."""

from __future__ import annotations

from .core import Operator


class SplitChecker:
    """Regions whose approximate size or key count exceed the limits get
    a split operator (ref: checker/split_checker + TiKV's size-based
    split check). The split bumps the region epoch, so in-flight cop
    tasks surface EpochNotMatch and re-split through the distsql retry
    path — the data plane's own contract."""

    name = "split-checker"

    def schedule(self, pd) -> list[Operator]:
        ops = []
        stats = pd.flow.stats()
        for r in pd.cluster.regions():
            size, keys = stats.get(r.region_id, (0, 0))
            if size > pd.conf.max_region_size or keys > pd.conf.max_region_keys:
                ops.append(pd.new_operator(
                    "split", r.region_id,
                    note=f"size={size} keys={keys}",
                ))
        return ops


class MergeChecker:
    """Adjacent tiny/empty regions fold into one (ref:
    checker/merge_checker.go — both peers must be below the merge bounds;
    the survivor keeps the left region's placement). The first region is
    never absorbed, mirroring the reference's new-region protection."""

    name = "merge-checker"

    def schedule(self, pd) -> list[Operator]:
        ops = []
        stats = pd.flow.stats()
        regions = pd.cluster.regions()
        i = 0
        while i + 1 < len(regions):
            left, right = regions[i], regions[i + 1]
            lsize, lkeys = stats.get(left.region_id, (0, 0))
            rsize, rkeys = stats.get(right.region_id, (0, 0))
            if (lsize <= pd.conf.merge_region_size and lkeys <= pd.conf.merge_region_keys
                    and rsize <= pd.conf.merge_region_size and rkeys <= pd.conf.merge_region_keys):
                ops.append(pd.new_operator(
                    "merge", left.region_id, peer_region=right.region_id,
                    note=f"keys={lkeys}+{rkeys}",
                ))
                i += 2  # the pair is spoken for this round
            else:
                i += 1
        return ops


class BalanceRegionScheduler:
    """Even the region count across stores by moving the coldest regions
    off the most loaded store (ref: schedulers/balance_region.go — the
    reference balances a size score; region count is our size analog
    since regions are the TPU work unit). Proposes a batch per tick
    against a simulated count map so one tick can close a large gap."""

    name = "balance-region-scheduler"

    def schedule(self, pd) -> list[Operator]:
        cluster = pd.cluster
        regions = cluster.regions()
        if cluster.n_stores < 2 or not regions:
            return []
        counts = {s: 0 for s in range(cluster.n_stores)}
        by_store: dict[int, list] = {s: [] for s in range(cluster.n_stores)}
        for r in regions:
            sid = cluster.store_of(r.region_id)
            counts[sid] = counts.get(sid, 0) + 1
            by_store.setdefault(sid, []).append(r)
        # coldest first within each store: moving quiet regions is cheap
        heat = pd.hot_read.rates()
        for rid, rate in pd.hot_write.rates().items():
            heat[rid] = heat.get(rid, 0.0) + rate
        for lst in by_store.values():
            lst.sort(key=lambda r: heat.get(r.region_id, 0.0))
        ops = []
        while len(ops) < pd.conf.ops_per_tick:
            src = max(counts, key=counts.get)
            dst = min(counts, key=counts.get)
            if counts[src] - counts[dst] <= pd.conf.balance_tolerance or not by_store[src]:
                break
            region = by_store[src].pop(0)
            ops.append(pd.new_operator(
                "move-region", region.region_id, source=src, target=dst,
                note=f"count {counts[src]}->{counts[dst]}",
            ))
            counts[src] -= 1
            counts[dst] += 1
        return ops


class LeaderBalanceScheduler:
    """Even LEADER counts across stores by transferring leadership to
    follower peers on leader-light stores (ref: schedulers/
    balance_leader.go — leadership moves are cheap, no data moves, so
    this runs before region moves get considered). Only regions with a
    follower peer on the destination store are candidates: a transfer
    must stay within the peer set."""

    name = "leader-balance-scheduler"

    def schedule(self, pd) -> list[Operator]:
        from ..replication import QUORUM_SAFE_TS_MAX

        cluster = pd.cluster
        regions = cluster.regions()
        if cluster.n_stores < 2 or not regions:
            return []
        # never balance ONTO a dead store: a down store's leaders failed
        # over away, so its zero count would otherwise make it the
        # destination every round and every proposal would cancel at the
        # apply-time ping (same rationale as _apply_move's guard)
        live = [s for s in range(cluster.n_stores) if pd.store.ping_store(s)]
        if len(live) < 2:
            return []
        repl = getattr(pd.store, "replication", None)
        counts = {s: 0 for s in live}
        by_leader: dict[int, list] = {s: [] for s in live}
        for r in regions:
            sid = cluster.leader_of(r.region_id)
            if sid in counts:
                counts[sid] = counts.get(sid, 0) + 1
                by_leader.setdefault(sid, []).append(r)
        ops = []
        while len(ops) < pd.conf.ops_per_tick:
            src = max(counts, key=counts.get)
            dst = min(counts, key=counts.get)
            if counts[src] - counts[dst] <= pd.conf.balance_tolerance:
                break
            movable = [r for r in by_leader[src]
                       if dst in cluster.peers_of(r.region_id)
                       and (repl is None or repl.safe_ts(
                           r.region_id, dst) == QUORUM_SAFE_TS_MAX)]
            if not movable:
                break  # no caught-up peer on the light store
            region = movable[0]
            by_leader[src].remove(region)
            ops.append(pd.new_operator(
                "transfer-leader", region.region_id, source=src, target=dst,
                note=f"leaders {counts[src]}->{counts[dst]}",
            ))
            counts[src] -= 1
            counts[dst] += 1
        return ops


class HotRegionScheduler:
    """Move the hottest peer off the most flow-loaded store (ref:
    schedulers/hot_region.go — byte-rate dominant dimension). One
    operator per tick: hot placement oscillates if moved greedily, so the
    2x source/destination guard plus the hot-degree hysteresis in the
    cache keep it damped."""

    name = "hot-region-scheduler"

    def schedule(self, pd) -> list[Operator]:
        cluster = pd.cluster
        if cluster.n_stores < 2:
            return []
        peers = pd.hot_write.hot_peers() + pd.hot_read.hot_peers()
        if not peers:
            return []
        load = {s: 0.0 for s in range(cluster.n_stores)}
        by_store: dict[int, list] = {s: [] for s in range(cluster.n_stores)}
        seen = set()
        for p in peers:
            if p.region_id in seen or cluster.region_by_id(p.region_id) is None:
                continue
            seen.add(p.region_id)
            sid = cluster.store_of(p.region_id)
            load[sid] = load.get(sid, 0.0) + p.byte_rate
            by_store.setdefault(sid, []).append(p)
        src = max(load, key=load.get)
        dst = min(load, key=load.get)
        movable = by_store.get(src, [])
        if len(movable) < len(by_store.get(dst, [])) + 2:
            # moving the only hot peer just relocates the hotspot — only
            # move when the source actually has peers to spare (damping)
            return []
        hottest = movable[0]
        return [pd.new_operator(
            "move-hot-region", hottest.region_id, source=src, target=dst,
            note=f"byte_rate={hottest.byte_rate:.0f}",
        )]
