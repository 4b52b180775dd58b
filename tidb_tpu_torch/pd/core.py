"""The Placement Driver core: hot-peer statistics, the bounded operator
queue, and the tick loop that turns heartbeats into placement actions
(ref: pd server/cluster/coordinator.go runs checkers+schedulers per
region; statistics/hot_peer_cache.go keeps decaying flow averages with a
hot-degree counter; schedule/operator has the bounded operator controller
with TTL expiry).

One tick = one PD scheduling round:

  heartbeat   drain the FlowRecorder (failpoint `pd/heartbeat-lost` drops
              the interval on the floor, like a lost heartbeat stream)
  statistics  feed the read/write hot-peer caches, refresh region stats
  checkers    split-checker + merge-checker propose structural operators
  schedulers  balance-region + hot-region propose movement operators
  dispatch    execute up to `ops_per_tick` queued operators against the
              cluster (split/merge bump epochs, so in-flight cop tasks
              take the existing EpochNotMatch re-split retry path);
              stale operators expire (failpoint `pd/operator-timeout`
              expires every pending operator immediately)

Everything is observable: `pd_operator_total{type=}` counts proposals,
`pd_hot_region{store=}` gauges hot peers per store, and each tick emits a
`pd.tick` trace with per-phase child spans.

Copy of `tidb_tpu/pd/core.py` for the PyTorch port (imports rewritten; it
imports nothing of tidb_tpu)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .flow import FlowRecorder, RegionHeartbeat

KV_MAX_TS = (1 << 62)  # "latest" snapshot for PD-side key sampling


@dataclass
class PDConfig:
    """Scheduling knobs (ref: pd config ScheduleConfig; sizes scaled down
    from the reference's 96MiB/960k-key region defaults to the in-process
    scale)."""

    tick_interval: float = 10.0  # seconds between Timer ticks
    max_region_size: int = 1 << 22  # bytes; split-checker threshold
    max_region_keys: int = 1 << 16  # keys; split-checker threshold
    merge_region_size: int = 1 << 10  # bytes; merge-checker "tiny" bound
    merge_region_keys: int = 16  # keys; merge-checker "tiny" bound
    balance_tolerance: int = 1  # allowed max-min region-count gap
    hot_decay: float = 0.8  # EWMA weight on the previous average
    hot_byte_rate: float = 1024.0  # bytes/tick considered hot
    hot_min_degree: int = 2  # ticks above threshold before "hot"
    operator_limit: int = 64  # queue bound (excess proposals dropped)
    operator_ttl_ticks: int = 16  # pending longer than this -> timeout
    ops_per_tick: int = 8  # operators dispatched per tick


# ---------------------------------------------------------------- hot peers

@dataclass
class HotPeer:
    """Decayed flow average of one region (ref: statistics/hot_peer_cache
    HotPeerStat: rolling byte/key rates + HotDegree/AntiCount)."""

    region_id: int
    byte_rate: float = 0.0
    key_rate: float = 0.0
    degree: int = 0


class HotPeerCache:
    """One cache per flow kind (read / write). Each heartbeat updates the
    EWMA rate; sustained rate above `hot_byte_rate` grows the hot degree,
    quiet intervals shrink it — a region must stay hot for
    `hot_min_degree` ticks before the scheduler believes it (the
    reference's HotDegree/AntiCount hysteresis)."""

    def __init__(self, kind: str, conf: PDConfig):
        self.kind = kind
        self.conf = conf
        self.peers: dict[int, HotPeer] = {}  # guarded_by: _mu
        # the PD timer thread updates while session/HTTP threads read
        # (SHOW PLACEMENT, /pd/api/v1/hotspot) — snapshot under the lock
        self._mu = threading.Lock()

    def update(self, region_id: int, byte_delta: int, key_delta: int) -> None:
        with self._mu:
            p = self.peers.get(region_id)
            if p is None:
                p = self.peers[region_id] = HotPeer(region_id)
            a = self.conf.hot_decay
            p.byte_rate = a * p.byte_rate + (1.0 - a) * float(byte_delta)
            p.key_rate = a * p.key_rate + (1.0 - a) * float(key_delta)
            if p.byte_rate >= self.conf.hot_byte_rate:
                p.degree += 1
            else:
                p.degree -= 1
            if p.degree <= 0 and p.byte_rate < self.conf.hot_byte_rate / 4:
                del self.peers[region_id]
            else:
                p.degree = max(p.degree, 0)

    def prune(self, live: set) -> None:
        with self._mu:
            for rid in [rid for rid in self.peers if rid not in live]:
                del self.peers[rid]

    def hot_peers(self) -> list[HotPeer]:
        """Peers past the degree hysteresis, hottest first (copies — the
        cache keeps mutating under its own lock)."""
        with self._mu:
            out = [
                HotPeer(p.region_id, p.byte_rate, p.key_rate, p.degree)
                for p in self.peers.values()
                if p.degree >= self.conf.hot_min_degree
            ]
        out.sort(key=lambda p: -p.byte_rate)
        return out

    def rates(self) -> dict[int, float]:
        """region_id -> decayed byte rate, every tracked peer (the
        balance scheduler's coldness key)."""
        with self._mu:
            return {rid: p.byte_rate for rid, p in self.peers.items()}


# ---------------------------------------------------------------- operators

@dataclass
class Operator:
    """One placement action (ref: schedule/operator.Operator). `kind` is
    the pd_operator_total label: split / merge / move-region (balance) /
    move-hot-region."""

    op_id: int
    kind: str
    region_id: int
    source: int = -1  # store id (moves)
    target: int = -1  # store id (moves)
    peer_region: int = -1  # the absorbed region (merge)
    state: str = "pending"  # pending -> finished | cancelled | timeout
    created_tick: int = 0
    note: str = ""


class OperatorQueue:
    """Bounded FIFO with one-operator-per-region admission (ref: the
    operator controller's region lock: a region with a pending operator
    does not accept another)."""

    def __init__(self, limit: int):
        self.limit = limit
        self._mu = threading.Lock()
        self._pending: list[Operator] = []  # guarded_by: _mu
        self.history: list[Operator] = []  # finished/cancelled/timeout ring; guarded_by: _mu
        self._history_max = 128

    def add(self, op: Operator) -> bool:
        with self._mu:
            if len(self._pending) >= self.limit:
                return False
            busy = {o.region_id for o in self._pending} | {
                o.peer_region for o in self._pending if o.peer_region >= 0
            }
            if op.region_id in busy or (op.peer_region >= 0 and op.peer_region in busy):
                return False
            self._pending.append(op)
            return True

    def pop_batch(self, n: int) -> list[Operator]:
        with self._mu:
            batch, self._pending = self._pending[:n], self._pending[n:]
            return batch

    def pending(self) -> list[Operator]:
        with self._mu:
            return list(self._pending)

    def history_view(self) -> list[Operator]:
        """Locked snapshot of the retired-operator ring (/pd/api/v1/operators
        must not iterate `history` raw while retire() appends from the
        tick thread)."""
        with self._mu:
            return list(self.history)

    def retire(self, op: Operator, state: str, note: str = "") -> None:
        op.state = state
        if note:
            op.note = note
        with self._mu:
            self.history.append(op)
            del self.history[: -self._history_max]

    def expire(self, now_tick: int, ttl: int, force: bool = False) -> list[Operator]:
        """Time out pending operators older than `ttl` ticks (all of them
        when `force`, the pd/operator-timeout failpoint's behavior)."""
        with self._mu:
            expired = [
                o for o in self._pending
                if force or (now_tick - o.created_tick) > ttl
            ]
            self._pending = [o for o in self._pending if o not in expired]
        for o in expired:
            self.retire(o, "timeout")
        return expired


# ---------------------------------------------------------------- the PD

class PlacementDriver:
    """The control plane of one TPUStore: consumes region flow, keeps hot
    statistics, and schedules split/merge/move operators over the
    cluster's placement map (which it owns — Cluster.store_of misses
    route back here)."""

    def __init__(self, store, conf: PDConfig | None = None):
        from .schedulers import (
            BalanceRegionScheduler,
            HotRegionScheduler,
            LeaderBalanceScheduler,
            MergeChecker,
            SplitChecker,
        )

        self.store = store
        self.cluster = store.cluster
        self.conf = conf or PDConfig()
        self.flow = FlowRecorder(self.cluster)
        self.hot_read = HotPeerCache("read", self.conf)
        self.hot_write = HotPeerCache("write", self.conf)
        self.queue = OperatorQueue(self.conf.operator_limit)
        self.checkers = [SplitChecker(), MergeChecker()]
        self.schedulers = [LeaderBalanceScheduler(), BalanceRegionScheduler(),
                           HotRegionScheduler()]
        self.ticks = 0  # guarded_by: _mu
        self.heartbeats_seen = 0  # guarded_by: _mu
        self._next_op_id = 1  # guarded_by: _mu
        self._mu = threading.Lock()  # id/counter bumps
        self._tick_mu = threading.RLock()  # serializes whole ticks
        # (timer-driven + manual tick() must not interleave: each tick
        # drains ONE heartbeat interval and owns the scheduling round)
        self._timer = None
        self.last_tick_root = None  # last pd.tick trace (TRACE/debug view); guarded_by: _mu
        # store health as dispatch reported it + the tick's own probes
        # (ref: PD's store state machine Up/Disconnected/Down driven by
        # store heartbeats); surfaced in /pd/api/v1/stores
        self.store_health: dict[int, str] = {}  # guarded_by: _mu
        self.cluster.pd = self  # placement authority hookup

    # -- placement authority ------------------------------------------------
    def place_region(self, region_id: int) -> int:
        """Authoritative placement for a region the map does not know —
        never a silent `region_id % n_stores`
        guess: a miss is a placement DECISION (least-loaded store),
        recorded so every later lookup agrees (ref: pd's operator-driven
        AddPeer on new regions)."""
        from ..util import metrics

        metrics.PD_PLACEMENT_DECISIONS.inc()
        return self.cluster.place_least_loaded(region_id)

    # -- store health + failover --------------------------------------------
    def note_store_down(self, store_id: int) -> None:
        """Dispatch-reported store failure (ref: client-go feeding store
        liveness back; PD flips the store Disconnected)."""
        with self._mu:
            self.store_health[store_id] = "down"

    def note_store_up(self, store_id: int) -> None:
        # dispatch calls this after every successful cop response; an
        # unlocked fast-path read would race the tick thread's probe
        # writes — one uncontended lock is cheap
        with self._mu:
            if self.store_health.get(store_id) == "down":
                self.store_health[store_id] = "up"

    def store_state(self, store_id: int) -> str:
        with self._mu:
            return self.store_health.get(store_id, "up")

    def failover_region(self, region_id: int, bad_store: int,
                        avoid=frozenset()) -> int | None:
        """Fail one region over off a sick leader store — the dispatch
        layer's escape hatch once the leader's circuit breaker opens.
        The first choice is a LEADER TRANSFER among live
        peers (ref: raft leadership election after a leader dies: the
        data is already replicated, no bytes move); a placement move —
        re-placing the whole peer set, a fresh-snapshot bootstrap — only
        happens when QUORUM is lost (majority of peers unreachable, or
        the last proposal failed its quorum ack). Both shapes record an
        operator so /pd/api/v1/operators shows the storm, and both count
        `pd_failover_total`; transfers additionally count
        `pd_transfer_leader_total`. Returns the new leader store, or None
        when nothing can serve (caller backs off and retries — e.g. the
        `store/transfer-leader-timeout` failpoint eating the transfer)."""
        from ..util import failpoint, metrics

        if self.cluster.region_by_id(region_id) is None:
            return None
        peers = self.cluster.peers_of(region_id)
        down = self.store.down_stores()
        live = [
            p for p in peers
            if p != bad_store and p not in avoid and p not in down
            and self.store.ping_store(p)
        ]
        quorum = len(peers) // 2 + 1
        counts = self.cluster.counts_per_store()
        if len(live) >= quorum and self.store.replication.quorum_ok(region_id):
            if failpoint.eval("store/transfer-leader-timeout"):
                op = self.new_operator("transfer-leader", region_id,
                                       source=bad_store, target=live[0])
                self.queue.retire(op, "timeout", "transfer-leader timed out")
                metrics.PD_OPERATOR_TIMEOUTS.inc()
                return None  # caller backs off; a later attempt may land
            # raft: only an up-to-date peer may win the election — prefer
            # fully-applied live peers, then least-loaded among them
            target = self.store.replication.best_transfer_target(
                region_id, live, counts)
            if self.cluster.transfer_leader(region_id, target):
                self.note_store_down(bad_store)
                op = self.new_operator("transfer-leader", region_id,
                                       source=bad_store, target=target)
                self.queue.retire(op, "finished", "breaker failover: leader transfer")
                metrics.PD_OPERATORS.labels("transfer-leader").inc()
                metrics.PD_TRANSFER_LEADER.inc()
                metrics.PD_FAILOVERS.inc()
                return target
            # the transfer lost a race (another thread moved leadership
            # already, or the peer set changed under us): quorum is NOT
            # lost — let the caller re-route against the fresh topology
            return None
        # quorum lost: re-place the whole group on healthy stores
        candidates = [
            s for s in range(self.cluster.n_stores)
            if s != bad_store and s not in avoid and not self.store.store_down(s)
        ]
        if not candidates:
            return None
        target = min(candidates, key=lambda s: counts.get(s, 0))
        self.cluster.re_place(region_id, target,
                              avoid=set(avoid) | down | {bad_store})
        self.note_store_down(bad_store)
        op = self.new_operator("failover", region_id, source=bad_store, target=target)
        self.queue.retire(op, "finished", "quorum lost: placement move")
        metrics.PD_OPERATORS.labels("failover").inc()
        metrics.PD_FAILOVERS.inc()
        return target

    def new_operator(self, kind: str, region_id: int, **kw) -> Operator:
        with self._mu:
            op_id = self._next_op_id
            self._next_op_id += 1
            tick = self.ticks
        return Operator(op_id, kind, region_id, created_tick=tick, **kw)

    # -- the tick loop ------------------------------------------------------
    def timer(self, interval: float | None = None):
        from ..background import Timer

        return Timer("pd", interval or self.conf.tick_interval, self.tick)

    def start_background(self, interval: float | None = None):
        if self._timer is None:
            self._timer = self.timer(interval).start()
        return self

    def stop(self):
        if self._timer is not None:
            self._timer.stop()
            self._timer = None

    def tick(self) -> list[Operator]:
        """One scheduling round; returns the operators dispatched."""
        from ..util import failpoint, metrics, tracing

        with self._tick_mu:
            return self._tick(failpoint, metrics, tracing)

    def _tick(self, failpoint, metrics, tracing) -> list[Operator]:
        with self._mu:
            self.ticks += 1
            tick_no = self.ticks
        t0 = time.monotonic()
        dispatched: list[Operator] = []
        with tracing.trace("pd.tick", tick=tick_no) as root:
            with self._mu:
                self.last_tick_root = root
            with tracing.span("pd.heartbeat") as hsp:
                beats = self.flow.heartbeat()
                if failpoint.eval("pd/heartbeat-lost"):
                    beats = []  # the interval's heartbeat stream was lost
                self._absorb(beats)
                if hsp is not None:
                    hsp.set("heartbeats", len(beats))
            with tracing.span("pd.health") as psp:
                down = self._probe_stores()
                if psp is not None:
                    psp.set("down_stores", down)
            with tracing.span("pd.replication") as rsp:
                # the resolved-ts worker analog: unwedged followers catch
                # up to their leader's committed watermark here, and the
                # per-store safe_ts lag gauges refresh
                repl = getattr(self.store, "replication", None)
                advanced = repl.catch_up() if repl is not None else 0
                if rsp is not None:
                    rsp.set("followers_advanced", advanced)
            with tracing.span("pd.cdc") as csp:
                # the changefeed frontier driver: each feed
                # recovers lost spans, advances its resolved-ts, drains
                # the sorter up to the frontier, and flushes its sink
                hub = getattr(self.store, "cdc", None)
                emitted = hub.tick() if hub is not None else 0
                if csp is not None:
                    csp.set("events_emitted", emitted)
            with tracing.span("pd.columnar") as osp:
                # the columnar replica's compaction driver:
                # fold each table's delta into its device-resident stable
                # chunks and refresh the freshness gauges — AFTER pd.cdc
                # so this tick's flushed frontier is foldable immediately
                rep = getattr(self.store, "columnar", None)
                folded = rep.compact_tick() if rep is not None else 0
                if osp is not None:
                    osp.set("rows_folded", folded)
            with tracing.span("pd.pitr") as pitr_sp:
                # point-in-time recovery upkeep: refresh each log backup's
                # durable-checkpoint gauges and trim the schema journal
                # below the floor every feed has passed — AFTER pd.cdc so
                # this tick's checkpoint slide is visible
                from ..br import pitr_tick

                pitr_tick(self.store)
                if pitr_sp is not None:
                    pitr_sp.set("log_backups",
                                len(getattr(self.store, "log_backups", ())))
            with tracing.span("topsql.report") as tsp:
                # Top SQL window rotation: the reporter seals
                # its live window on a clock even when no statement lands
                # to trigger the lazy rotation — the PD tick is the
                # process's background heartbeat, same as cdc/columnar
                from .. import topsql

                sealed = topsql.COLLECTOR.rotate()
                if tsp is not None:
                    tsp.set("windows_sealed", sealed)
            with tracing.span("pd.schedule") as ssp:
                proposed = 0
                for sched in self.checkers + self.schedulers:
                    for op in sched.schedule(self):
                        if self.queue.add(op):
                            metrics.PD_OPERATORS.labels(op.kind).inc()
                            proposed += 1
                if ssp is not None:
                    ssp.set("proposed", proposed)
            with tracing.span("pd.dispatch") as dsp:
                forced = bool(failpoint.eval("pd/operator-timeout"))
                for op in self.queue.expire(tick_no, self.conf.operator_ttl_ticks, force=forced):
                    metrics.PD_OPERATOR_TIMEOUTS.inc()
                for op in self.queue.pop_batch(self.conf.ops_per_tick):
                    self._apply(op)
                    dispatched.append(op)
                if dsp is not None:
                    dsp.set("dispatched", len(dispatched))
            self._refresh_gauges()
            root.set("operators", len(dispatched))
        metrics.PD_TICK_DURATION.observe(time.monotonic() - t0)
        return dispatched

    def _probe_stores(self) -> int:
        """Liveness-probe every store (ref: PD's store heartbeat watchdog):
        refresh the health view, and close a tripped circuit breaker whose
        store answers again — but ONLY for stores with no regions placed
        (their traffic failed over away, so no request would ever run the
        breaker's own half-open probe). A store still holding regions —
        e.g. one opened by a server-busy storm the liveness ping cannot
        see — keeps its probe discipline: dispatch traffic decides.
        Returns the down-store count."""
        board = getattr(self.store, "breakers", None)
        counts = self.cluster.counts_per_store()
        down = 0
        for sid in range(self.cluster.n_stores):
            up = self.store.ping_store(sid)
            with self._mu:
                self.store_health[sid] = "up" if up else "down"
            if not up:
                down += 1
            elif (
                board is not None
                and counts.get(sid, 0) == 0
                and board.states().get(sid) not in (None, "closed")
            ):
                board.record_success(sid)
        return down

    def _absorb(self, beats: list[RegionHeartbeat]) -> None:
        from ..util import metrics

        live = {r.region_id for r in self.cluster.regions()}
        with self._mu:
            self.heartbeats_seen += len(beats)
        for b in beats:
            metrics.PD_REGION_HEARTBEATS.inc()
            self.hot_read.update(b.region_id, b.read_bytes, b.read_keys)
            self.hot_write.update(b.region_id, b.write_bytes, b.write_keys)
        self.hot_read.prune(live)
        self.hot_write.prune(live)

    # -- operator execution -------------------------------------------------
    def _apply(self, op: Operator) -> None:
        try:
            if op.kind == "split":
                self._apply_split(op)
            elif op.kind == "merge":
                self._apply_merge(op)
            elif op.kind == "transfer-leader":
                self._apply_transfer_leader(op)
            elif op.kind in ("move-region", "move-hot-region"):
                self._apply_move(op)
            else:
                self.queue.retire(op, "cancelled", f"unknown kind {op.kind!r}")
        except Exception as exc:  # noqa: BLE001 — a bad operator must not kill the tick
            self.queue.retire(op, "cancelled", str(exc))

    def _split_key(self, region) -> bytes | None:
        """Median live key of the region — the split point (ref: TiKV's
        size-based SplitCheck picking the approximate middle key).

        The KV_MAX_TS scan is a deliberate latest-version read: split
        points should reflect CURRENT data, not any statement snapshot.
        Control-plane only: the request path never reads the latest
        version."""
        keys = [k for k, _ in self.store.kv.scan(region.start_key, region.end_key, KV_MAX_TS)]
        if len(keys) < 2:
            return None
        mid = keys[len(keys) // 2]
        return mid if mid != region.start_key else None

    def _apply_split(self, op: Operator) -> None:
        region = self.cluster.region_by_id(op.region_id)
        if region is None:
            self.queue.retire(op, "cancelled", "region gone")
            return
        key = self._split_key(region)
        if key is None:
            self.queue.retire(op, "cancelled", "no split point")
            return
        child = self.cluster.split(key)  # cluster notifies flow.on_split
        self.queue.retire(op, "finished", f"child={child.region_id}")

    def _apply_merge(self, op: Operator) -> None:
        merged = self.cluster.merge(op.region_id, op.peer_region)
        if merged is None:  # cluster notifies flow.on_merge on success
            self.queue.retire(op, "cancelled", "neighbor gone")
            return
        self.queue.retire(op, "finished", f"absorbed={op.peer_region}")

    def _apply_transfer_leader(self, op: Operator) -> None:
        """Move a region's leadership to a follower peer (ref: pd's
        transfer-leader operator -> raft TransferLeader). No epoch bump;
        in-flight cop tasks at the old leader get NotLeader with a hint."""
        from ..util import failpoint, metrics

        if self.cluster.region_by_id(op.region_id) is None:
            self.queue.retire(op, "cancelled", "region gone")
            return
        if failpoint.eval("store/transfer-leader-timeout"):
            self.queue.retire(op, "timeout", "transfer-leader timed out")
            metrics.PD_OPERATOR_TIMEOUTS.inc()
            return
        if not self.store.ping_store(op.target):
            self.queue.retire(op, "cancelled", f"target store {op.target} down")
            return
        from ..replication import QUORUM_SAFE_TS_MAX

        repl = getattr(self.store, "replication", None)
        if repl is not None and repl.safe_ts(
                op.region_id, op.target) != QUORUM_SAFE_TS_MAX:
            # raft refuses to elect a peer that has not applied the full
            # log; retry after the catch-up phase closes the gap
            self.queue.retire(op, "cancelled", "target apply lags")
            return
        if self.cluster.transfer_leader(op.region_id, op.target):
            metrics.PD_TRANSFER_LEADER.inc()
            self.queue.retire(op, "finished")
        else:
            self.queue.retire(op, "cancelled", "target no longer a follower peer")

    def _apply_move(self, op: Operator) -> None:
        if self.cluster.region_by_id(op.region_id) is None:
            self.queue.retire(op, "cancelled", "region gone")
            return
        if not self.store.ping_store(op.target):
            # a balance/hot-region proposal computed before the outage (or
            # during it — the schedulers see the empty store as the least
            # loaded) must not ping-pong regions back ONTO a down store
            self.queue.retire(op, "cancelled", f"target store {op.target} down")
            return
        self.cluster.set_store(op.region_id, op.target)
        self.queue.retire(op, "finished")

    # -- observability ------------------------------------------------------
    def _refresh_gauges(self) -> None:
        from ..util import metrics

        regions = self.cluster.regions()
        metrics.PD_REGIONS.set(len(regions))
        hot_by_store: dict[int, int] = {s: 0 for s in range(self.cluster.n_stores)}
        count_by_store: dict[int, int] = {s: 0 for s in range(self.cluster.n_stores)}
        hot = {p.region_id for p in self.hot_read.hot_peers()} | {
            p.region_id for p in self.hot_write.hot_peers()
        }
        for r in regions:
            sid = self.cluster.store_of(r.region_id)
            count_by_store[sid] = count_by_store.get(sid, 0) + 1
            if r.region_id in hot:
                hot_by_store[sid] = hot_by_store.get(sid, 0) + 1
        for sid, n in hot_by_store.items():
            metrics.PD_HOT_REGION.labels(str(sid)).set(n)
        for sid, n in count_by_store.items():
            metrics.PD_STORE_REGIONS.labels(str(sid)).set(n)
        metrics.PD_OPERATOR_PENDING.set(len(self.queue.pending()))

    def regions_view(self) -> list[dict]:
        stats = self.flow.stats()
        out = []
        for r in self.cluster.regions():
            size, keys = stats.get(r.region_id, (0, 0))
            out.append({
                "region_id": r.region_id,
                "start_key": r.start_key.hex(),
                "end_key": r.end_key.hex(),
                "epoch": r.epoch,
                "store": self.cluster.store_of(r.region_id),
                "leader": self.cluster.leader_of(r.region_id),
                "peers": self.cluster.peers_of(r.region_id),
                "approximate_size": size,
                "approximate_keys": keys,
            })
        return out

    def stores_view(self) -> list[dict]:
        stats = self.flow.stats()
        breaker_states = {}
        board = getattr(self.store, "breakers", None)
        if board is not None:
            breaker_states = board.states()
        repl = getattr(self.store, "replication", None)
        lag = repl.lag_view() if repl is not None else {}
        peer_counts = self.cluster.peer_counts_per_store()
        by_store: dict[int, dict] = {
            s: {"store_id": s, "region_count": 0, "region_size": 0, "region_keys": 0,
                "hot_read_regions": 0, "hot_write_regions": 0,
                "leader_count": 0, "peer_count": peer_counts.get(s, 0),
                "safe_ts_lag": lag.get(s, 0),
                "state": self.store_state(s),
                "breaker": breaker_states.get(s, "closed")}
            for s in range(self.cluster.n_stores)
        }
        hot_r = {p.region_id for p in self.hot_read.hot_peers()}
        hot_w = {p.region_id for p in self.hot_write.hot_peers()}
        for r in self.cluster.regions():
            sid = self.cluster.store_of(r.region_id)
            st = by_store.setdefault(sid, {"store_id": sid, "region_count": 0, "region_size": 0,
                                           "region_keys": 0, "hot_read_regions": 0, "hot_write_regions": 0,
                                           "leader_count": 0, "peer_count": 0, "safe_ts_lag": 0})
            size, keys = stats.get(r.region_id, (0, 0))
            # region_count IS the leader view ("a region lives where it
            # leads"); leader_count is kept as the replication-explicit
            # ALIAS below so the two can never diverge
            st["region_count"] += 1
            st["region_size"] += size
            st["region_keys"] += keys
            st["hot_read_regions"] += 1 if r.region_id in hot_r else 0
            st["hot_write_regions"] += 1 if r.region_id in hot_w else 0
        for st in by_store.values():
            st["leader_count"] = st["region_count"]
        return [by_store[s] for s in sorted(by_store)]

    def hotspot_view(self) -> dict:
        def peers(cache: HotPeerCache) -> list[dict]:
            return [
                {"region_id": p.region_id, "store": self.cluster.store_of(p.region_id),
                 "byte_rate": round(p.byte_rate, 1), "key_rate": round(p.key_rate, 1),
                 "degree": p.degree}
                for p in cache.hot_peers()
            ]

        with self._mu:
            tick = self.ticks
        return {"as_of_tick": tick, "read": peers(self.hot_read), "write": peers(self.hot_write)}

    def operators_view(self) -> dict:
        def row(o: Operator) -> dict:
            return {"op_id": o.op_id, "kind": o.kind, "region_id": o.region_id,
                    "source": o.source, "target": o.target, "state": o.state,
                    "created_tick": o.created_tick, "note": o.note}

        return {"pending": [row(o) for o in self.queue.pending()],
                "history": [row(o) for o in self.queue.history_view()]}

    def scheduling_state(self, region_id: int) -> str:
        """SHOW PLACEMENT's Scheduling_State column for one region."""
        for o in self.queue.pending():
            if o.region_id == region_id or o.peer_region == region_id:
                return f"pending-{o.kind}"
        states = []
        if any(p.region_id == region_id for p in self.hot_read.hot_peers()):
            states.append("hot-read")
        if any(p.region_id == region_id for p in self.hot_write.hot_peers()):
            states.append("hot-write")
        return ",".join(states) if states else "scheduled"
