"""Region replication on the port (tidb_tpu_torch/replication/, the store's
fault ladder and quorum gate) against the JAX package's, on the CPU: the
33 cases of tests/test_replication.py.

Each case starts a JAX TPUStore and a port TPUStore(device="cpu") from
one plain state (tidb_tpu_torch/interop.py: the same rows, regions,
epochs, peers and leaders), or runs the same SQL on a session of each
package, then runs the reference's scenario on each, the package's own
failpoints armed and its own metrics read. The scenario keeps the
reference's assertions, and what it returns — region layouts (ids, keys,
epochs, peers, leaders), operator kinds and states, safe_ts values, typed
error kinds, counter deltas and rows — must be equal between the packages.
Tolerance: exact.

Where a scenario's dispatch runs on a thread pool, the order in which
regions fail over is the pool's, so those scenarios return what does not
depend on it (rows, sets, breaker states, whether a counter moved).
"""

import threading
import time

import pytest

from torch_sql_parity import (JAX, PORT, chunk_rows, fill_pair, layout, norm, row_kv, region_table, run_both,
                              store_pair)

TID = 21


def scan_req(P, start_ts=100, **kw):
    D, T = P.dag, P.types
    dag = D.DAGRequest((D.TableScan(TID, (D.ColumnInfo(1, T.new_longlong()),)),), output_offsets=(0,))
    return P.dispatch.KVRequest(dag, P.dispatch.full_table_ranges(TID), start_ts=start_ts, **kw)


def replica_reads(P) -> dict:
    out = {"leader": 0, "follower": 0}
    for series, value in P.metrics.REGISTRY.sample_lines():
        if series.startswith("tidb_tpu_replica_read_total{"):
            out[series.split('"')[1]] = int(value)
    return out


def region_errors(P, kind: str) -> int:
    return P.metrics.REGISTRY.counter_vec("tidb_tpu_region_errors_total", labelnames=("kind",)).labels(kind).value


def rows_of(res) -> int:
    return sum(c.num_rows() for c in res.chunks)


def key(P, h):
    return P.tablecodec.encode_row_key(TID, h)


# ------------------------------------------------------ peer-set topology

def test_scatter_builds_peer_sets_with_leaders():
    def case(P, store):
        for r in store.cluster.regions():
            peers = store.cluster.peers_of(r.region_id)
            leader = store.cluster.leader_of(r.region_id)
            assert len(peers) == min(store.cluster.max_replicas, 4)
            assert len(set(peers)) == len(peers)
            assert leader in peers
            assert store.cluster.store_of(r.region_id) == leader
        return layout(store)

    run_both(case, fill_pair(TID))


def test_max_replicas_capped_at_n_stores():
    def case(P, store):
        store.cluster.set_stores(2)
        assert all(len(store.cluster.peers_of(r.region_id)) == 2 for r in store.cluster.regions())
        return layout(store)

    run_both(case, store_pair([], region_table([], 1), 1))


def test_split_child_inherits_peer_set():
    def case(P, store):
        parent = store.cluster.regions()[0]
        ppeers = store.cluster.peers_of(parent.region_id)
        child = store.cluster.split(key(P, 20))
        assert store.cluster.peers_of(child.region_id) == ppeers
        assert store.cluster.leader_of(child.region_id) == store.cluster.leader_of(parent.region_id)
        return layout(store), store.pd.flow.stats()

    run_both(case, fill_pair(TID, rows=40, regions=1, stores=4))


def test_merge_drops_absorbed_peer_set():
    def case(P, store):
        left, right = store.cluster.regions()
        store.cluster.merge(left.region_id, right.region_id)
        assert store.cluster.region_by_id(right.region_id) is None
        with store.cluster._mu:
            assert right.region_id not in store.cluster._peers
        return layout(store), store.pd.flow.stats()

    run_both(case, fill_pair(TID, rows=40, regions=2, stores=4))


def test_placement_miss_assigns_peers_via_shared_helper():
    def case(P, store):
        child = store.cluster.split(key(P, 7))
        with store.cluster._mu:
            store.cluster._store_of.pop(child.region_id)
            store.cluster._peers.pop(child.region_id)
        d0 = P.metrics.PD_PLACEMENT_DECISIONS.value
        leader = store.cluster.store_of(child.region_id)  # drives the miss
        peers = store.cluster.peers_of(child.region_id)
        assert leader in peers and len(peers) == 3
        return layout(store), P.metrics.PD_PLACEMENT_DECISIONS.value - d0

    run_both(case, fill_pair(TID))


def test_peer_counts_per_store():
    def case(P, store):
        counts = store.cluster.peer_counts_per_store()
        assert sum(counts.values()) == 4 * 3
        return counts

    run_both(case, fill_pair(TID, rows=40, regions=4, stores=4))


# -------------------------------------------------------- leader transfer

def test_transfer_within_peer_set_only_no_epoch_bump():
    def case(P, store):
        region = store.cluster.regions()[0]
        rid, epoch0 = region.region_id, region.epoch
        leader = store.cluster.leader_of(rid)
        follower = store.cluster.followers_of(rid)[0]
        outsider = next(s for s in range(4) if s not in store.cluster.peers_of(rid))
        got = [store.cluster.transfer_leader(rid, outsider), store.cluster.transfer_leader(rid, leader),
               store.cluster.transfer_leader(rid, follower)]
        assert got == [False, False, True]
        assert store.cluster.leader_of(rid) == follower
        assert store.cluster.region_by_id(rid).epoch == epoch0
        safe = store.replication.safe_ts(rid, leader)
        assert safe == P.replication.QUORUM_SAFE_TS_MAX
        return layout(store), safe

    run_both(case, fill_pair(TID))


def test_pd_transfer_leader_operator():
    def case(P, store):
        rid = store.cluster.regions()[0].region_id
        follower = store.cluster.followers_of(rid)[0]
        t0 = P.metrics.PD_TRANSFER_LEADER.value
        op = store.pd.new_operator("transfer-leader", rid, target=follower)
        store.pd._apply(op)
        assert op.state == "finished"
        assert store.cluster.leader_of(rid) == follower
        return layout(store), (op.kind, op.state, op.note), P.metrics.PD_TRANSFER_LEADER.value - t0

    run_both(case, fill_pair(TID))


def test_transfer_leader_timeout_failpoint():
    def case(P, store):
        rid = store.cluster.regions()[0].region_id
        follower = store.cluster.followers_of(rid)[0]
        leader0 = store.cluster.leader_of(rid)
        t0 = P.metrics.PD_OPERATOR_TIMEOUTS.value
        with P.fp.enabled("store/transfer-leader-timeout", 1):
            op = store.pd.new_operator("transfer-leader", rid, target=follower)
            store.pd._apply(op)
        assert op.state == "timeout"
        assert store.cluster.leader_of(rid) == leader0
        return layout(store), (op.state, op.note), P.metrics.PD_OPERATOR_TIMEOUTS.value - t0

    run_both(case, fill_pair(TID))


def test_breaker_failover_is_a_leader_transfer():
    def case(P, store):
        peer_counts0 = store.cluster.peer_counts_per_store()
        store.set_down(1)
        t0 = P.metrics.PD_TRANSFER_LEADER.value
        res = P.dispatch.select(store, scan_req(P))
        assert rows_of(res) == 120
        assert P.metrics.PD_TRANSFER_LEADER.value > t0
        assert store.cluster.counts_per_store().get(1, 0) == 0
        assert store.cluster.peer_counts_per_store() == peer_counts0
        kinds = sorted({o.kind for o in store.pd.queue.history_view()})
        store.set_up(1)
        return chunk_rows(res.chunks), kinds, store.cluster.peer_counts_per_store()

    run_both(case, fill_pair(TID))


def test_quorum_loss_falls_back_to_placement_move():
    def case(P, store):
        region = store.cluster.regions()[0]
        peers = store.cluster.peers_of(region.region_id)
        for p in peers:
            store.set_down(p)
        survivor = next(s for s in range(4) if s not in peers)
        t0 = P.metrics.PD_TRANSFER_LEADER.value
        res = P.dispatch.select(store, scan_req(P, concurrency=1))
        assert rows_of(res) == 120
        assert store.cluster.leader_of(region.region_id) == survivor
        assert survivor in store.cluster.peers_of(region.region_id)
        ops = [(o.kind, o.region_id, o.source, o.target, o.state, o.note) for o in store.pd.queue.history_view()]
        assert ops and any(o[0] == "failover" and "quorum lost" in o[5] for o in ops)
        for p in peers:
            store.set_up(p)
        return (chunk_rows(res.chunks), layout(store), ops, P.metrics.PD_TRANSFER_LEADER.value - t0,
                store.breakers.states())

    run_both(case, fill_pair(TID))


def test_leader_balance_scheduler_evens_leader_counts():
    def case(P, store):
        for r in store.cluster.regions():
            store.cluster.set_store(r.region_id, 0)
        t0 = P.metrics.PD_TRANSFER_LEADER.value
        ticks = []
        for _ in range(8):
            ticks.append([(o.kind, o.region_id, o.source, o.target, o.state) for o in store.pd.tick()])
            counts = store.cluster.counts_per_store()
            if max(counts.values()) - min(counts.values()) <= store.pd.conf.balance_tolerance:
                break
        counts = store.cluster.counts_per_store()
        assert max(counts.values()) - min(counts.values()) <= store.pd.conf.balance_tolerance
        assert P.metrics.PD_TRANSFER_LEADER.value > t0
        return layout(store), ticks, P.metrics.PD_TRANSFER_LEADER.value - t0

    run_both(case, fill_pair(TID, rows=120, regions=8, stores=4))


# ------------------------------------------------- NotLeader leader hints

def test_hint_round_trips_the_wire_string():
    def case(P):
        err = P.store.NotLeader.make(5, 2, leader_store=3)
        back = P.store.parse_region_error(str(err))
        assert isinstance(back, P.store.NotLeader)
        old = P.store.parse_region_error("not_leader: region 5 store 2")
        assert isinstance(old, P.store.NotLeader) and old.leader_store == -1
        return str(err), (back.kind, back.store_id, back.leader_store), (old.store_id, old.leader_store)

    run_both(case)


def test_non_leader_peer_answers_hint():
    def case(P, store):
        region = store.cluster.regions()[0]
        leader = store.cluster.leader_of(region.region_id)
        follower = store.cluster.followers_of(region.region_id)[0]
        req = scan_req(P)
        resp = store.coprocessor(P.store.CopRequest(
            req.dag, [P.store.KeyRange(region.start_key, region.end_key)], 100,
            region.region_id, region.epoch, peer_store=follower))
        err = P.store.parse_region_error(resp.region_error)
        assert isinstance(err, P.store.NotLeader)
        assert err.store_id == follower and err.leader_store == leader
        return resp.region_error, resp.other_error, resp.chunk is None

    run_both(case, fill_pair(TID))


def test_dispatch_uses_hint_for_immediate_retry_without_backoff():
    def case(P, store):
        region = store.cluster.regions()[0]
        follower = store.cluster.followers_of(region.region_id)[0]
        b0 = P.metrics.BACKOFF_SECONDS.labels("not_leader").value
        e0 = region_errors(P, "not_leader")
        with P.fp.enabled("store/not-leader", {follower}):
            res = P.dispatch.select(store, scan_req(P, replica_read="follower", concurrency=1))
        assert rows_of(res) == 120
        assert region_errors(P, "not_leader") > e0
        assert P.metrics.BACKOFF_SECONDS.labels("not_leader").value == b0
        return chunk_rows(res.chunks), region_errors(P, "not_leader") - e0

    run_both(case, fill_pair(TID))


# ------------------------------------------- replica reads + safe_ts gate

def test_follower_mode_serves_from_followers():
    def case(P, store):
        r0 = replica_reads(P)
        res = P.dispatch.select(store, scan_req(P, replica_read="follower"))
        assert rows_of(res) == 120
        r1 = replica_reads(P)
        assert r1["follower"] - r0["follower"] >= 4
        assert r1["leader"] == r0["leader"]
        # which follower serves a region is the pool's race for the read
        # loads; how many reads were served is not
        return chunk_rows(res.chunks), {k: r1[k] - r0[k] for k in r1}, sum(store.replication.read_counts().values())

    run_both(case, fill_pair(TID))


def test_closest_replica_spreads_read_load():
    def case(P, store):
        for _ in range(6):
            res = P.dispatch.select(store, scan_req(P, replica_read="closest-replica", concurrency=1))
            assert rows_of(res) == 120
        loads = store.replication.read_counts()
        assert len([s for s, n in loads.items() if n > 0]) >= 3
        return sorted(loads.items())

    run_both(case, fill_pair(TID))


def test_lagging_follower_gates_new_snapshots_to_leader():
    def case(P, store):
        # peers join (one thread: the routed followers, and so the read
        # loads the gated reads route by, are the same in both packages)
        P.dispatch.select(store, scan_req(P, replica_read="follower", concurrency=1))
        rid = store.cluster.locate(key(P, 500)).region_id
        followers = store.cluster.followers_of(rid)
        with P.fp.enabled("replica/apply-lag", True):
            store.put_row(TID, 500, [1], [P.types.Datum.i64(500)], ts=150)
            lagged = [store.replication.safe_ts(rid, f) for f in followers]
            assert all(s < 150 for s in lagged)
            d0 = region_errors(P, "data_not_ready")
            res = P.dispatch.select(store, scan_req(P, start_ts=200, replica_read="follower", concurrency=1))
            assert rows_of(res) == 121
            dnr = region_errors(P, "data_not_ready") - d0
            assert dnr > 0
            r0 = replica_reads(P)
            old = P.dispatch.select(store, scan_req(P, start_ts=100, replica_read="follower", concurrency=1))
            assert rows_of(old) == 120
            assert replica_reads(P)["follower"] > r0["follower"]
        store.pd.tick()
        after = [store.replication.safe_ts(rid, f) for f in store.cluster.followers_of(rid)]
        assert all(s == P.replication.QUORUM_SAFE_TS_MAX for s in after)
        return lagged, dnr, chunk_rows(res.chunks), chunk_rows(old.chunks), after, store.replication.lag_view()

    run_both(case, fill_pair(TID))


def test_batch_cop_groups_by_routed_follower():
    def case(P, store):
        r0 = replica_reads(P)
        res = P.dispatch.select(store, scan_req(P, replica_read="follower", batch_cop=True))
        assert rows_of(res) == 120
        assert replica_reads(P)["follower"] - r0["follower"] >= 6
        return chunk_rows(res.chunks), replica_reads(P)["follower"] - r0["follower"]

    run_both(case, fill_pair(TID, rows=120, regions=6, stores=3))


def test_cop_request_peer_fields_survive_the_wire():
    def case(P):
        req = scan_req(P)
        a = P.store.CopRequest(req.dag, [P.store.KeyRange(b"a", b"z")], 100, 7, 3, peer_store=2, replica_read=True)
        b = P.store.CopRequest(req.dag, [P.store.KeyRange(b"a", b"z")], 100, 7, 3)
        out = []
        for r in (a, b):
            raw = P.wire.encode_cop_request(r)
            back = P.wire.decode_cop_request(raw)
            out.append((raw, back.peer_store, back.replica_read))
        assert out[0][1:] == (2, True) and out[1][1:] == (-1, False)
        return out

    run_both(case)


def test_data_is_not_ready_round_trips():
    def case(P):
        err = P.store.DataIsNotReady.make(7, 2, safe_ts=42)
        back = P.store.parse_region_error(str(err))
        assert isinstance(back, P.store.DataIsNotReady)
        assert back.store_id == 2 and back.safe_ts == 42 and back.kind == "data_not_ready"
        return str(err), back.kind, back.store_id, back.safe_ts

    run_both(case)


# ------------------------------------------------------- watermark edges

def test_first_proposal_under_wedge_still_gates():
    def case(P, store):
        store.cluster.set_stores(3)
        with P.fp.enabled("replica/apply-lag", True):
            store.put_row(TID, 1, [1], [P.types.Datum.i64(1)], ts=50)
            rid = store.cluster.locate(key(P, 1)).region_id
            safe = [store.replication.safe_ts(rid, f) for f in store.cluster.followers_of(rid)]
        assert all(s < 50 for s in safe)
        return safe, layout(store)

    run_both(case, store_pair([], region_table([], 1), 1))


def test_leader_move_within_peers_leaves_no_phantom_lag():
    def case(P, store):
        rid = store.cluster.locate(key(P, 1)).region_id
        follower = store.cluster.followers_of(rid)[0]
        store.cluster.set_store(rid, follower)
        assert store.cluster.leader_of(rid) == follower
        store.put_row(TID, 1, [1], [P.types.Datum.i64(2)], ts=300)
        store.pd.tick()
        lag = store.replication.lag_view()
        assert all(v == 0 for v in lag.values())
        return lag, layout(store)

    run_both(case, fill_pair(TID))


def test_failover_prefers_caught_up_peer():
    def case(P, store):
        rid = store.cluster.locate(key(P, 1)).region_id
        leader = store.cluster.leader_of(rid)
        lagging, healthy = store.cluster.followers_of(rid)
        with P.fp.enabled("replica/apply-lag", {lagging}):
            store.put_row(TID, 1, [1], [P.types.Datum.i64(3)], ts=400)
            store.set_down(leader)
            target = store.pd.failover_region(rid, leader)
        assert target == healthy
        store.set_up(leader)
        return target, layout(store), [(o.kind, o.source, o.target, o.note) for o in store.pd.queue.history_view()]

    run_both(case, fill_pair(TID))


# --------------------------------------------------------- quorum writes

def test_one_dropped_ack_still_commits():
    def case(P, store):
        rid = store.cluster.regions()[0].region_id
        follower = store.cluster.followers_of(rid)[0]
        q0 = P.metrics.REPLICA_QUORUM_FAILS.value
        with P.fp.enabled("replica/drop-ack", {follower}):
            ok = store.replication.propose(rid, 200)
        assert ok and store.replication.quorum_ok(rid)
        return ok, P.metrics.REPLICA_QUORUM_FAILS.value - q0, store.replication.safe_ts(rid, follower)

    run_both(case, fill_pair(TID))


def test_majority_dropped_acks_lose_quorum():
    def case(P, store):
        rid = store.cluster.regions()[0].region_id
        followers = store.cluster.followers_of(rid)
        q0 = P.metrics.REPLICA_QUORUM_FAILS.value
        with P.fp.enabled("replica/drop-ack", set(followers)):
            ok = store.replication.propose(rid, 200)
        lost = store.replication.quorum_ok(rid)
        assert not ok and not lost
        store.pd.tick()
        back = store.replication.quorum_ok(rid)
        assert back and store.replication.propose(rid, 201) and store.replication.quorum_ok(rid)
        return ok, lost, back, P.metrics.REPLICA_QUORUM_FAILS.value - q0

    run_both(case, fill_pair(TID))


def test_write_refused_on_quorum_loss_then_succeeds():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE qw (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO qw VALUES (1, 1)")
        s.store.cluster.set_stores(4)
        s.store.cluster.scatter()
        tid = s.catalog.table("qw").table_id
        rid = s.store.cluster.locate(P.tablecodec.encode_row_key(tid, 2)).region_id
        followers = s.store.cluster.followers_of(rid)
        q0 = P.metrics.REPLICA_QUORUM_FAILS.value
        with P.fp.enabled("replica/drop-ack", set(followers)):
            with pytest.raises(P.sql.SQLError) as ei:
                s.execute("INSERT INTO qw VALUES (2, 2)")
            assert ei.value.code == 9005 and "quorum_lost" in str(ei.value)
            during = s.execute("SELECT count(*) FROM qw").values()
            assert during == [[1]]
        assert P.metrics.REPLICA_QUORUM_FAILS.value > q0
        s.execute("INSERT INTO qw VALUES (2, 2)")
        after = s.execute("SELECT count(*) FROM qw").values()
        assert after == [[2]]
        return ei.value.code, str(ei.value), during, after, P.metrics.REPLICA_QUORUM_FAILS.value - q0

    run_both(case)


def test_direct_put_refused_on_quorum_loss():
    def case(P, store):
        rid = store.cluster.locate(key(P, 999)).region_id
        followers = store.cluster.followers_of(rid)
        with P.fp.enabled("replica/drop-ack", set(followers)):
            with pytest.raises(P.store.QuorumLostError) as ei:
                store.put_row(TID, 999, [1], [P.types.Datum.i64(999)], ts=300)
        refused = store.kv.get(key(P, 999), 1000)
        store.put_row(TID, 999, [1], [P.types.Datum.i64(999)], ts=301)
        return str(ei.value), refused, store.kv.get(key(P, 999), 1000)

    run_both(case, fill_pair(TID))


# ------------------------------------------------------- session surfaces

def make_session(P, rows=120, regions=6, stores=3):
    s = P.new_session()
    s.execute("CREATE TABLE rep (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO rep VALUES " + ",".join(f"({i},{i % 7})" for i in range(rows)))
    tid = s.catalog.table("rep").table_id
    for i in range(1, regions):
        s.store.cluster.split(P.tablecodec.encode_row_key(tid, i * rows // regions))
    s.store.cluster.set_stores(stores)
    s.store.cluster.scatter()
    return s


def test_replica_read_sysvar_validates_and_routes():
    def case(P):
        s = make_session(P)
        with pytest.raises(P.sql.SQLError) as ei:
            s.execute("SET tidb_replica_read = 'sideways'")
        s.execute("SET tidb_replica_read = 'follower'")
        mode = s.execute("SELECT @@tidb_replica_read").scalar()
        r0 = replica_reads(P)
        n = s.execute("SELECT count(*) FROM rep").scalar()
        assert mode == "follower" and n == 120 and replica_reads(P)["follower"] > r0["follower"]
        return str(ei.value), mode, n, replica_reads(P)["follower"] - r0["follower"]

    run_both(case)


def test_stale_snapshot_session_rides_followers_only_when_covered():
    def case(P):
        s = make_session(P, rows=60, regions=3, stores=3)
        snap_ts = s.store.next_ts()
        s.execute("SET tidb_replica_read = 'follower'")
        out = [s.execute("SELECT count(*) FROM rep").scalar()]
        with P.fp.enabled("replica/apply-lag", True):
            s.execute("INSERT INTO rep VALUES (1000, 1)")
            out.append(s.execute("SELECT count(*) FROM rep").scalar())
            r0 = replica_reads(P)
            s.execute(f"SET tidb_snapshot = '{snap_ts}'")
            out.append(s.execute("SELECT count(*) FROM rep").scalar())
            assert replica_reads(P)["follower"] > r0["follower"]
            s.execute("SET tidb_snapshot = ''")
            out.append(s.execute("SELECT count(*) FROM rep").scalar())
        assert out == [60, 61, 60, 61]
        return out

    run_both(case)


def test_show_placement_lists_peers_and_leaders():
    def case(P):
        s = make_session(P, rows=40, regions=2, stores=3)
        rows = s.execute("SHOW PLACEMENT").values()
        store_rows = [r for r in rows if r[0].startswith("STORE")]
        region_rows = [r for r in rows if r[0].startswith("REGION")]
        assert store_rows and region_rows
        assert all("leaders=" in r[1] and "peers=" in r[1] for r in store_rows)
        assert all("leader=" in r[1] and "peers=[" in r[1] for r in region_rows)
        return rows

    run_both(case)


def test_stores_view_surfaces_replica_counts():
    def case(P):
        s = make_session(P, rows=40, regions=2, stores=3)
        view = s.store.pd.stores_view()
        for st in view:
            assert "leader_count" in st and "peer_count" in st and "safe_ts_lag" in st
        total = sum(st["peer_count"] for st in view)
        assert total == sum(len(s.store.cluster.peers_of(r.region_id)) for r in s.store.cluster.regions())
        return view

    run_both(case)


# --------------------------------- lockwatch storm: transfers vs dispatch

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_leader_transfer_storm_under_lockwatch(pkg):
    """Leader transfers racing follower-read dispatch and the PD tick under
    the runtime lockset detector (tidb_tpu/analysis/lockwatch.py, watching
    the package under test): no lock-order cycle, no unguarded annotated
    access, and every scan returns every row. Each package runs its own
    storm (a storm's interleaving is the threads'); the store starts from
    one plain state in both."""
    from tidb_tpu.analysis import lockwatch

    P = JAX if pkg == "jax" else PORT
    rows, regions = 160, 8
    keys = [PORT.tablecodec.encode_row_key(TID, i * rows // regions) for i in range(1, regions)]
    kv, table = row_kv(TID, rows), region_table(keys, 4)
    with lockwatch.watching(packages=("tidb_tpu",) if pkg == "jax" else ("tidb_tpu_torch",)) as w:
        store = store_pair(kv, table, 4)[pkg]
        D, T = P.dag, P.types
        dag = D.DAGRequest((D.TableScan(TID, (D.ColumnInfo(1, T.new_longlong()),)),), output_offsets=(0,))
        stop = threading.Event()
        errors: list = []
        counts: list = []

        def scanner(mode):
            while not stop.is_set():
                try:
                    res = P.dispatch.select(store, P.dispatch.KVRequest(
                        dag, P.dispatch.full_table_ranges(TID), 100, replica_read=mode))
                    counts.append(rows_of(res))
                except Exception as exc:  # noqa: BLE001 — any error fails the test
                    errors.append(exc)
                    return

        def transferrer():
            k = 0
            while not stop.is_set():
                for r in store.cluster.regions():
                    folls = store.cluster.followers_of(r.region_id)
                    if folls:
                        store.cluster.transfer_leader(r.region_id, folls[k % len(folls)])
                k += 1
                store.pd.tick()

        threads = [threading.Thread(target=scanner, args=(m,), daemon=True)
                   for m in ("follower", "closest-replica", "leader")]
        threads.append(threading.Thread(target=transferrer, daemon=True))
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    rep = w.report()
    assert rep["cycles"] == [], rep["cycles"]
    assert rep["violations"] == [], "\n".join(rep["violations"])
    assert not errors, errors
    assert counts and all(c == rows for c in counts)
    assert rep["edges"], "lockwatch saw no lock nesting at all"
    assert norm(store.kv.get(PORT.tablecodec.encode_row_key(TID, 5), 1000)) == norm(kv[5][1])
