"""The Placement Driver on the port (tidb_tpu_torch/pd/: region flow,
hot-peer caches, the operator queue, checkers and schedulers, the tick and
its failpoints) against the JAX package's, on the CPU: the cases of
tests/test_pd.py but `test_pd_http_api_endpoints` and
`test_config_server_boots_and_stops_pd_loop`, which are in
tests/test_torch_http_api.py and tests/test_torch_server.py beside the
port's HTTP status server and MySQL server.

A JAX TPUStore is filled as the reference's fill_store fills it, its
state read out as plain values (interop.store_state) and both packages'
stores started from them (interop); or both packages run the same SQL.
Each scenario keeps the reference's assertions and returns what the PD did
— region layouts, operator kinds and states, flow stats, hot peers,
counter deltas, rows — which must be equal between the packages.
Tolerance: exact.
"""

import threading

import pytest

from torch_sql_parity import JAX, PORT, fill_pair, layout, run_both

TID = 9


def pair(rows=200, regions=4, stores=4, pin_store=None):
    return fill_pair(TID, rows=rows, regions=regions, stores=stores, pin_store=pin_store)


def scan_region(P, store, region):
    D, T = P.dag, P.types
    dag = D.DAGRequest((D.TableScan(TID, (D.ColumnInfo(1, T.new_longlong()),)),), output_offsets=(0,))
    resp = store.coprocessor(P.store.CopRequest(dag, [P.store.KeyRange(region.start_key, region.end_key)], 100,
                                                region.region_id, region.epoch))
    assert resp.other_error is None and resp.region_error is None, resp.other_error or resp.region_error
    return resp


def beats(store) -> list:
    return sorted((b.region_id, b.read_bytes, b.read_keys, b.write_bytes, b.write_keys, b.approx_size,
                   b.approx_keys) for b in store.pd.flow.heartbeat())


def ops(dispatched) -> list:
    return [(o.kind, o.region_id, o.source, o.target, o.peer_region, o.state, o.note) for o in dispatched]


# ---------------------------------------------------------------- flow

def test_flow_records_reads_and_writes_into_heartbeats():
    def case(P, store):
        r1 = store.cluster.regions()[0]
        scan_region(P, store, r1)
        first = beats(store)
        b = {x[0]: x for x in first}[r1.region_id]
        assert b[1] > 0 and b[2] > 0 and b[3] > 0 and b[4] > 0 and b[5] > 0 and b[6] > 0
        second = beats(store)
        b2 = {x[0]: x for x in second}[r1.region_id]
        assert b2[1] == 0 and b2[4] == 0 and b2[6] == b[6]
        return first, second

    run_both(case, pair(rows=100, regions=2, stores=1))


def test_flow_write_path_through_txn_commit():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE w (id INT PRIMARY KEY, v INT)")
        s.execute("BEGIN")
        s.execute("INSERT INTO w VALUES (1, 10), (2, 20)")
        s.execute("COMMIT")
        keys = sum(b.write_keys for b in s.store.pd.flow.heartbeat())
        assert keys >= 2
        return keys

    run_both(case)


def test_flow_split_and_merge_redistribute_approximates():
    def case(P, store):
        before = store.pd.flow.stats()
        (rid,) = before
        size, keys = before[rid]
        child = store.cluster.split(P.tablecodec.encode_row_key(TID, 50))
        split = store.pd.flow.stats()
        assert split[rid][1] + split[child.region_id][1] == keys
        assert abs(split[rid][1] - split[child.region_id][1]) <= 1
        store.cluster.merge(rid, child.region_id)
        merged = store.pd.flow.stats()
        assert child.region_id not in merged and merged[rid] == (size, keys)
        return before, split, merged

    run_both(case, pair(rows=100, regions=1, stores=1))


def test_flow_overwrites_and_deletes_track_logical_size():
    def case(P, store):
        (rid,) = store.pd.flow.stats()
        size0, keys0 = store.pd.flow.stats()[rid]
        assert keys0 == 20
        for _ in range(50):
            store.put_row(TID, 0, [1], [P.types.Datum.i64(999)], ts=store.next_ts())
        size1, keys1 = store.pd.flow.stats()[rid]
        assert keys1 == 20 and size1 == size0
        for h in range(20):
            store.delete_row(TID, h, ts=store.next_ts())
        size2, keys2 = store.pd.flow.stats()[rid]
        assert keys2 == 0 and size2 <= size0 // 10
        return (size0, keys0), (size1, keys1), (size2, keys2)

    run_both(case, pair(rows=20, regions=1, stores=1))


def test_load_data_records_region_flow(tmp_path):
    p = tmp_path / "ld.csv"
    p.write_text("".join(f"{i},{i}\n" for i in range(40)))

    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE ld (id INT PRIMARY KEY, v INT)")
        s.execute(f"LOAD DATA INFILE '{p}' INTO TABLE ld FIELDS TERMINATED BY ','")
        n = s.execute("SELECT count(*) FROM ld").values()
        stats = s.store.pd.flow.stats()
        assert n == [[40]] and sum(k for _, k in stats.values()) >= 40
        return n, sorted(stats.values())

    run_both(case)


# ---------------------------------------------------------------- hot peers

def test_hot_peer_cache_hysteresis_and_decay():
    def case(P):
        conf = P.pd.PDConfig(hot_byte_rate=100.0, hot_min_degree=2, hot_decay=0.5)
        c = P.pd.HotPeerCache("read", conf)
        c.update(1, 1000, 10)
        first = [p.region_id for p in c.hot_peers()]
        c.update(1, 1000, 10)
        second = [(p.region_id, p.byte_rate, p.key_rate, p.degree) for p in c.hot_peers()]
        for _ in range(8):
            c.update(1, 0, 0)
        assert first == [] and [x[0] for x in second] == [1] and c.hot_peers() == []
        return first, second, c.rates()

    run_both(case)


# ---------------------------------------------------------------- operators

def test_operator_queue_bounded_and_one_per_region():
    def case(P):
        Op = P.pd.Operator
        q = P.pd.OperatorQueue(limit=2)
        got = [q.add(Op(1, "split", 10)), q.add(Op(2, "move-region", 10)), q.add(Op(3, "merge", 11, peer_region=10)),
               q.add(Op(4, "move-region", 12)), q.add(Op(5, "split", 13))]
        assert got == [True, False, False, True, False] and len(q.pending()) == 2
        return got, [o.op_id for o in q.pending()]

    run_both(case)


def test_operator_timeout_failpoint_expires_pending():
    def case(P, store):
        base = P.metrics.PD_OPERATOR_TIMEOUTS.value
        with P.fp.enabled("pd/operator-timeout"):
            dispatched = store.pd.tick()
        assert dispatched == []
        assert P.metrics.PD_OPERATOR_TIMEOUTS.value > base
        assert any(o.state == "timeout" for o in store.pd.queue.history)
        assert store.cluster.counts_per_store()[0] == len(store.cluster.regions())
        return (P.metrics.PD_OPERATOR_TIMEOUTS.value - base, ops(store.pd.queue.history_view()), layout(store))

    run_both(case, pair(rows=100, regions=2, stores=4, pin_store=0))


def test_heartbeat_lost_failpoint_drops_interval():
    def case(P, store):
        scan_region(P, store, store.cluster.regions()[0])
        base = store.pd.heartbeats_seen
        with P.fp.enabled("pd/heartbeat-lost"):
            store.pd.tick()
        lost = store.pd.heartbeats_seen
        store.pd.tick()
        assert lost == base and store.pd.heartbeats_seen > base
        return base, lost, store.pd.heartbeats_seen

    run_both(case, pair(rows=100, regions=2, stores=1))


# ---------------------------------------------------------------- checkers

def test_split_checker_splits_oversized_region_and_bumps_epoch():
    def case(P, store):
        region = store.cluster.regions()[0]
        epoch0 = region.epoch
        store.pd.conf.max_region_keys = 50
        store.pd.conf.merge_region_keys = -1
        store.pd.conf.merge_region_size = -1
        base = P.metrics.PD_OPERATORS.labels("split").value
        ticks = [ops(store.pd.tick()) for _ in range(4)]
        regions = store.cluster.regions()
        assert len(regions) >= 2 and P.metrics.PD_OPERATORS.labels("split").value > base
        assert store.cluster.region_by_id(region.region_id).epoch > epoch0
        stats = store.pd.flow.stats()
        assert sum(stats[r.region_id][1] for r in regions) == 120
        return ticks, layout(store), stats, P.metrics.PD_OPERATORS.labels("split").value - base

    run_both(case, pair(rows=120, regions=1, stores=1))


def test_merge_checker_folds_adjacent_empty_regions():
    def case(P, store):
        store.cluster.split(P.tablecodec.encode_row_key(TID, 1000))
        store.cluster.split(P.tablecodec.encode_row_key(TID, 2000))
        assert len(store.cluster.regions()) == 3
        base = P.metrics.PD_OPERATORS.labels("merge").value
        ticks = [ops(store.pd.tick()) for _ in range(4)]
        assert len(store.cluster.regions()) < 3 and P.metrics.PD_OPERATORS.labels("merge").value > base
        total = sum(scan_region(P, store, r).chunk.num_rows() for r in store.cluster.regions())
        assert total == 60
        return ticks, layout(store), total

    run_both(case, pair(rows=60, regions=1, stores=1))


# ---------------------------------------------------------------- placement

def test_store_of_miss_routes_through_pd_and_is_recorded():
    def case(P, store):
        base = P.metrics.PD_PLACEMENT_DECISIONS.value
        r = store.cluster.regions()[2]
        with store.cluster._mu:
            store.cluster._store_of.pop(r.region_id)
        first = store.cluster.store_of(r.region_id)
        d1 = P.metrics.PD_PLACEMENT_DECISIONS.value - base
        second = store.cluster.store_of(r.region_id)
        assert d1 == 1 and second == first and P.metrics.PD_PLACEMENT_DECISIONS.value - base == 1
        return first, layout(store)

    run_both(case, pair(rows=40, regions=4, stores=4))


def test_split_child_inherits_parent_store():
    def case(P, store):
        parent = store.cluster.regions()[1]
        parent_store = store.cluster.store_of(parent.region_id)
        child = store.cluster.split(P.tablecodec.encode_row_key(TID, 75))
        assert store.cluster.store_of(child.region_id) == parent_store
        return layout(store)

    run_both(case, pair(rows=100, regions=2, stores=4))


def test_standalone_cluster_without_pd_places_least_loaded():
    def case(P):
        c = P.region.Cluster(n_stores=3)
        for k in (b"b", b"d", b"f"):
            c.split(k)
        c.scatter()
        with c._mu:
            rid = c._regions[1].region_id
            c._store_of.pop(rid)
        sid = c.store_of(rid)
        assert 0 <= sid < 3 and c.store_of(rid) == sid
        return sid, c.counts_per_store()

    run_both(case)


# ---------------------------------------------------------------- schedulers

def test_balance_converges_skewed_placement():
    def case(P, store):
        store.pd.conf.merge_region_keys = -1
        store.pd.conf.merge_region_size = -1
        ticks = [ops(store.pd.tick()) for _ in range(8)]
        counts = store.cluster.counts_per_store()
        total = len(store.cluster.regions())
        assert max(counts.values()) <= total / 2
        assert max(counts.values()) / max(min(counts.values()), 1) <= 2 and min(counts.values()) >= 1
        return ticks, layout(store)

    run_both(case, pair(rows=400, regions=8, stores=4, pin_store=0))


def test_hot_region_scheduler_moves_hot_peer_off_overloaded_store():
    def case(P, store):
        store.pd.conf.hot_byte_rate = 64.0
        store.pd.conf.merge_region_keys = -1
        store.pd.conf.merge_region_size = -1
        store.pd.conf.balance_tolerance = 100
        hot1, hot2 = store.cluster.regions()[:2]
        store.cluster.set_store(hot1.region_id, 0)
        store.cluster.set_store(hot2.region_id, 0)
        base = P.metrics.PD_OPERATORS.labels("move-hot-region").value
        ticks = []
        for _ in range(6):
            for _ in range(4):
                scan_region(P, store, store.cluster.region_by_id(hot1.region_id))
                scan_region(P, store, store.cluster.region_by_id(hot2.region_id))
            ticks.append(ops(store.pd.tick()))
        assert P.metrics.PD_OPERATORS.labels("move-hot-region").value > base
        assert store.cluster.store_of(hot1.region_id) != store.cluster.store_of(hot2.region_id)
        hot = store.pd.hotspot_view()
        assert {p["region_id"] for p in hot["read"]} >= {hot1.region_id, hot2.region_id}
        return ticks, layout(store), hot

    run_both(case, pair(rows=200, regions=4, stores=2))


# ---------------------------------------------------------------- retry path

def test_concurrent_pd_split_retries_through_epoch_not_match():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE c (id INT PRIMARY KEY, v INT)")
        s.execute("INSERT INTO c VALUES " + ",".join(f"({i},{i % 11})" for i in range(200)))
        pd = s.store.pd
        pd.conf.max_region_keys = 40
        pd.conf.merge_region_keys = -1
        pd.conf.merge_region_size = -1
        retries0 = P.metrics.DISTSQL_RETRIES.value
        fired = []

        def mid_dispatch_tick():
            if not fired:
                fired.append(1)
                pd.tick()

        with P.fp.enabled("distsql.before_task", mid_dispatch_tick):
            got = s.execute("SELECT count(*), sum(v) FROM c").values()
        assert fired and len(s.store.cluster.regions()) >= 2
        assert got[0][0] == 200 and int(str(got[0][1])) == sum(i % 11 for i in range(200))
        assert P.metrics.DISTSQL_RETRIES.value > retries0
        return got, layout(s.store), P.metrics.DISTSQL_RETRIES.value - retries0

    run_both(case)


# ---------------------------------------------------------------- surfaces

def test_show_placement_statement():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE p (id INT PRIMARY KEY, v INT)")
        s.execute("INSERT INTO p VALUES (1, 1), (2, 2)")
        s.store.cluster.set_stores(2)
        r = s.execute("SHOW PLACEMENT")
        targets = [row[0] for row in r.values()]
        assert r.columns == ["Target", "Placement", "Scheduling_State"]
        assert any(t.startswith("STORE") for t in targets) and any(t.startswith("REGION") for t in targets)
        assert any("store=" in row[1] for row in r.values())
        return r

    run_both(case)


def test_pd_tick_emits_trace_span():
    import tidb_tpu.topsql as j_topsql

    import tidb_tpu_torch.topsql as p_topsql

    def case(P, store):
        # each package's Top SQL window starts afresh, so the tick's
        # topsql.report phase seals none in either: a window left by an
        # earlier test could have aged past its 1 s span in one package only
        (j_topsql if P is JAX else p_topsql).COLLECTOR.rotate(force=True)
        store.pd.tick()
        root = store.pd.last_tick_root
        assert root is not None and root.name == "pd.tick"
        names = [c.name for c in root.children]
        assert {"pd.heartbeat", "pd.schedule", "pd.dispatch"} <= set(names)
        return names, [sorted(c.attrs.items()) for c in root.children]

    run_both(case, pair(rows=50, regions=2, stores=2))


def test_pd_timer_tick_loop():
    def case(P, store):
        t = store.pd.timer(0.01)
        assert t.name == "pd"
        t.fire_once()
        assert store.pd.ticks >= 1
        return t.name, t.interval, t.fire_count, store.pd.ticks

    run_both(case, pair(rows=50, regions=2, stores=2))


def test_pd_metric_families_pass_scrape_check():
    def case(P, store):
        import os
        import sys

        for _ in range(4):
            store.pd.tick()
        text = P.metrics.REGISTRY.dump()
        for family in ("pd_operator_total", "pd_hot_region", "pd_region_heartbeat_total",
                       "pd_regions", "pd_store_regions", "pd_tick_seconds"):
            assert f"# TYPE {family} " in text, family
        # every operator kind the ticks proposed has its labelled sample
        # (tests/test_pd.py names "move-region", a sample an earlier test
        # of its process creates: these ticks balance by leader transfer)
        kinds = {o.kind for o in store.pd.queue.history_view()}
        assert kinds and all(f'pd_operator_total{{type="{k}"}}' in text for k in kinds)
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
        from scrape_check import validate

        assert validate(text) == []
        return layout(store), sorted(kinds)

    run_both(case, pair(rows=400, regions=8, stores=4, pin_store=0))


def test_hot_key_workload_end_to_end_acceptance():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE acc (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO acc VALUES " + ",".join(f"({i},{i % 13})" for i in range(400)))
        tid = s.catalog.table("acc").table_id
        for i in range(1, 8):
            s.store.cluster.split(P.tablecodec.encode_row_key(tid, i * 50))
        s.store.cluster.set_stores(4)
        for r in s.store.cluster.regions():
            s.store.cluster.set_store(r.region_id, 0)
        pd = s.store.pd
        pd.conf.hot_byte_rate = 64.0
        pd.conf.merge_region_keys = -1
        pd.conf.merge_region_size = -1
        base = {k: P.metrics.PD_OPERATORS.labels(k).value for k in ("move-region", "move-hot-region")}
        ticks, sums = [], []
        for _ in range(6):
            for _ in range(3):
                sums.append(s.execute("SELECT sum(v) FROM acc WHERE id < 50").values())
            ticks.append(ops(pd.tick()))
        counts = s.store.cluster.counts_per_store()
        assert max(counts.values()) <= len(s.store.cluster.regions()) / 2, counts
        hot = pd.hotspot_view()
        assert hot["read"]
        moved = {k: P.metrics.PD_OPERATORS.labels(k).value - base[k] for k in base}
        assert sum(moved.values()) > 0
        n = s.execute("SELECT count(*) FROM acc").values()
        assert n == [[400]]
        return ticks, sums, layout(s.store), hot, moved, n

    run_both(case)


# ------------------------------------------- PD failpoints under dispatch

def test_pd_failpoints_under_concurrent_dispatch():
    """The scanners run on threads beside the ticks, so the ticks' reads of
    their flow are the threads'; what is compared is what does not depend
    on the interleaving: every scan's rows, the queue drained at each
    armed tick, the final layout's convergence, and timeouts counted."""
    def case(P, store):
        rows = 400
        D, T = P.dag, P.types
        dag = D.DAGRequest((D.TableScan(TID, (D.ColumnInfo(1, T.new_longlong()),)),), output_offsets=(0,))
        stop = threading.Event()
        errors: list = []
        scan_counts: list = []

        def scanner():
            while not stop.is_set():
                try:
                    res = P.dispatch.select(store, P.dispatch.KVRequest(dag, P.dispatch.full_table_ranges(TID), 100))
                    scan_counts.append(sum(c.num_rows() for c in res.chunks))
                except Exception as exc:  # noqa: BLE001 — any error fails the test
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=scanner, daemon=True) for _ in range(3)]
        for t in threads:
            t.start()
        drained = []
        try:
            with P.fp.enabled("pd/heartbeat-lost"), P.fp.enabled("pd/operator-timeout"):
                for _ in range(6):
                    store.pd.tick()
                    drained.append(store.pd.queue.pending() == [])
            for _ in range(16):
                store.pd.tick()
                counts = store.cluster.counts_per_store()
                if max(counts.values()) - min(counts.values()) <= store.pd.conf.balance_tolerance:
                    break
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and scan_counts and all(c == rows for c in scan_counts)
        timed_out = [o for o in store.pd.queue.history if o.state == "timeout"]
        assert timed_out
        assert P.metrics.REGISTRY.counter("pd_operator_timeout_total").value >= len(timed_out)
        assert store.pd.queue.pending() == []
        counts = store.cluster.counts_per_store()
        return drained, set(scan_counts), bool(timed_out), max(counts.values()) - min(counts.values()) <= 1

    run_both(case, pair(rows=400, regions=8, stores=4, pin_store=0))


def test_stores_view_exposes_health_and_breaker_state():
    def case(P, store):
        store.set_down(2)
        store.pd.tick()
        view = {d["store_id"]: d for d in store.pd.stores_view()}
        assert view[2]["state"] == "down" and view[0]["state"] == "up"
        assert all("breaker" in d for d in view.values())
        store.set_up(2)
        store.pd.tick()
        after = {d["store_id"]: d["state"] for d in store.pd.stores_view()}
        assert after[2] == "up"
        return sorted(view.items()), after

    run_both(case, pair(rows=100, regions=4, stores=4))
