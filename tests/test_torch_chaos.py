"""The port's fault ladder, circuit breakers and failover (tidb_tpu_torch/
store/store.py _region_fault and its failpoints, distsql/dispatch.py's
breakers and retries, pd/core.py failover_region) against the JAX
package's, on the CPU: the typed-error, breaker, failover and session
error-code cases of tests/test_chaos.py (its seeded storm,
tools/chaos.py run_chaos, is the reference's harness over its own
package).

A JAX TPUStore is filled as the reference's fill_store fills it and both
packages' stores are started from its state (interop); the session cases
run the same SQL on a session of each package. Each scenario keeps the
reference's assertions, arms its own package's failpoints, and returns the
typed error kinds, breaker states, counter deltas, layouts and rows, which
must be equal. Where dispatch runs on a thread pool the failover order is
the pool's, and the scenario returns what does not depend on it.
Tolerance: exact.
"""

import pytest

from torch_sql_parity import chunk_rows, fill_pair, layout, run_both

TID = 11


def scan_req(P, **kw):
    D, T = P.dag, P.types
    dag = D.DAGRequest((D.TableScan(TID, (D.ColumnInfo(1, T.new_longlong()),)),), output_offsets=(0,))
    return P.dispatch.KVRequest(dag, P.dispatch.full_table_ranges(TID), start_ts=100, **kw)


def rows_of(res) -> int:
    return sum(c.num_rows() for c in res.chunks)


def make_session(P, rows=160, regions=8, stores=4):
    s = P.new_session()
    s.execute("CREATE TABLE ft (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO ft VALUES " + ",".join(f"({i},{i % 9})" for i in range(rows)))
    tid = s.catalog.table("ft").table_id
    for i in range(1, regions):
        s.store.cluster.split(P.tablecodec.encode_row_key(tid, i * rows // regions))
    s.store.cluster.set_stores(stores)
    s.store.cluster.scatter()
    return s


def err_of(P, s: str):
    e = P.store.parse_region_error(s)
    return None if e is None else (type(e).__name__, e.kind, str(e))


# ------------------------------------------------------- typed region errors

def test_parse_round_trips_every_kind():
    def case(P):
        S = P.store
        out = []
        for err, cls, attrs in [(S.NotLeader.make(5, 2), S.NotLeader, {"store_id": 2}),
                                (S.ServerIsBusy.make(1, 250), S.ServerIsBusy, {"backoff_ms": 250}),
                                (S.StoreUnavailable.make(3), S.StoreUnavailable, {"store_id": 3})]:
            back = S.parse_region_error(str(err))
            assert isinstance(back, cls) and back.kind == err.kind
            assert all(getattr(back, k) == v for k, v in attrs.items())
            out.append((str(err), back.kind))
        assert isinstance(S.parse_region_error("epoch_not_match: have 3, got 2"), S.EpochNotMatch)
        assert isinstance(S.parse_region_error("region 9 not found"), S.RegionNotFound)
        assert S.parse_region_error("mystery failure").kind == "region_miss"
        assert S.parse_region_error(None) is None
        return out

    run_both(case)


def test_region_errors_survive_the_wire_seam():
    def case(P, store):
        W = P.wire
        store.set_down(0)
        region = next(r for r in store.cluster.regions() if store.cluster.store_of(r.region_id) == 0)
        creq = P.store.CopRequest(scan_req(P).dag, [P.store.KeyRange(region.start_key, region.end_key)], 100,
                                  region.region_id, region.epoch)
        resp = W.decode_cop_response(store.coprocessor_bytes(W.encode_cop_request(creq)))
        err = P.store.parse_region_error(resp.region_error)
        assert isinstance(err, P.store.StoreUnavailable) and err.store_id == 0
        resps = W.decode_batch_cop_response(store.batch_coprocessor_bytes(W.encode_batch_cop_request([creq, creq])))
        assert all(isinstance(P.store.parse_region_error(r.region_error), P.store.StoreUnavailable) for r in resps)
        return err_of(P, resp.region_error), [err_of(P, r.region_error) for r in resps]

    run_both(case, fill_pair(TID))


def test_per_store_failpoint_arming():
    def case(P, store):
        S = P.store
        by_store = {}
        for r in store.cluster.regions():
            by_store.setdefault(store.cluster.store_of(r.region_id), r)
        dag = scan_req(P).dag

        def cop(region):
            return store.coprocessor(S.CopRequest(dag, [S.KeyRange(region.start_key, region.end_key)], 100,
                                                  region.region_id, region.epoch))

        out = []
        with P.fp.enabled("store/not-leader", {1}):
            ok, bad = cop(by_store[0]), cop(by_store[1])
            assert ok.region_error is None and isinstance(S.parse_region_error(bad.region_error), S.NotLeader)
            out += [chunk_rows([ok.chunk]), err_of(P, bad.region_error)]
        with P.fp.enabled("store/server-busy", {"stores": {2}, "backoff_ms": 40}):
            busy = S.parse_region_error(cop(by_store[2]).region_error)
            assert isinstance(busy, S.ServerIsBusy) and busy.backoff_ms == 40
            out.append((busy.kind, busy.backoff_ms))
        with P.fp.enabled("store/unreachable", {3}):
            pings = (store.ping_store(3), store.ping_store(0))
            assert pings == (False, True)
            down = cop(by_store[3])
            assert isinstance(S.parse_region_error(down.region_error), S.StoreUnavailable)
            out += [pings, err_of(P, down.region_error)]
        healthy = cop(by_store[3])
        assert healthy.region_error is None
        return out + [chunk_rows([healthy.chunk])]

    run_both(case, fill_pair(TID))


# --------------------------------------------------------- circuit breakers

def test_opens_after_threshold_probes_and_recloses():
    def case(P):
        t = [0.0]
        br = P.dispatch.CircuitBreaker(0, threshold=3, probe_after=1.0, now_fn=lambda: t[0])
        seq = [br.allow_request(), br.record_failure(), br.record_failure(), br.record_failure(), br.state,
               br.allow_request()]
        t[0] += 1.5
        seq += [br.allow_request(), br.allow_request(), br.record_failure(), br.state]
        t[0] += 1.5
        seq.append(br.allow_request())
        br.record_success()
        seq += [br.state, br.allow_request()]
        assert seq == [True, False, False, True, "open", False, True, False, True, "open", True, "closed", True]
        return seq

    run_both(case)


def test_success_resets_consecutive_failures():
    def case(P):
        br = P.dispatch.CircuitBreaker(0, threshold=3)
        br.record_failure(), br.record_failure()
        br.record_success()
        seq = [br.record_failure(), br.record_failure(), br.state]
        assert seq == [False, False, "closed"]
        return seq

    run_both(case)


def test_board_views():
    def case(P):
        board = P.dispatch.BreakerBoard(threshold=1, probe_after=99.0)
        board.record_failure(2)
        seq = [board.open_stores(), board.states(), board.all_closed()]
        board.record_success(2)
        seq.append(board.all_closed())
        assert seq[0] == {2} and seq[1][2] == "open" and not seq[2] and seq[3]
        return [sorted(seq[0])] + seq[1:]

    run_both(case)


# ----------------------------------------------- dispatch failover via PD

def test_down_store_fails_over_and_query_answers():
    def case(P, store):
        store.set_down(1)
        f0 = P.metrics.PD_FAILOVERS.value
        res = P.dispatch.select(store, scan_req(P))
        assert rows_of(res) == 120 and P.metrics.PD_FAILOVERS.value > f0
        assert store.cluster.counts_per_store().get(1, 0) == 0
        assert store.breakers.states()[1] == "open" and store.pd.store_state(1) == "down"
        return (chunk_rows(res.chunks), store.cluster.counts_per_store()[1], store.breakers.states()[1],
                store.pd.store_state(1), store.cluster.peer_counts_per_store())

    run_both(case, fill_pair(TID))


def test_down_store_mid_batch_fails_over():
    def case(P, store):
        store.set_down(2)
        res = P.dispatch.select(store, scan_req(P, batch_cop=True))
        assert rows_of(res) == 120 and store.cluster.counts_per_store().get(2, 0) == 0
        return chunk_rows(res.chunks), store.cluster.counts_per_store()[2], store.breakers.states()[2]

    run_both(case, fill_pair(TID, rows=120, regions=6, stores=3))


def test_open_breaker_skips_batch_dispatch():
    def case(P, store):
        store.breakers = P.dispatch.BreakerBoard(threshold=3, probe_after=99.0)
        for _ in range(3):
            store.breakers.record_failure(0)
        c0 = P.metrics.COP_ERRORS.value
        res = P.dispatch.select(store, scan_req(P, batch_cop=True))
        assert rows_of(res) == 120
        # the open breaker meant no request reached the (healthy) store's
        # fault path: the lanes failed over before sending
        assert P.metrics.COP_ERRORS.value == c0 and store.cluster.counts_per_store().get(0, 0) == 0
        return chunk_rows(res.chunks), store.cluster.counts_per_store()[0], P.metrics.COP_ERRORS.value - c0

    run_both(case, fill_pair(TID, rows=120, regions=6, stores=3))


def test_all_stores_down_raises_region_unavailable():
    def case(P, store):
        store.set_down(0), store.set_down(1)
        with pytest.raises(P.dispatch.RegionUnavailableError, match="backoff budget exhausted") as ei:
            P.dispatch.select(store, scan_req(P, backoff_weight=0))
        return type(ei.value).__name__

    run_both(case, fill_pair(TID, rows=60, regions=2, stores=2))


def test_select_stream_surfaces_identical_typed_errors():
    def case(P, store):
        store.set_down(0), store.set_down(1)
        with pytest.raises(P.dispatch.RegionUnavailableError) as e1:
            list(P.dispatch.select_stream(store, scan_req(P, backoff_weight=0)))
        for sid in (0, 1):
            store.set_up(sid)
        with P.fp.enabled("cop-other-error"):
            with pytest.raises(P.dispatch.CopInternalError) as e2:
                list(P.dispatch.select_stream(store, scan_req(P)))
        return type(e1.value).__name__, type(e2.value).__name__, str(e2.value)

    run_both(case, fill_pair(TID, rows=60, regions=2, stores=2))


def test_server_busy_honors_suggested_backoff_then_succeeds():
    def case(P, store):
        b0 = P.metrics.BACKOFF_SECONDS.labels("server_busy").value
        hits = [0]

        def flaky():
            hits[0] += 1
            return {"stores": {1}, "backoff_ms": 4} if hits[0] <= 3 else None

        with P.fp.enabled("store/server-busy", flaky):
            res = P.dispatch.select(store, scan_req(P, concurrency=1))
        slept = P.metrics.BACKOFF_SECONDS.labels("server_busy").value - b0
        assert rows_of(res) == 60 and slept > 0
        return chunk_rows(res.chunks), hits[0]

    run_both(case, fill_pair(TID, rows=60, regions=2, stores=2))


def test_pd_tick_health_probe_recloses_breakers():
    def case(P, store):
        store.set_down(3)
        P.dispatch.select(store, scan_req(P))
        opened = store.breakers.states()[3]
        store.set_up(3)
        store.pd.tick()
        view = {d["store_id"]: d for d in store.pd.stores_view()}
        assert opened == "open" and store.breakers.all_closed() and store.pd.store_state(3) == "up"
        assert view[3]["state"] == "up" and view[3]["breaker"] == "closed"
        return opened, store.breakers.states(), sorted((k, v["state"], v["breaker"]) for k, v in view.items())

    run_both(case, fill_pair(TID))


# ------------------------------------------------------- session error codes

def test_exhausted_backoff_maps_to_9005():
    def case(P):
        s = make_session(P, rows=60, regions=2, stores=2)
        s.execute("SET tidb_backoff_weight = 0")
        s.store.set_down(0), s.store.set_down(1)
        with pytest.raises(P.sql.SQLError, match="Region is unavailable") as ei:
            s.execute("SELECT count(*) FROM ft")
        s.store.set_up(0), s.store.set_up(1)
        assert ei.value.code == 9005
        return ei.value.code

    run_both(case)


def test_backoff_weight_sysvar_scales_the_budget():
    def case(P):
        s = make_session(P, rows=60, regions=2, stores=2)
        s.store.set_down(0)
        s.execute("SET tidb_backoff_weight = 0")
        with pytest.raises(P.sql.SQLError) as ei:
            s.execute("SELECT count(*) FROM ft")
        assert ei.value.code == 9005
        s.execute("SET tidb_backoff_weight = 2")
        n = s.execute("SELECT count(*) FROM ft").scalar()
        assert n == 60
        s.store.set_up(0)
        return ei.value.code, n, layout(s.store)

    run_both(case)


def test_other_error_maps_to_1105():
    def case(P):
        s = make_session(P, rows=40, regions=2, stores=1)
        with P.fp.enabled("cop-other-error"):
            with pytest.raises(P.sql.SQLError) as ei:
                s.execute("SELECT count(*) FROM ft")
        assert ei.value.code == 1105
        return ei.value.code, str(ei.value)

    run_both(case)
