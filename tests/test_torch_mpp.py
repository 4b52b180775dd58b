"""The port's MPP tier (tidb_tpu_torch/mpp/dispatch.py try_mpp_select and
the wire codec's fragment frames) against the JAX package's, on the CPU:
tests/test_mpp.py's TestFragmentWire and TestMppDispatch, with the session
path of its non-unique build join. Its
`test_replica_served_probe_matches_row_store`, whose probe scan comes from
the columnar replica, is in tests/test_torch_columnar.py.

The fragment frames are byte-exact: the port's encode_fragment_plan of the
Q3 chain (one and three joins), the aggregation shape and the partitioned
probe table's plan equals the JAX package's, and each side decodes the
other's bytes. The dispatch cases run the same SQL on a JAX session (on
tests/conftest.py's eight virtual CPU devices) and a port session on
`mesh_devices=["cpu"] * 8`, each package arming its own failpoints: the
rows (in order), the MPP / mesh / retry counter deltas and the fallbacks
must be equal, and each must equal its own mesh-off answer. Tolerance:
exact.
"""

import os
import sys

import pytest

from torch_sql_parity import norm, run_both

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def _scan(P, tid):
    I = P.types.new_longlong()
    return P.dag.TableScan(tid, (P.dag.ColumnInfo(1, I), P.dag.ColumnInfo(2, I)))


def _chain_dag(P, n_joins):
    D, X, I = P.dag, P.expr, P.types.new_longlong()
    exs = [_scan(P, 10)]
    for j in range(n_joins):
        exs.append(D.Join(build=(_scan(P, 11 + j),), probe_keys=(X.col(0, I),), build_keys=(X.col(0, I),),
                          join_type="inner"))
    exs.append(D.Aggregation(group_by=(X.col(1, I),), aggs=(X.AggDesc("count", ()),)))
    return D.DAGRequest(tuple(exs), output_offsets=(0, 1))


def _agg_dag(P):
    D, X, I = P.dag, P.expr, P.types.new_longlong()
    return D.DAGRequest((_scan(P, 10), D.Selection((X.func("gt", I, X.col(1, I), X.lit(2, I)),)),
                         D.Aggregation(group_by=(X.col(0, I),), aggs=(X.AggDesc("count", ()),))),
                        output_offsets=(0, 1))


PARTITIONED_SQL = "select pt.g, count(*), sum(v) from pt join pd on pt.g = d_id group by pt.g"


def _partitioned_session(P):
    s = P.new_session(mesh=True)
    s.execute("create table pd (d_id bigint primary key, g bigint)")
    s.execute("insert into pd values " + ",".join(f"({i}, {i % 5})" for i in range(20)))
    s.execute("CREATE TABLE pt (a BIGINT PRIMARY KEY, g BIGINT, v BIGINT) PARTITION BY HASH(a) PARTITIONS 3")
    s.execute("insert into pt values " + ",".join(f"({i}, {i % 5}, {i * 7 % 23})" for i in range(300)))
    return s


def _partitioned_dag(P):
    s = _partitioned_session(P)
    return P.sql.plan_select(P.parse_one(PARTITIONED_SQL), s.catalog).dag


SHAPES = {"chain1": lambda P: _chain_dag(P, 1), "chain3": lambda P: _chain_dag(P, 3), "agg": _agg_dag,
          "partitioned": _partitioned_dag}


class TestFragmentWire:
    @pytest.mark.parametrize("shape", list(SHAPES))
    def test_topology_round_trips_byte_exactly(self, shape):
        from tidb_tpu.codec import wire as JW

        from tidb_tpu_torch.codec import wire as TW

        def case(P):
            fp = P.fragment.fragment_plan(SHAPES[shape](P), n_tasks=8)
            assert fp is not None
            raw = P.wire.encode_fragment_plan(fp)
            fp2 = P.wire.decode_fragment_plan(raw)
            assert P.wire.encode_fragment_plan(fp2) == raw
            assert (fp2.n_tasks, fp2.root, len(fp2.fragments)) == (fp.n_tasks, fp.root, len(fp.fragments))
            for a, b in zip(fp.fragments, fp2.fragments):
                assert a.idx == b.idx and len(a.executors) == len(b.executors)
                assert (a.sender.exchange_type, a.sender.target_fragment, len(a.sender.partition_keys)) == \
                       (b.sender.exchange_type, b.sender.target_fragment, len(b.sender.partition_keys))
                assert [r.source_fragment for r in a.receivers] == [r.source_fragment for r in b.receivers]
            return raw

        raw = run_both(case)[1]
        # each package decodes the other's frame to a plan that re-encodes
        # to the same bytes
        assert TW.encode_fragment_plan(TW.decode_fragment_plan(raw)) == raw
        assert JW.encode_fragment_plan(JW.decode_fragment_plan(raw)) == raw


def _q3_session(P, nl=600, no=40, nc=12):
    s = P.new_session(mesh=True)
    s.execute("create table cust (c_id bigint primary key, seg varchar(2))")
    s.execute("insert into cust values " + ",".join(f"({i}, '{'AB'[i % 2]}')" for i in range(nc)))
    s.execute("create table ords (o_id bigint primary key, ckey bigint, odate bigint)")
    s.execute("insert into ords values " + ",".join(f"({i}, {i % nc}, {1000 + i % 9})" for i in range(no)))
    s.execute("create table items (i_id bigint primary key, oid bigint, v decimal(10,2))")
    s.execute("insert into items values " + ",".join(f"({i}, {(i * 3) % (no + 4)}, {i}.25)" for i in range(nl)))
    return s


Q3_SQL = ("select oid, count(*), sum(v) from items join ords on oid = o_id join cust on ckey = c_id "
          "where seg = 'B' and odate < 1007 group by oid")
COUNTERS = ("MPP_SELECTS", "MPP_FRAGMENTS", "MPP_TASKS", "MPP_FALLBACKS", "MPP_EXCHANGED_BYTES", "MESH_SELECTS",
            "DISTSQL_RETRIES")


def _canon(rows):
    return sorted(tuple(None if d.is_null() else str(d.val) for d in r) for r in rows)


def _counters(P) -> dict:
    return {k: getattr(P.metrics, k).value for k in COUNTERS}


def _run(P, s, sql, armed=None, hits=None):
    """The statement's rows and the counters it moved, then its rows with
    the mesh off (the per-region path), which must be the same set."""
    c0 = _counters(P)
    if armed is None:
        rows = s.execute(sql).rows
    else:
        with P.fp.enabled(armed, hits) if hits is not None else P.fp.enabled(armed):
            rows = s.execute(sql).rows
    moved = {k: v - c0[k] for k, v in _counters(P).items()}
    s.execute("set tidb_enable_tpu_mesh = OFF")
    assert _canon(rows) == _canon(s.execute(sql).rows)
    return norm(rows), moved


class TestMppDispatch:
    def test_q3_chain_rides_mpp_byte_identical(self):
        def case(P):
            rows, moved = _run(P, _q3_session(P), Q3_SQL)
            assert moved["MPP_SELECTS"] == 1 and moved["MPP_FRAGMENTS"] >= 2 and moved["MPP_EXCHANGED_BYTES"] > 0
            return rows, moved

        run_both(case)

    def test_allow_mpp_off_takes_the_mesh_shortcut(self):
        def case(P):
            s = _q3_session(P)
            s.execute("set tidb_allow_mpp = OFF")
            rows, moved = _run(P, s, Q3_SQL)
            assert moved["MPP_SELECTS"] == 0 and moved["MESH_SELECTS"] == 1
            return rows, moved

        run_both(case)

    @pytest.mark.parametrize("failpoint", ["mpp/dispatch-lost", "mpp/exchange-stall"])
    def test_failpoint_is_a_counted_fallback(self, failpoint):
        """test_dispatch_lost_is_a_counted_fallback and
        test_exchange_stall_is_a_counted_fallback: the MPP run is abandoned
        (one MPP_FALLBACKS) and the mesh select answers."""
        def case(P):
            rows, moved = _run(P, _q3_session(P), Q3_SQL, armed=failpoint)
            assert moved["MPP_SELECTS"] == 0 and moved["MPP_FALLBACKS"] == 1 and moved["MESH_SELECTS"] == 1
            return rows, moved

        run_both(case)

    def test_mid_query_epoch_error_retries_typed(self):
        def case(P):
            rows, moved = _run(P, _q3_session(P), Q3_SQL, armed="cop-region-error", hits=1)
            assert moved["DISTSQL_RETRIES"] == 1 and moved["MPP_SELECTS"] == 1
            return rows, moved

        run_both(case)

    def test_partitioned_probe_table_rides_mpp(self):
        def case(P):
            rows, moved = _run(P, _partitioned_session(P), PARTITIONED_SQL)
            assert moved["MPP_SELECTS"] == 1
            return rows, moved

        run_both(case)

    def test_non_unique_build_join_on_session_path(self):
        def case(P):
            sql = "select ckey, count(*), sum(v) from items join ords on oid = ckey group by ckey"
            rows, moved = _run(P, _q3_session(P), sql)
            assert moved["MPP_SELECTS"] == 1
            return rows, moved

        run_both(case)

    def test_mpp_metric_families_pass_scrape_check(self):
        def case(P):
            s = _q3_session(P)
            s.execute(Q3_SQL)
            text = P.metrics.REGISTRY.dump()
            families = ("tidb_tpu_mpp_selects_total", "tidb_tpu_mpp_fragments_total", "tidb_tpu_mpp_tasks_total",
                        "tidb_tpu_mpp_fallbacks_total", "tidb_tpu_mpp_exchanged_bytes_total")
            for family in families:
                assert f"# TYPE {family}" in text, family
            from scrape_check import validate

            assert validate(text) == []
            return [f for f in families if f"# TYPE {f}" in text]

        run_both(case)

    def test_trace_shows_the_dispatch_span(self):
        """TRACE of the statement shows the mpp.dispatch span (the trace
        test_replica_served_probe_matches_row_store reads, here over the
        row store's probe scan)."""
        def case(P):
            s = _q3_session(P)
            r = s.execute("TRACE " + Q3_SQL).values()
            names = [str(row[0]).strip() for row in r]
            assert "mpp.dispatch" in names
            # the port's exchange program also traces its exchanges and
            # local joins (mpp.exchange / mpp.local_join spans), where the
            # JAX package's runs inside one shard_map program
            return names.count("mpp.dispatch")

        run_both(case)
