"""Statement tracing and the metric families in the PyTorch port (the
port's counterpart of tests/test_tracing.py): the span tree behind TRACE,
the tracing primitives' threading contract, the device-time attribution
riding the exec summaries, and the Prometheus exposition contract of
tools/scrape_check, all against `tidb_tpu_torch.util.tracing` and
`tidb_tpu_torch.util.metrics` on `device="cpu"`.

The parity half runs the same statements through `tidb_tpu.sql.Session`
and `tidb_tpu_torch.sql.Session(device="cpu")` and holds the two span
trees (names and attribute keys) and the deltas of the store's, the
program cache's and the native decoder's 13 counter families equal: the
single tier, the batch tier, an oracle fallback, a result-cache repeat, a
radix join and `TRACE select sum(v) from t where v > 1`.
"""

import json
import os
import sys
import threading
import urllib.request

import pytest

import tidb_tpu.exec.executor as j_executor
import tidb_tpu_torch.exec.executor as p_executor
from tidb_tpu_torch.codec import tablecodec
from tidb_tpu_torch.sql.session import Session
from tidb_tpu_torch.util import tracing

from chip_smoke import OBSERVE_FAMILIES as FAMILIES, family_deltas, family_values
from torch_sql_parity import JAX, PORT, norm, run_case, same, session_pair

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from scrape_check import validate  # noqa: E402


@pytest.fixture()
def sess():
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i % 5})" for i in range(1, 61)))
    tid = s.catalog.table("t").table_id
    for h in (20, 40):  # 3 regions
        s.store.cluster.split(tablecodec.encode_row_key(tid, h))
    return s


def _find(node, name):
    out = [node] if node["name"] == name else []
    for c in node.get("children", []):
        out.extend(_find(c, name))
    return out


# ---------------------------------------------------------------- primitives
class TestSpanPrimitives:
    def test_span_is_noop_without_trace(self):
        assert tracing.current_span() is None
        with tracing.span("anything") as sp:
            assert sp is None  # zero bookkeeping when tracing is off
        assert tracing.current_span() is None

    def test_nesting_and_attrs(self):
        with tracing.trace("root") as root:
            with tracing.span("child", k=1) as c:
                c.set("rows", 7)
                with tracing.span("grand"):
                    pass
        assert [c.name for c in root.children] == ["child"]
        assert root.children[0].attrs == {"k": 1, "rows": 7}
        assert [g.name for g in root.children[0].children] == ["grand"]
        # every span finished, children contained in the parent window
        assert root.end_ns is not None
        assert root.children[0].duration_ns <= root.duration_ns

    def test_exception_recorded_and_reraised(self):
        with tracing.trace("root") as root:
            with pytest.raises(ValueError):
                with tracing.span("boom"):
                    raise ValueError("no")
        assert "ValueError: no" in root.children[0].attrs["error"]
        assert root.children[0].end_ns is not None

    def test_cross_thread_parent_handoff(self):
        """Pool workers do not inherit contextvars; the explicit parent=
        handoff is how dispatch parents its cop-task spans."""
        with tracing.trace("root") as root:
            parent = tracing.current_span()

            def worker():
                assert tracing.current_span() is None  # not inherited
                with tracing.span("task", parent=parent, region_id=9):
                    pass

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert [c.name for c in root.children] == ["task"]
        assert root.children[0].attrs["region_id"] == 9

    def test_find_and_rows_render(self):
        with tracing.trace("root") as root:
            with tracing.span("a"):
                with tracing.span("b"):
                    pass
            with tracing.span("b"):
                pass
        assert len(root.find("b")) == 2
        ops = [r[0] for r in root.rows()]
        assert ops == ["root", "  a", "    b", "  b"]


# ---------------------------------------------------------------- TRACE stmt
class TestTraceStatement:
    @staticmethod
    def _tree(sess, sql):
        res = sess.execute(f"TRACE FORMAT='json' {sql}")
        assert res.columns == ["trace"]
        return json.loads(res.values()[0][0])

    def test_multi_region_aggregate_span_shape(self, sess):
        tree = self._tree(sess, "SELECT v, count(*) FROM t GROUP BY v")
        assert tree["name"] == "session"
        assert _find(tree, "session.execute")
        assert _find(tree, "planner.plan")
        dispatch = (_find(tree, "distsql.execute_root") + _find(tree, "parallel.mesh_select")
                    + _find(tree, "mpp.dispatch"))
        assert dispatch
        cop = _find(tree, "distsql.cop_task")
        assert len(cop) == 3  # one child span per region
        assert sorted(c["attrs"]["region_id"] for c in cop) == [1, 2, 3]
        assert all(c["attrs"]["rows"] >= 1 for c in cop)
        # each region task decodes and executes under its cop_task span
        assert len(_find(tree, "cop.decode")) == 3 and len(_find(tree, "cop.execute")) == 3
        # the program built at most once across the per-region tasks
        # (cache hits after)
        progs = _find(tree, "exec.program")
        assert progs and all("cache_hit" in p["attrs"] for p in progs)
        assert sum(1 for p in progs if not p["attrs"]["cache_hit"]) <= 2  # push + root merge
        assert all(p["attrs"]["compile_ns"] > 0 for p in progs if not p["attrs"]["cache_hit"])

    def test_durations_sum_consistently(self, sess):
        tree = self._tree(sess, "SELECT v, count(*) FROM t GROUP BY v")

        def check(node):
            for c in node.get("children", []):
                assert c["duration_ns"] <= node["duration_ns"]
                check(c)

        check(tree)
        dispatch = (_find(tree, "distsql.execute_root") + _find(tree, "parallel.mesh_select")
                    + _find(tree, "mpp.dispatch"))[0]
        cop = _find(tree, "distsql.cop_task")
        assert cop and all(c["duration_ns"] <= dispatch["duration_ns"] for c in cop)

    def test_row_format(self, sess):
        res = sess.execute("TRACE SELECT count(*) FROM t")
        assert res.columns == ["operation", "start_us", "duration_us", "attrs"]
        ops = [r[0] for r in res.values()]
        assert ops[0] == "session"
        assert any(op.lstrip().startswith("distsql.cop_task") for op in ops)
        # indentation encodes the tree depth
        assert any(op.startswith("  ") for op in ops)

    def test_trace_of_failing_statement_returns_partial_tree(self, sess):
        res = sess.execute("TRACE FORMAT='json' SELECT * FROM no_such_table")
        tree = json.loads(res.values()[0][0])
        assert "error" in tree["attrs"]
        assert _find(tree, "session.execute")  # the partial tree survived

    def test_trace_dml(self, sess):
        tree = self._tree(sess, "INSERT INTO t VALUES (1000, 1)")
        assert tree["attrs"].get("rows") == 1
        assert sess.execute("SELECT v FROM t WHERE id = 1000").values() == [[1]]


# ------------------------------------------------------- summary attribution
class TestExecSummaryAttribution:
    def test_summaries_carry_compile_and_bytes(self, sess):
        from tidb_tpu_torch.distsql import full_table_ranges
        from tidb_tpu_torch.distsql.dispatch import KVRequest, select
        from tidb_tpu_torch.exec.dag import DAGRequest, TableScan

        meta = sess.catalog.table("t")
        scan = TableScan(meta.table_id, meta.scan_columns())
        dag = DAGRequest((scan,), output_offsets=(0, 1))
        res = select(sess.store, KVRequest(dag, full_table_ranges(meta.table_id), sess.store.next_ts()))
        assert len(res.exec_summaries) == 3  # one per region task
        for task_sums in res.exec_summaries:
            assert task_sums[0].num_bytes > 0  # decoded region bytes
        # a second identical dispatch: every program comes from the cache
        res2 = select(sess.store, KVRequest(dag, full_table_ranges(meta.table_id), sess.store.next_ts()))
        assert all(s[0].cache_hit for s in res2.exec_summaries)
        assert all(s[0].time_compile_ns == 0 for s in res2.exec_summaries)

    def test_wire_roundtrip_preserves_attribution(self):
        from tidb_tpu_torch.codec.wire import decode_cop_response, encode_cop_response
        from tidb_tpu_torch.store.store import CopResponse, ExecSummary

        resp = CopResponse(
            chunk=None,
            exec_summaries=[ExecSummary(10, 5, 1, time_compile_ns=77, cache_hit=True, num_bytes=123)],
        )
        out = decode_cop_response(encode_cop_response(resp))
        s = out.exec_summaries[0]
        assert (s.time_compile_ns, s.cache_hit, s.num_bytes) == (77, True, 123)


# ------------------------------------------------------------ slow-log links
class TestSlowLogArtifacts:
    def test_fast_failure_leaves_slow_log_entry(self, sess):
        from tidb_tpu_torch.util import failpoint

        sess.execute("SET tidb_slow_log_threshold = 100000")  # nothing is slow
        failpoint.enable("cop-other-error", 1)
        try:
            with pytest.raises(Exception, match="injected"):
                sess.execute("SELECT sum(v) FROM t")
        finally:
            failpoint.disable("cop-other-error")
        rows = sess.execute("SELECT query, success, error FROM information_schema.slow_query").values()
        failed = [r for r in rows if r[1] == 0]
        assert failed and any("injected" in (r[2] or "") for r in failed)

    def test_plan_digest_joins_slow_log(self, sess):
        sess.execute("SET tidb_slow_log_threshold = 0")  # everything is slow
        sess.execute("SELECT sum(v) FROM t")
        rows = sess.execute("SELECT plan_digest, query FROM information_schema.slow_query").values()
        digests = [r[0] for r in rows if "sum(v)" in r[1].lower()]
        assert digests and all(len(d) == 32 for d in digests)


# ------------------------------------------------------------- metrics/text
class TestMetricsExposition:
    def test_dump_passes_scrape_check(self, sess):
        sess.execute("SELECT sum(v) FROM t")  # move some instruments
        from tidb_tpu_torch.util import metrics

        text = metrics.REGISTRY.dump()
        assert validate(text) == []
        assert "# HELP tidb_tpu_cop_requests_total" in text
        assert "# TYPE tidb_tpu_cop_duration_seconds histogram" in text
        assert 'tidb_tpu_cop_duration_seconds_bucket{le="+Inf"}' in text
        # the store's and program cache's families moved and are exposed
        assert metrics.PROGRAM_LAUNCHES.value > 0 and metrics.PROGRAM_COMPILE_DURATION.count > 0
        assert "# TYPE tidb_tpu_program_compile_seconds histogram" in text
        assert 'tidb_tpu_cop_executor_rows_total{executor="tablescan"}' in text

    def test_status_server_metrics_pass_scrape_check(self, sess):
        from tidb_tpu_torch.server.http_api import StatusServer

        sess.execute("SELECT sum(v) FROM t WHERE v > 1")
        srv = StatusServer(sess).start_background()
        try:
            text = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
        finally:
            srv.close()
        assert validate(text) == []
        for family in FAMILY_NAMES:
            assert f"# TYPE {family} " in text, family

    def test_an_unobserved_histogram_vec_passes_the_scrape_check(self):
        """A histogram family with no label set yet (the distsql task
        latency before a process's first select) has no samples: the
        registry leaves it out until its first observation, so the
        exposition passes whatever ran before in the process."""
        from tidb_tpu_torch.util.metrics import Registry

        reg = Registry()
        reg.counter_vec("t_requests_total", "requests", labelnames=("kind",))
        hist = reg.histogram_vec("t_task_seconds", "task latency", labelnames=("scan",))
        text = reg.dump()
        assert validate(text) == [], validate(text)
        assert "t_task_seconds" not in text and "# TYPE t_requests_total counter" in text
        hist.labels("table").observe(0.02)
        text = reg.dump()
        assert validate(text) == [], validate(text)
        assert "# TYPE t_task_seconds histogram" in text
        assert 't_task_seconds_bucket{scan="table",le="+Inf"} 1' in text

    def test_labeled_vec_exposition(self):
        from tidb_tpu_torch.util import metrics

        metrics.STATEMENTS.labels("select", "ok").inc(3)
        metrics.DISTSQL_TASK_DURATION.labels("table").observe(0.02)
        text = metrics.REGISTRY.dump()
        assert validate(text) == []
        assert 'tidb_tpu_statements_total{type="select",status="ok"}' in text
        assert 'tidb_tpu_distsql_task_duration_seconds_bucket{scan="table",le="0.05"}' in text

    def test_gauge_moves_both_ways(self, sess):
        from tidb_tpu_torch.util import metrics

        base = metrics.OPEN_TXNS.value
        sess.execute("BEGIN")
        assert metrics.OPEN_TXNS.value == base + 1
        sess.execute("ROLLBACK")
        assert metrics.OPEN_TXNS.value == base

    def test_scrape_check_rejects_bad_expositions(self):
        assert validate('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\nh_sum 1.0\nh_count 3\n')
        assert validate("# TYPE c counter\nc -4\n")
        assert validate("# TYPE c counter\nc 1\nc 1\n")  # duplicate series
        assert validate('# TYPE h histogram\nh_bucket{le="+Inf"} 1\nh_count 1\n')  # no _sum


# ---------------------------------------------------------- parity with JAX

FAMILY_NAMES = tuple(getattr(PORT.metrics, a).name for a in FAMILIES)


# The port's spans that the JAX package does not open: the program's
# phases (exec.launch / exec.wait / exec.fetch) and the pool's queue wait.
# shape() drops exactly these (their children, if any, take their place),
# so the rest of each tree is held whole against the JAX package's. The
# port's `cpu_ns` renders beside `duration_ns`, which shape() reads no
# more than it reads durations.
PORT_ONLY = frozenset({"exec.launch", "exec.wait", "exec.fetch", "distsql.cop_queue"})


def _kept(node) -> list:
    out = []
    for c in node.get("children", []):
        out.extend(_kept(c) if c["name"] in PORT_ONLY else [c])
    return out


def shape(node) -> tuple:
    """A span tree by names and attribute keys, children in a canonical
    order (the pool tier's region tasks finish in any order), the
    PORT_ONLY spans projected out."""
    return (node["name"], tuple(sorted(node.get("attrs", {}))),
            tuple(sorted(shape(c) for c in _kept(node))))


@pytest.fixture()
def fresh_default_caches(monkeypatch):
    """Each package's process-wide program cache (the root merge's) starts
    empty, so its builds and hits do not depend on earlier tests."""
    monkeypatch.setattr(j_executor, "DEFAULT_PROGRAM_CACHE", j_executor.ProgramCache())
    monkeypatch.setattr(p_executor, "DEFAULT_PROGRAM_CACHE", p_executor.ProgramCache())


def parity_pair(rows: int = 60, splits=(20, 40)):
    sessions = session_pair()
    run_case(["CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, s VARCHAR(20))",
              "INSERT INTO t VALUES " + ",".join(f"({i},{i % 5},'s{i % 7}b')" for i in range(1, rows + 1))],
             sessions)
    for pkg in (JAX, PORT):
        s = sessions[pkg.name]["s"]
        tid = s.catalog.table("t").table_id
        for h in splits:
            s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))
    return sessions


def run_measured(sessions, statements) -> dict:
    """Each package runs the statements; its family deltas and the span
    tree of every TRACE statement, by package name."""
    out = {}
    for pkg in (JAX, PORT):
        s = sessions[pkg.name]["s"]
        before = family_values(pkg.metrics)
        trees, rows = [], []
        for sql in statements:
            res = s.execute(sql)
            if sql.upper().startswith("TRACE"):
                trees.append(shape(json.loads(res.values()[0][0])))
            else:
                rows.append(norm(res.rows))
        out[pkg.name] = (family_deltas(before, family_values(pkg.metrics)), trees, rows)
    return out


def assert_parity(got):
    (jd, jt, jr), (pd, pt, pr) = got["jax"], got["port"]
    assert same(pr, jr), f"\n  jax  {jr}\n  port {pr}"
    assert pd == jd, f"\n  jax  {jd}\n  port {pd}"
    assert pt == jt, f"\n  jax  {jt}\n  port {pt}"
    return pd, pt


def names(tree) -> list:
    out = [tree[0]]
    for c in tree[2]:
        out.extend(names(c))
    return out


@pytest.mark.usefixtures("fresh_default_caches")
class TestParityWithTheJaxPackage:
    def test_trace_sum_gives_the_same_tree(self):
        sessions = parity_pair(rows=3, splits=())
        d, trees = assert_parity(run_measured(sessions, ["TRACE FORMAT='json' SELECT sum(v) FROM t WHERE v > 1"]))
        ns = names(trees[0])
        assert ns.count("exec.program") == 2  # the push program and the root merge
        assert "cop.decode" in ns and "cop.execute" in ns
        assert d["PROGRAM_LAUNCHES"] == 2 and d["PROGRAM_COMPILES"] == 2

    def test_single_tier(self):
        sessions = parity_pair()
        d, trees = assert_parity(run_measured(sessions, ["TRACE FORMAT='json' SELECT sum(v) FROM t WHERE v > 1"]))
        assert d["COP_EXECUTOR_ROWS"] and d["PROGRAM_CACHE_HITS"] == 2  # the second and third region
        assert names(trees[0]).count("cop.execute") == 3 and d["NATIVE_DECODES"] == 3

    def test_batch_tier(self):
        sessions = parity_pair()
        run_case(["SET tidb_allow_batch_cop = ON"], sessions)
        d, trees = assert_parity(run_measured(sessions, ["TRACE FORMAT='json' SELECT sum(v) FROM t WHERE v > 1"]))
        assert d["BATCH_COP_BATCHES"] > 0 and d["BATCH_COP_REGIONS"] > 0 and d["BATCH_COP_LAUNCHES_SAVED"] > 0
        assert "cop.batch_decode" in names(trees[0]) and "cop.batch_execute" in names(trees[0])

    def test_oracle_fallback(self):
        sessions = parity_pair()
        d, trees = assert_parity(run_measured(sessions, ["TRACE FORMAT='json' SELECT count(*) FROM t WHERE s LIKE '%3b'"]))
        assert d["COP_FALLBACKS"] > 0
        assert "cop.oracle_fallback" in names(trees[0])

    def test_result_cache_repeat(self):
        sessions = parity_pair()
        d, trees = assert_parity(run_measured(sessions, [
            "SELECT sum(v) FROM t WHERE v > 1", "SELECT sum(v) FROM t WHERE v > 1",
            "TRACE FORMAT='json' SELECT sum(v) FROM t WHERE v > 1"]))
        assert d["COP_CACHE_HITS"] >= 3
        assert "cop.decode" not in names(trees[0])  # every region from the result cache

    def test_radix_join(self):
        sessions = session_pair()
        run_case(["CREATE TABLE o (id BIGINT PRIMARY KEY, w BIGINT)",
                  "CREATE TABLE l (id BIGINT PRIMARY KEY, ok BIGINT NOT NULL, v BIGINT NOT NULL)",
                  "INSERT INTO o VALUES " + ",".join(f"({k},{k * 3})" for k in range(32)),
                  "INSERT INTO l VALUES " + ",".join(f"({i},{i % 40},{i % 97})" for i in range(512))], sessions)
        sql = "SELECT sum(l.v), count(*) FROM l JOIN o ON l.ok = o.id"
        d, trees = assert_parity(run_measured(sessions, ["TRACE FORMAT='json' " + sql]))
        assert "exec.join_radix" in names(trees[0])
        assert d["COP_EXECUTOR_ROWS"].get("join", 0) > 0

    def test_native_decode_fallback(self):
        """Bytes the native decoder refuses: each package counts one
        fallback and hands the region to its Python decoder."""
        got = {}
        for pkg in (JAX, PORT):
            import importlib

            native = importlib.import_module(pkg.sql.__name__.split(".")[0] + ".native")
            cols = (pkg.dag.ColumnInfo(1, pkg.types.new_longlong()),)
            before = family_values(pkg.metrics)
            assert native.available()
            assert native.decode_rows_columnar([b"\x80\x00\x05"], [1], cols) is None
            got[pkg.name] = family_deltas(before, family_values(pkg.metrics))
        assert got["port"] == got["jax"] and got["port"]["NATIVE_DECODE_FALLBACKS"] == 1

    def test_the_projection_drops_only_port_only_spans(self):
        """Each PORT_ONLY span appears in the port's raw tree of a pool-tier
        statement and in none of the JAX package's, and nothing else of the
        port's tree differs from the JAX package's."""
        sessions = parity_pair()
        raw = {}
        for pkg in (JAX, PORT):
            res = sessions[pkg.name]["s"].execute("TRACE FORMAT='json' SELECT v, count(*) FROM t GROUP BY v")
            raw[pkg.name] = json.loads(res.values()[0][0])

        def all_names(node):
            return [node["name"]] + [n for c in node.get("children", []) for n in all_names(c)]

        assert PORT_ONLY <= set(all_names(raw["port"]))
        assert not PORT_ONLY & set(all_names(raw["jax"]))
        assert shape(raw["port"]) == shape(raw["jax"])
        assert names(shape(raw["port"])) == [n for n in names(shape(raw["port"])) if n not in PORT_ONLY]

    def test_family_names_are_the_jax_packages(self):
        for attr in FAMILIES:
            j, p = getattr(JAX.metrics, attr), getattr(PORT.metrics, attr)
            assert (type(p).__name__, p.name) == (type(j).__name__, j.name), attr
