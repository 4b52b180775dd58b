"""Top SQL's device attribution in the PyTorch port (the device cases of
tests/test_topsql.py, on `device="cpu"`): the store records each launch's
time on the ambient statement tag and in the collector's conservation
ledger across the single, batched and mesh tiers; a result-cache hit adds
no device time and counts one hit; the sinks are free without a tag; the
collector, information_schema, the HTTP API and the Prometheus counters
show the same numbers.

Also: every metric family that `tidb_tpu_torch/util/metrics.py` registers
has a use site (an increment, a set or an observe) in the port.
"""

import ast
import json
import pathlib
import sys
import urllib.error
import urllib.request

import pytest

from tidb_tpu_torch import topsql
from tidb_tpu_torch.codec import tablecodec
from tidb_tpu_torch.distsql import KVRequest, full_table_ranges, select
from tidb_tpu_torch.exec import Aggregation, ColumnInfo, DAGRequest, Selection, TableScan
from tidb_tpu_torch.expr import AggDesc, col, func, lit
from tidb_tpu_torch.sql.session import Session
from tidb_tpu_torch.store import TPUStore
from tidb_tpu_torch.topsql import COLLECTOR, ResourceTag
from tidb_tpu_torch.types import Datum, new_longlong
from tidb_tpu_torch.util import metrics

BOOL = new_longlong(notnull=True)
TID = 97
FT = new_longlong()
PORT_ROOT = pathlib.Path(__file__).resolve().parent.parent / "tidb_tpu_torch"


def fill_store(n=200, regions=8):
    # eight mesh devices, the counterpart of the JAX package's eight
    # virtual CPU devices, so the planner's default sends a partial
    # aggregate to the store's mesh tier
    store = TPUStore(device="cpu", mesh_devices=["cpu"] * 8)
    for h in range(n):
        store.put_row(TID, h, [1], [Datum.i64(h * 3)], ts=10)
    for i in range(1, regions):
        store.cluster.split(tablecodec.encode_row_key(TID, i * n // regions))
    return store


def scan_dag():
    scan = TableScan(TID, (ColumnInfo(1, FT),))
    return DAGRequest((scan,), output_offsets=(0,))


def agg_dag():
    scan = TableScan(TID, (ColumnInfo(1, FT),))
    sel = Selection((func("lt", BOOL, col(0, FT), lit(300, new_longlong())),))
    agg = Aggregation(group_by=(), aggs=(AggDesc("count", ()),), partial=True)
    return DAGRequest((scan, sel, agg), output_offsets=(0,))


def kvreq(dag, ts, **kw):
    return KVRequest(dag, full_table_ranges(TID), start_ts=ts, **kw)


class TestConservation:
    def test_tiers_conserve_device_time(self):
        """sum(per-digest device_ns) == sum(launch totals), exactly,
        across the per-region, batched and mesh tiers; per-lane
        ExecSummary shares of a batched launch sum exactly to its time."""
        COLLECTOR.reset()
        store = fill_store(n=200, regions=8)
        tag = ResourceTag("tier-test")
        with topsql.adopt(tag):
            select(store, kvreq(scan_dag(), 100, concurrency=2, mesh=False))
            single_ns = tag.device_ns
            store.evict_caches()
            select(store, kvreq(scan_dag(), 101, batch_cop=True, mesh=False))
            batch_ns = tag.device_ns - single_ns
            store.evict_caches()
            mesh0 = store.stats()["mesh_batches"]
            select(store, kvreq(agg_dag(), 102))  # planner default: mesh tier
            mesh_ns = tag.device_ns - single_ns - batch_ns
        assert store.stats()["mesh_batches"] == mesh0 + 1
        assert single_ns > 0 and batch_ns > 0 and mesh_ns > 0
        assert tag.device_ns == COLLECTOR.launch_device_ns
        assert tag.compile_ns > 0 and tag.bytes_to_device > 0
        # the batched tier alone under a fresh tag: its lanes' shares sum
        # to the device time it recorded
        store.evict_caches()
        tag2 = ResourceTag("lane-sum")
        with topsql.adopt(tag2):
            res2 = select(store, kvreq(scan_dag(), 103, batch_cop=True, mesh=False))
        lane_total = sum(task[0].time_processed_ns for task in res2.exec_summaries)
        assert lane_total == tag2.device_ns, (lane_total, tag2.device_ns)

    def test_cop_cache_hits_lose_nothing(self):
        """A fully cached re-read does no device work: the tag shows the
        hit count, and the conservation ledger is untouched."""
        COLLECTOR.reset()
        store = fill_store(n=120, regions=6)
        select(store, kvreq(scan_dag(), 100, concurrency=2, mesh=False))  # untagged populate
        assert COLLECTOR.launch_device_ns == 0  # no ambient tag, no ledger
        tag = ResourceTag("cached")
        l0 = metrics.PROGRAM_LAUNCHES.value
        h0 = metrics.COP_CACHE_HITS.value
        with topsql.adopt(tag):
            select(store, kvreq(scan_dag(), 101, concurrency=2, mesh=False))
        assert metrics.PROGRAM_LAUNCHES.value == l0  # served from the result cache
        assert metrics.COP_CACHE_HITS.value == h0 + 6
        assert tag.device_ns == 0 and tag.cop_cache_hits == 6
        assert COLLECTOR.launch_device_ns == 0

    def test_untagged_sinks_are_free_noops(self):
        COLLECTOR.reset()
        topsql.record_device(123, compile_ns=1)
        topsql.record_backoff(1.0)
        topsql.record_queue_wait(1.0)
        topsql.record_cop_cache_hit()  # no ambient tag: all no-ops
        assert COLLECTOR.launch_device_ns == 0


def test_surfaces_byte_consistent():
    """One serializer, four surfaces: the collector's windows_view, the
    information_schema memtable, the HTTP API and the Prometheus counters
    all show the same numbers, and the statements' device time is the
    launches' total."""
    COLLECTOR.reset()
    cpu0 = metrics.TOPSQL_CPU_NS.value
    dev0 = metrics.TOPSQL_DEVICE_NS.value
    n0 = metrics.TOPSQL_RECORDS.value
    s = Session(device="cpu")
    s.execute("create table t (a bigint primary key, b bigint)")
    s.execute("insert into t values " + ",".join(f"({i},{i})" for i in range(64)))
    for i in range(4):
        s.execute(f"select sum(b) from t where a > {i}")
    s.execute("set tidb_enable_top_sql = OFF")  # freeze: reads don't self-record
    COLLECTOR.rotate(force=True)
    try:
        view = COLLECTOR.windows_view()
        assert view and all(not w["live"] for w in view)

        def total(win_list, key):
            return sum(sum(d[key] for d in w["digests"]) + (w["others"][key] if w["others"] else 0)
                       for w in win_list)

        # collector totals == window sums == prometheus counter deltas
        assert total(view, "cpu_ns") == COLLECTOR.totals["cpu_ns"] == metrics.TOPSQL_CPU_NS.value - cpu0
        assert total(view, "device_ns") == COLLECTOR.totals["device_ns"] == metrics.TOPSQL_DEVICE_NS.value - dev0
        assert COLLECTOR.totals["exec_count"] == metrics.TOPSQL_RECORDS.value - n0
        # ... == the conservation ledger (every launch was tagged), and the
        # launches did record device time
        assert COLLECTOR.totals["device_ns"] == COLLECTOR.launch_device_ns > 0

        rows = s.execute("select digest, exec_count, cpu_ns, device_ns from information_schema.tidb_top_sql").values()
        by_digest = {}
        for dg, ec, cpu, dev in rows:
            acc = by_digest.setdefault(dg, [0, 0, 0])
            acc[0] += ec
            acc[1] += cpu
            acc[2] += dev
        want = {}
        for w in view:
            for d in w["digests"] + ([w["others"]] if w["others"] else []):
                acc = want.setdefault(d["digest"], [0, 0, 0])
                acc[0] += d["exec_count"]
                acc[1] += d["cpu_ns"]
                acc[2] += d["device_ns"]
        assert by_digest == want
        from tidb_tpu_torch.util.stmtlog import normalize_sql

        sum_digest = normalize_sql("select sum(b) from t where a > 0")[1]
        assert want[sum_digest][0] == 4 and want[sum_digest][2] > 0

        # the HTTP API serves the very same serializer output
        from tidb_tpu_torch.server.http_api import StatusServer

        srv = StatusServer(s).start_background()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            api = json.loads(urllib.request.urlopen(base + "/topsql/api/v1/windows", timeout=30).read())
            assert api == json.loads(json.dumps(view, default=str))
            dg = view[-1]["digests"][0]["digest"]
            one = json.loads(urllib.request.urlopen(base + f"/topsql/api/v1/digests/{dg}", timeout=30).read())
            assert one["digest"] == dg and one["windows"]
            assert one["cost_class"] in ("point", "small", "scan", "heavy")
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + "/topsql/api/v1/digests/absent", timeout=30)
        finally:
            srv.close()
    finally:
        s.execute("set tidb_enable_top_sql = ON")


def test_pool_workers_cpu_lands_on_the_digest():
    """The pool's tasks burn thread CPU that the session thread does not
    (through the distsql.before_task failpoint, on the workers): the
    digest's cpu_ns holds the workers' CPU besides the session's."""
    import threading
    import time

    from tidb_tpu_torch.util import failpoint
    from tidb_tpu_torch.util.stmtlog import normalize_sql

    COLLECTOR.reset()
    s = Session(device="cpu")
    s.execute("create table t (a bigint primary key, b bigint)")
    s.execute("insert into t values " + ",".join(f"({i},{i})" for i in range(60)))
    tid = s.catalog.table("t").table_id
    for h in (20, 40):  # 3 regions
        s.store.cluster.split(tablecodec.encode_row_key(tid, h))
    s.execute("set tidb_distsql_scan_concurrency = 4")
    session_thread = threading.get_ident()
    burned = []

    def burn():
        assert threading.get_ident() != session_thread  # a pool worker
        c0 = time.thread_time_ns()
        while time.thread_time_ns() - c0 < 100_000_000:
            pass
        burned.append(time.thread_time_ns() - c0)

    sql = "select sum(b) from t where a > 3"
    failpoint.enable("distsql.before_task", burn)
    try:
        c0 = time.thread_time_ns()
        s.execute(sql)
        session_cpu = time.thread_time_ns() - c0
    finally:
        failpoint.disable("distsql.before_task")
    assert len(burned) == 3 and session_cpu < sum(burned)
    digest = normalize_sql(sql)[1]
    ((n, cpu),) = s.execute("select exec_count, cpu_ns from information_schema.tidb_top_sql "
                            f"where digest = '{digest}'").values()
    assert n == 1 and cpu >= sum(burned)


# ------------------------------------------------------ every family is used

_USES = {"inc", "dec", "set", "observe", "labels"}


def _registered_families() -> set:
    tree = ast.parse((PORT_ROOT / "util" / "metrics.py").read_text())
    out = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call) and isinstance(node.value.func, ast.Attribute)
                and isinstance(node.value.func.value, ast.Name) and node.value.func.value.id == "REGISTRY"):
            out.add(node.targets[0].id)
    return out


def _used_families() -> set:
    """NAME of every `<x>.NAME.<use>(...)` or `NAME.<use>(...)` call in the
    port, a use being an increment, a set, an observe or a label pick."""
    used = set()
    for path in PORT_ROOT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _USES):
                continue
            target = node.func.value
            if isinstance(target, ast.Attribute):
                used.add(target.attr)
            elif isinstance(target, ast.Name):
                used.add(target.id)
    return used


def test_every_registered_family_has_a_use_site():
    registered = _registered_families()
    assert len(registered) > 90  # the parse found the registry's families
    missing = sorted(registered - _used_families())
    assert missing == [], f"families registered in util/metrics.py with no use site: {missing}"


def test_the_use_site_walk_sees_a_missing_family(tmp_path, monkeypatch):
    """The walk itself: a family registered and never moved is found."""
    root = tmp_path / "pkg"
    (root / "util").mkdir(parents=True)
    (root / "util" / "metrics.py").write_text(
        'REGISTRY = None\nA = REGISTRY.counter("a_total")\nB = REGISTRY.gauge("b")\n')
    (root / "user.py").write_text("from .util import metrics\nmetrics.A.inc()\n")
    monkeypatch.setattr(sys.modules[__name__], "PORT_ROOT", root)
    assert _registered_families() == {"A", "B"}
    assert sorted(_registered_families() - _used_families()) == ["B"]
