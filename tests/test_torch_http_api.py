"""The port's HTTP status API (tidb_tpu_torch/server/http_api.py) on the
CPU: the cases of tests/test_http_api.py, tests/test_pd.py's
test_pd_http_api_endpoints, tests/test_cdc.py's test_http_api_routes and
tests/test_columnar.py's test_http_columnar_routes over a port
`Session(device="cpu")`; then parity with the JAX package's status server:
both packages' sessions take the same statements on one thread, and the
deterministic JSON of every route must be equal, as must the TYPE line of
every metric family both registries have. The port's whole
/metrics exposition must pass the scrape check. Tolerance: exact.
"""

import json
import os
import sys
import urllib.error
import urllib.request

import pytest

from tidb_tpu_torch.server.http_api import StatusServer
from tidb_tpu_torch.sql import Session

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

TIMEOUT = 10


@pytest.fixture()
def api():
    s = Session(device="cpu")
    s.execute("create table t (id bigint primary key, v bigint)")
    s.execute("insert into t values (1, 10), (2, 20)")
    s.execute("update t set v = 11 where id = 1")
    s.execute("create index iv on t (v)")
    srv = StatusServer(s).start_background()
    try:
        yield srv
    finally:
        srv.close()


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}", timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def test_status_and_schema(api):
    code, body = _get(api, "/status")
    assert code == 200 and "tidb_tpu" in body["version"]
    code, dbs = _get(api, "/schema")
    assert "test" in dbs and "mysql" in dbs
    code, tables = _get(api, "/schema/test")
    names = [t["name"]["O"] for t in tables]
    assert "t" in names
    code, ti = _get(api, "/schema/test/t")
    assert code == 200 and ti["pk_is_handle"] and len(ti["cols"]) == 2
    assert any(i["name"] == "iv" for i in ti["index_info"])


def test_ddl_history(api):
    code, jobs = _get(api, "/ddl/history")
    assert code == 200 and jobs
    assert any(j["type"] == "add index" or "index" in j["type"] for j in jobs) or len(jobs) >= 1


def test_settings_metrics(api):
    code, st = _get(api, "/settings")
    assert code == 200 and "max_execution_time" in st
    code, m = _get(api, "/metrics/json")
    assert code == 200 and "prometheus" in m and "samples" in m


def test_metrics_text_exposition(api):
    """GET /metrics is raw Prometheus text v0.0.4 — what a scraper parses."""
    from scrape_check import validate

    with urllib.request.urlopen(f"http://{api.host}:{api.port}/metrics", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        assert "version=0.0.4" in r.headers["Content-Type"]
        text = r.read().decode()
    assert "# TYPE tidb_tpu_cop_requests_total counter" in text
    assert 'tidb_tpu_cop_duration_seconds_bucket{le="+Inf"}' in text
    assert validate(text) == []


def test_mvcc_versions(api):
    code, body = _get(api, "/mvcc/key/test/t/1")
    assert code == 200 and len(body["versions"]) >= 2  # insert + update
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(api, "/mvcc/key/test/t/999")
    assert ei.value.code == 404


def test_regions_meta(api):
    code, regions = _get(api, "/regions/meta")
    assert code == 200 and regions and "region_id" in regions[0]


def test_unknown_route_404(api):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(api, "/nope")
    assert ei.value.code == 404


def test_pd_http_api_endpoints():
    s = Session(device="cpu")
    s.execute("CREATE TABLE h (id INT PRIMARY KEY, v INT)")
    s.execute("INSERT INTO h VALUES " + ",".join(f"({i},{i})" for i in range(50)))
    s.store.cluster.set_stores(2)
    s.execute("SELECT sum(v) FROM h")
    s.store.pd.tick()
    srv = StatusServer(s).start_background()
    try:
        def get(path):
            code, body = _get(srv, path)
            assert code == 200
            return body

        regions = get("/pd/api/v1/regions")
        assert regions and {"region_id", "store", "epoch", "approximate_size"} <= set(regions[0])
        stores = get("/pd/api/v1/stores")
        assert [st["store_id"] for st in stores] == [0, 1]
        assert sum(st["region_count"] for st in stores) == len(regions)
        hot = get("/pd/api/v1/hotspot")
        assert "read" in hot and "write" in hot
        ops = get("/pd/api/v1/operators")
        assert "pending" in ops and "history" in ops
    finally:
        srv.close()


def test_http_api_routes():
    from test_torch_cdc import feed_on, make_session

    s = make_session()
    feed_on(s, name="web")
    srv = StatusServer(s).start_background()
    try:
        code, body = srv._route("/cdc/api/v1/changefeeds")
        assert code == 200 and body[0]["name"] == "web"
        code, body = srv._route("/cdc/api/v1/changefeeds/web")
        assert code == 200 and body["state"] == "normal"
        code, _ = srv._route("/cdc/api/v1/changefeeds/nope")
        assert code == 404
    finally:
        srv.close()


def test_http_columnar_routes():
    from test_torch_columnar import make_replicated

    s = make_replicated()
    srv = StatusServer(s).start_background()
    try:
        code, body = _get(srv, "/columnar/api/v1/tables")
        assert code == 200 and body[0]["table"] == "t"
        assert body[0]["stable_rows"] == 40
        code, body = _get(srv, "/columnar/api/v1/tables/t")
        assert code == 200 and body["state"] == "normal"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv, "/columnar/api/v1/tables/nope")
        assert ei.value.code == 404
    finally:
        srv.close()


def test_topsql_routes():
    s = Session(device="cpu")
    s.execute("CREATE TABLE q (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO q VALUES (1, 1), (2, 2)")
    s.execute("SELECT sum(v) FROM q")
    srv = StatusServer(s).start_background()
    try:
        code, windows = _get(srv, "/topsql/api/v1/windows")
        assert code == 200 and isinstance(windows, list)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv, "/topsql/api/v1/digests/not-a-digest")
        assert ei.value.code == 404
    finally:
        srv.close()


# --------------------------------------------------- parity with the JAX package

STATEMENTS = [
    "CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, k VARCHAR(8), d DECIMAL(8,2))",
    "INSERT INTO t VALUES (1, 10, 'a', 1.25), (2, 20, 'b', NULL), (3, 30, NULL, -3.50)",
    "UPDATE t SET v = 11 WHERE id = 1",
    "DELETE FROM t WHERE id = 3",
    "CREATE INDEX iv ON t (v)",
    "ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 7",
    "CREATE TABLE p (a INT, b INT) PARTITION BY RANGE (a) "
    "(PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN MAXVALUE)",
    "INSERT INTO p VALUES (1, 1), (20, 2)",
    "SELECT sum(v) FROM t",
]

PARITY_ROUTES = [
    "/schema", "/schema/test", "/schema/test/t", "/schema/test/p", "/ddl/history",
    "/mvcc/key/test/t/1", "/mvcc/key/test/t/3", "/regions/meta", "/pd/api/v1/regions",
    "/pd/api/v1/stores", "/cdc/api/v1/changefeeds", "/cdc/api/v1/changefeeds/f",
    "/columnar/api/v1/tables", "/nope",
]


def _fed_servers():
    import tidb_tpu.cdc as j_cdc
    import tidb_tpu.server.http_api as j_http
    import tidb_tpu.sql as j_sql

    import tidb_tpu_torch.cdc as p_cdc

    out = []
    for sql, cdc, http, kw in ((j_sql, j_cdc, j_http, {}), (None, p_cdc, None, {"device": "cpu"})):
        s = sql.Session() if sql else Session(**kw)
        s.execute("SET tidb_enable_tpu_mesh = 0")
        for stmt in STATEMENTS:
            s.execute(stmt)
        meta = s.catalog.table("t")
        s.store.cdc.create("f", cdc.MemorySink(), s.catalog, table_ids={meta.table_id}, start_ts=0)
        s.store.cdc.tick()
        s.store.pd.tick()
        out.append((http.StatusServer if http else StatusServer)(s).start_background())
    return out


def test_routes_equal_the_jax_package():
    """The same statements on one thread through both packages' sessions:
    each route's status and JSON body are equal. The fields a clock or a
    port number fills (`/status`'s status_port, the feeds' lag) are left
    out, and /settings is compared on the sysvars both packages have."""
    j_srv, p_srv = _fed_servers()
    try:
        for path in PARITY_ROUTES:
            j_code, j_body = j_srv._route(path)
            p_code, p_body = p_srv._route(path)
            if path.startswith("/cdc"):
                for body in (j_body, p_body):
                    for v in body if isinstance(body, list) else [body]:
                        v.pop("resolved_lag", None)
            assert (p_code, p_body) == (j_code, j_body), path
        j_st, p_st = j_srv._route("/status")[1], p_srv._route("/status")[1]
        assert {k: v for k, v in p_st.items() if k != "status_port"} == \
            {k: v for k, v in j_st.items() if k != "status_port"}
        j_set, p_set = j_srv._route("/settings")[1], p_srv._route("/settings")[1]
        shared = set(j_set) & set(p_set)
        assert len(shared) >= 0.9 * len(j_set)
        assert {k: p_set[k] for k in shared} == {k: j_set[k] for k in shared}
    finally:
        j_srv.close()
        p_srv.close()


def _families(text: str) -> dict:
    """family -> its TYPE line. HELP strings are left out (the port words
    some of them its own way), and so are the samples: the registry is the
    process's, so which label values it holds depends on what ran before."""
    return {line.split()[2]: line for line in text.splitlines() if line.startswith("# TYPE ")}


def test_metric_families_equal_the_jax_package():
    """Every family both registries have carries the same TYPE;
    the port's whole exposition passes the scrape check."""
    from scrape_check import validate

    j_srv, p_srv = _fed_servers()
    try:
        j_text = j_srv._route("/metrics")[1]
        p_text = p_srv._route("/metrics")[1]
    finally:
        j_srv.close()
        p_srv.close()
    j_fam, p_fam = _families(j_text), _families(p_text)
    shared = set(j_fam) & set(p_fam)
    assert len(shared) >= 0.9 * len(j_fam)
    for fam in sorted(shared):
        assert p_fam[fam] == j_fam[fam], fam
    for fam in ("tidb_tpu_coalesce_batches_total", "tidb_tpu_coalesce_launches_saved_total",
                "tidb_tpu_coalesce_fallbacks_total", "tidb_tpu_pitr_restores_total"):
        assert fam in p_fam, fam
    assert validate(p_text) == []
