"""HTTP status API (ref: pkg/server/http_status.go + the handler set in
pkg/server/handler/tikvhandler — docs/tidb_http_api.md):

  GET /status                          server status (version, git hash)
  GET /schema                          all databases
  GET /schema/{db}                     tables of a database
  GET /schema/{db}/{table}             one table's TableInfo
  GET /ddl/history                     DDL job log (newest first)
  GET /settings                        config + global sysvars
  GET /metrics                         Prometheus text exposition v0.0.4
                                       (text/plain — scrapers point here)
  GET /metrics/json                    the same samples as a JSON object
  GET /mvcc/key/{db}/{table}/{handle}  MVCC versions of one row
  GET /regions/meta                    region/cluster layout
  GET /pd/api/v1/regions               PD view: regions + placement + size
  GET /pd/api/v1/stores                PD view: per-store region/hot counts
  GET /pd/api/v1/hotspot               PD view: hot read/write peers
  GET /pd/api/v1/operators             PD view: pending + recent operators
  GET /cdc/api/v1/changefeeds          changefeed list (state, frontier)
  GET /cdc/api/v1/changefeeds/{name}   one changefeed's detail
  GET /columnar/api/v1/tables          columnar replica tables (delta rows,
                                       stable chunks, applied resolved-ts)
  GET /columnar/api/v1/tables/{name}   one columnar table's detail
  GET /topsql/api/v1/windows           Top SQL reporter windows (top-K
                                       digests + "(others)" fold per window)
  GET /topsql/api/v1/digests/{digest}  one digest across windows + its
                                       measured cost class / EWMA

The /pd/api/v1 prefix mirrors the reference PD's HTTP API (pd
server/api/router.go) and /cdc/api/v1 mirrors TiCDC's open API — both
served from this status port since PD and CDC are embedded in the store
process.

Runs on its own port next to the MySQL protocol listener, like the
reference's status server. JSON bodies except /metrics; 404 with a
message otherwise.

Copy of `tidb_tpu/server/http_api.py` for the PyTorch port (it imports
nothing of tidb_tpu): the routes read the port's session, catalog, PD,
changefeed hub, columnar replica, Top SQL collector and metric registry.
/metrics carries the port's own families beside the reference's."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _table_info(meta) -> dict:
    return {
        "id": meta.table_id,
        "name": {"O": meta.name.rsplit(".", 1)[-1], "L": meta.name.rsplit(".", 1)[-1]},
        "cols": [
            {
                "id": c.col_id,
                "name": {"O": c.name, "L": c.name},
                "type": c.decl or c.ft.eval_type(),
                "nullable": not c.ft.not_null(),
                "generated": c.generated is not None,
            }
            for c in meta.columns
        ],
        "index_info": [
            {"id": i.index_id, "name": i.name, "cols": i.col_names,
             "unique": i.unique, "state": i.state}
            for i in meta.indices
        ],
        "fk_info": [
            {"name": fk.name, "cols": fk.cols, "ref_table": fk.ref_table,
             "ref_cols": fk.ref_cols, "on_delete": fk.on_delete}
            for fk in getattr(meta, "foreign_keys", [])
        ],
        "pk_is_handle": meta.handle_col is not None,
        "row_count": meta.row_count,
        "partition": None if meta.partition is None else {
            "type": meta.partition.method,
            "expr": meta.partition.col,
            "definitions": [{"id": p.pid, "name": p.name} for p in meta.partition.parts],
        },
    }


class StatusServer:
    """The status endpoint server; `start_background()` + `.port`."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0):
        self.session = session
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):  # noqa: N802 (stdlib contract)
                ctype = "application/json"
                try:
                    routed = outer._route(self.path)
                    if len(routed) == 3:  # raw body + explicit content type
                        code, data, ctype = routed
                        data = data if isinstance(data, bytes) else data.encode()
                    else:
                        code, body = routed
                        data = json.dumps(body, indent=1, default=str).encode()
                except Exception as exc:  # noqa: BLE001 — surface, don't kill the thread
                    code, data = 500, json.dumps({"error": str(exc)}).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address

    def start_background(self):
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # ---------------------------------------------------------- routing
    def _route(self, path: str):
        s = self.session
        parts = [p for p in path.split("?")[0].split("/") if p]
        if parts == ["status"]:
            return 200, {
                "connections": 0,
                "version": "8.0.11-tidb_tpu",
                "git_hash": "tpu-native",
                "status_port": self.port,
            }
        if parts == ["schema"]:
            return 200, sorted({"information_schema"} | s.catalog.databases)
        if len(parts) == 2 and parts[0] == "schema":
            db = parts[1].lower()
            pre = "" if db == "test" else db + "."
            out = []
            for name in s.catalog.tables():
                if db == "test" and "." not in name:
                    out.append(_table_info(s.catalog.table(name)))
                elif pre and name.startswith(pre):
                    out.append(_table_info(s.catalog.table(name)))
            return 200, out
        if len(parts) == 3 and parts[0] == "schema":
            key = parts[2].lower() if parts[1].lower() == "test" else f"{parts[1].lower()}.{parts[2].lower()}"
            try:
                return 200, _table_info(s.catalog.table(key))
            except Exception:  # noqa: BLE001
                return 404, {"error": f"table {parts[1]}.{parts[2]} not found"}
        if parts == ["ddl", "history"]:
            return 200, [
                {"id": j.job_id, "type": j.job_type, "state": j.state,
                 "schema_state": j.schema_state, "table": j.table,
                 "query": j.query}
                for j in reversed(s.catalog.ddl_jobs.view())
            ]
        if parts == ["settings"]:
            return 200, dict(s.sysvars.items())
        if parts == ["metrics"]:
            from ..util import metrics

            # raw exposition a Prometheus scraper actually parses
            return 200, metrics.REGISTRY.dump(), "text/plain; version=0.0.4; charset=utf-8"
        if parts == ["metrics", "json"]:
            from ..util import metrics

            return 200, {
                "prometheus": metrics.REGISTRY.dump(),
                "samples": dict(metrics.REGISTRY.sample_lines()),
            }
        if len(parts) >= 4 and parts[:3] == ["cdc", "api", "v1"]:
            return self._cdc_route(parts[3:])
        if len(parts) >= 4 and parts[:3] == ["columnar", "api", "v1"]:
            return self._columnar_route(parts[3:])
        if len(parts) >= 4 and parts[:3] == ["topsql", "api", "v1"]:
            return self._topsql_route(parts[3:])
        if len(parts) == 4 and parts[:3] == ["pd", "api", "v1"]:
            pd = getattr(s.store, "pd", None)
            if pd is None:
                return 404, {"error": "no placement driver attached to this store"}
            view = {
                "regions": pd.regions_view,
                "stores": pd.stores_view,
                "hotspot": pd.hotspot_view,
                "operators": pd.operators_view,
            }.get(parts[3])
            if view is None:
                return 404, {"error": f"unknown pd route {parts[3]!r} (regions|stores|hotspot|operators)"}
            return 200, view()
        if parts == ["regions", "meta"]:
            return 200, [
                {"region_id": r.region_id, "epoch": r.epoch,
                 "start_key": r.start_key.hex(), "end_key": r.end_key.hex()}
                for r in s.store.cluster.regions()
            ]
        if len(parts) == 5 and parts[:2] == ["mvcc", "key"]:
            db, tbl, h = parts[2].lower(), parts[3].lower(), int(parts[4])
            key = tbl if db == "test" else f"{db}.{tbl}"
            meta = s.catalog.table(key)
            from ..codec import tablecodec

            out = []
            for pid in meta.physical_ids():
                k = tablecodec.encode_row_key(pid, h)
                with s.store.kv.lock:
                    vers = list(s.store.kv._data.get(k, []))
                for ts, val in vers:
                    out.append({
                        "key": k.hex(), "commit_ts": ts,
                        "deleted": val is None,
                        "value_len": 0 if val is None else len(val),
                    })
            if not out:
                return 404, {"error": "no MVCC versions for that handle"}
            return 200, {"handle": h, "versions": out}
        return 404, {"error": f"unknown path {path!r} (see docs/tidb_http_api.md routes)"}

    def _columnar_route(self, parts: list):
        """/columnar/api/v1/tables[/{name}] (the TiFlash-analog
        of information_schema.tiflash_replica as an HTTP view): per-table
        delta rows, stable chunks, and the applied resolved-ts frontier."""
        rep = getattr(self.session.store, "columnar", None)
        if rep is None or parts[0] != "tables":
            return 404, {"error": "unknown columnar route (tables)"}
        views = rep.views()
        if len(parts) == 1:
            return 200, views
        for v in views:
            if v["table"] == parts[1]:
                return 200, v
        return 404, {"error": f"columnar table {parts[1]!r} not found"}

    def _topsql_route(self, parts: list):
        """/topsql/api/v1/windows and /topsql/api/v1/digests/{digest}
        (ref: TiDB's Top SQL pushed to ng-monitoring — here
        pulled from the embedded reporter). Serves the SAME
        `windows_view()` rows information_schema.tidb_top_sql renders,
        so the two surfaces are byte-consistent by construction."""
        from ..topsql import COLLECTOR

        if parts[0] == "windows" and len(parts) == 1:
            return 200, COLLECTOR.windows_view()
        if parts[0] == "digests" and len(parts) == 2:
            view = COLLECTOR.digest_view(parts[1])
            if not view["windows"] and not view["measured_executions"]:
                return 404, {"error": f"digest {parts[1]!r} not in any window"}
            return 200, view
        return 404, {"error": "unknown topsql route (windows | digests/{digest})"}

    def _cdc_route(self, parts: list):
        """/cdc/api/v1/changefeeds[/{name}] (ref: TiCDC's open API
        api/v1/changefeeds — list + detail)."""
        hub = getattr(self.session.store, "cdc", None)
        if hub is None or parts[0] != "changefeeds":
            return 404, {"error": "unknown cdc route (changefeeds)"}
        views = hub.views()
        if len(parts) == 1:
            return 200, views
        for v in views:
            if v["name"] == parts[1]:
                return 200, v
        return 404, {"error": f"changefeed {parts[1]!r} not found"}
