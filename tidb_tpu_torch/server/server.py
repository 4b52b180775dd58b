"""MySQL protocol server over the embedded engine (ref: pkg/server/server.go
accept loop, conn.go clientConn.Run/dispatch/writeResultSet;
cmd/tidb-server/main.go wiring).

One OS thread per connection (the reference runs one goroutine per conn);
every connection gets its own Session over the shared store + catalog, so
transactions, sysvars and temporary state are per-connection exactly like
the reference's session management.

Copy of `tidb_tpu/server/server.py` for the PyTorch port (it imports
nothing of tidb_tpu). The server lives on one device: a server that builds
its own store builds it on `device` ("cuda" unless the caller asks for the
CPU; it raises without CUDA), and every connection's Session runs on its
server's store's device. Accepted sockets set TCP_NODELAY, as the
reference's Go listener does by default; the packets' bytes are the JAX
package's."""

from __future__ import annotations

import socket
import socketserver
import threading

import torch

from ..sql import Session, SQLError
from ..sql.catalog import Catalog, CatalogError
from ..sql.planner import PlanError
from ..store import TPUStore
from ..types import Datum, DatumKind, Flag
from . import protocol as P


def datum_text(d: Datum) -> str | None:
    """Datum -> text-protocol cell (ref: dumpTextRow value formatting)."""
    if d.is_null():
        return None
    if d.kind == DatumKind.Bytes:
        v = d.val
        return v.decode("utf-8", "surrogateescape") if isinstance(v, bytes) else str(v)
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        v = float(d.val)
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    if d.kind == DatumKind.MysqlJSON:
        from ..types import json_binary as jb

        return jb.to_text(jb.decode(d.val))
    return str(d.val)


def column_flags(ft) -> int:
    flags = 0
    if ft.flag & Flag.NotNull:
        flags |= 1  # NOT_NULL_FLAG
    if ft.is_unsigned():
        flags |= 32  # UNSIGNED_FLAG
    return flags


class Connection:
    def __init__(self, sock, server, conn_id: int):
        self.io = P.PacketIO(sock)
        self.server = server
        self.conn_id = conn_id
        self.session = Session(server.store, server.catalog, config=server.config,
                               device=server.store.device)

    # ------------------------------------------------------------------
    def handshake(self) -> bool:
        salt = P.new_salt()
        self.io.write(P.handshake_v10(self.conn_id, salt))
        resp = P.parse_handshake_response(self.io.read())
        user = resp["user"]
        if self.server.users:
            stored = self.server.users.get(user)  # explicit override map
        else:
            # CREATE USER records (ref: privilege cache feeding auth)
            stored = self.server.catalog.privileges.password_of(user)
        if stored is None:
            self.io.write(P.err_packet(1045, f"Access denied for user '{user}'", "28000"))
            return False
        if not P.check_auth(stored, salt, resp["auth"]):
            self.io.write(P.err_packet(1045, f"Access denied for user '{user}'", "28000"))
            return False
        if not self.server.users:
            # privilege-store users run as themselves; the explicit override
            # map is a test shortcut whose users bypass privilege checks
            self.session.user = user.lower()
        self.io.write(P.ok_packet(status=self._status()))
        return True

    def _status(self) -> int:
        st = P.SERVER_STATUS_AUTOCOMMIT
        if self.session.txn is not None:
            st |= P.SERVER_STATUS_IN_TRANS
        return st

    # ------------------------------------------------------------------
    def run(self):
        while True:
            self.io.reset()
            try:
                pkt = self.io.read()
            except (ConnectionError, OSError):
                return
            if not pkt:
                continue
            cmd, payload = pkt[0], pkt[1:]
            if cmd == P.COM_QUIT:
                return
            if cmd == P.COM_PING:
                self.io.write(P.ok_packet(status=self._status()))
                continue
            if cmd == P.COM_INIT_DB:
                self.io.write(P.ok_packet(status=self._status()))
                continue
            if cmd == P.COM_FIELD_LIST:
                self.io.write(P.eof_packet(self._status()))
                continue
            if cmd == P.COM_QUERY:
                self.handle_query(payload.decode("utf-8", "replace"))
                continue
            if cmd in (P.COM_STMT_PREPARE, P.COM_STMT_EXECUTE, P.COM_STMT_CLOSE):
                self.io.write(P.err_packet(1295, "binary protocol not supported; use text PREPARE/EXECUTE"))
                continue
            self.io.write(P.err_packet(1047, f"unknown command {cmd}"))

    def handle_query(self, sql: str):
        """(ref: conn.go handleQuery -> handleStmt -> writeResultSet)."""
        from ..parser.parser import ParseError

        stmts = split_statements(sql)
        for i, stmt_sql in enumerate(stmts):
            try:
                res = self.session.execute(stmt_sql)
            except (SQLError, PlanError, CatalogError, ParseError) as exc:
                # typed statement errors carry their MySQL errno (9005
                # region-unavailable, 3024/1317 killed); the rest are 1105
                self.io.write(P.err_packet(getattr(exc, "code", 1105), str(exc)))
                return
            except Exception as exc:  # noqa: BLE001 — wire must answer
                self.io.write(P.err_packet(1105, f"internal error: {exc}"))
                return
            self.write_result(res, more=i + 1 < len(stmts))

    SERVER_MORE_RESULTS = 0x0008

    def write_result(self, res, more: bool = False):
        status = self._status() | (self.SERVER_MORE_RESULTS if more else 0)
        if not res.columns:
            self.io.write(P.ok_packet(affected=res.affected, status=status))
            return
        fts = getattr(res, "fts", None)
        self.io.write(P.lenenc_int(len(res.columns)))
        for i, name in enumerate(res.columns):
            ft = fts[i] if fts else None
            if ft is not None:
                self.io.write(P.column_def(str(name), int(ft.tp), ft.flen, max(ft.decimal, 0), column_flags(ft)))
            else:
                self.io.write(P.column_def(str(name), 0xFD))  # VAR_STRING
        self.io.write(P.eof_packet(status))
        for row in res.rows:
            self.io.write(P.text_row([datum_text(d) for d in row]))
        self.io.write(P.eof_packet(status))


def split_statements(sql: str) -> list[str]:
    """Split a COM_QUERY payload on top-level semicolons (multi-statement
    support; quote-aware, no comment handling beyond trailing whitespace)."""
    out, buf, quote = [], [], None
    i = 0
    while i < len(sql):
        ch = sql[i]
        if quote:
            buf.append(ch)
            if ch == quote and not (i + 1 < len(sql) and sql[i + 1] == quote):
                quote = None
            elif ch == quote:
                buf.append(sql[i + 1])
                i += 1
            elif ch == "\\" and i + 1 < len(sql):
                buf.append(sql[i + 1])
                i += 1
        elif ch in ("'", '"', "`"):
            quote = ch
            buf.append(ch)
        elif ch == ";":
            s = "".join(buf).strip()
            if s:
                out.append(s)
            buf = []
        else:
            buf.append(ch)
        i += 1
    s = "".join(buf).strip()
    if s:
        out.append(s)
    return out


def _same_device(a, b) -> bool:
    """Whether two torch.devices name one device ("cuda" is "cuda:0")."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class MySQLServer:
    """(ref: server.NewServer + Run). Listens on a TCP port; serves each
    connection on a thread. `users` maps user -> password bytes; empty map
    = accept anyone (the mock default). `device` places the store the
    server builds when it is given none ("cuda" by default); given with a
    store, it must name that store's device."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: TPUStore | None = None, catalog: Catalog | None = None,
                 users: dict | None = None, config=None, device=None):
        if store is None:
            store = TPUStore(device="cuda" if device is None else device)
        elif device is not None and not _same_device(torch.device(device), store.device):
            raise ValueError(f"device {device!r} is not the store's device {store.device}")
        self.store = store
        self.catalog = catalog or Catalog()
        self.users = users or {}
        self.config = config
        self._conn_ids = iter(range(1, 1 << 31))
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()
        self._threads: list = []
        self._closing = False
        # a config'd server boots the PD's scheduling loop
        # (ref: PD runs beside the cluster; embedded here, so the server
        # owns its lifecycle). Config-less servers (tests) tick manually.
        if config is not None and getattr(self.store, "pd", None) is not None:
            self.store.pd.start_background(config.pd_tick_interval)

    def serve_forever(self):
        while not self._closing:
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(sock,), daemon=True)
            t.start()
            self._threads.append(t)

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def _serve_conn(self, sock):
        # packets go out as they are written, as Go's net package (and so
        # the reference server) sends them: without TCP_NODELAY a result
        # set's small writes wait out the peer's delayed ACK under Nagle
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(sock, self, next(self._conn_ids))
        try:
            if conn.handshake():
                conn.run()
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        self._closing = True
        if getattr(self.store, "pd", None) is not None:
            self.store.pd.stop()
        try:
            self._sock.close()
        except OSError:
            pass
