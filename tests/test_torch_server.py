"""The port's MySQL wire front end (tidb_tpu_torch/server/protocol.py,
client.py, server.py) against the JAX package's, on the CPU.

- Protocol bytes: over a seeded corpus of inputs, every packet writer of
  the port (`handshake_v10` with a fixed salt, the mysql_native_password
  scramble and check, OK / ERR / EOF, `column_def`, `text_row`, the
  length-encoded ints and strings) gives the same bytes as the JAX
  package's, and the readers invert the writers.
- `split_statements` gives the same pieces as the JAX package's.
- The cases of tests/test_server.py over a port `MySQLServer(device="cpu")`.
- Wire parity: the plain-statement cases of tests/test_torch_sql.py go
  through a JAX server and a port server, and the packets that come back
  (OK, ERR, column definitions, text rows, EOF) must be byte-equal. The
  port's MiniClient talks to the JAX server and the JAX one to the port's.
- tests/test_pd.py's test_config_server_boots_and_stops_pd_loop.

Every socket has a timeout (MiniClient's, 10 s), every server binds port 0
and is closed in a `finally`, and every thread join has a deadline.
Tolerance: exact.
"""

import random
import struct
import time

import pytest

import tidb_tpu.server as j_server
import tidb_tpu.server.protocol as JP
import tidb_tpu_torch.server as p_server
import tidb_tpu_torch.server.protocol as PP
from tidb_tpu_torch.server import MiniClient, MySQLServer, split_statements
from tidb_tpu_torch.server.client import ClientError

# ------------------------------------------------------------ protocol bytes

RNG_SEED = 20260418


def _corpus(n=64):
    rng = random.Random(RNG_SEED)
    words = ["", "a", "id", "count(*)", "名前", "x" * 300, "sum(l_quantity)", "'q'"]
    for _ in range(n):
        yield rng, rng.choice(words), rng.randrange(0, 1 << 40)


@pytest.mark.parametrize("packet", [
    "handshake", "scramble", "ok", "err", "eof", "column_def", "text_row", "lenenc",
])
def test_protocol_bytes_equal_the_jax_package(packet):
    for rng, word, big in _corpus():
        salt = bytes(rng.randrange(1, 256) for _ in range(20))
        if packet == "handshake":
            conn_id = rng.randrange(0, 1 << 32)
            assert PP.handshake_v10(conn_id, salt) == JP.handshake_v10(conn_id, salt)
            assert PP.handshake_v10(conn_id, salt, "8.0.11-x") == JP.handshake_v10(conn_id, salt, "8.0.11-x")
        elif packet == "scramble":
            pw = word.encode()
            got = PP.native_password_scramble(pw, salt)
            assert got == JP.native_password_scramble(pw, salt)
            assert PP.check_auth(pw, salt, got) and JP.check_auth(pw, salt, got)
            assert PP.check_auth(b"other", salt, got) == JP.check_auth(b"other", salt, got)
        elif packet == "ok":
            args = (rng.choice([0, 1, 250, 251, 65535, 65536, big]), big % 100000,
                    rng.choice([PP.SERVER_STATUS_AUTOCOMMIT, 3, 0x000A]), rng.randrange(0, 4))
            assert PP.ok_packet(*args) == JP.ok_packet(*args)
        elif packet == "err":
            code = rng.choice([1045, 1105, 9003, 9005, 1062])
            state = rng.choice(["HY000", "28000", "23", "4200012"])
            assert PP.err_packet(code, word, state) == JP.err_packet(code, word, state)
        elif packet == "eof":
            st, w = rng.randrange(0, 1 << 16), rng.randrange(0, 1 << 16)
            assert PP.eof_packet(st, w) == JP.eof_packet(st, w)
        elif packet == "column_def":
            args = (word, rng.choice([1, 3, 5, 8, 0xF6, 0xFD, 0xFE, 12]),
                    rng.choice([-1, 0, 11, 20, 1 << 20]), rng.randrange(0, 31), rng.randrange(0, 64))
            assert PP.column_def(*args) == JP.column_def(*args)
        elif packet == "text_row":
            vals = [rng.choice([None, word, str(big), "", "1.5", "-0.001"]) for _ in range(rng.randrange(0, 9))]
            assert PP.text_row(vals) == JP.text_row(vals)
        else:
            for v in (0, 250, 251, 65535, 65536, (1 << 24) - 1, 1 << 24, big, (1 << 64) - 1):
                enc = PP.lenenc_int(v)
                assert enc == JP.lenenc_int(v)
                assert PP.read_lenenc_int(b"\x07" + enc, 1) == (v, 1 + len(enc))
            s = word.encode()
            assert PP.lenenc_str(s) == JP.lenenc_str(s)
            assert PP.read_lenenc_str(PP.lenenc_str(s), 0) == (s, len(PP.lenenc_str(s)))


def test_handshake_response_parses_as_the_jax_package():
    """The client's HandshakeResponse41 (built the way MiniClient builds
    it) parses to the same fields in both packages."""
    rng = random.Random(RNG_SEED)
    for _ in range(32):
        user = rng.choice(["root", "alice", "u_1"])
        db = rng.choice(["", "test", "tpch"])
        salt = bytes(rng.randrange(1, 256) for _ in range(20))
        auth = PP.native_password_scramble(rng.choice([b"", b"secret"]), salt)
        caps = (PP.CLIENT_PROTOCOL_41 | PP.CLIENT_SECURE_CONNECTION | PP.CLIENT_PLUGIN_AUTH
                | (PP.CLIENT_CONNECT_WITH_DB if db else 0))
        payload = struct.pack("<IIB", caps, 1 << 24, PP.CHARSET_UTF8MB4) + b"\x00" * 23
        payload += user.encode() + b"\x00" + bytes([len(auth)]) + auth
        if db:
            payload += db.encode() + b"\x00"
        assert PP.parse_handshake_response(payload) == JP.parse_handshake_response(payload)


SPLIT_CORPUS = [
    "a; b;c", "insert into t values (';');", 'select ";;" ; x', "select 1", "",
    ";;;", "select 'it''s; fine'; select 2", "select `a;b` from t; ", "select '\\';' ; y",
    "create table t (a int); insert into t values (1);select * from t",
]


def test_split_statements_equal_the_jax_package():
    from tidb_tpu.server import split_statements as j_split

    for sql in SPLIT_CORPUS:
        assert split_statements(sql) == j_split(sql), sql


# ------------------------------------------------- tests/test_server.py cases

@pytest.fixture(scope="module")
def server():
    srv = MySQLServer(port=0, device="cpu")
    srv.start_background()
    try:
        yield srv
    finally:
        srv.close()


@pytest.fixture()
def client(server):
    c = MiniClient(server.host, server.port)
    try:
        yield c
    finally:
        c.close()


def test_handshake_and_ping(client):
    assert client.ping()


def test_ddl_dml_select(client):
    assert client.query("CREATE TABLE st (id INT PRIMARY KEY, name VARCHAR(20), v INT)") == 0
    assert client.query("INSERT INTO st VALUES (1,'ann',10),(2,'bob',20)") == 2
    cols, rows = client.query("SELECT id, name, v FROM st ORDER BY id")
    assert cols == ["id", "name", "v"]
    assert rows == [["1", "ann", "10"], ["2", "bob", "20"]]


def test_null_and_expressions(client):
    client.query("CREATE TABLE sn (id INT PRIMARY KEY, x INT)")
    client.query("INSERT INTO sn VALUES (1, NULL), (2, 5)")
    cols, rows = client.query("SELECT x, x + 1 FROM sn ORDER BY id")
    assert rows == [[None, None], ["5", "6"]]


def test_aggregate_over_wire(client):
    client.query("CREATE TABLE sa (id INT PRIMARY KEY, v INT)")
    client.query("INSERT INTO sa VALUES (1,1),(2,2),(3,3)")
    cols, rows = client.query("SELECT count(*), sum(v), avg(v) FROM sa")
    assert rows[0][0] == "3"
    assert rows[0][1] == "6"


def test_error_packet(client):
    with pytest.raises(ClientError) as ei:
        client.query("SELECT * FROM no_such_table")
    assert "no_such_table" in str(ei.value)


def test_multi_statement(client):
    client.query("CREATE TABLE sm (id INT PRIMARY KEY)")
    got = client.query("INSERT INTO sm VALUES (1); INSERT INTO sm VALUES (2); SELECT count(*) FROM sm")
    assert got == (["count(*)"], [["2"]]) or got[1] == [["2"]]


def test_transactions_over_wire(server):
    c1 = MiniClient(server.host, server.port)
    c2 = MiniClient(server.host, server.port)
    try:
        c1.query("CREATE TABLE stx (id INT PRIMARY KEY, v INT)")
        c1.query("INSERT INTO stx VALUES (1, 10)")
        c1.query("BEGIN")
        c1.query("UPDATE stx SET v = 99 WHERE id = 1")
        _, rows = c2.query("SELECT v FROM stx")
        assert rows == [["10"]], "other connection must not see uncommitted write"
        c1.query("COMMIT")
        _, rows = c2.query("SELECT v FROM stx")
        assert rows == [["99"]]
    finally:
        c1.close()
        c2.close()


def test_auth_rejected():
    srv = MySQLServer(port=0, users={"alice": b"secret"}, device="cpu")
    srv.start_background()
    try:
        with pytest.raises(ClientError):
            MiniClient(srv.host, srv.port, user="mallory", password="nope")
        c = MiniClient(srv.host, srv.port, user="alice", password="secret")
        assert c.ping()
        c.close()
        with pytest.raises(ClientError):
            MiniClient(srv.host, srv.port, user="alice", password="wrong")
    finally:
        srv.close()


def test_split_statements():
    assert split_statements("a; b;c") == ["a", "b", "c"]
    assert split_statements("insert into t values (';');") == ["insert into t values (';')"]
    assert split_statements('select ";;" ; x') == ['select ";;"', "x"]
    assert split_statements("select 1") == ["select 1"]


def test_connections_run_on_the_store_device(server):
    """Each connection's Session runs on its server's store's device (a
    CPU server builds no CUDA session)."""
    c = MiniClient(server.host, server.port)
    try:
        assert c.ping()
    finally:
        c.close()
    assert server.store.device.type == "cpu"


# ----------------------------------------------------------------- wire parity

def raw_query(client, sql: str) -> list:
    """Send one COM_QUERY and return every packet of the answer, raw."""
    io = client.io
    io.reset()
    io.write(bytes([PP.COM_QUERY]) + sql.encode())
    out = []
    while True:
        first = io.read()
        out.append(first)
        if first[0] == 0xFF:
            return out
        if first[0] == 0x00:
            affected, pos = PP.read_lenenc_int(first, 1)
            _, pos = PP.read_lenenc_int(first, pos)
            status = int.from_bytes(first[pos:pos + 2], "little")
            if not status & 0x0008:
                return out
            continue
        ncols, _ = PP.read_lenenc_int(first, 0)
        for _ in range(ncols + 1):  # column definitions, then EOF
            out.append(io.read())
        while True:
            pkt = io.read()
            out.append(pkt)
            if pkt[0] == 0xFE and len(pkt) < 9:
                status = int.from_bytes(pkt[3:5], "little")
                break
            if pkt[0] == 0xFF:
                return out
        if not status & 0x0008:
            return out


def _plain_cases():
    from test_torch_sql import SQL_CASES

    return {k: v for k, v in SQL_CASES.items() if all(isinstance(s, str) for s in v)}


WIRE_CASES = _plain_cases()


def test_wire_corpus_size():
    assert len(WIRE_CASES) >= 30


@pytest.mark.parametrize("name", list(WIRE_CASES))
def test_wire_packets_equal_the_jax_package(name):
    """The same statements through a JAX server and a port server: every
    packet of every answer is byte-equal (column definitions and text rows
    included; `datum_text` formats reals with repr and decimals with str in
    both)."""
    j_srv = j_server.MySQLServer(port=0)
    p_srv = p_server.MySQLServer(port=0, device="cpu")
    clients = []
    try:
        for srv in (j_srv, p_srv):
            srv.start_background()
            clients.append(MiniClient(srv.host, srv.port))
        for c in clients:
            c.query("SET tidb_enable_tpu_mesh = 0")
        for sql in WIRE_CASES[name]:
            j_pkts = raw_query(clients[0], sql)
            p_pkts = raw_query(clients[1], sql)
            assert p_pkts == j_pkts, f"{sql}:\n  jax  {j_pkts}\n  port {p_pkts}"
    finally:
        for c in clients:
            c.close()
        j_srv.close()
        p_srv.close()


def test_clients_cross_talk():
    """The port's MiniClient against the JAX server, and the JAX package's
    MiniClient against the port's server, with the same answers."""
    j_srv = j_server.MySQLServer(port=0)
    p_srv = p_server.MySQLServer(port=0, device="cpu")
    clients = []
    try:
        j_srv.start_background()
        p_srv.start_background()
        pairs = [(MiniClient(j_srv.host, j_srv.port), "port client, jax server"),
                 (j_server.MiniClient(p_srv.host, p_srv.port), "jax client, port server")]
        clients = [c for c, _ in pairs]
        got = []
        for c, _ in pairs:
            assert c.ping()
            c.query("CREATE TABLE x (id BIGINT PRIMARY KEY, v DOUBLE, d DECIMAL(8,3), s VARCHAR(8))")
            assert c.query("INSERT INTO x VALUES (1, 0.1, 1.5, 'a'), (2, 1e300, -2.125, NULL)") == 2
            got.append(c.query("SELECT id, v, v * 3, d, s FROM x ORDER BY id; SELECT count(*) FROM x"))
            with pytest.raises(Exception) as ei:
                c.query("SELECT * FROM nope")
            got.append((type(ei.value).__name__, ei.value.code))
        assert got[0] == got[2] and got[1] == got[3]
    finally:
        for c in clients:
            c.close()
        j_srv.close()
        p_srv.close()


# ------------------------------------------------------------- the PD's loop

def test_config_server_boots_and_stops_pd_loop():
    from tidb_tpu_torch.config import Config

    srv = MySQLServer(port=0, config=Config(pd_tick_interval=0.01), device="cpu")
    try:
        assert srv.store.pd._timer is not None
        deadline = time.monotonic() + 2.0
        while srv.store.pd.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.store.pd.ticks >= 1
    finally:
        srv.close()
    assert srv.store.pd._timer is None  # close() stopped the loop
