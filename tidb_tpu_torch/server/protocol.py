"""MySQL client/server wire protocol codec (ref: pkg/server/conn.go packet
IO + handshake, pkg/server/column.go column definitions, and the protocol
constants in pkg/parser/mysql/const.go).

Covers what a standard client needs to connect and run queries:
  - packet framing: 3-byte little-endian length + 1-byte sequence id
  - HandshakeV10 greeting, HandshakeResponse41 parsing
  - mysql_native_password auth (SHA1 scramble check; empty password OK)
  - OK / ERR / EOF packets (CLIENT_PROTOCOL_41 shapes)
  - column definition 41 + text-protocol result rows (length-encoded)

Copy of `tidb_tpu/server/protocol.py` for the PyTorch port (pure bytes: the
same inputs give the same packets; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import hashlib
import os
import struct

# capability flags (ref: mysql/const.go Client*)
CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_FOUND_ROWS = 1 << 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_MULTI_STATEMENTS = 1 << 16
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_DEPRECATE_EOF = 1 << 24

SERVER_CAPS = (
    CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
    | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION | CLIENT_MULTI_STATEMENTS
    | CLIENT_MULTI_RESULTS | CLIENT_PLUGIN_AUTH
)

SERVER_STATUS_AUTOCOMMIT = 0x0002
SERVER_STATUS_IN_TRANS = 0x0001

# commands (ref: mysql/const.go Com*)
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19

CHARSET_UTF8MB4 = 255  # utf8mb4_0900_ai_ci


class PacketIO:
    """Framed packet reader/writer over a socket (ref: conn.go readPacket /
    writePacket; sequence ids reset per command)."""

    def __init__(self, sock):
        self.sock = sock
        self.seq = 0

    def reset(self):
        self.seq = 0

    def read(self) -> bytes:
        header = self._read_exact(4)
        length = header[0] | header[1] << 8 | header[2] << 16
        self.seq = (header[3] + 1) & 0xFF
        return self._read_exact(length)

    def write(self, payload: bytes):
        # 16MB+ splitting is not needed for this server's result sizes, but
        # keep the loop for protocol correctness
        while True:
            chunk, payload = payload[: 0xFFFFFF], payload[0xFFFFFF:]
            self.sock.sendall(struct.pack("<I", len(chunk))[:3] + bytes([self.seq]) + chunk)
            self.seq = (self.seq + 1) & 0xFF
            if len(chunk) < 0xFFFFFF:
                break

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("peer closed")
            buf += part
        return buf


# ---------------------------------------------------------------- lenenc

def lenenc_int(v: int) -> bytes:
    if v < 251:
        return bytes([v])
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + struct.pack("<I", v)[:3]
    return b"\xfe" + struct.pack("<Q", v)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_int(buf: bytes, pos: int) -> tuple[int, int]:
    first = buf[pos]
    if first < 251:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return buf[pos + 1] | buf[pos + 2] << 8 | buf[pos + 3] << 16, pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def read_lenenc_str(buf: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos : pos + n], pos + n


# ---------------------------------------------------------------- packets

def handshake_v10(conn_id: int, salt: bytes, version: str = "8.0.11-tidb-tpu") -> bytes:
    """Initial greeting (ref: conn.go writeInitialHandshake)."""
    out = bytes([10]) + version.encode() + b"\x00"
    out += struct.pack("<I", conn_id)
    out += salt[:8] + b"\x00"
    out += struct.pack("<H", SERVER_CAPS & 0xFFFF)
    out += bytes([CHARSET_UTF8MB4])
    out += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
    out += struct.pack("<H", (SERVER_CAPS >> 16) & 0xFFFF)
    out += bytes([21])  # auth plugin data length
    out += b"\x00" * 10
    out += salt[8:20] + b"\x00"
    out += b"mysql_native_password\x00"
    return out


def parse_handshake_response(payload: bytes) -> dict:
    """HandshakeResponse41 (ref: conn.go readOptionalSSLRequestAndHandshakeResponse)."""
    caps, _max_packet, _charset = struct.unpack_from("<IIB", payload, 0)
    pos = 4 + 4 + 1 + 23
    end = payload.index(b"\x00", pos)
    user = payload[pos:end].decode()
    pos = end + 1
    if caps & CLIENT_PLUGIN_AUTH or caps & CLIENT_SECURE_CONNECTION:
        alen = payload[pos]
        auth = payload[pos + 1 : pos + 1 + alen]
        pos += 1 + alen
    else:
        end = payload.index(b"\x00", pos)
        auth = payload[pos:end]
        pos = end + 1
    db = ""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        end = payload.index(b"\x00", pos)
        db = payload[pos:end].decode()
        pos = end + 1
    return {"caps": caps, "user": user, "auth": auth, "db": db}


def native_password_scramble(password: bytes, salt: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password).digest()
    h2 = hashlib.sha1(h1).digest()
    mix = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, mix))


def check_auth(stored_password: bytes, salt: bytes, client_auth: bytes) -> bool:
    if not stored_password:
        return client_auth in (b"", None) or client_auth == native_password_scramble(b"", salt)
    return client_auth == native_password_scramble(stored_password, salt)


def ok_packet(affected: int = 0, last_insert_id: int = 0, status: int = SERVER_STATUS_AUTOCOMMIT,
              warnings: int = 0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def err_packet(code: int, message: str, state: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state.encode()[:5].ljust(5, b"0")
            + message.encode())


def eof_packet(status: int = SERVER_STATUS_AUTOCOMMIT, warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def column_def(name: str, tp: int, flen: int = 0, decimals: int = 0, flags: int = 0,
               charset: int = CHARSET_UTF8MB4) -> bytes:
    """ColumnDefinition41 (ref: pkg/server/column.go Dump)."""
    out = lenenc_str(b"def")  # catalog
    out += lenenc_str(b"")  # schema
    out += lenenc_str(b"")  # table
    out += lenenc_str(b"")  # org_table
    out += lenenc_str(name.encode())
    out += lenenc_str(name.encode())  # org_name
    out += bytes([0x0C])  # fixed-length fields size
    out += struct.pack("<H", charset)
    out += struct.pack("<I", max(flen, 0) or 255)
    out += bytes([tp & 0xFF])
    out += struct.pack("<H", flags)
    out += bytes([decimals])
    out += b"\x00\x00"
    return out


def text_row(values: list) -> bytes:
    """values: list of str|None (ref: pkg/server/util.go dumpTextRow)."""
    out = b""
    for v in values:
        if v is None:
            out += b"\xfb"
        else:
            out += lenenc_str(str(v).encode())
    return out


def new_salt() -> bytes:
    # 20 bytes, no zero bytes (clients c-string them)
    raw = bytearray(os.urandom(20))
    for i, b in enumerate(raw):
        if b == 0 or b == ord("$"):
            raw[i] = b + 1
    return bytes(raw)
