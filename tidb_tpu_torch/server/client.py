"""Minimal MySQL text-protocol client — the test/CLI counterpart of the
server (the reference tests through a Go MySQL client library; the
framework ships its own, with no dependency).

Implements HandshakeResponse41 + mysql_native_password and the text result
set decode; enough to validate the server against the real wire format.

Copy of `tidb_tpu/server/client.py` for the PyTorch port (it imports
nothing of tidb_tpu); it talks to either package's server. Its socket
sets TCP_NODELAY, so a command's packets leave as they are written.
"""

from __future__ import annotations

import socket
import struct

from . import protocol as P


class ClientError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"({code}) {message}")
        self.code = code
        self.message = message


class MiniClient:
    def __init__(self, host: str, port: int, user: str = "root", password: str = "",
                 database: str = "", timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.io = P.PacketIO(self.sock)
        self._handshake(user, password.encode(), database)

    def _handshake(self, user: str, password: bytes, database: str):
        greeting = self.io.read()
        assert greeting[0] == 10, "expected HandshakeV10"
        ver_end = greeting.index(b"\x00", 1)
        pos = ver_end + 1
        (self.conn_id,) = struct.unpack_from("<I", greeting, pos)
        pos += 4
        salt = greeting[pos : pos + 8]
        pos += 9  # salt1 + filler
        pos += 2 + 1 + 2 + 2 + 1 + 10  # caps_lo, charset, status, caps_hi, salt_len, reserved
        salt += greeting[pos : pos + 12]
        caps = (
            P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION | P.CLIENT_PLUGIN_AUTH
            | P.CLIENT_MULTI_STATEMENTS | P.CLIENT_MULTI_RESULTS
            | (P.CLIENT_CONNECT_WITH_DB if database else 0)
        )
        auth = P.native_password_scramble(password, salt)
        payload = struct.pack("<IIB", caps, 1 << 24, P.CHARSET_UTF8MB4) + b"\x00" * 23
        payload += user.encode() + b"\x00"
        payload += bytes([len(auth)]) + auth
        if database:
            payload += database.encode() + b"\x00"
        payload += b"mysql_native_password\x00"
        self.io.write(payload)
        resp = self.io.read()
        if resp[0] == 0xFF:
            code, msg = self._parse_err(resp)
            raise ClientError(code, msg)

    @staticmethod
    def _parse_err(payload: bytes) -> tuple[int, str]:
        (code,) = struct.unpack_from("<H", payload, 1)
        msg = payload[3:]
        if msg[:1] == b"#":
            msg = msg[6:]
        return code, msg.decode("utf-8", "replace")

    # ------------------------------------------------------------------
    def query(self, sql: str):
        """Run one statement; returns (columns, rows) for result sets or
        affected-row count for OK responses. Multi-statement payloads
        return the LAST result."""
        self.io.reset()
        self.io.write(bytes([P.COM_QUERY]) + sql.encode())
        result = None
        while True:
            result = self._read_result()
            if not self._more_results:
                return result

    _more_results = False

    def _read_result(self):
        first = self.io.read()
        self._more_results = False
        if first[0] == 0xFF:
            code, msg = self._parse_err(first)
            raise ClientError(code, msg)
        if first[0] == 0x00:
            affected, pos = P.read_lenenc_int(first, 1)
            _, pos = P.read_lenenc_int(first, pos)
            (status,) = struct.unpack_from("<H", first, pos)
            self._more_results = bool(status & 0x0008)  # SERVER_MORE_RESULTS_EXISTS
            return affected
        ncols, _ = P.read_lenenc_int(first, 0)
        columns = []
        for _ in range(ncols):
            cdef = self.io.read()
            pos = 0
            for _ in range(4):  # catalog, schema, table, org_table
                _, pos = P.read_lenenc_str(cdef, pos)
            name, pos = P.read_lenenc_str(cdef, pos)
            columns.append(name.decode())
        eof = self.io.read()
        assert eof[0] == 0xFE
        rows = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                (status,) = struct.unpack_from("<H", pkt, 3)
                self._more_results = bool(status & 0x0008)
                break
            if pkt[0] == 0xFF:
                code, msg = self._parse_err(pkt)
                raise ClientError(code, msg)
            row, pos = [], 0
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    v, pos = P.read_lenenc_str(pkt, pos)
                    row.append(v.decode())
            rows.append(row)
        return columns, rows

    def ping(self) -> bool:
        self.io.reset()
        self.io.write(bytes([P.COM_PING]))
        return self.io.read()[0] == 0x00

    def close(self):
        try:
            self.io.reset()
            self.io.write(bytes([P.COM_QUIT]))
        except OSError:
            pass
        self.sock.close()
