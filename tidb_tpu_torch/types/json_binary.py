"""MySQL/TiDB binary JSON codec + path engine
(ref: pkg/types/json_binary.go — the storage format rowcodec embeds —
and pkg/types/json_path_expr.go for path grammar).

Value model on the Python side: None/True/False/int/float/str/list/dict
(dict keys are str, insertion order preserved; MySQL sorts object keys by
length-then-bytes in the binary format, reproduced here for byte parity).

Binary layout (little-endian; ref: json_binary.go:20-60 doc comment):
  value      ::= type(1) payload
  object     ::= elemCount(4) size(4) keyEntry* valueEntry* key* value*
  array      ::= elemCount(4) size(4) valueEntry* value*
  keyEntry   ::= keyOff(4) keyLen(2)
  valueEntry ::= type(1) offset-or-inlined(4)
  literal    ::= 0x00 NULL | 0x01 TRUE | 0x02 FALSE
  string     ::= varint-len data

Copy of `tidb_tpu/types/json_binary.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import json as _pyjson
import struct

TYPE_OBJECT = 0x01
TYPE_ARRAY = 0x03
TYPE_LITERAL = 0x04
TYPE_I64 = 0x09
TYPE_U64 = 0x0A
TYPE_F64 = 0x0B
TYPE_STRING = 0x0C

LIT_NULL = 0x00
LIT_TRUE = 0x01
LIT_FALSE = 0x02

_INLINE_TYPES = (TYPE_LITERAL,)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(b: bytes, pos: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        c = b[pos]
        pos += 1
        n |= (c & 0x7F) << shift
        if not c & 0x80:
            return n, pos
        shift += 7


def _type_of(v) -> int:
    if v is None or isinstance(v, bool):
        return TYPE_LITERAL
    if isinstance(v, int):
        return TYPE_I64 if -(1 << 63) <= v < (1 << 63) else TYPE_U64
    if isinstance(v, float):
        return TYPE_F64
    if isinstance(v, str):
        return TYPE_STRING
    if isinstance(v, list):
        return TYPE_ARRAY
    if isinstance(v, dict):
        return TYPE_OBJECT
    raise TypeError(f"unsupported JSON value {type(v).__name__}")


def _encode_payload(v) -> bytes:
    t = _type_of(v)
    if t == TYPE_LITERAL:
        return bytes([LIT_NULL if v is None else (LIT_TRUE if v else LIT_FALSE)])
    if t == TYPE_I64:
        return struct.pack("<q", v)
    if t == TYPE_U64:
        return struct.pack("<Q", v & ((1 << 64) - 1))
    if t == TYPE_F64:
        return struct.pack("<d", v)
    if t == TYPE_STRING:
        raw = v.encode()
        return _varint(len(raw)) + raw
    # containers
    if t == TYPE_ARRAY:
        entries = [(_type_of(x), x) for x in v]
        keys: list[bytes] = []
    else:
        # MySQL sorts object keys by (length, bytes) in storage
        items = sorted(v.items(), key=lambda kv: (len(kv[0].encode()), kv[0].encode()))
        keys = [k.encode() for k, _ in items]
        entries = [(_type_of(x), x) for _, x in items]
    n = len(entries)
    key_entry_sz = 6 * len(keys)
    val_entry_sz = 5 * n
    header = 8 + key_entry_sz + val_entry_sz
    key_blob = bytearray()
    key_offs = []
    for k in keys:
        key_offs.append(header + len(key_blob))
        key_blob += k
    val_blob = bytearray()
    val_entries = []
    base = header + len(key_blob)
    for t2, x in entries:
        if t2 == TYPE_LITERAL:
            val_entries.append((t2, LIT_NULL if x is None else (LIT_TRUE if x else LIT_FALSE)))
        else:
            val_entries.append((t2, base + len(val_blob)))
            val_blob += _encode_payload(x)
    total = base + len(val_blob)
    out = bytearray(struct.pack("<II", n, total))
    for off, k in zip(key_offs, keys):
        out += struct.pack("<IH", off, len(k))
    for t2, off in val_entries:
        out += struct.pack("<BI", t2, off)
    out += key_blob
    out += val_blob
    return bytes(out)


def encode(v) -> bytes:
    """Python value -> binary JSON (type byte + payload)."""
    return bytes([_type_of(v)]) + _encode_payload(v)


def _decode_payload(t: int, b: bytes, pos: int):
    if t == TYPE_LITERAL:
        lit = b[pos]
        return None if lit == LIT_NULL else lit == LIT_TRUE
    if t == TYPE_I64:
        return struct.unpack_from("<q", b, pos)[0]
    if t == TYPE_U64:
        return struct.unpack_from("<Q", b, pos)[0]
    if t == TYPE_F64:
        return struct.unpack_from("<d", b, pos)[0]
    if t == TYPE_STRING:
        n, p = _read_varint(b, pos)
        return b[p : p + n].decode("utf-8", "surrogateescape")
    # containers: offsets in entries are relative to the container start
    n, _total = struct.unpack_from("<II", b, pos)
    if t == TYPE_ARRAY:
        out = []
        ve = pos + 8
        for i in range(n):
            t2, off = struct.unpack_from("<BI", b, ve + 5 * i)
            if t2 == TYPE_LITERAL:
                out.append(None if off == LIT_NULL else off == LIT_TRUE)
            else:
                out.append(_decode_payload(t2, b, pos + off))
        return out
    obj = {}
    ke = pos + 8
    ve = ke + 6 * n
    for i in range(n):
        koff, klen = struct.unpack_from("<IH", b, ke + 6 * i)
        key = b[pos + koff : pos + koff + klen].decode("utf-8", "surrogateescape")
        t2, off = struct.unpack_from("<BI", b, ve + 5 * i)
        if t2 == TYPE_LITERAL:
            obj[key] = None if off == LIT_NULL else off == LIT_TRUE
        else:
            obj[key] = _decode_payload(t2, b, pos + off)
    return obj


def decode(b: bytes):
    """Binary JSON -> Python value."""
    return _decode_payload(b[0], bytes(b), 1)


def parse_text(s: str):
    """JSON text -> Python value (MySQL-compatible errors collapse to
    ValueError)."""
    return _pyjson.loads(s)


def to_text(v) -> str:
    """Python value -> MySQL-style JSON text (", " separators like MySQL)."""
    return _pyjson.dumps(v, separators=(", ", ": "), ensure_ascii=False)


def json_type_name(v) -> str:
    """(ref: json_binary.go TypeCode -> type name for JSON_TYPE())."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER" if -(1 << 63) <= v < (1 << 63) else "UNSIGNED INTEGER"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "ARRAY"
    return "OBJECT"


# ------------------------------------------------------------------ paths
class PathError(ValueError):
    pass


def parse_path(path: str) -> list:
    """JSONPath subset (ref: json_path_expr.go): $, .key, ."quoted",
    [N], [*], .*, ** (prefix wildcard). Returns a list of legs:
    ("key", name) | ("idx", n) | ("key*",) | ("idx*",) | ("**",)."""
    s = path.strip()
    if not s.startswith("$"):
        raise PathError(f"invalid JSON path {path!r}")
    i = 1
    legs: list = []
    while i < len(s):
        c = s[i]
        if c == ".":
            i += 1
            if i < len(s) and s[i] == "*":
                legs.append(("key*",))
                i += 1
            elif i < len(s) and s[i] == '"':
                j = s.index('"', i + 1)
                legs.append(("key", s[i + 1 : j]))
                i = j + 1
            else:
                j = i
                while j < len(s) and (s[j].isalnum() or s[j] in "_$"):
                    j += 1
                if j == i:
                    raise PathError(f"invalid JSON path {path!r}")
                legs.append(("key", s[i:j]))
                i = j
        elif c == "[":
            j = s.index("]", i)
            inner = s[i + 1 : j].strip()
            if inner == "*":
                legs.append(("idx*",))
            else:
                legs.append(("idx", int(inner)))
            i = j + 1
        elif c == "*" and i + 1 < len(s) and s[i + 1] == "*":
            legs.append(("**",))
            i += 2
        elif c.isspace():
            i += 1
        else:
            raise PathError(f"invalid JSON path {path!r}")
    return legs


def _walk(v, legs: list, out: list):
    if not legs:
        out.append(v)
        return
    leg, rest = legs[0], legs[1:]
    if leg[0] == "key":
        if isinstance(v, dict) and leg[1] in v:
            _walk(v[leg[1]], rest, out)
    elif leg[0] == "idx":
        if isinstance(v, list):
            if 0 <= leg[1] < len(v):
                _walk(v[leg[1]], rest, out)
        elif leg[1] == 0:
            _walk(v, rest, out)  # scalar acts as a one-element array
    elif leg[0] == "key*":
        if isinstance(v, dict):
            for x in v.values():
                _walk(x, rest, out)
    elif leg[0] == "idx*":
        if isinstance(v, list):
            for x in v:
                _walk(x, rest, out)
    elif leg[0] == "**":
        _walk(v, rest, out)
        if isinstance(v, dict):
            for x in v.values():
                _walk(x, legs, out)
        elif isinstance(v, list):
            for x in v:
                _walk(x, legs, out)


def extract(v, paths: list[str]):
    """JSON_EXTRACT semantics (ref: builtin_json_vec.go vecEvalJSONExtract):
    one non-wildcard path -> the value itself (or missing -> None marker);
    multiple paths or wildcards -> array of matches. Returns (found, value)."""
    matches: list = []
    single_scalar = len(paths) == 1
    for p in paths:
        legs = parse_path(p)
        if any(l[0] in ("key*", "idx*", "**") for l in legs):
            single_scalar = False
        _walk(v, legs, matches)
    if not matches:
        return False, None
    if single_scalar and len(matches) == 1:
        return True, matches[0]
    return True, matches


def contains(doc, target) -> bool:
    """JSON_CONTAINS semantics (ref: types/json_binary_functions.go)."""
    if isinstance(doc, list):
        if isinstance(target, list):
            return all(contains(doc, t) for t in target)
        return any(contains(x, target) if isinstance(x, (list, dict)) else _eq(x, target) for x in doc)
    if isinstance(doc, dict):
        if isinstance(target, dict):
            return all(k in doc and contains(doc[k], v) if isinstance(doc[k], (dict, list)) else (k in doc and _eq(doc[k], v)) for k, v in target.items())
        return False
    return _eq(doc, target)


def _eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b or (isinstance(a, bool) and isinstance(b, bool) and a == b)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return type(a) is type(b) and a == b
