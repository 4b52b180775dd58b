"""Host-evaluated builtin batch — the long tail of MySQL scalar functions
(ref: pkg/expression/builtin_string.go, builtin_encryption.go,
builtin_math.go). These are rarely hot-path: the reference evaluates them
row-wise too, and most sit outside every coprocessor pushdown whitelist,
so they register through the SAME extension mechanism user functions use
(sql/extension.py) and the DAG splitter pins them to the root oracle.

Registered once at import; names deliberately stay out of the device
compiler's SCALAR_OPS.

Copy of `tidb_tpu/sql/builtins_host.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import math
import random
import uuid as _uuid
import zlib

from ..types import new_double, new_longlong, new_varchar
from .extension import EXTENSIONS

_NULL_IF_ANY = object()


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, bytearray):
        return bytes(v)
    return str(v).encode("utf-8")


def _as_str(v) -> str:
    return v.decode("utf-8", "replace") if isinstance(v, (bytes, bytearray)) else str(v)


def _as_num(v):
    if isinstance(v, (int, float)):
        return v
    try:
        return int(str(v))
    except ValueError:
        try:
            return float(str(v))
        except ValueError:
            return 0


def _hex(v):
    if v is None:
        return None
    if isinstance(v, int):
        return format(v, "X")
    if isinstance(v, float):
        return format(int(round(v)), "X")
    return _as_bytes(v).hex().upper()


def _unhex(v):
    if v is None:
        return None
    try:
        s = _as_str(v)
        if len(s) % 2:
            s = "0" + s
        return binascii.unhexlify(s)
    except (binascii.Error, ValueError):
        return None


def _sha2(v, bits):
    if v is None or bits is None:
        return None
    algo = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384", 512: "sha512"}.get(int(bits))
    if algo is None:
        return None
    return getattr(hashlib, algo)(_as_bytes(v)).hexdigest()


# @@block_encryption_mode (ref: builtin_encryption.go deriveKeyMySQL +
# mode dispatch). Module-level because extension builtins get plain
# values; Session.__init__ resets it and SET updates it.
BLOCK_ENCRYPTION_MODE = "aes-128-ecb"


def _aes_mode(iv):
    """-> (key_size, mode_factory) per @@block_encryption_mode; ECB ignores
    the iv argument (MySQL warns), CBC/OFB/CFB require a 16-byte iv."""
    try:
        from cryptography.hazmat.primitives.ciphers import modes  # type: ignore
    except ImportError:
        return None
    parts = BLOCK_ENCRYPTION_MODE.lower().split("-")
    bits = int(parts[1]) if len(parts) == 3 and parts[1].isdigit() else 128
    mname = parts[2] if len(parts) == 3 else "ecb"
    if mname == "ecb":
        return bits // 8, modes.ECB(), False
    if iv is None or len(_as_bytes(iv)) < 16:
        raise ValueError("Incorrect initialization vector")
    ivb = _as_bytes(iv)[:16]
    if mname == "cbc":
        return bits // 8, modes.CBC(ivb), False
    # OFB/CFB are STREAM modes: no PKCS padding, any ciphertext length
    fac = {"ofb": modes.OFB, "cfb": getattr(modes, "CFB128", modes.CFB)}.get(mname)
    if fac is None:
        return bits // 8, modes.ECB(), False
    return bits // 8, fac(ivb), True


def _mysql_aes_key(key: bytes, size: int = 16) -> bytes:
    out = bytearray(size)
    for i, b in enumerate(key):
        out[i % size] ^= b
    return bytes(out)


def _aes_encrypt(v, key, iv=None):
    if v is None or key is None:
        return None
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes  # type: ignore
    except ImportError:
        return None  # no AES backend in this image: NULL like a bad key
    data = _as_bytes(v)
    try:
        ks, mode, stream = _aes_mode(iv)
    except ValueError:
        return None
    if not stream:
        pad = 16 - len(data) % 16
        data += bytes([pad]) * pad
    enc = Cipher(algorithms.AES(_mysql_aes_key(_as_bytes(key), ks)), mode).encryptor()
    return enc.update(data) + enc.finalize()


def _aes_decrypt(v, key, iv=None):
    if v is None or key is None:
        return None
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes  # type: ignore
    except ImportError:
        return None
    raw = _as_bytes(v)
    try:
        ks, mode, stream = _aes_mode(iv)
    except ValueError:
        return None
    if not raw or (not stream and len(raw) % 16):
        return None
    dec = Cipher(algorithms.AES(_mysql_aes_key(_as_bytes(key), ks)), mode).decryptor()
    try:
        out = dec.update(raw) + dec.finalize()
        if stream:
            return out
        pad = out[-1]
        if not 1 <= pad <= 16:
            return None
        return out[:-pad]
    except ValueError:
        return None


def _elt(n, *items):
    if n is None:
        return None
    i = int(_as_num(n))
    if i < 1 or i > len(items):
        return None
    return items[i - 1]


def _cmp_many(fn, args):
    if any(a is None for a in args):
        return None
    if all(isinstance(a, (int, float)) for a in args):
        return fn(args)
    try:
        nums = [float(_as_num(a)) for a in args]
        if any(isinstance(a, (bytes, str)) and not str(a).replace(".", "").replace("-", "").isdigit() for a in args):
            raise ValueError
        return fn(nums)
    except ValueError:
        return fn([_as_str(a) for a in args])


def _truncate(x, d):
    if x is None or d is None:
        return None
    d = int(_as_num(d))
    f = 10.0 ** d
    v = _as_num(x)
    out = math.floor(abs(v) * f) / f * (1 if v >= 0 else -1)
    if isinstance(v, int) and d >= 0:
        return int(out)
    return out


def _insert_fn(s, pos, ln, new):
    if s is None or pos is None or ln is None or new is None:
        return None
    if isinstance(s, (bytes, bytearray)) or isinstance(new, (bytes, bytearray)):
        # a binary operand makes the whole expression binary (byte units;
        # ref: builtin_string.go INSERT with binary collation)
        s, new = _as_bytes(s), _as_bytes(new)
    else:
        s, new = _as_str(s), _as_str(new)
    pos, ln = int(_as_num(pos)), int(_as_num(ln))
    if pos < 1 or pos > len(s):
        return s
    if ln < 0 or pos + ln - 1 >= len(s):
        return s[: pos - 1] + new
    return s[: pos - 1] + new + s[pos - 1 + ln :]


def _pad(s, ln, p, left: bool):
    if s is None or ln is None or p is None:
        return None
    if isinstance(s, (bytes, bytearray)) or isinstance(p, (bytes, bytearray)):
        s, p = _as_bytes(s), _as_bytes(p)
    else:
        s, p = _as_str(s), _as_str(p)
    ln = int(_as_num(ln))
    if ln < 0:
        return None
    if len(s) >= ln:
        return s[:ln]
    if not p:
        return None
    fill = (p * ln)[: ln - len(s)]
    return fill + s if left else s + fill


def _concat_ws(sep, *args):
    if sep is None:
        return None
    return _as_str(sep).join(_as_str(a) for a in args if a is not None)


def _compress(v):
    if v is None:
        return None
    data = _as_bytes(v)
    if not data:
        return b""
    import struct

    return struct.pack("<I", len(data)) + zlib.compress(data)


def _uncompress(v):
    if v is None:
        return None
    raw = _as_bytes(v)
    if not raw:
        return b""
    try:
        return zlib.decompress(raw[4:])
    except zlib.error:
        return None


def _microsecond(t):
    if t is None:
        return None
    s = _as_str(t)
    if "." in s:
        frac = s.rsplit(".", 1)[1][:6]
        return int(frac.ljust(6, "0"))
    return 0


def _password(v):
    if v is None:
        return None
    h = hashlib.sha1(hashlib.sha1(_as_bytes(v)).digest()).hexdigest().upper()
    return "*" + h


_DEFS = [
    ("hex", _hex, new_varchar()),
    ("unhex", _unhex, new_varchar()),
    ("md5", lambda v: None if v is None else hashlib.md5(_as_bytes(v)).hexdigest(), new_varchar(32)),
    ("sha", lambda v: None if v is None else hashlib.sha1(_as_bytes(v)).hexdigest(), new_varchar(40)),
    ("sha1", lambda v: None if v is None else hashlib.sha1(_as_bytes(v)).hexdigest(), new_varchar(40)),
    ("sha2", _sha2, new_varchar(128)),
    ("aes_encrypt", _aes_encrypt, new_varchar()),
    ("aes_decrypt", _aes_decrypt, new_varchar()),
    ("elt", _elt, new_varchar()),
    ("greatest", lambda *a: _cmp_many(max, a), new_varchar()),
    ("least", lambda *a: _cmp_many(min, a), new_varchar()),
    ("uuid", lambda: str(_uuid.uuid4()), new_varchar(36)),
    ("truncate", _truncate, new_double()),
    ("insert", _insert_fn, new_varchar()),
    ("lpad", lambda s, n, p: _pad(s, n, p, True), new_varchar()),
    ("rpad", lambda s, n, p: _pad(s, n, p, False), new_varchar()),
    ("concat_ws", _concat_ws, new_varchar()),
    ("pi", lambda: 3.141593, new_double()),
    ("ascii", lambda v: None if v is None else (ord(_as_str(v)[0]) if _as_str(v) else 0), new_longlong()),
    ("ord", lambda v: None if v is None else (_as_bytes(v)[0] if _as_bytes(v) else 0), new_longlong()),
    ("octet_length", lambda v: None if v is None else len(_as_bytes(v)), new_longlong()),
    ("to_base64", lambda v: None if v is None else base64.b64encode(_as_bytes(v)).decode(), new_varchar()),
    ("from_base64", lambda v: None if v is None else base64.b64decode(_as_bytes(v), validate=False), new_varchar()),
    ("compress", _compress, new_varchar()),
    ("uncompress", _uncompress, new_varchar()),
    ("instr", lambda s, sub: None if s is None or sub is None else _as_str(s).find(_as_str(sub)) + 1, new_longlong()),
    ("crc32", lambda v: None if v is None else zlib.crc32(_as_bytes(v)), new_longlong()),
    ("rand", lambda *a: random.Random(int(_as_num(a[0]))).random() if a and a[0] is not None else random.random(), new_double()),
    ("password", _password, new_varchar(41)),
    ("microsecond", _microsecond, new_longlong()),
    ("coercibility", lambda *a: 2, new_longlong()),
    ("collation", lambda v: "binary" if isinstance(v, (bytes, int, float)) else "utf8mb4_bin", new_varchar(64)),
    ("format_bytes", lambda v: None if v is None else f"{_as_num(v)} bytes", new_varchar()),
    ("any_value", lambda v: v, new_varchar()),
]


def register_all():
    for name, fn, ft in _DEFS:
        if name not in EXTENSIONS.functions:
            EXTENSIONS.register_function(name, fn, ft)


register_all()
