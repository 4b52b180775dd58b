"""Row-at-a-time reference evaluator — the parity oracle.

Re-expresses the semantics of the reference's naive coprocessor executors
(ref: unistore/cophandler/mpp_exec.go, pkg/expression builtin row Eval*) in
host Python over Datums. Every device kernel is cross-checked against this
(SURVEY.md §4: "bit-parity harness = run the same DAG through the Go-semantics
reference executor and the TPU kernels and diff chunks").

Slow by design; never on the hot path.

Copy of `tidb_tpu/expr/eval_ref.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import re

from ..types import Datum, DatumKind, FieldType, MyDecimal, MyTime, DIV_FRAC_INCR
from .ir import ColumnRef, Const, Expr, ScalarFunc

# MySQL string->number takes the longest valid numeric prefix
# (ref: pkg/types/convert.go getValidFloatPrefix)
_NUM_PREFIX = re.compile(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")


# host builtins that consume their string arguments as BYTES (encoded in
# the argument's column charset); everything else gets character semantics
_BYTE_SEMANTICS_OPS = frozenset({
    "md5", "sha", "sha1", "sha2", "password", "crc32", "compress",
    "uncompress", "uncompressed_length", "to_base64", "aes_encrypt",
    "aes_decrypt", "bit_length",
})

# character-unit builtins where a BINARY operand first converts into the
# string operand's charset (then character semantics apply; ref:
# builtin_string.go convertString on mixed binary/str args)
_BIN_TO_CHAR_OPS = frozenset({
    "instr", "position", "locate", "insert", "lpad", "rpad", "elt",
    "find_in_set", "field", "concat_ws",
})

_CHARSET_CODEC = {"gbk": "gbk", "gb2312": "gb2312", "gb18030": "gb18030",
                  "latin1": "latin-1", "ascii": "ascii", "utf8": "utf-8",
                  "utf8mb4": "utf-8", "big5": "big5"}


def charset_bytes(v, ft) -> bytes:
    """Value -> the bytes MySQL's byte-semantics functions (LENGTH, HEX,
    ASCII, OCTET_LENGTH) see: the column's declared charset encoding, with
    BINARY(n) zero-padding to the declared width (ref:
    pkg/expression/builtin_string.go Length over the stored bytes)."""
    if isinstance(v, (bytes, bytearray)):
        b = bytes(v)
    else:
        codec = _CHARSET_CODEC.get(getattr(ft, "charset", "") or "", "utf-8")
        b = str(v).encode(codec, "replace")
    return b


def _ascii_upper(s: str) -> str:
    """ASCII-only case fold (the general_ci subset every engine path uses)."""
    return "".join(chr(ord(c) - 32) if "a" <= c <= "z" else c for c in s)


def _ascii_lower(s: str) -> str:
    return "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in s)


def str_prefix_f64(s) -> float:
    import math
    import sys as _sys

    if isinstance(s, (bytes, bytearray)):
        s = bytes(s).decode("utf-8", "replace")
    m = _NUM_PREFIX.match(s)
    v = float(m.group(0)) if m else 0.0
    if math.isinf(v):  # MySQL clamps to +/-DBL_MAX (convert.go StrToFloat)
        v = math.copysign(_sys.float_info.max, v)
    return v


def _num(d: Datum):
    return d.val


def _as_decimal(d: Datum) -> MyDecimal:
    if d.kind == DatumKind.MysqlDecimal:
        return d.val
    if d.kind in (DatumKind.Int64, DatumKind.Uint64):
        return MyDecimal(d.val, 0)
    if d.kind in (DatumKind.Float64, DatumKind.Float32):
        return MyDecimal(d.val)
    raise TypeError(f"cannot coerce {d} to decimal")


def _as_float(d: Datum) -> float:
    if d.kind == DatumKind.MysqlDecimal:
        return d.val.to_float()
    return float(d.val)


def _class2(a: Datum, b: Datum) -> str:
    ks = {a.kind, b.kind}
    if DatumKind.Float64 in ks or DatumKind.Float32 in ks:
        return "real"
    if DatumKind.MysqlDecimal in ks:
        return "decimal"
    if ks <= {DatumKind.String, DatumKind.Bytes}:
        return "string"
    return "int"


_JNULL = None  # python None doubles as JSON null (SQL NULL is Datum.NULL)


def _truth(d: Datum) -> bool | None:
    if d.is_null():
        return None
    if d.kind in (DatumKind.String, DatumKind.Bytes):
        return str_prefix_f64(d.val) != 0
    if d.kind == DatumKind.MysqlDecimal:
        return d.val.d != 0
    if d.kind == DatumKind.MysqlTime:
        return d.val.packed != 0
    return d.val != 0


def compare(a: Datum, b: Datum, ci: bool = False, collation=None) -> int | None:
    """3-way semantic compare; None if either side NULL. ci compares by
    collation WEIGHT BYTES (full Unicode, types/collate.py) — general_ci
    unless a specific collation is given."""
    if a.is_null() or b.is_null():
        return None
    cls = _class2(a, b)
    if cls == "string":
        if ci or collation is not None:
            from ..types.collate import weight_bytes
            from ..types.field_type import Collation

            coll = collation or Collation.Utf8MB4GeneralCI
            av = weight_bytes(a.val, coll)
            bv = weight_bytes(b.val, coll)
            return (av > bv) - (av < bv)
        av = a.val.encode() if isinstance(a.val, str) else bytes(a.val)
        bv = b.val.encode() if isinstance(b.val, str) else bytes(b.val)
        return (av > bv) - (av < bv)
    if cls == "real":
        av, bv = _as_float(a), _as_float(b)
        return (av > bv) - (av < bv)
    if cls == "decimal":
        av, bv = _as_decimal(a), _as_decimal(b)
        return (av.d > bv.d) - (av.d < bv.d)
    if a.kind == DatumKind.MysqlTime or b.kind == DatumKind.MysqlTime:
        av = a.val.packed if isinstance(a.val, MyTime) else a.val
        bv = b.val.packed if isinstance(b.val, MyTime) else b.val
        return (av > bv) - (av < bv)
    if a.kind in (DatumKind.MysqlEnum, DatumKind.MysqlSet) or b.kind in (DatumKind.MysqlEnum, DatumKind.MysqlSet):
        ek = (DatumKind.MysqlEnum, DatumKind.MysqlSet)
        if a.kind in ek and b.kind in ek:
            av, bv = int(a.val), int(b.val)  # member number (ref: types/enum.go)
        elif (b if a.kind in ek else a).kind in (DatumKind.String, DatumKind.Bytes):
            # enum vs string compares by NAME (ref: enum.go ConvertToString)
            av, bv = str(a.val), str(b.val)
            if ci:
                av, bv = av.upper(), bv.upper()
            return (av > bv) - (av < bv)
        else:
            av, bv = int(a.val), int(b.val)
        return (av > bv) - (av < bv)
    if a.kind == DatumKind.MysqlJSON or b.kind == DatumKind.MysqlJSON:
        # JSON equality is exact after coercing the other side to a JSON
        # scalar; ordering approximates MySQL's type-precedence rules with
        # text order (documented divergence)
        from ..types import json_binary as jb

        ja = jb.decode(a.val) if a.kind == DatumKind.MysqlJSON else RefEvaluator._jscalar(a)
        jv = jb.decode(b.val) if b.kind == DatumKind.MysqlJSON else RefEvaluator._jscalar(b)
        if jb._eq(ja, jv):
            return 0
        at, bt = jb.to_text(ja), jb.to_text(jv)
        return (at > bt) - (at < bt)
    av, bv = a.val, b.val  # python ints compare exactly regardless of sign
    return (av > bv) - (av < bv)


class RefEvaluator:
    """Evaluate an Expr over one row of Datums."""

    def eval(self, e: Expr, row: list[Datum]) -> Datum:
        if isinstance(e, ColumnRef):
            return row[e.index]
        if isinstance(e, Const):
            return e.datum
        assert isinstance(e, ScalarFunc)
        method = getattr(self, f"_op_{e.op}", None)
        if method is None:
            from ..expr.ir import EXTENSION_OPS
            from ..sql.extension import EXTENSIONS

            # an op name can outlive its registration (an expression built
            # before unregister_function): it is refused like any unknown op
            if e.op in EXTENSION_OPS and e.op in EXTENSIONS.functions:
                ds = self._args(e, row)
                if e.op in _BIN_TO_CHAR_OPS:
                    csl = [(getattr(ae.ft, "charset", "") or "").lower()
                           for ae in e.args]
                    target = next((c for c in csl if c not in ("", "binary")),
                                  "utf8mb4")
                    codec = _CHARSET_CODEC.get(target, "utf-8")
                    ds = [
                        Datum.string(bytes(d.val).decode(codec, "replace"))
                        if (not d.is_null()
                            and isinstance(d.val, (bytes, bytearray)))
                        else d
                        for d in ds
                    ]
                if e.op in _BYTE_SEMANTICS_OPS:
                    # byte-semantics parity: a gbk/latin1/binary argument
                    # reaches these host builtins as its COLUMN CHARSET
                    # bytes, not re-encoded utf-8 (ref:
                    # builtin_encryption.go: args convert via arg charset).
                    # Character-unit builtins (INSTR, ELT, LPAD...) keep
                    # their str arguments — byte offsets would be wrong.
                    ds = [
                        Datum.bytes_(charset_bytes(d.val, ae.ft))
                        if (not d.is_null() and isinstance(d.val, str)
                            and (getattr(ae.ft, "charset", "") or "").lower()
                            not in ("", "utf8", "utf8mb4"))
                        else d
                        for d, ae in zip(ds, e.args)
                    ]
                return EXTENSIONS.call(e.op, ds)
            raise NotImplementedError(f"no reference evaluator for {e.op!r}")
        return method(e, row)

    # -- helpers -------------------------------------------------------------
    def _args(self, e, row):
        return [self.eval(a, row) for a in e.args]

    @staticmethod
    def _jval(d: Datum):
        """Datum -> python JSON value (None return means SQL NULL input)."""
        from ..types import json_binary as jb

        if d.is_null():
            return _JNULL
        if d.kind == DatumKind.MysqlJSON:
            return jb.decode(d.val)
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            txt = d.val if isinstance(d.val, str) else bytes(d.val).decode("utf-8", "surrogateescape")
            return jb.parse_text(txt)
        if d.kind in (DatumKind.Int64, DatumKind.Uint64):
            return int(d.val)
        if d.kind in (DatumKind.Float32, DatumKind.Float64):
            return float(d.val)
        if d.kind == DatumKind.MysqlDecimal:
            return float(d.val.to_float())
        raise NotImplementedError(f"cannot treat {d.kind.name} as JSON")

    @staticmethod
    def _jscalar(d: Datum):
        """SQL value -> JSON SCALAR (strings stay strings — MySQL treats
        string args of JSON_ARRAY/JSON_OBJECT/MEMBER OF as values, not
        JSON text to parse)."""
        from ..types import json_binary as jb

        if d.kind == DatumKind.MysqlJSON:
            return jb.decode(d.val)
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            return d.val if isinstance(d.val, str) else bytes(d.val).decode("utf-8", "surrogateescape")
        if d.kind in (DatumKind.Int64, DatumKind.Uint64):
            return int(d.val)
        if d.kind in (DatumKind.Float32, DatumKind.Float64):
            return float(d.val)
        if d.kind == DatumKind.MysqlDecimal:
            return float(d.val.to_float())
        return str(d.val)

    @staticmethod
    def _jdatum(v) -> Datum:
        from ..types import json_binary as jb

        return Datum.json(jb.encode(v))

    # -- JSON (ref: pkg/expression/builtin_json_vec.go; semantics
    # pkg/types/json_binary_functions.go) --------------------------------
    def _op_json_extract(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        doc = self._jval(args[0])
        paths = [str(a.val) for a in args[1:]]
        from ..types import json_binary as jb

        found, v = jb.extract(doc, paths)
        return self._jdatum(v) if found else Datum.NULL

    def _op_json_unquote(self, e, row):
        a = self._args(e, row)[0]
        if a.is_null():
            return Datum.NULL
        from ..types import json_binary as jb

        if a.kind in (DatumKind.String, DatumKind.Bytes):
            # MySQL only parses/unquotes double-quoted JSON strings; any
            # other plain string passes through unchanged
            txt = a.val if isinstance(a.val, str) else bytes(a.val).decode("utf-8", "surrogateescape")
            if txt.startswith('"') and txt.endswith('"'):
                try:
                    v = jb.parse_text(txt)
                    if isinstance(v, str):
                        return Datum.string(v)
                except ValueError:
                    pass
            return Datum.string(txt)
        v = self._jval(a)
        if isinstance(v, str):
            return Datum.string(v)
        return Datum.string(jb.to_text(v))

    def _op_json_type(self, e, row):
        a = self._args(e, row)[0]
        if a.is_null():
            return Datum.NULL
        from ..types import json_binary as jb

        return Datum.string(jb.json_type_name(self._jval(a)))

    def _op_json_valid(self, e, row):
        a = self._args(e, row)[0]
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlJSON:
            return Datum.i64(1)
        if a.kind not in (DatumKind.String, DatumKind.Bytes):
            return Datum.i64(0)
        try:
            self._jval(a)
            return Datum.i64(1)
        except ValueError:
            return Datum.i64(0)

    def _op_json_length(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        v = self._jval(args[0])
        if len(args) > 1:
            from ..types import json_binary as jb

            found, v = jb.extract(v, [str(args[1].val)])
            if not found:
                return Datum.NULL
        if isinstance(v, (list, dict)):
            return Datum.i64(len(v))
        return Datum.i64(1)

    def _op_json_keys(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        v = self._jval(args[0])
        if len(args) > 1:
            from ..types import json_binary as jb

            found, v = jb.extract(v, [str(args[1].val)])
            if not found:
                return Datum.NULL
        if not isinstance(v, dict):
            return Datum.NULL
        return self._jdatum(list(v.keys()))

    def _op_json_contains(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        from ..types import json_binary as jb

        return Datum.i64(1 if jb.contains(self._jval(args[0]), self._jval(args[1])) else 0)

    def _op_json_member_of(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        from ..types import json_binary as jb

        target, arr = self._jscalar(args[0]), self._jval(args[1])
        if isinstance(arr, list):
            return Datum.i64(1 if any(jb._eq(x, target) for x in arr) else 0)
        return Datum.i64(1 if jb._eq(arr, target) else 0)

    def _op_json_array(self, e, row):
        return self._jdatum([None if a.is_null() else self._jscalar(a) for a in self._args(e, row)])

    def _op_json_object(self, e, row):
        args = self._args(e, row)
        if len(args) % 2 != 0:
            raise ValueError(
                "Incorrect parameter count in the call to native function 'json_object'"
            )
        obj = {}
        for i in range(0, len(args), 2):
            k = args[i]
            if k.is_null():
                raise ValueError("JSON documents may not contain NULL member names")
            obj[str(k.val)] = None if args[i + 1].is_null() else self._jscalar(args[i + 1])
        return self._jdatum(obj)

    def _op_json_quote(self, e, row):
        a = self._args(e, row)[0]
        if a.is_null():
            return Datum.NULL
        import json as _pyjson

        return Datum.string(_pyjson.dumps(str(a.val), ensure_ascii=False))

    # -- regexp (ref: pkg/expression/builtin_regexp_vec.go) --------------
    def _regexp_match(self, e, row, with_match_type: bool):
        import re as _re

        args = self._args(e, row)
        if any(a.is_null() for a in args[:2]):
            return None
        def _txt(d):
            if isinstance(d.val, str):
                return d.val
            if isinstance(d.val, (bytes, bytearray, memoryview)):
                return bytes(d.val).decode("utf-8", "surrogateescape")
            return str(d.val)  # enum/set render as member names

        subject, pattern = _txt(args[0]), _txt(args[1])
        flags = 0
        ci = bool(e.args[0].ft.is_ci() or e.args[1].ft.is_ci())
        if with_match_type and len(args) > 2 and not args[2].is_null():
            mt = str(args[2].val)
            if "c" in mt:
                ci = False
            if "i" in mt:
                ci = True
            if "n" in mt:
                flags |= _re.DOTALL
            if "m" in mt:
                flags |= _re.MULTILINE
        if ci:
            flags |= _re.IGNORECASE
        return _re.search(pattern, subject, flags) is not None

    def _op_regexp(self, e, row):
        m = self._regexp_match(e, row, False)
        return Datum.NULL if m is None else Datum.i64(1 if m else 0)

    def _op_regexp_like(self, e, row):
        m = self._regexp_match(e, row, True)
        return Datum.NULL if m is None else Datum.i64(1 if m else 0)

    def _result_num(self, v, ft: FieldType) -> Datum:
        if v is None:
            return Datum.NULL
        if ft.eval_type() == "decimal":
            return Datum.dec(v if isinstance(v, MyDecimal) else MyDecimal(v, max(ft.decimal, 0)))
        if ft.eval_type() == "real":
            return Datum.f64(float(v))
        if ft.is_unsigned():
            return Datum.u64(int(v))
        return Datum.i64(int(v))

    def _arith(self, e, row, int_fn, real_fn, dec_fn):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        cls = _class2(a, b)
        if cls == "real":
            return self._result_num(real_fn(_as_float(a), _as_float(b)), e.ft)
        if cls == "decimal":
            return self._result_num(dec_fn(_as_decimal(a), _as_decimal(b)), e.ft)
        return self._result_num(int_fn(a.val, b.val), e.ft)

    # -- arithmetic ----------------------------------------------------------
    def _op_plus(self, e, row):
        return self._arith(e, row, lambda a, b: a + b, lambda a, b: a + b, lambda a, b: a + b)

    def _op_minus(self, e, row):
        return self._arith(e, row, lambda a, b: a - b, lambda a, b: a - b, lambda a, b: a - b)

    def _op_mul(self, e, row):
        return self._arith(e, row, lambda a, b: a * b, lambda a, b: a * b, lambda a, b: a * b)

    def _op_div(self, e, row):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        if _class2(a, b) == "real":
            bf = _as_float(b)
            if bf == 0.0:
                return Datum.NULL
            return Datum.f64(_as_float(a) / bf)
        q = _as_decimal(a).div(_as_decimal(b))
        if q is None:
            return Datum.NULL
        return Datum.dec(q.round(max(e.ft.decimal, 0)))

    def _op_intdiv(self, e, row):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        if _class2(a, b) in ("decimal", "real"):
            ad, bd = _as_decimal(a), _as_decimal(b)
            if bd.d == 0:
                return Datum.NULL
            q = ad.d / bd.d
            return self._result_num(int(q), e.ft)
        if b.val == 0:
            return Datum.NULL
        q = abs(a.val) // abs(b.val)
        return self._result_num(-q if (a.val < 0) != (b.val < 0) else q, e.ft)

    def _op_mod(self, e, row):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        if _class2(a, b) == "real":
            bf = _as_float(b)
            if bf == 0.0:
                return Datum.NULL
            import math

            return Datum.f64(math.fmod(_as_float(a), bf))
        if _class2(a, b) == "decimal":
            ad, bd = _as_decimal(a), _as_decimal(b)
            if bd.d == 0:
                return Datum.NULL
            s = max(ad.scale, bd.scale)
            r = abs(ad.d) % abs(bd.d)
            return Datum.dec(MyDecimal(-r if ad.d < 0 else r, s))
        if b.val == 0:
            return Datum.NULL
        r = abs(a.val) % abs(b.val)
        return self._result_num(-r if a.val < 0 else r, e.ft)

    def _op_unaryminus(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlDecimal:
            return Datum.dec(-a.val)
        return self._result_num(-a.val, e.ft)

    def _op_abs(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlDecimal:
            return Datum.dec(MyDecimal(abs(a.val.d), a.val.scale))
        return self._result_num(abs(a.val), e.ft)

    # -- comparison ----------------------------------------------------------
    @staticmethod
    def _ci(e) -> bool:
        return any(a.ft.is_string() and a.ft.is_ci() for a in e.args)

    @staticmethod
    def _coll(e):
        for a in e.args:
            if a.ft.is_string() and a.ft.is_ci():
                return a.ft.collate
        return None

    def _cmp_op(self, e, row, pred):
        a, b = self._args(e, row)
        a, b = self._bin_coerce(e, a, b)
        c = compare(a, b, ci=self._ci(e), collation=self._coll(e))
        if c is None:
            return Datum.NULL
        return Datum.i64(1 if pred(c) else 0)

    @staticmethod
    def _bin_coerce(e, a, b):
        """Binary-vs-string comparison compares the string side's COLUMN
        CHARSET bytes (ref: pkg/expression/builtin_compare.go with a binary
        collation operand; hex literals are VARBINARY)."""
        if len(e.args) < 2:
            return a, b
        ka = isinstance(a.val, (bytes, bytearray)) and not a.is_null()
        kb = isinstance(b.val, (bytes, bytearray)) and not b.is_null()
        if ka == kb:
            return a, b
        if ka and isinstance(b.val, str):
            b = Datum.bytes_(charset_bytes(b.val, e.args[1].ft))
        elif kb and isinstance(a.val, str):
            a = Datum.bytes_(charset_bytes(a.val, e.args[0].ft))
        return a, b

    def _op_eq(self, e, row):
        return self._cmp_op(e, row, lambda c: c == 0)

    def _op_ne(self, e, row):
        return self._cmp_op(e, row, lambda c: c != 0)

    def _op_lt(self, e, row):
        return self._cmp_op(e, row, lambda c: c < 0)

    def _op_le(self, e, row):
        return self._cmp_op(e, row, lambda c: c <= 0)

    def _op_gt(self, e, row):
        return self._cmp_op(e, row, lambda c: c > 0)

    def _op_ge(self, e, row):
        return self._cmp_op(e, row, lambda c: c >= 0)

    def _op_nulleq(self, e, row):
        a, b = self._args(e, row)
        if a.is_null() and b.is_null():
            return Datum.i64(1)
        c = compare(a, b)
        return Datum.i64(1 if c == 0 else 0)

    def _op_in(self, e, row):
        a = self.eval(e.args[0], row)
        if a.is_null():
            return Datum.NULL
        saw_null = False
        for arg in e.args[1:]:
            b = self.eval(arg, row)
            c = compare(a, b, ci=self._ci(e), collation=self._coll(e))
            if c is None:
                saw_null = True
            elif c == 0:
                return Datum.i64(1)
        return Datum.NULL if saw_null else Datum.i64(0)

    def _op_between(self, e, row):
        a, lo, hi = self._args(e, row)
        ci = self._ci(e)
        coll = self._coll(e)
        c1, c2 = compare(a, lo, ci=ci, collation=coll), compare(a, hi, ci=ci, collation=coll)
        if c1 is None or c2 is None:
            return Datum.NULL
        return Datum.i64(1 if c1 >= 0 and c2 <= 0 else 0)

    # -- logical -------------------------------------------------------------
    def _op_and(self, e, row):
        a, b = self._args(e, row)
        ta, tb = _truth(a), _truth(b)
        if ta is False or tb is False:
            return Datum.i64(0)
        if ta is None or tb is None:
            return Datum.NULL
        return Datum.i64(1)

    def _op_or(self, e, row):
        a, b = self._args(e, row)
        ta, tb = _truth(a), _truth(b)
        if ta is True or tb is True:
            return Datum.i64(1)
        if ta is None or tb is None:
            return Datum.NULL
        return Datum.i64(0)

    def _op_not(self, e, row):
        (a,) = self._args(e, row)
        t = _truth(a)
        if t is None:
            return Datum.NULL
        return Datum.i64(0 if t else 1)

    def _op_xor(self, e, row):
        a, b = self._args(e, row)
        ta, tb = _truth(a), _truth(b)
        if ta is None or tb is None:
            return Datum.NULL
        return Datum.i64(1 if ta != tb else 0)

    # -- null / control ------------------------------------------------------
    def _op_isnull(self, e, row):
        (a,) = self._args(e, row)
        return Datum.i64(1 if a.is_null() else 0)

    def _op_ifnull(self, e, row):
        a, b = self._args(e, row)
        return b if a.is_null() else a

    def _op_if(self, e, row):
        c, a, b = self._args(e, row)
        return a if _truth(c) else b

    def _op_case(self, e, row):
        args = e.args
        i = 0
        while i + 1 < len(args):
            if _truth(self.eval(args[i], row)):
                return self.eval(args[i + 1], row)
            i += 2
        if i < len(args):
            return self.eval(args[i], row)
        return Datum.NULL

    def _op_coalesce(self, e, row):
        for a in e.args:
            v = self.eval(a, row)
            if not v.is_null():
                return v
        return Datum.NULL

    # -- cast ----------------------------------------------------------------
    def _op_cast(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        dst = e.ft.eval_type()
        if dst == "real":
            return Datum.f64(_as_float(a))
        if dst == "decimal":
            return Datum.dec(_as_decimal(a).round(max(e.ft.decimal, 0)))
        if dst == "int":
            if a.kind in (DatumKind.Float64, DatumKind.Float32):
                import math

                v = a.val
                return self._result_num(int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5)), e.ft)
            if a.kind == DatumKind.MysqlDecimal:
                return self._result_num(a.val.to_int(), e.ft)
            return self._result_num(a.val, e.ft)
        if dst == "string":
            if a.kind in (DatumKind.String, DatumKind.Bytes):
                return a
            return Datum.string(str(a.val))
        if dst == "time":
            from ..types import TypeCode as _TC

            if a.kind in (DatumKind.String, DatumKind.Bytes):
                # CAST('...' AS DATETIME/DATE) (ref: builtin_cast.go
                # castStringAsTime -> types.ParseTime); bare time-of-day
                # strings parse at the zero date ('10:30:00' -> hour 10)
                s = self._sval(a).strip()
                try:
                    t = MyTime.parse(s, max(e.ft.decimal, 0))
                except (ValueError, TypeError):
                    try:
                        t = MyTime.parse("0000-00-00 " + s, max(e.ft.decimal, 0))
                    except (ValueError, TypeError):
                        return Datum.NULL
                a = Datum.time(t)
            if e.ft.tp == _TC.Date and isinstance(a.val, MyTime):
                from ..types.mytime import unpack_datetime

                y, m, d2, *_ = unpack_datetime(a.val.packed)
                return Datum.time(MyTime.from_ymd(y, m, d2))
            return a
        raise NotImplementedError(f"ref cast to {dst}")

    # -- math ----------------------------------------------------------------
    def _op_ceil(self, e, row):
        import math

        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlDecimal:
            return self._result_num(int(math.ceil(a.val.d)), e.ft)
        if a.kind == DatumKind.Float64:
            return Datum.f64(math.ceil(a.val))
        return a

    def _op_floor(self, e, row):
        import math

        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlDecimal:
            return self._result_num(int(math.floor(a.val.d)), e.ft)
        if a.kind == DatumKind.Float64:
            return Datum.f64(math.floor(a.val))
        return a

    def _op_round(self, e, row):
        a = self.eval(e.args[0], row)
        nd = 0
        if len(e.args) > 1:
            d = self.eval(e.args[1], row)
            if d.is_null():
                return Datum.NULL
            nd = int(d.val)
        if a.is_null():
            return Datum.NULL
        if a.kind == DatumKind.MysqlDecimal:
            tgt = min(max(nd, 0), a.val.scale)
            return Datum.dec(a.val.round(tgt).round(max(e.ft.decimal, 0)))
        if a.kind == DatumKind.Float64:
            import math

            p = 10.0 ** nd
            v = a.val * p
            out = math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)
            return Datum.f64(out / p)
        if nd >= 0:
            return a
        p = 10 ** (-nd)
        v = a.val
        q = (abs(v) * 2 + p) // (2 * p) * p
        return self._result_num(-q if v < 0 else q, e.ft)

    def _op_sqrt(self, e, row):
        import math

        (a,) = self._args(e, row)
        if a.is_null() or _as_float(a) < 0:
            return Datum.NULL
        return Datum.f64(math.sqrt(_as_float(a)))

    def _op_exp(self, e, row):
        import math

        (a,) = self._args(e, row)
        return Datum.NULL if a.is_null() else Datum.f64(math.exp(_as_float(a)))

    def _op_ln(self, e, row):
        import math

        (a,) = self._args(e, row)
        if a.is_null() or _as_float(a) <= 0:
            return Datum.NULL
        return Datum.f64(math.log(_as_float(a)))

    _op_log = _op_ln

    def _op_pow(self, e, row):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        return Datum.f64(_as_float(a) ** _as_float(b))

    def _op_sign(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        v = _as_float(a)
        return Datum.i64((v > 0) - (v < 0))

    # -- bit -----------------------------------------------------------------
    def _bits(self, e, row, fn):
        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        return Datum.u64(fn(a.val & 0xFFFFFFFFFFFFFFFF, b.val & 0xFFFFFFFFFFFFFFFF) & 0xFFFFFFFFFFFFFFFF)

    def _op_bitand(self, e, row):
        return self._bits(e, row, lambda a, b: a & b)

    def _op_bitor(self, e, row):
        return self._bits(e, row, lambda a, b: a | b)

    def _op_bitxor(self, e, row):
        return self._bits(e, row, lambda a, b: a ^ b)

    def _op_bitneg(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        return Datum.u64(~a.val & 0xFFFFFFFFFFFFFFFF)

    def _op_shiftleft(self, e, row):
        return self._bits(e, row, lambda a, b: 0 if b >= 64 else a << b)

    def _op_shiftright(self, e, row):
        return self._bits(e, row, lambda a, b: 0 if b >= 64 else a >> b)

    # -- string --------------------------------------------------------------
    def _op_length(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        return Datum.i64(len(charset_bytes(a.val, e.args[0].ft)))

    def _op_octet_length(self, e, row):
        return self._op_length(e, row)

    def _op_hex(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        if isinstance(a.val, (int,)) or a.kind in (DatumKind.Int64, DatumKind.Uint64):
            return Datum.string(format(int(a.val), "X"))
        return Datum.string(charset_bytes(a.val, e.args[0].ft).hex().upper())

    def _op_ascii(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        b = charset_bytes(a.val, e.args[0].ft)
        return Datum.i64(b[0] if b else 0)

    def _op_ord(self, e, row):
        # ORD: leading multi-byte character folded big-endian (MySQL docs)
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        b = charset_bytes(a.val, e.args[0].ft)
        if not b:
            return Datum.i64(0)
        s = a.val if isinstance(a.val, str) else None
        if s:
            cb = charset_bytes(s[0], e.args[0].ft)
            n = 0
            for x in cb:
                n = n * 256 + x
            return Datum.i64(n)
        return Datum.i64(b[0])

    def _op_strcmp(self, e, row):
        a, b = self._args(e, row)
        c = compare(a, b)
        return Datum.NULL if c is None else Datum.i64(c)

    def _op_like(self, e, row):
        import re

        a, p = self._args(e, row)
        if a.is_null() or p.is_null():
            return Datum.NULL
        if isinstance(p.val, (bytes, bytearray)) or isinstance(a.val, (bytes, bytearray)):
            # binary operand: LIKE matches over the string side's COLUMN
            # CHARSET bytes, latin1-lifted so the regex machinery stays 1:1
            # with byte positions (same coercion rule as _bin_coerce)
            a, p = self._bin_coerce(e, a, p)
            s = bytes(a.val).decode("latin1") if isinstance(a.val, (bytes, bytearray)) else a.val
            pat = bytes(p.val).decode("latin1") if isinstance(p.val, (bytes, bytearray)) else p.val
        else:
            s = a.val
            pat = p.val
        if self._ci(e):
            # the SAME per-collation fold weight_bytes uses — '=' and LIKE
            # must agree (types/collate.py fold_text)
            from ..types.collate import fold_text
            from ..types.field_type import Collation

            coll = self._coll(e) or Collation.Utf8MB4GeneralCI
            s, pat = fold_text(s, coll), fold_text(pat, coll)
        rx = re.escape(pat).replace(re.escape("%"), ".*").replace(re.escape("_"), ".")
        return Datum.i64(1 if re.fullmatch(rx, s, re.S) else 0)

    def _op_substr(self, e, row):
        args = self._args(e, row)
        a = args[0]
        if any(x.is_null() for x in args):
            return Datum.NULL
        s = a.val if isinstance(a.val, str) else a.val.decode("utf-8", "surrogateescape")
        pos = int(args[1].val)
        if pos > 0:
            start = pos - 1
        elif pos < 0:
            start = len(s) + pos
            if start < 0:  # MySQL: position before string start -> ''
                return Datum.string("")
        else:
            return Datum.string("")
        ln = int(args[2].val) if len(args) > 2 else None
        out = s[start : start + ln] if ln is not None else s[start:]
        return Datum.string(out)

    @staticmethod
    def _sval(d: Datum) -> str:
        v = d.val
        if isinstance(v, str):
            return v
        if isinstance(v, (bytes, bytearray)):
            return bytes(v).decode("utf-8", "surrogateescape")
        if isinstance(v, MyDecimal):
            return str(v)
        return str(v)

    def _op_convert_using(self, e, row):
        """CONVERT(expr USING cs) (ref: builtin_string.go builtinConvertSig):
        USING binary yields the source-charset bytes; otherwise the text
        round-trips through the target codec with '?' for unencodable."""
        a, csd = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        cs = str(csd.val).lower()
        if cs == "binary":
            return Datum.bytes_(charset_bytes(a.val, e.args[0].ft))
        codec = _CHARSET_CODEC.get(cs, "utf-8")
        if isinstance(a.val, (bytes, bytearray)):
            return Datum.string(bytes(a.val).decode(codec, "replace"))
        s = self._sval(a)
        return Datum.string(s.encode(codec, "replace").decode(codec, "replace"))

    def _op_concat(self, e, row):
        args = self._args(e, row)
        if any(a.is_null() for a in args):
            return Datum.NULL
        if any(isinstance(a.val, (bytes, bytearray)) for a in args):
            # a binary operand makes CONCAT binary: every piece contributes
            # its COLUMN-CHARSET bytes (ref: builtin_string.go concat with
            # binary collation propagation)
            return Datum.bytes_(b"".join(
                charset_bytes(a.val, ae.ft) for a, ae in zip(args, e.args)
            ))
        return Datum.string("".join(self._sval(a) for a in args))

    def _str1(self, e, row, fn):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        return Datum.string(fn(self._sval(a)))

    @staticmethod
    def _case_cs(e):
        return (getattr(e.args[0].ft, "charset", "") or "").lower()

    def _op_upper(self, e, row):
        # gbk-class charsets case-map ASCII only (ref:
        # pkg/util/charset/encoding_gbk.go ToUpper/ToLower special-casing)
        if self._case_cs(e) in ("gbk", "gb2312", "gb18030", "big5"):
            return self._str1(e, row, _ascii_upper)
        return self._str1(e, row, str.upper)

    def _op_lower(self, e, row):
        if self._case_cs(e) in ("gbk", "gb2312", "gb18030", "big5"):
            return self._str1(e, row, _ascii_lower)
        return self._str1(e, row, str.lower)

    def _op_trim(self, e, row):
        return self._str1(e, row, lambda s: s.strip(" "))

    def _op_ltrim(self, e, row):
        return self._str1(e, row, lambda s: s.lstrip(" "))

    def _op_rtrim(self, e, row):
        return self._str1(e, row, lambda s: s.rstrip(" "))

    def _op_replace(self, e, row):
        a, frm, to = self._args(e, row)
        if a.is_null() or frm.is_null() or to.is_null():
            return Datum.NULL
        f = self._sval(frm)
        if f == "":
            return Datum.string(self._sval(a))
        return Datum.string(self._sval(a).replace(f, self._sval(to)))

    # -- date arithmetic ------------------------------------------------------
    def _op_date_add(self, e, row):
        return self._date_shift(e, row, +1)

    def _op_date_sub(self, e, row):
        return self._date_shift(e, row, -1)

    def _date_shift(self, e, row, sign: int):
        from ..types.mytime import datetime_add

        d, n = self.eval(e.args[0], row), self.eval(e.args[1], row)
        unit = e.args[2].datum.val  # const string
        if d.is_null() or n.is_null():
            return Datum.NULL
        t = d.val if isinstance(d.val, MyTime) else MyTime(int(d.val))
        return Datum.time(MyTime(datetime_add(t.packed, sign * int(n.val), str(unit)), t.fsp))

    def _op_datediff(self, e, row):
        from ..types.mytime import days_from_civil

        a, b = self._args(e, row)
        if a.is_null() or b.is_null():
            return Datum.NULL
        ya, ma, da = self._time_parts(a)[:3]
        yb, mb, db = self._time_parts(b)[:3]
        return Datum.i64(days_from_civil(ya, ma, da) - days_from_civil(yb, mb, db))

    # -- time ----------------------------------------------------------------
    def _time_parts(self, a: Datum):
        t = a.val if isinstance(a.val, MyTime) else MyTime(int(a.val))
        return t.parts()

    def _tfield(self, e, row, idx):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        return Datum.i64(self._time_parts(a)[idx])

    def _op_year(self, e, row):
        return self._tfield(e, row, 0)

    def _op_month(self, e, row):
        return self._tfield(e, row, 1)

    def _op_day(self, e, row):
        return self._tfield(e, row, 2)

    def _op_hour(self, e, row):
        return self._tfield(e, row, 3)

    def _op_minute(self, e, row):
        return self._tfield(e, row, 4)

    def _op_second(self, e, row):
        return self._tfield(e, row, 5)

    def _op_to_days(self, e, row):
        (a,) = self._args(e, row)
        if a.is_null():
            return Datum.NULL
        y, m, d = self._time_parts(a)[:3]
        delsum = 365 * y + 31 * (m - 1) + d
        if m > 2:
            delsum -= int(0.4 * m + 2.3)
            yy = y
        else:
            yy = y - 1
        return Datum.i64(delsum + yy // 4 - yy // 100 + yy // 400)

    def _op_weekday(self, e, row):
        d = self._op_to_days(e, row)
        if d.is_null():
            return Datum.NULL
        return Datum.i64((d.val + 5) % 7)

    def _op_extract(self, e, row):
        unit = e.args[0]
        u = str(unit.datum.val).lower()
        from .ir import ScalarFunc as SF

        return self.eval(SF(u, (e.args[1],), e.ft), row)
