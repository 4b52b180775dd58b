"""Compile expression trees to eager torch computations
(port of tidb_tpu/expr/compile.py).

Value model as in the JAX package: every node yields a CompVal — (value,
null) tensors plus the FieldType; SQL three-valued logic is explicit.

  int       int64 lanes; mixed signed/unsigned compares handled explicitly
  real      float64 lanes (MySQL DOUBLE)
  decimal   int64 lanes scaled by 10^ft.decimal — exact fixed-point
  time      int64 lanes holding the order-preserving packed layout
  string    int64 [N, W+1] packed big-endian words + length (device compare);
            raw bytes ride along for pass-through projection

Every op of the JAX package's compiler runs here:
  arithmetic  plus minus mul div intdiv mod unaryminus abs
  comparison  eq ne lt le gt ge nulleq in between (binary and general_ci)
  logic       and or not xor; isnull ifnull if case coalesce; cast
  math        ceil floor round sqrt exp ln log pow sign
  bit         bitand bitor bitxor bitneg shiftleft shiftright
  string      length strcmp like substr upper lower concat trim ltrim rtrim
  date        date_add date_sub datediff year month day hour minute second
              to_days weekday extract
  string -> real / decimal / int (MySQL's numeric-prefix parse,
  parse_f64_prefix), also for a bare string in WHERE (ops/selection.py).

Refused in both packages (NotImplementedError, so the store answers from
its row oracle): replace; LIKE other than an exact or a 'prefix%'
pattern; round with non-constant digits; date_add / date_sub with a unit
other than second minute hour day week month quarter year; and, or, not,
xor, if and case over a string operand; concat of a non-string; length of
a string with no raw bytes; a non-ASCII constant under a CI collation;
JSON and regexp functions (no _op_ at all). EXTRACT of a unit with no op of
its own (quarter) raises ValueError from ScalarFunc, as in the reference.

Every op is out of place and makes its decisions on constants (LIKE's
pattern, round's digits, the interval unit) in Python, so the same
closures run under torch.func.vmap for the batch tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..chunk.device import DeviceColumn, pack_string_words
from ..runtime import resolve_device
from ..types import FieldType, MyDecimal, MyTime, TypeCode
from ..types.mytime import _UNIT_SECONDS, add_months, civil_from_days, days_from_civil
from .eval_ref import _ascii_upper
from .ir import ColumnRef, Const, Expr, ScalarFunc

I64_MIN = -0x8000000000000000
I64_MAX = 0x7FFFFFFFFFFFFFFF
DBL_MAX = 1.7976931348623157e308


@dataclass
class CompVal:
    value: torch.Tensor  # [N] lanes, or [N, W+1] packed words for strings
    null: torch.Tensor  # bool [N]
    ft: FieldType
    raw: tuple | None = None  # (data[N,W] uint8, length[N] int32) for strings
    const_bytes: bytes | None = None  # python bytes of string CONSTANTS (CI guard)

    @property
    def eval_type(self) -> str:
        return self.ft.eval_type()


def _scale(ft: FieldType) -> int:
    return max(ft.decimal, 0)


def _pow10(k: int) -> int:
    return 10 ** k


def _flip(v):
    """Map uint64-bitcast lanes to sign-flipped int64 so signed compare
    gives unsigned order."""
    return v ^ I64_MIN


def device_bytes(b: bytes, dev) -> torch.Tensor:
    """uint8 [len(b)] holding `b`, made on `dev` without a host-to-device
    copy (a blocking copy from pageable memory waits for the stream): the
    bytes ride as fill values, eight to a big-endian int64 word, and are
    split by shifts on the device."""
    n_words = max(1, -(-len(b) // 8))
    padded = b.ljust(8 * n_words, b"\0")
    words = torch.stack([torch.full((), int.from_bytes(padded[8 * i: 8 * i + 8], "big", signed=True),
                                    dtype=torch.int64, device=dev) for i in range(n_words)])
    shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=dev)
    return ((words[:, None] >> shifts[None, :]) & 0xFF).reshape(-1)[: len(b)].to(torch.uint8)


def _round_div(num: torch.Tensor, den) -> torch.Tensor:
    """Integer divide rounding half away from zero (MySQL decimal/int rules).
    Operands are made non-negative first, so torch's flooring `//` equals
    truncation here; the sign is applied afterwards."""
    if isinstance(den, torch.Tensor):
        den = den.to(device=num.device, dtype=torch.int64)
    else:  # a fill, not a host-to-device copy
        den = torch.full((), den, dtype=torch.int64, device=num.device)
    neg = (num < 0) ^ (den < 0)
    n, d = torch.abs(num), torch.abs(den)
    q = (2 * n + d) // (2 * d)
    return torch.where(neg, -q, q)


def string_bytes(c: CompVal):
    """(data [N, W] uint8, length [N] int32) for a string CompVal — the raw
    bytes when they rode along, else unpacked from the packed compare words
    (which cover the first STRING_WORDS*8 bytes)."""
    if c.raw is not None:
        return c.raw
    words = c.value[:, :-1] ^ I64_MIN  # unflip the sign bit
    length = c.value[:, -1].to(torch.int32)
    shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=words.device)  # 56, 48, ..., 0
    b = (words[:, :, None] >> shifts[None, None, :]) & 0xFF
    return b.reshape(words.shape[0], words.shape[1] * 8).to(torch.uint8), length


def parse_f64_prefix(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """MySQL string->double: value of the longest numeric prefix, 0.0 when
    none (leading spaces skipped, trailing garbage ignored, no error).

    Byte-at-a-time state machine over the static width W, as the JAX
    package runs it: stage 0 leading spaces/sign, 1 sign seen, 2 integer
    digits, 3 fraction, 4 exponent sign, 5 exponent digits, 6 done. The
    float steps keep the reference's order (mant * 10.0 + dv, one multiply
    or divide by an exact power of ten, a clamp to +-DBL_MAX), so the
    result is bit-equal to the JAX package's on the CPU."""
    w = data.shape[1]
    ch_all = data.to(torch.int32)
    zi = torch.zeros_like(length, dtype=torch.int32)
    zb = torch.zeros_like(length, dtype=torch.bool)
    stage, frac, exp = zi, zi, zi
    mant = torch.zeros_like(length, dtype=torch.float64)
    neg, eneg, seen = zb, zb, zb
    for i in range(w):
        ch = ch_all[:, i]
        act = (length > i) & (stage < 6)
        digit = act & (ch >= 48) & (ch <= 57)
        is_sign = (ch == 43) | (ch == 45)
        c_sp = act & (stage == 0) & (ch == 32)
        c_sign = act & (stage == 0) & is_sign
        c_int = digit & (stage <= 2)
        c_dot = act & (stage <= 2) & (ch == 46)
        c_frac = digit & (stage == 3)
        c_e = act & ((stage == 2) | (stage == 3)) & ((ch == 101) | (ch == 69)) & seen
        c_es = act & (stage == 4) & is_sign
        c_exp = digit & ((stage == 4) | (stage == 5))
        matched = c_sp | c_sign | c_int | c_dot | c_frac | c_e | c_es | c_exp
        dv = (ch - 48).to(torch.float64)
        mant = torch.where(c_int | c_frac, mant * 10.0 + dv, mant)
        frac = torch.where(c_frac, frac + 1, frac)
        exp = torch.where(c_exp, torch.clamp(exp * 10 + (ch - 48), max=1000), exp)
        neg = neg | (c_sign & (ch == 45))
        eneg = eneg | (c_es & (ch == 45))
        seen = seen | c_int | c_frac
        stage = torch.where(c_sign, 1, stage)
        stage = torch.where(c_int, 2, stage)
        stage = torch.where(c_dot, 3, stage)
        stage = torch.where(c_e, 4, stage)
        stage = torch.where(c_es | c_exp, 5, stage)
        stage = torch.where(act & ~matched, 6, stage)
    e10 = torch.clamp(torch.where(eneg, -exp, exp) - frac, -400, 400)
    # mant is an exact integer up to 2^53; scaling by an exact power of ten
    # (dividing for negative exponents) keeps short decimals bit-exact
    p = _pow10_f64(torch.abs(e10))
    out = torch.where(e10 >= 0, mant * p, mant / p)
    # MySQL clamps range overflow to +/-DBL_MAX, not inf
    out = torch.clamp(out, -DBL_MAX, DBL_MAX)
    return torch.where(seen, torch.where(neg, -out, out), 0.0)


def _pow10_f64(ae: torch.Tensor) -> torch.Tensor:
    """Exact-where-possible 10**ae for non-negative int lanes: a table
    lookup (10^k is exactly representable for k <= 22) times the remainder
    by squaring (ae <= 400)."""
    # 10^0 .. 10^22 by a product scan on the device: every partial product
    # is a power of ten that float64 holds exactly, so the scan is exact
    table = torch.cumprod(torch.cat([torch.ones(1, dtype=torch.float64, device=ae.device),
                                     torch.full((22,), 10.0, dtype=torch.float64, device=ae.device)]), 0)
    small = torch.clamp(ae, max=22)
    out = table[small.to(torch.int64)]
    r = ae - small
    b = 10.0
    for _ in range(9):  # rem <= 378 < 2^9
        out = torch.where((r & 1) == 1, out * b, out)
        b = b * b
        r = r >> 1
    return out


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. CUDA computes a tensor
    divided by a Python scalar as x * (1 / d), which can be one ulp off;
    a 0-d tensor on x's device takes the true division, as the CPU does."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 as XLA converts (the JAX package's astype): out of
    range saturates to the int64 bounds and NaN gives 0. A plain .to()
    gives INT64_MIN for all of them on the CPU and saturates on CUDA."""
    big = x >= 9.223372036854775808e18
    small = x <= -9.223372036854775808e18
    out = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int64)
    return torch.where(big, I64_MAX, torch.where(small, I64_MIN, out))


def _cmp3(lt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-1/0/1 int32 from strict less / greater masks."""
    return gt.to(torch.int32) - lt.to(torch.int32)


def _ci_ascii_guard(*vals):
    """The device CI kernels fold ASCII only: a non-ASCII string CONSTANT
    under a CI collation is refused (NotImplementedError)."""
    for v in vals:
        if not isinstance(v, CompVal):
            continue
        b = v.const_bytes
        if b is not None and any(x >= 0x80 for x in b):
            raise NotImplementedError("non-ASCII constant under CI collation")


def fold_words_ci(words: torch.Tensor) -> torch.Tensor:
    """ASCII-case-fold packed compare words (a-z -> A-Z), keeping the
    length word — general_ci collation compare on device. Byte-local
    subtract of 0x20 never borrows (0x61-0x20 = 0x41 > 0)."""
    payload = words[..., :-1] ^ I64_MIN
    adj = torch.zeros_like(payload)
    for b in range(8):
        sh = 56 - 8 * b
        byte = (payload >> sh) & 0xFF
        is_lower = (byte >= 0x61) & (byte <= 0x7A)
        adj = adj + is_lower.to(torch.int64) * (0x20 << sh)
    return torch.cat([(payload - adj) ^ I64_MIN, words[..., -1:]], dim=-1)


def _words_cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic compare of [N, W] int64 word arrays -> (-1/0/1)[N]."""
    a, b = torch.broadcast_tensors(a, b)
    neq = a != b
    any_neq = neq.any(dim=-1)
    idx = neq.to(torch.int32).argmax(dim=-1)  # first differing word
    av = torch.gather(a, -1, idx[:, None].to(torch.int64))[:, 0]
    bv = torch.gather(b, -1, idx[:, None].to(torch.int64))[:, 0]
    return _cmp3(any_neq & (av < bv), any_neq & (av > bv))


def normalize_device_column(c: DeviceColumn) -> CompVal:
    """DeviceColumn -> CompVal (strings get packed compare words)."""
    if c.is_varlen():
        words = pack_string_words(c.data, c.length)
        return CompVal(words, c.null, c.ft, raw=(c.data, c.length))
    data = c.data
    if data.dtype != torch.int64 and c.ft.eval_type() != "real":
        data = data.to(torch.int64)
    return CompVal(data, c.null, c.ft)


def _pad_width(d: torch.Tensor, w: int) -> torch.Tensor:
    if d.shape[1] >= w:
        return d
    out = torch.zeros((d.shape[0], w), dtype=d.dtype, device=d.device)
    out[:, : d.shape[1]] = d
    return out


class ExprCompiler:
    """Compiles Expr trees against a fixed input schema.

    `device` is where constants are built when there are no input
    columns; otherwise the columns' own device is used."""

    def __init__(self, input_fts: list[FieldType], device="cuda"):
        self.input_fts = input_fts
        self.device = torch.device(device)

    # -- entry ---------------------------------------------------------------
    def run(self, exprs: list[Expr], cols: list) -> list[CompVal]:
        """Evaluate `exprs` over device columns (or bound CompVals)."""
        self._cols = cols
        self._n = cols[0].null.shape[0] if cols else 1
        self._dev = cols[0].null.device if cols else self.device
        self._col_cache: dict[int, CompVal] = {}
        return [self._eval(e) for e in exprs]

    # -- dispatch ------------------------------------------------------------
    def _eval(self, e: Expr) -> CompVal:
        if isinstance(e, ColumnRef):
            return self._column(e)
        if isinstance(e, Const):
            return self._const(e)
        if isinstance(e, ScalarFunc):
            fn = getattr(self, f"_op_{e.op}", None)
            if fn is None:
                raise NotImplementedError(f"scalar op {e.op} not implemented on device")
            return fn(e)
        raise TypeError(f"unknown expr node {e!r}")

    def _column(self, e: ColumnRef) -> CompVal:
        if e.index in self._col_cache:
            return self._col_cache[e.index]
        c = self._cols[e.index]
        if isinstance(c, CompVal):
            # pipeline stages (exec/builder.py) bind already-normalized values
            self._col_cache[e.index] = c
            return c
        v = normalize_device_column(c)
        self._col_cache[e.index] = v
        return v

    def _full(self, value, dtype):
        return torch.full((self._n,), value, dtype=dtype, device=self._dev)

    def _bools(self, value: bool):
        return torch.full((self._n,), value, dtype=torch.bool, device=self._dev)

    def _const(self, e: Const) -> CompVal:
        d = e.datum
        et = e.ft.eval_type()
        if d.is_null():
            dt = torch.float64 if et == "real" else torch.int64
            return CompVal(self._full(0, dt), self._bools(True), e.ft)
        if et == "real":
            v = self._full(float(d.val), torch.float64)
        elif et == "decimal":
            dec = d.val if isinstance(d.val, MyDecimal) else MyDecimal(d.val)
            v = self._full(dec.to_scaled_int(_scale(e.ft)), torch.int64)
        elif et == "time":
            packed = d.val.packed if isinstance(d.val, MyTime) else int(d.val)
            v = self._full(packed, torch.int64)
        elif et == "string":
            b = d.val.encode() if isinstance(d.val, str) else bytes(d.val)
            w = max(1, len(b))
            data = torch.zeros((1, w), dtype=torch.uint8, device=self._dev)
            if b:
                data[0, : len(b)] = device_bytes(b, self._dev)
            ln = torch.full((1,), len(b), dtype=torch.int32, device=self._dev)
            words = pack_string_words(data, ln)
            v = words.expand(self._n, words.shape[1])
            return CompVal(v, self._bools(False), e.ft,
                           raw=(data.expand(self._n, w), ln.expand(self._n)),
                           const_bytes=b)
        else:
            v = self._full(int(d.val), torch.int64)
        return CompVal(v, self._bools(False), e.ft)

    # -- coercion ------------------------------------------------------------
    @staticmethod
    def _common_class(a: CompVal, b: CompVal) -> str:
        ea, eb = a.eval_type, b.eval_type
        if "string" in (ea, eb) and ea == eb:
            return "string"
        if "real" in (ea, eb):
            return "real"
        if "decimal" in (ea, eb):
            return "decimal"
        if "time" in (ea, eb):
            return "time"
        return "int"

    def _to_class(self, v: CompVal, cls: str, scale: int | None = None) -> CompVal:
        et = v.eval_type
        if cls == "real":
            if et == "real":
                return v
            if et == "string":
                data, length = string_bytes(v)
                return CompVal(parse_f64_prefix(data, length), v.null, FieldType(TypeCode.Double))
            if et == "decimal":
                return CompVal(div_exact(v.value.to(torch.float64), float(10 ** _scale(v.ft))), v.null,
                               FieldType(TypeCode.Double))
            if v.ft.is_unsigned():
                # uint64 bit-pattern -> f64 without sign error
                val = v.value
                f = val.to(torch.float64)
                return CompVal(torch.where(val >= 0, f, f + 2.0 ** 64), v.null, FieldType(TypeCode.Double))
            return CompVal(v.value.to(torch.float64), v.null, FieldType(TypeCode.Double))
        if cls == "decimal":
            s = _scale(v.ft) if scale is None else scale
            if et == "string":
                # via double (MySQL parses the numeric prefix first)
                v = self._to_class(v, "real")
                et = "real"
            if et == "decimal":
                return self._rescale_dec(v, s)
            if et == "int":
                from ..types import new_decimal

                vv = CompVal(v.value, v.null, new_decimal(20, 0))
                return self._rescale_dec(vv, s)
            if et == "real":
                ft = FieldType(TypeCode.NewDecimal, decimal=s)
                x = v.value * float(10 ** s)
                # half away from zero, on the binary value (the JAX
                # package's documented deviation, kept for parity)
                scaled = _f64_to_i64(torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)))
                return CompVal(scaled, v.null, ft)
        if cls in ("int", "time"):
            return v
        raise NotImplementedError(f"coerce {et} -> {cls}")

    @staticmethod
    def _rescale_dec(v: CompVal, s: int) -> CompVal:
        cur = _scale(v.ft)
        ft = v.ft.clone()
        ft.tp = TypeCode.NewDecimal
        ft.decimal = s
        if s == cur:
            return CompVal(v.value, v.null, ft)
        if s > cur:
            return CompVal(v.value * _pow10(s - cur), v.null, ft)
        return CompVal(_round_div(v.value, _pow10(cur - s)), v.null, ft)

    # -- arithmetic ----------------------------------------------------------
    def _arith(self, e: ScalarFunc, int_fn, real_fn, dec_fn):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        cls = self._common_class(a, b)
        null = a.null | b.null
        if cls == "real":
            a, b = self._to_class(a, "real"), self._to_class(b, "real")
            return CompVal(real_fn(a.value, b.value), null, e.ft)
        if cls == "decimal":
            return dec_fn(a, b, null, e.ft)
        return CompVal(int_fn(a.value, b.value), null, e.ft)

    def _dec_addsub(self, sign: int):
        def fn(a: CompVal, b: CompVal, null, ft):
            s = max(_scale(a.ft), _scale(b.ft))
            av = self._to_class(a, "decimal", s).value
            bv = self._to_class(b, "decimal", s).value
            out = av + bv if sign > 0 else av - bv
            return self._rescale_dec(CompVal(out, null, FieldType(TypeCode.NewDecimal, decimal=s)), _scale(ft))

        return fn

    def _op_plus(self, e):
        return self._arith(e, lambda a, b: a + b, lambda a, b: a + b, self._dec_addsub(1))

    def _op_minus(self, e):
        return self._arith(e, lambda a, b: a - b, lambda a, b: a - b, self._dec_addsub(-1))

    def _op_mul(self, e):
        def dec(a: CompVal, b: CompVal, null, ft):
            av, bv = self._to_class(a, "decimal"), self._to_class(b, "decimal")
            s = _scale(av.ft) + _scale(bv.ft)
            out = av.value * bv.value
            return self._rescale_dec(CompVal(out, null, FieldType(TypeCode.NewDecimal, decimal=s)), _scale(ft))

        return self._arith(e, lambda a, b: a * b, lambda a, b: a * b, dec)

    def _op_div(self, e):
        """`/`: reals divide; ints & decimals use decimal division with the
        +4 scale increment (DIV_FRAC_INCR carried by the result FieldType).
        Division by zero yields NULL."""
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        if self._common_class(a, b) == "real":
            a, b = self._to_class(a, "real"), self._to_class(b, "real")
            zero = b.value == 0.0
            null = a.null | b.null | zero
            out = a.value / torch.where(zero, 1.0, b.value)
            return CompVal(out, null, e.ft)
        av, bv = self._to_class(a, "decimal"), self._to_class(b, "decimal")
        sr = _scale(e.ft)
        k = sr - _scale(av.ft) + _scale(bv.ft)
        zero = bv.value == 0
        null = a.null | b.null | zero
        num = av.value * _pow10(max(k, 0))
        den = torch.where(zero, 1, bv.value)
        out = _round_div(num, den)
        if k < 0:
            out = _round_div(out, _pow10(-k))
        return CompVal(out, null, e.ft)

    @staticmethod
    def _trunc_div(num, den):
        """Integer division truncating toward zero (den != 0)."""
        q = torch.abs(num) // torch.abs(den)
        return torch.where((num < 0) ^ (den < 0), -q, q)

    def _op_intdiv(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        cls = self._common_class(a, b)
        if cls == "real":
            av, bv = self._to_class(a, "real"), self._to_class(b, "real")
            zero = bv.value == 0.0
            null = a.null | b.null | zero
            q = av.value / torch.where(zero, 1.0, bv.value)
            return CompVal(_f64_to_i64(torch.trunc(q)), null, e.ft)
        if cls == "decimal":
            av, bv = self._to_class(a, "decimal"), self._to_class(b, "decimal")
            zero = bv.value == 0
            null = a.null | b.null | zero
            sa, sb = _scale(av.ft), _scale(bv.ft)
            num, den = av.value * _pow10(sb), bv.value * _pow10(sa)
            den = torch.where(zero, 1, den)
            return CompVal(self._trunc_div(num, den), null, e.ft)
        zero = b.value == 0
        null = a.null | b.null | zero
        den = torch.where(zero, 1, b.value)
        return CompVal(self._trunc_div(a.value, den), null, e.ft)

    def _op_mod(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        cls = self._common_class(a, b)
        if cls == "real":
            a, b = self._to_class(a, "real"), self._to_class(b, "real")
            zero = b.value == 0.0
            null = a.null | b.null | zero
            return CompVal(torch.fmod(a.value, torch.where(zero, 1.0, b.value)), null, e.ft)
        if cls == "decimal":
            s = max(_scale(a.ft), _scale(b.ft))
            av = self._to_class(a, "decimal", s).value
            bv = self._to_class(b, "decimal", s).value
        else:
            av, bv = a.value, b.value
        zero = bv == 0
        null = a.null | b.null | zero
        den = torch.where(zero, 1, bv)
        r = torch.abs(av) % torch.abs(den)
        return CompVal(torch.where(av < 0, -r, r), null, e.ft)  # dividend sign

    def _op_unaryminus(self, e):
        a = self._eval(e.args[0])
        return CompVal(-a.value, a.null, e.ft)

    def _op_abs(self, e):
        a = self._eval(e.args[0])
        return CompVal(torch.abs(a.value), a.null, e.ft)

    # -- comparison ----------------------------------------------------------
    def _cmp(self, a: CompVal, b: CompVal):
        """Return (-1/0/1)[N] semantic comparison of a vs b."""
        cls = self._common_class(a, b)
        if cls == "string":
            av, bv = a.value, b.value
            if a.ft.is_ci() or b.ft.is_ci():
                _ci_ascii_guard(a, b)
                av, bv = fold_words_ci(av), fold_words_ci(bv)
            return _words_cmp(av, bv)
        if cls == "real":
            av, bv = self._to_class(a, "real").value, self._to_class(b, "real").value
            return torch.sign(av - bv).to(torch.int32)
        if cls == "decimal":
            s = max(_scale(a.ft), _scale(b.ft))
            av = self._to_class(a, "decimal", s).value
            bv = self._to_class(b, "decimal", s).value
            return torch.sign(av - bv).to(torch.int32)
        # int/time class: handle signedness (ref: builtin_compare.go CompareInt)
        au, bu = a.ft.is_unsigned(), b.ft.is_unsigned()
        av, bv = a.value, b.value
        if au == bu:
            if au:
                av, bv = _flip(av), _flip(bv)
            return _cmp3(av < bv, av > bv)
        c = _cmp3(_flip(av) < _flip(bv), _flip(av) > _flip(bv))
        if au:
            # a unsigned vs b signed: b<0 => a>b; else unsigned compare
            return torch.where(bv < 0, 1, c).to(torch.int32)
        return torch.where(av < 0, -1, c).to(torch.int32)

    def _cmp_op(self, e: ScalarFunc, pred):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        c = self._cmp(a, b)
        return CompVal(pred(c).to(torch.int64), a.null | b.null, e.ft)

    def _op_eq(self, e):
        return self._cmp_op(e, lambda c: c == 0)

    def _op_ne(self, e):
        return self._cmp_op(e, lambda c: c != 0)

    def _op_lt(self, e):
        return self._cmp_op(e, lambda c: c < 0)

    def _op_le(self, e):
        return self._cmp_op(e, lambda c: c <= 0)

    def _op_gt(self, e):
        return self._cmp_op(e, lambda c: c > 0)

    def _op_ge(self, e):
        return self._cmp_op(e, lambda c: c >= 0)

    def _op_nulleq(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        c = self._cmp(a, b)
        both_null = a.null & b.null
        eq = (c == 0) & ~a.null & ~b.null
        return CompVal((both_null | eq).to(torch.int64), torch.zeros_like(a.null), e.ft)

    def _op_in(self, e):
        a = self._eval(e.args[0])
        hit = self._bools(False)
        any_null = self._bools(False)
        for arg in e.args[1:]:
            b = self._eval(arg)
            c = self._cmp(a, b)
            hit = hit | ((c == 0) & ~b.null)
            any_null = any_null | b.null
        # a NULL lane's value is garbage — never let it match
        hit = hit & ~a.null
        # NULL if lhs null, or no hit with some NULL operand (MySQL IN)
        null = a.null | (~hit & any_null)
        return CompVal(hit.to(torch.int64), null, e.ft)

    def _op_between(self, e):
        a, lo, hi = (self._eval(x) for x in e.args)
        c1, c2 = self._cmp(a, lo), self._cmp(a, hi)
        out = ((c1 >= 0) & (c2 <= 0)).to(torch.int64)
        return CompVal(out, a.null | lo.null | hi.null, e.ft)

    # -- logical -------------------------------------------------------------
    @staticmethod
    def _truth(v: CompVal):
        """MySQL truthiness of a value lane (nonzero = true)."""
        if v.eval_type == "real":
            return v.value != 0.0
        if v.value.dim() == 2:
            raise NotImplementedError("logical op over string operand not on device")
        return v.value != 0

    @staticmethod
    def _sel(cond, a: CompVal, b: CompVal, av, bv):
        """torch.where that handles 2-D string word lanes and carries raw."""
        if av.dim() == 2:
            out = torch.where(cond[:, None], av, bv)
            raw = None
            if a.raw is not None and b.raw is not None:
                ad, al = a.raw
                bd, bl = b.raw
                w = max(ad.shape[1], bd.shape[1])
                ad, bd = _pad_width(ad, w), _pad_width(bd, w)
                raw = (torch.where(cond[:, None], ad, bd), torch.where(cond, al, bl))
            return out, raw
        return torch.where(cond, av, bv), None

    def _op_and(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        ta, tb = self._truth(a), self._truth(b)
        f = (~ta & ~a.null) | (~tb & ~b.null)
        null = ~f & (a.null | b.null)
        return CompVal((~f & ~null).to(torch.int64), null, e.ft)

    def _op_or(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        ta, tb = self._truth(a), self._truth(b)
        t = (ta & ~a.null) | (tb & ~b.null)
        null = ~t & (a.null | b.null)
        return CompVal(t.to(torch.int64), null, e.ft)

    def _op_not(self, e):
        a = self._eval(e.args[0])
        return CompVal((~self._truth(a)).to(torch.int64), a.null, e.ft)

    def _op_xor(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        out = (self._truth(a) ^ self._truth(b)).to(torch.int64)
        return CompVal(out, a.null | b.null, e.ft)

    # -- null handling / control ---------------------------------------------
    def _op_isnull(self, e):
        a = self._eval(e.args[0])
        return CompVal(a.null.to(torch.int64), torch.zeros_like(a.null), e.ft)

    def _op_ifnull(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        av = self._coerce_result(a, e.ft).value
        bv = self._coerce_result(b, e.ft).value
        out, raw = self._sel(~a.null, a, b, av, bv)
        return CompVal(out, a.null & b.null, e.ft, raw=raw)

    def _op_if(self, e):
        c, a, b = (self._eval(x) for x in e.args)
        cond = self._truth(c) & ~c.null
        av = self._coerce_result(a, e.ft).value
        bv = self._coerce_result(b, e.ft).value
        out, raw = self._sel(cond, a, b, av, bv)
        null = torch.where(cond, a.null, b.null)
        return CompVal(out, null, e.ft, raw=raw)

    def _op_case(self, e):
        """case [when1, then1, when2, then2, ..., else?]."""
        args = e.args
        pairs = []
        i = 0
        while i + 1 < len(args):
            pairs.append((args[i], args[i + 1]))
            i += 2
        els = self._eval(args[i]) if i < len(args) else None
        if els is not None:
            out = self._coerce_result(els, e.ft).value
            null = els.null
        else:
            dt = torch.float64 if e.ft.eval_type() == "real" else torch.int64
            out = self._full(0, dt)
            null = self._bools(True)
        for cond_e, then_e in reversed(pairs):
            c = self._eval(cond_e)
            t = self._eval(then_e)
            hit = self._truth(c) & ~c.null
            tv = self._coerce_result(t, e.ft).value
            cond2 = hit[:, None] if tv.dim() == 2 else hit
            out = torch.where(cond2, tv, out)
            null = torch.where(hit, t.null, null)
        return CompVal(out, null, e.ft)

    def _op_coalesce(self, e):
        vals = [self._eval(a) for a in e.args]
        out = self._coerce_result(vals[-1], e.ft).value
        null = vals[-1].null
        for v in reversed(vals[:-1]):
            vv = self._coerce_result(v, e.ft).value
            cond = v.null[:, None] if vv.dim() == 2 else v.null
            out = torch.where(cond, out, vv)
            null = null & v.null
        return CompVal(out, null, e.ft)

    def _coerce_result(self, v: CompVal, ft: FieldType) -> CompVal:
        cls = ft.eval_type()
        if cls == "decimal":
            return self._to_class(v, "decimal", _scale(ft))
        if cls == "real":
            return self._to_class(v, "real")
        return v

    # -- cast ----------------------------------------------------------------
    def _op_cast(self, e):
        a = self._eval(e.args[0])
        src, dst = a.eval_type, e.ft.eval_type()
        if dst == "real":
            return CompVal(self._to_class(a, "real").value, a.null, e.ft)
        if dst == "decimal":
            return CompVal(self._to_class(a, "decimal", _scale(e.ft)).value, a.null, e.ft)
        if dst == "int":
            if src == "string":
                a = self._to_class(a, "real")
                src = "real"
            if src == "real":
                # round half to even, as jnp.round does
                return CompVal(_f64_to_i64(torch.round(a.value)), a.null, e.ft)
            if src == "decimal":
                return CompVal(_round_div(a.value, _pow10(_scale(a.ft))), a.null, e.ft)
            return CompVal(a.value, a.null, e.ft)
        if dst == "time" and src == "time":
            return CompVal(a.value, a.null, e.ft)
        if dst == "string" and src == "string":
            return CompVal(a.value, a.null, e.ft, raw=a.raw)
        raise NotImplementedError(f"cast {src} -> {dst} not on device")

    # -- math ----------------------------------------------------------------
    def _op_ceil(self, e):
        a = self._eval(e.args[0])
        if a.eval_type == "real":
            return CompVal(torch.ceil(a.value), a.null, e.ft)
        if a.eval_type == "decimal":
            p = _pow10(_scale(a.ft))
            q = torch.where(a.value >= 0, (a.value + p - 1) // p, -((-a.value) // p))
            return CompVal(q, a.null, e.ft)
        return CompVal(a.value, a.null, e.ft)

    def _op_floor(self, e):
        a = self._eval(e.args[0])
        if a.eval_type == "real":
            return CompVal(torch.floor(a.value), a.null, e.ft)
        if a.eval_type == "decimal":
            p = _pow10(_scale(a.ft))
            q = torch.where(a.value >= 0, a.value // p, -((-a.value + p - 1) // p))
            return CompVal(q, a.null, e.ft)
        return CompVal(a.value, a.null, e.ft)

    def _op_round(self, e):
        a = self._eval(e.args[0])
        nd = 0
        if len(e.args) > 1:
            c = e.args[1]
            if isinstance(c, Const) and not c.datum.is_null():
                nd = int(c.datum.val)
            else:
                raise NotImplementedError("round with non-constant digits")
        if a.eval_type == "real":
            p = float(10 ** nd)
            v = a.value * p
            out = div_exact(torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5)), p)
            return CompVal(out, a.null, e.ft)
        if a.eval_type == "decimal":
            tgt = min(max(nd, 0), _scale(a.ft))
            r = self._rescale_dec(a, tgt)
            return CompVal(self._rescale_dec(r, _scale(e.ft)).value, a.null, e.ft)
        if nd >= 0:
            return CompVal(a.value, a.null, e.ft)
        p = _pow10(-nd)
        return CompVal(_round_div(a.value, p) * p, a.null, e.ft)

    def _op_sqrt(self, e):
        a = self._to_class(self._eval(e.args[0]), "real")
        neg = a.value < 0
        out = torch.sqrt(torch.where(neg, 0.0, a.value))
        return CompVal(out, a.null | neg, e.ft)

    def _op_exp(self, e):
        a = self._to_class(self._eval(e.args[0]), "real")
        return CompVal(torch.exp(a.value), a.null, e.ft)

    def _op_ln(self, e):
        a = self._to_class(self._eval(e.args[0]), "real")
        bad = a.value <= 0
        return CompVal(torch.log(torch.where(bad, 1.0, a.value)), a.null | bad, e.ft)

    _op_log = _op_ln

    def _op_pow(self, e):
        a = self._to_class(self._eval(e.args[0]), "real")
        b = self._to_class(self._eval(e.args[1]), "real")
        return CompVal(torch.pow(a.value, b.value), a.null | b.null, e.ft)

    def _op_sign(self, e):
        a = self._eval(e.args[0])
        return CompVal(torch.sign(a.value).to(torch.int64), a.null, e.ft)

    # -- bit ops (int64 lanes) -----------------------------------------------
    def _bitop(self, e, fn):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        return CompVal(fn(a.value, b.value), a.null | b.null, e.ft)

    def _op_bitand(self, e):
        return self._bitop(e, lambda a, b: a & b)

    def _op_bitor(self, e):
        return self._bitop(e, lambda a, b: a | b)

    def _op_bitxor(self, e):
        return self._bitop(e, lambda a, b: a ^ b)

    def _op_bitneg(self, e):
        a = self._eval(e.args[0])
        return CompVal(~a.value, a.null, e.ft)

    def _op_shiftleft(self, e):
        return self._bitop(e, lambda a, b: torch.where((b >= 64) | (b < 0), 0, a << torch.clamp(b, 0, 63)))

    def _op_shiftright(self, e):
        """Logical (unsigned) shift, as MySQL >> on BIGINT UNSIGNED. torch
        has no >> for uint64, so: an arithmetic shift masked to the low
        64 - b bits (b == 0 passes a through), 0 for b outside [0, 64)."""

        def lsr(a, b):
            bc = torch.clamp(b, 0, 63)
            mask = torch.where(bc == 0, -1, (torch.ones_like(bc) << (64 - bc)) - 1)
            return torch.where((b >= 64) | (b < 0), 0, (a >> bc) & mask)

        return self._bitop(e, lsr)

    # -- string --------------------------------------------------------------
    def _op_length(self, e):
        a = self._eval(e.args[0])
        if a.raw is None:
            raise NotImplementedError("length() needs raw string column")
        return CompVal(a.raw[1].to(torch.int64), a.null, e.ft)

    def _op_strcmp(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])
        av, bv = a.value, b.value
        if a.ft.is_ci() or b.ft.is_ci():
            _ci_ascii_guard(a, b)
            av, bv = fold_words_ci(av), fold_words_ci(bv)
        return CompVal(_words_cmp(av, bv).to(torch.int64), a.null | b.null, e.ft)

    def _op_like(self, e):
        """LIKE with a constant exact or 'prefix%' pattern; every other
        pattern raises (the oracle answers), as in the JAX package."""
        a = self._eval(e.args[0])
        pat = e.args[1]
        if not isinstance(pat, Const):
            raise NotImplementedError("LIKE with non-constant pattern")
        p = pat.datum.val
        p = p if isinstance(p, str) else p.decode()
        if a.raw is None:
            raise NotImplementedError("LIKE needs raw string column")
        data, length = a.raw
        if a.ft.is_ci() or pat.ft.is_ci():
            # general_ci LIKE: ASCII fold on BOTH sides (matching the
            # compare / sort-key fold); a non-ASCII pattern goes to the oracle
            if any(ord(c) >= 0x80 for c in p):
                raise NotImplementedError("non-ASCII CI LIKE pattern (oracle)")
            hit = (data >= 0x61) & (data <= 0x7A)
            data = torch.where(hit, data - 0x20, data)
            p = _ascii_upper(p)
        if p.endswith("%") and "%" not in p[:-1] and "_" not in p:
            out = self._prefix_match(data, length, p[:-1].encode())
        elif "%" not in p and "_" not in p:
            exact = p.encode()
            out = self._prefix_match(data, length, exact) & (length == len(exact))
        else:
            raise NotImplementedError(f"LIKE pattern {p!r} not on device yet")
        return CompVal(out.to(torch.int64), a.null, e.ft)

    @staticmethod
    def _prefix_match(data, length, prefix: bytes):
        k = len(prefix)
        if k == 0:
            return torch.ones_like(length, dtype=torch.bool)
        if k > data.shape[1]:
            return torch.zeros_like(length, dtype=torch.bool)
        pref = device_bytes(prefix, data.device)
        eq = (data[:, :k] == pref[None, :]).all(dim=1)
        return eq & (length >= k)

    def _op_substr(self, e):
        """SUBSTR(s, pos[, len]) — per-row byte shift via gather."""
        a = self._eval(e.args[0])
        data, length = string_bytes(a)
        pos_cv = self._eval(e.args[1])
        pos = pos_cv.value.to(torch.int32)
        null = a.null | pos_cv.null
        # MySQL: 1-based; negative counts from the end; 0 -> ''
        start = torch.where(pos > 0, pos - 1, length + pos)
        bad = (pos == 0) | (start < 0)
        start = torch.minimum(torch.clamp(start, min=0), length)
        avail = torch.clamp(length - start, min=0)
        if len(e.args) > 2:
            want_cv = self._eval(e.args[2])
            null = null | want_cv.null
            new_len = torch.minimum(torch.clamp(want_cv.value.to(torch.int32), min=0), avail)
        else:
            new_len = avail
        new_len = torch.where(bad, 0, new_len)
        w = data.shape[1]
        pos_w = torch.arange(w, device=data.device)[None, :]
        idx = torch.clamp(pos_w + start[:, None], 0, w - 1)
        shifted = torch.gather(data, 1, idx)
        shifted = torch.where(pos_w < new_len[:, None], shifted, 0)
        return self._string_result(shifted, new_len, null, e.ft)

    @staticmethod
    def _string_result(data, length, null, ft):
        return CompVal(pack_string_words(data, length), null, ft, raw=(data, length))

    def _op_upper(self, e):
        return self._case_fold(e, upper=True)

    def _op_lower(self, e):
        return self._case_fold(e, upper=False)

    def _case_fold(self, e, upper: bool):
        a = self._eval(e.args[0])
        data, length = string_bytes(a)
        if upper:
            hit = (data >= 0x61) & (data <= 0x7A)
            out = torch.where(hit, data - 0x20, data)
        else:
            hit = (data >= 0x41) & (data <= 0x5A)
            out = torch.where(hit, data + 0x20, data)
        return self._string_result(out, length, a.null, e.ft)

    def _op_concat(self, e):
        """CONCAT(...) — pairwise fold; NULL if any arg NULL (MySQL)."""
        args = [self._as_string(self._eval(x)) for x in e.args]
        out = args[0]
        for b in args[1:]:
            out = self._concat2(out, b)
        d, ln = out.raw
        return self._string_result(d, ln, out.null, e.ft)

    @staticmethod
    def _as_string(a: CompVal) -> CompVal:
        if a.value.dim() == 2:
            return CompVal(a.value, a.null, a.ft, raw=string_bytes(a))
        raise NotImplementedError("concat of non-string operands on device (cast first)")

    @staticmethod
    def _concat2(a: CompVal, b: CompVal) -> CompVal:
        """a's bytes then b's: a width of wa + wb, b's bytes gathered to
        start at a's length, everything past the new length zeroed."""
        da, la = a.raw
        db, lb = b.raw
        wa, wb = da.shape[1], db.shape[1]
        w = wa + wb
        pos = torch.arange(w, device=da.device)[None, :]
        a_pad = torch.nn.functional.pad(da, (0, w - wa))
        b_pad = torch.nn.functional.pad(db, (0, w - wb))
        b_shift = torch.gather(b_pad, 1, torch.clamp(pos - la[:, None], 0, w - 1))
        out = torch.where(pos < la[:, None], a_pad, b_shift)
        ln = la + lb
        out = torch.where(pos < ln[:, None], out, 0)
        return CompVal(a.value, a.null | b.null, a.ft, raw=(out, ln.to(torch.int32)))

    def _op_trim(self, e):
        return self._trim(e, left=True, right=True)

    def _op_ltrim(self, e):
        return self._trim(e, left=True, right=False)

    def _op_rtrim(self, e):
        return self._trim(e, left=False, right=True)

    def _trim(self, e, left: bool, right: bool):
        a = self._eval(e.args[0])
        data, length = string_bytes(a)
        w = data.shape[1]
        pos = torch.arange(w, device=data.device)[None, :]
        in_str = pos < length[:, None]
        is_sp = (data == 0x20) & in_str
        lead = torch.zeros_like(length)
        if left:
            # leading spaces: cumulative product of the space mask
            run = torch.cumprod(torch.where(in_str, is_sp, True).to(torch.int32), dim=1)
            lead = torch.minimum((run * in_str.to(torch.int32)).sum(dim=1), length)
        trail = torch.zeros_like(length)
        if right:
            # walk from the end: src index for the k-th-from-last byte
            src = length[:, None] - 1 - pos
            rev_bytes = torch.gather(data, 1, torch.clamp(src, 0, w - 1))
            is_sp_end = (src >= 0) & (rev_bytes == 0x20)
            run_t = torch.cumprod(is_sp_end.to(torch.int32), dim=1)
            trail = torch.minimum(run_t.sum(dim=1), length)
        new_len = torch.clamp(length - lead - trail, min=0)
        shifted = torch.gather(data, 1, torch.clamp(pos + lead[:, None], 0, w - 1))
        shifted = torch.where(pos < new_len[:, None], shifted, 0)
        return self._string_result(shifted, new_len.to(torch.int32), a.null, e.ft)

    def _op_replace(self, e):
        raise NotImplementedError("replace() is host-only (data-dependent lengths); planner keeps it at root")

    # -- date arithmetic (vectorized civil-calendar math) ---------------------
    def _op_date_add(self, e):
        return self._date_shift(e, +1)

    def _op_date_sub(self, e):
        return self._date_shift(e, -1)

    def _date_shift(self, e, sign: int):
        """packed datetime +/- INTERVAL n unit (semantics types/mytime.py
        datetime_add — Hinnant civil-from-days, month-end clamping)."""
        d = self._eval(e.args[0])
        n = self._eval(e.args[1])
        unit = e.args[2].datum.val  # const string (planner contract)
        p = d.value
        micro = p & 0xFFFFFF
        rest = p >> 24
        hms = rest & ((1 << 17) - 1)
        ymd = rest >> 17
        day = ymd & 31
        ym = ymd >> 5
        y, m = ym // 13, ym % 13
        sec, minute, hour = hms & 63, (hms >> 6) & 63, hms >> 12
        nn = sign * n.value.to(torch.int64)
        if unit in _UNIT_SECONDS:
            total = days_from_civil(y, m, day) * 86400 + hour * 3600 + minute * 60 + sec + nn * _UNIT_SECONDS[unit]
            days, secs = total // 86400, total % 86400
            y, m, day = civil_from_days(days)
            hour, minute, sec = secs // 3600, (secs // 60) % 60, secs % 60
        elif unit in ("month", "quarter", "year"):
            months = nn * {"month": 1, "quarter": 3, "year": 12}[unit]
            y, m, day = add_months(y, m, day, months)
        else:
            raise NotImplementedError(f"interval unit {unit!r}")
        packed = (((y * 13 + m) << 5 | day) << 17 | (hour << 12 | minute << 6 | sec)) << 24 | micro
        return CompVal(packed, d.null | n.null, e.ft)

    def _op_datediff(self, e):
        a, b = self._eval(e.args[0]), self._eval(e.args[1])

        def days_of(v):
            ymd = v.value >> 41
            ym = ymd >> 5
            return days_from_civil(ym // 13, ym % 13, ymd & 31)

        return CompVal(days_of(a) - days_of(b), a.null | b.null, e.ft)

    # -- time extraction (packed layout, types/mytime.py) ---------------------
    @staticmethod
    def _ymd(a: CompVal):
        """(ymd, ym) fields of packed datetime lanes."""
        ymd = a.value >> 41
        return ymd, ymd >> 5

    @staticmethod
    def _hms(a: CompVal):
        return (a.value >> 24) & ((1 << 17) - 1)

    def _op_year(self, e):
        a = self._eval(e.args[0])
        return CompVal(self._ymd(a)[1] // 13, a.null, e.ft)

    def _op_month(self, e):
        a = self._eval(e.args[0])
        return CompVal(self._ymd(a)[1] % 13, a.null, e.ft)

    def _op_day(self, e):
        a = self._eval(e.args[0])
        return CompVal(self._ymd(a)[0] & 31, a.null, e.ft)

    def _op_hour(self, e):
        a = self._eval(e.args[0])
        return CompVal(self._hms(a) >> 12, a.null, e.ft)

    def _op_minute(self, e):
        a = self._eval(e.args[0])
        return CompVal((self._hms(a) >> 6) & 63, a.null, e.ft)

    def _op_second(self, e):
        a = self._eval(e.args[0])
        return CompVal(self._hms(a) & 63, a.null, e.ft)

    def _op_to_days(self, e):
        """Days since year 0 (MySQL TO_DAYS, calcDaynr), with the
        reference's float step (0.4 * m + 2.3) truncated to int64."""
        a = self._eval(e.args[0])
        ymd, ym = self._ymd(a)
        y, m, d = ym // 13, ym % 13, ymd & 31
        early = m <= 2
        delsum = 365 * y + 31 * (m - 1) + d
        adj = torch.where(early, 0, (0.4 * m.to(torch.float64) + 2.3).to(torch.int64))
        delsum = torch.where(early, delsum, delsum - adj)
        yy = torch.where(early, y - 1, y)
        return CompVal(delsum + yy // 4 - yy // 100 + yy // 400, a.null, e.ft)

    def _op_weekday(self, e):
        a = self._eval(e.args[0])
        days = self._op_to_days(ScalarFunc("to_days", (e.args[0],), e.ft))
        return CompVal((days.value + 5) % 7, a.null, e.ft)

    def _op_extract(self, e):
        unit = e.args[0]
        if not isinstance(unit, Const):
            raise NotImplementedError("EXTRACT with a non-constant unit")
        return self._eval(ScalarFunc(str(unit.datum.val).lower(), (e.args[1],), e.ft))


@dataclass
class CompiledExpr:
    """A projection over an input schema: fn(cols) -> [(value, null)]."""

    fn: Callable
    out_fts: list[FieldType]


def compile_exprs(input_fts: list[FieldType], exprs: list[Expr], device="cuda") -> CompiledExpr:
    """`exprs` as one eager projection over device columns of `input_fts`
    (the JAX package jit-compiles the same closure). `device` is where
    constants are built when there are no input columns; "cuda" raises
    without a card."""
    comp = ExprCompiler(input_fts, device=resolve_device(device))

    def run(cols):
        return [(v.value, v.null) for v in comp.run(exprs, cols)]

    return CompiledExpr(run, [e.ft for e in exprs])
