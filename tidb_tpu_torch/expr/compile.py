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

Ported ops: column, const, arithmetic (plus minus mul div intdiv mod
unaryminus abs), comparison (eq ne lt le gt ge nulleq in between), logic and
control (and or not xor isnull ifnull if case coalesce) and cast. String,
date and math functions raise NotImplementedError through the dispatch, as
every unknown op does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..chunk.device import DeviceColumn, pack_string_words
from ..types import FieldType, MyDecimal, MyTime, TypeCode
from .ir import ColumnRef, Const, Expr, ScalarFunc

I64_MIN = -0x8000000000000000


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


def _round_div(num: torch.Tensor, den) -> torch.Tensor:
    """Integer divide rounding half away from zero (MySQL decimal/int rules).
    Operands are made non-negative first, so torch's flooring `//` equals
    truncation here; the sign is applied afterwards."""
    den = torch.as_tensor(den, dtype=torch.int64, device=num.device)
    neg = (num < 0) ^ (den < 0)
    n, d = torch.abs(num), torch.abs(den)
    q = (2 * n + d) // (2 * d)
    return torch.where(neg, -q, q)


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
                data[0, : len(b)] = torch.tensor(list(b), dtype=torch.uint8, device=self._dev)
            ln = torch.tensor([len(b)], dtype=torch.int32, device=self._dev)
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
        if et == "string" and cls in ("real", "decimal"):
            # MySQL parses the numeric prefix (StrToFloat) — a string op
            raise NotImplementedError("string -> number conversion not on device")
        if cls == "real":
            if et == "real":
                return v
            if et == "decimal":
                return CompVal(v.value.to(torch.float64) / float(10 ** _scale(v.ft)), v.null, FieldType(TypeCode.Double))
            if v.ft.is_unsigned():
                # uint64 bit-pattern -> f64 without sign error
                val = v.value
                f = val.to(torch.float64)
                return CompVal(torch.where(val >= 0, f, f + 2.0 ** 64), v.null, FieldType(TypeCode.Double))
            return CompVal(v.value.to(torch.float64), v.null, FieldType(TypeCode.Double))
        if cls == "decimal":
            s = _scale(v.ft) if scale is None else scale
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
                scaled = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(torch.int64)
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
            return CompVal(torch.trunc(q).to(torch.int64), null, e.ft)
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
            if src == "real":
                # round half to even, as jnp.round does
                return CompVal(torch.round(a.value).to(torch.int64), a.null, e.ft)
            if src == "decimal":
                return CompVal(_round_div(a.value, _pow10(_scale(a.ft))), a.null, e.ft)
            return CompVal(a.value, a.null, e.ft)
        if dst == "time" and src == "time":
            return CompVal(a.value, a.null, e.ft)
        if dst == "string" and src == "string":
            return CompVal(a.value, a.null, e.ft, raw=a.raw)
        raise NotImplementedError(f"cast {src} -> {dst} not on device")
