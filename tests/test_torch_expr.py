"""The port's expression compiler (tidb_tpu_torch.expr.compile) against the
JAX package's ExprCompiler on the same rows: arithmetic with decimal
scales and DIV_FRAC_INCR, signed/unsigned, datetime and string compares
(binary and general_ci), 3VL logic, control flow and casts; the math, bit,
string and date families; string -> real / decimal / int; string
truthiness in WHERE (ops/selection.py apply_selection). Values are
compared where the result is not NULL; NULL masks everywhere; string
results also by their bytes within their lengths.

Tolerance: exact (bit for bit) everywhere but exp, ln, log, pow and sqrt:
within ULP_TOL = 2 units in the last place. XLA's and torch's libm results
for exp, ln, log and pow need not agree to the last bit; sqrt is correctly
rounded in XLA-CPU and on a CUDA device, but torch's CPU sqrt is not (it
is 1 ulp from numpy's np.sqrt in 0.7 % of random lanes), so sqrt takes the
same bound here; chip_smoke.py holds the card's sqrt bit for bit against
np.sqrt. The cases the JAX package refuses raise in the port too,
with the same exception type (test_refused_in_both)."""

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.chunk.device as JD
import tidb_tpu.expr as JX
import tidb_tpu.types as JT

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.chunk.device as TD
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT

N = 48


ULP_TOL = 2
NUMERIC_STRINGS = ["12.5abc", "  -3e2", ".5", "-0", "1e-3x", "abc", "", "+7", "3.", "e5", "1.5e",
                   "12e+2z", "  ", "0.1", "-.25", "7e-1", "1.25E2", "99", "- 5", "0x1A"]
EXTREME_STRINGS = ["1e400", "-1e400", "9999999999999999999", "1e-400", "123456789012345678901234",
                   "4.9e-324", "0.000000000000000000000000000001", "1.7976931348623157e308"]
PADDED_STRINGS = ["  padded  ", "  x", "hello world ", "", "   ", "Mixed Case", "ab", "a b c  ", "zz ", " 1"]
MONTH_ENDS = [(2020, 1, 31, 23, 59, 59), (2019, 3, 31, 0, 0, 0), (2020, 2, 29, 12, 0, 0), (2021, 12, 31, 12, 30, 45),
              (2019, 8, 31, 0, 0, 1), (2000, 5, 31, 6, 7, 8), (1999, 10, 31, 1, 2, 3), (2024, 1, 30, 0, 0, 0)]


def _schema(T):
    ci = T.new_varchar(8, collate=T.Collation.Utf8MB4GeneralCI)
    return [
        T.new_longlong(),                 # 0 a
        T.new_longlong(),                 # 1 b
        T.new_longlong(unsigned=True),    # 2 u
        T.new_decimal(10, 2),             # 3 d2
        T.new_decimal(12, 4),             # 4 d4
        T.new_double(),                   # 5 r
        T.new_datetime(),                 # 6 t
        T.new_varchar(8),                 # 7 s
        ci,                               # 8 c
        T.new_longlong(),                 # 9 flag (0/1/NULL)
        T.new_varchar(16),                # 10 ns: numeric-prefix strings
        T.new_varchar(16),                # 11 ps: strings with spaces
        T.new_double(),                   # 12 pr: reals around 1 (some <= 0)
        T.new_longlong(),                 # 13 sh: shift counts 0 / 63 / 64 / -1 ...
        T.new_datetime(),                 # 14 me: month ends with times
        T.new_longlong(),                 # 15 pos: substr positions (< 0, 0, NULL)
        T.new_longlong(),                 # 16 big: int64 extremes for bit ops
        T.new_decimal(10, 2),             # 17 nd: negative decimals
        T.new_varchar(40),                # 18 xs: out-of-range numeric strings
    ]


def _rows(T):
    rng = np.random.default_rng(11)
    D = T.Datum
    words = ["", "a", "A", "ab", "Ab", "b", "abc", "zz"]
    def pick(options):
        return options[int(rng.integers(len(options)))]

    rows = []
    for i in range(N):
        def maybe(d, p=0.15):
            return D.NULL if rng.random() < p else d

        rows.append([
            maybe(D.i64(int(rng.integers(-20, 20)))),
            maybe(D.i64(pick([0, -3, 3, 7, -7, 2]))),
            maybe(D.u64(pick([0, 1, 5, 2 ** 63 + 5, 2 ** 64 - 1]))),
            maybe(D.dec(T.MyDecimal(f"{rng.integers(-5000, 5000) / 100:.2f}"))),
            maybe(D.dec(T.MyDecimal(f"{pick([0, 1, -3, 12345]) / 10000:.4f}"))),
            maybe(D.f64(pick([0.0, 1.5, -2.25, 3.0, 1e-3]))),
            maybe(D.time(T.MyTime.from_ymd(int(rng.integers(1993, 1999)), int(rng.integers(1, 13)),
                                           int(rng.integers(1, 29)), int(rng.integers(0, 24))))),
            maybe(D.string(words[int(rng.integers(len(words)))])),
            maybe(D.string(words[int(rng.integers(len(words)))])),
            maybe(D.i64(int(rng.integers(0, 2))), p=0.3),
        ])
    # the later families' columns draw from their own generator, so the
    # first ten columns keep their values
    rng = np.random.default_rng(12)
    for row in rows:
        def maybe(d, p=0.1):
            return D.NULL if rng.random() < p else d

        row.extend([
            maybe(D.string(pick_from(rng, NUMERIC_STRINGS))),
            maybe(D.string(pick_from(rng, PADDED_STRINGS))),
            maybe(D.f64(pick_from(rng, [0.5, 1.0, 2.0, 3.25, 10.0, 1e-3, 0.0, -1.5, 7.77, 100.0, 2.5, 0.1]))),
            maybe(D.i64(pick_from(rng, [0, 1, 3, 63, 64, -1, 65, 62]))),
            maybe(D.time(T.MyTime.from_ymd(*pick_from(rng, MONTH_ENDS)))),
            maybe(D.i64(pick_from(rng, [-3, -1, 0, 1, 2, 5, 9, -9, 11]))),
            maybe(D.i64(pick_from(rng, [-1, 2 ** 62, -2 ** 63, 2 ** 63 - 1, 12345, 0, 255, -256]))),
            maybe(D.dec(T.MyDecimal(f"{-int(rng.integers(1, 10000)) / 100:.2f}"))),
            maybe(D.string(pick_from(rng, EXTREME_STRINGS + NUMERIC_STRINGS[:4]))),
        ])
    return rows


def pick_from(rng, options):
    return options[int(rng.integers(len(options)))]


def _exprs(X, T):
    """name -> Expr over _schema(T), built the same way for both packages."""
    fts = _schema(T)
    C = lambda i: X.col(i, fts[i])  # noqa: E731
    f, lit = X.func, X.lit
    B = T.new_longlong(notnull=True)
    LL, DBL = T.new_longlong(), T.new_double()
    dec = T.new_decimal
    DT = T.new_datetime()
    UB = T.new_longlong(unsigned=True)
    VC = T.new_varchar
    CI = T.new_varchar(8, collate=T.Collation.Utf8MB4GeneralCI)
    return {
        # arithmetic: int, decimal scales, real, mixed
        "plus_int": f("plus", LL, C(0), C(1)),
        "minus_dec_mixed_scale": f("minus", dec(14, 4), C(3), C(4)),
        "plus_dec_int": f("plus", dec(13, 2), C(3), C(0)),
        "mul_dec": f("mul", dec(22, 6), C(3), C(4)),
        "mul_dec_rescaled": f("mul", dec(22, 2), C(3), C(4)),
        "mul_int_real": f("mul", DBL, C(0), C(5)),
        "div_int_frac_incr": f("div", dec(20, 4), C(0), C(1)),
        "div_dec_frac_incr": f("div", dec(20, 6), C(3), C(1)),
        "div_dec_dec": f("div", dec(20, 8), C(3), C(4)),
        "div_real_by_zero": f("div", DBL, C(5), C(1)),
        "intdiv_int": f("intdiv", LL, C(0), C(1)),
        "intdiv_dec": f("intdiv", LL, C(3), C(4)),
        "intdiv_real": f("intdiv", LL, C(5), C(1)),
        "mod_int": f("mod", LL, C(0), C(1)),
        "mod_dec": f("mod", dec(12, 4), C(3), C(4)),
        "mod_real": f("mod", DBL, C(5), C(1)),
        "unaryminus_dec": f("unaryminus", dec(10, 2), C(3)),
        "abs_int": f("abs", LL, C(0)),
        # comparisons
        "lt_int": f("lt", B, C(0), C(1)),
        "ge_dec_scales": f("ge", B, C(3), C(4)),
        "eq_dec_int": f("eq", B, C(3), C(0)),
        "gt_real_int": f("gt", B, C(5), C(0)),
        "lt_unsigned": f("lt", B, C(2), lit(6, T.new_longlong(unsigned=True))),
        "le_unsigned_signed": f("le", B, C(2), C(0)),
        "gt_signed_unsigned": f("gt", B, C(0), C(2)),
        "le_datetime": f("le", B, C(6), lit("1996-06-15 12:00:00", DT)),
        "between_datetime": f("between", B, C(6), lit("1994-01-01", DT), lit("1995-01-01", DT)),
        "eq_string": f("eq", B, C(7), lit("ab", T.new_varchar(8))),
        "lt_string_cols": f("lt", B, C(7), C(8)),
        "eq_ci_string": f("eq", B, C(8), lit("AB", T.new_varchar(8, collate=T.Collation.Utf8MB4GeneralCI))),
        "ne_int": f("ne", B, C(0), C(1)),
        "nulleq_int": f("nulleq", B, C(0), C(1)),
        "in_with_null": f("in", B, C(0), lit(1, LL), lit(None, LL), lit(-3, LL)),
        "in_string": f("in", B, C(7), lit("a", T.new_varchar(8)), lit("zz", T.new_varchar(8))),
        "between_dec": f("between", B, C(3), lit("-10.00", dec(4, 2)), lit("10.00", dec(4, 2))),
        # 3VL logic
        "and_3vl": f("and", B, C(9), f("gt", B, C(0), lit(0, LL))),
        "or_3vl": f("or", B, C(9), f("gt", B, C(0), lit(0, LL))),
        "not_3vl": f("not", B, C(9)),
        "xor_3vl": f("xor", B, C(9), f("lt", B, C(1), lit(0, LL))),
        "and_real": f("and", B, C(5), C(9)),
        # null handling / control
        "isnull": f("isnull", B, C(3)),
        "ifnull_dec": f("ifnull", dec(12, 4), C(3), C(4)),
        "ifnull_string": f("ifnull", T.new_varchar(8), C(7), lit("x", T.new_varchar(8))),
        "if_int_real": f("if", DBL, C(9), C(0), C(5)),
        "if_string": f("if", T.new_varchar(8), C(9), C(7), C(8)),
        "case_dec": f("case", dec(12, 4), f("gt", B, C(0), lit(0, LL)), C(3),
                      f("lt", B, C(0), lit(-5, LL)), C(4), lit("1.5", dec(2, 1))),
        "case_no_else": f("case", LL, C(9), C(0)),
        "coalesce_int": f("coalesce", LL, C(0), C(1), lit(99, LL)),
        # casts
        "cast_dec_to_int": f("cast", LL, C(3)),
        "cast_real_to_int": f("cast", LL, C(5)),
        "cast_int_to_dec": f("cast", dec(10, 2), C(0)),
        "cast_dec_down_scale": f("cast", dec(10, 1), C(4)),
        "cast_real_to_dec": f("cast", dec(10, 2), C(5)),
        "cast_int_to_real": f("cast", DBL, C(2)),
        "cast_dec_to_real": f("cast", DBL, C(3)),
        "cast_string_to_string": f("cast", T.new_varchar(8), C(7)),
        # string -> number: the numeric-prefix parse
        "cast_string_to_double": f("cast", DBL, C(10)),
        "cast_extreme_string_to_double": f("cast", DBL, C(18)),
        "cast_string_to_decimal": f("cast", dec(20, 3), C(10)),
        "cast_string_to_int": f("cast", LL, C(10)),
        # out of int64's range: XLA saturates and turns NaN into 0
        "cast_extreme_string_to_int": f("cast", LL, C(18)),
        "cast_extreme_string_to_decimal": f("cast", dec(20, 3), C(18)),
        "intdiv_real_out_of_range": f("intdiv", LL, f("cast", DBL, C(18)), lit(1e-300, DBL)),
        "plus_string_real": f("plus", DBL, C(10), C(5)),
        "mul_string_decimal": f("mul", dec(24, 4), C(10), C(3)),
        # math
        "ceil_real": f("ceil", DBL, C(12)),
        "ceil_dec_negative": f("ceil", dec(10, 0), C(17)),
        "ceil_dec_mixed_sign": f("ceil", dec(10, 0), C(3)),
        "ceil_int": f("ceil", LL, C(0)),
        "floor_real": f("floor", DBL, C(5)),
        "floor_dec_negative": f("floor", dec(10, 0), C(17)),
        "floor_dec4": f("floor", dec(12, 0), C(4)),
        "round_real": f("round", DBL, C(12)),
        "round_real_digits": f("round", DBL, C(12), lit(1, LL)),
        "round_real_negative_digits": f("round", DBL, f("mul", DBL, C(12), lit(1234.5, DBL)), lit(-2, LL)),
        "round_dec": f("round", dec(10, 0), C(17)),
        "round_dec_digits": f("round", dec(12, 4), C(4), lit(2, LL)),
        "round_int_negative_digits": f("round", LL, C(0), lit(-1, LL)),
        "sqrt_real": f("sqrt", DBL, C(12)),
        "sqrt_dec": f("sqrt", DBL, C(3)),
        "exp_real": f("exp", DBL, C(12)),
        "exp_dec": f("exp", DBL, f("div", dec(20, 6), C(3), lit(10, LL))),
        "ln_real": f("ln", DBL, C(12)),
        "ln_int": f("ln", DBL, C(0)),
        "log_dec": f("log", DBL, C(3)),
        "pow_real": f("pow", DBL, C(12), lit(2.5, DBL)),
        "pow_int_int": f("pow", DBL, C(0), C(1)),
        "sign_dec": f("sign", LL, C(3)),
        "sign_real": f("sign", LL, C(12)),
        "sign_int": f("sign", LL, C(0)),
        # bit
        "bitand": f("bitand", UB, C(16), C(0)),
        "bitor": f("bitor", UB, C(16), C(1)),
        "bitxor": f("bitxor", UB, C(16), C(2)),
        "bitneg": f("bitneg", UB, C(16)),
        "shiftleft": f("shiftleft", UB, C(16), C(13)),
        "shiftleft_one": f("shiftleft", UB, lit(1, LL), C(13)),
        "shiftright": f("shiftright", UB, C(16), C(13)),
        "shiftright_unsigned": f("shiftright", UB, C(2), C(13)),
        # string
        "length": f("length", LL, C(11)),
        "length_of_concat": f("length", LL, f("concat", VC(32), C(11), C(7))),
        "strcmp": f("strcmp", LL, C(7), lit("ab", VC(8))),
        "strcmp_cols": f("strcmp", LL, C(7), C(11)),
        "strcmp_ci": f("strcmp", LL, C(8), lit("AB", CI)),
        "like_prefix": f("like", B, C(7), lit("a%", VC(4))),
        "like_exact": f("like", B, C(7), lit("ab", VC(4))),
        "like_match_all": f("like", B, C(11), lit("%", VC(4))),
        "like_ci_prefix": f("like", B, C(8), lit("a%", VC(4))),
        "like_ci_exact": f("like", B, C(8), lit("AB", VC(4))),
        "substr_column_pos": f("substr", VC(16), C(11), C(15)),
        "substr_pos_len": f("substr", VC(16), C(11), lit(2, LL), lit(3, LL)),
        "substr_negative_pos": f("substr", VC(16), C(11), lit(-3, LL)),
        "substr_zero_pos": f("substr", VC(16), C(11), lit(0, LL)),
        "substr_null_pos": f("substr", VC(16), C(11), lit(None, LL)),
        "substr_column_len": f("substr", VC(16), C(11), lit(1, LL), C(15)),
        "upper": f("upper", VC(16), C(11)),
        "lower": f("lower", VC(8), C(7)),
        "upper_without_raw": f("upper", VC(8), f("case", VC(8), C(9), C(7), C(8))),
        "concat": f("concat", VC(40), C(11), lit("-", VC(1)), C(7)),
        "concat_constants": f("concat", VC(8), lit("ab", VC(2)), lit("", VC(1)), lit("c", VC(1))),
        "trim": f("trim", VC(16), C(11)),
        "ltrim": f("ltrim", VC(16), C(11)),
        "rtrim": f("rtrim", VC(16), C(11)),
        "trim_of_concat": f("trim", VC(24), f("concat", VC(24), lit("  ", VC(2)), C(7), lit(" ", VC(1)))),
        # dates
        "year": f("year", LL, C(6)),
        "month": f("month", LL, C(14)),
        "day": f("day", LL, C(14)),
        "hour": f("hour", LL, C(14)),
        "minute": f("minute", LL, C(14)),
        "second": f("second", LL, C(14)),
        "to_days": f("to_days", LL, C(14)),
        "weekday": f("weekday", LL, C(6)),
        "datediff": f("datediff", LL, C(14), C(6)),
        "extract_year": f("extract", LL, lit("YEAR", VC(8)), C(6)),
        "extract_minute": f("extract", LL, lit("minute", VC(8)), C(14)),
        "date_add_month_end_clamp": f("date_add", DT, C(14), lit(1, LL), lit("month", VC(8))),
        "date_add_quarter": f("date_add", DT, C(14), lit(5, LL), lit("quarter", VC(8))),
        "date_add_year_leap": f("date_add", DT, C(14), lit(1, LL), lit("year", VC(8))),
        "date_add_day_column": f("date_add", DT, C(6), C(0), lit("day", VC(8))),
        "date_add_week": f("date_add", DT, C(14), lit(3, LL), lit("week", VC(8))),
        "date_add_hour": f("date_add", DT, C(14), lit(30, LL), lit("hour", VC(8))),
        "date_add_minute": f("date_add", DT, C(14), lit(-61, LL), lit("minute", VC(8))),
        "date_add_second": f("date_add", DT, C(14), lit(1, LL), lit("second", VC(8))),
        "date_sub_month": f("date_sub", DT, C(14), lit(13, LL), lit("month", VC(8))),
        "date_sub_day": f("date_sub", DT, C(14), lit(60, LL), lit("day", VC(8))),
    }


@pytest.fixture(scope="module")
def both():
    jfts, tfts = _schema(JT), _schema(TT)
    jb = JD.to_device_batch(JC.Chunk.from_rows(jfts, _rows(JT)))
    tb = TD.to_device_batch(TC.Chunk.from_rows(tfts, _rows(TT)), device="cpu")
    return jfts, jb, tfts, tb


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between float64 lanes (0 where both are the
    same NaN or the same infinity)."""
    ia = a.view(np.int64).astype(object)
    ib = b.view(np.int64).astype(object)
    # map the sign-magnitude bit patterns onto one monotone integer line
    lin = lambda i: i if i >= 0 else -(i & 0x7FFFFFFFFFFFFFFF)  # noqa: E731
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return np.array([0 if s else abs(lin(x) - lin(y)) for x, y, s in zip(ia, ib, same)], dtype=object)


def _ulp_op(name: str) -> bool:
    return name.split("_")[0] in ("exp", "ln", "log", "pow", "sqrt")


@pytest.mark.parametrize("name", sorted(_exprs(JX, JT)))
def test_op_matches_jax(name, both):
    jfts, jb, tfts, tb = both
    je = _exprs(JX, JT)[name]
    te = _exprs(TX, TT)[name]
    (jv,) = JX.ExprCompiler(jfts).run([je], jb.cols)
    (tv,) = TX.ExprCompiler(tfts, device="cpu").run([te], tb.cols)
    jnull = np.asarray(jv.null)
    assert np.array_equal(tv.null.numpy(), jnull)
    jval, tval = np.asarray(jv.value), tv.value.numpy()
    assert tval.dtype == jval.dtype and tval.shape == jval.shape
    keep = ~jnull
    if _ulp_op(name):
        ulps = _ulps(tval[keep], jval[keep])
        assert all(u <= ULP_TOL for u in ulps), (name, max(ulps, default=0), tval[keep], jval[keep])
    else:
        assert np.array_equal(tval[keep], jval[keep]), (tval[keep], jval[keep])
    if jv.raw is not None:
        assert tv.raw is not None
        ln = np.asarray(jv.raw[1])
        assert np.array_equal(tv.raw[1].numpy()[keep], ln[keep])
        jd, td = np.asarray(jv.raw[0]), tv.raw[0].numpy()
        for r in np.nonzero(keep)[0]:
            assert bytes(td[r, : ln[r]]) == bytes(jd[r, : ln[r]]), (r, bytes(td[r]), bytes(jd[r]))


@pytest.mark.parametrize("column", [7, 10, 11, 18])
def test_string_truthiness_in_where_matches_jax(column, both):
    """A bare string condition: true when its numeric prefix is non-zero."""
    from tidb_tpu.ops.selection import apply_selection as japply

    from tidb_tpu_torch.ops.selection import apply_selection as tapply

    jfts, jb, tfts, tb = both
    (jv,) = JX.ExprCompiler(jfts).run([JX.col(column, jfts[column])], jb.cols)
    (tv,) = TX.ExprCompiler(tfts, device="cpu").run([TX.col(column, tfts[column])], tb.cols)
    want = np.asarray(japply(jb.row_valid, [jv]))
    got = tapply(tb.row_valid, [tv]).numpy()
    assert np.array_equal(got, want)
    assert 0 < want.sum() < len(want) or column == 7


def _refused(X, T):
    """name -> (expr over _schema(T), the exception both packages raise)."""
    fts = _schema(T)
    C = lambda i: X.col(i, fts[i])  # noqa: E731
    f, lit = X.func, X.lit
    B, LL, VC, DT = T.new_longlong(notnull=True), T.new_longlong(), T.new_varchar, T.new_datetime()
    return {
        "replace": (f("replace", VC(16), C(11), lit("a", VC(1)), lit("b", VC(1))), NotImplementedError),
        "like_infix": (f("like", B, C(7), lit("%x%", VC(3))), NotImplementedError),
        "like_underscore": (f("like", B, C(7), lit("_", VC(1))), NotImplementedError),
        "like_suffix": (f("like", B, C(7), lit("%b", VC(2))), NotImplementedError),
        "round_column_digits": (f("round", T.new_double(), C(5), C(1)), NotImplementedError),
        "date_add_unknown_unit": (f("date_add", DT, C(6), lit(1, LL), lit("fortnight", VC(9))), NotImplementedError),
        "and_over_string": (f("and", B, C(7), C(9)), NotImplementedError),
        "if_over_string": (f("if", LL, C(10), C(0), C(1)), NotImplementedError),
        "concat_of_int": (f("concat", VC(16), C(7), C(0)), NotImplementedError),
        "length_without_raw": (f("length", LL, f("case", VC(8), C(9), C(7), C(8))), NotImplementedError),
        # EXTRACT dispatches to the unit's own op; a unit with none (quarter)
        # fails in ScalarFunc's constructor in both packages
        "extract_quarter": (f("extract", LL, lit("QUARTER", VC(8)), C(6)), ValueError),
    }


@pytest.mark.parametrize("name", sorted(_refused(JX, JT)))
def test_refused_in_both(name, both):
    jfts, jb, tfts, tb = both
    je, jexc = _refused(JX, JT)[name]
    te, texc = _refused(TX, TT)[name]
    assert jexc is texc
    with pytest.raises(jexc):
        JX.ExprCompiler(jfts).run([je], jb.cols)
    with pytest.raises(texc):
        TX.ExprCompiler(tfts, device="cpu").run([te], tb.cols)


def test_non_ascii_ci_constant_refused(both):
    _, _, tfts, tb = both
    ci = TT.new_varchar(8, collate=TT.Collation.Utf8MB4GeneralCI)
    e = TX.func("eq", TT.new_longlong(), TX.col(8, tfts[8]), TX.lit("é", ci))
    with pytest.raises(NotImplementedError):
        TX.ExprCompiler(tfts, device="cpu").run([e], tb.cols)
