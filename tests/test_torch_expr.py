"""The port's expression compiler (tidb_tpu_torch.expr.compile) against the
JAX package's ExprCompiler on the same rows: arithmetic with decimal
scales and DIV_FRAC_INCR, signed/unsigned, datetime and string compares
(binary and general_ci), 3VL logic, control flow and casts. Values are
compared where the result is not NULL; NULL masks everywhere. Ops the port
does not run yet raise NotImplementedError."""

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
    return rows


def _exprs(X, T):
    """name -> Expr over _schema(T), built the same way for both packages."""
    fts = _schema(T)
    C = lambda i: X.col(i, fts[i])  # noqa: E731
    f, lit = X.func, X.lit
    B = T.new_longlong(notnull=True)
    LL, DBL = T.new_longlong(), T.new_double()
    dec = T.new_decimal
    DT = T.new_datetime()
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
    }


@pytest.fixture(scope="module")
def both():
    jfts, tfts = _schema(JT), _schema(TT)
    jb = JD.to_device_batch(JC.Chunk.from_rows(jfts, _rows(JT)))
    tb = TD.to_device_batch(TC.Chunk.from_rows(tfts, _rows(TT)), device="cpu")
    return jfts, jb, tfts, tb


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
    assert np.array_equal(tval[keep], jval[keep]), (tval[keep], jval[keep])
    if jv.raw is not None:
        assert tv.raw is not None
        ln = np.asarray(jv.raw[1])
        assert np.array_equal(tv.raw[1].numpy()[keep], ln[keep])


UNPORTED = ["ceil", "floor", "round", "sqrt", "exp", "ln", "pow", "sign",
            "length", "strcmp", "like", "substr", "concat", "upper", "lower",
            "trim", "ltrim", "rtrim", "replace", "year", "month", "day", "hour",
            "minute", "second", "weekday", "to_days", "datediff", "date_add",
            "bitand", "bitor", "bitxor", "bitneg", "shiftleft", "shiftright"]


@pytest.mark.parametrize("op", UNPORTED)
def test_unported_op_raises(op, both):
    _, _, tfts, tb = both
    c = TX.col(0, tfts[0])
    e = TX.func(op, TT.new_longlong(), c, c)
    with pytest.raises(NotImplementedError):
        TX.ExprCompiler(tfts, device="cpu").run([e], tb.cols)


def test_string_to_number_raises(both):
    _, _, tfts, tb = both
    e = TX.func("cast", TT.new_double(), TX.col(7, tfts[7]))
    with pytest.raises(NotImplementedError):
        TX.ExprCompiler(tfts, device="cpu").run([e], tb.cols)


def test_non_ascii_ci_constant_refused(both):
    _, _, tfts, tb = both
    ci = TT.new_varchar(8, collate=TT.Collation.Utf8MB4GeneralCI)
    e = TX.func("eq", TT.new_longlong(), TX.col(8, tfts[8]), TX.lit("é", ci))
    with pytest.raises(NotImplementedError):
        TX.ExprCompiler(tfts, device="cpu").run([e], tb.cols)
