"""The port's host->device batch (tidb_tpu_torch.chunk.device) against the
JAX package's over a column-type matrix (ints, unsigned, float, double,
decimal, datetime, date, enum, collated strings, varbinary, NULLs), and
pack_string_words bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.chunk.device as JD
import tidb_tpu.types as JT

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.chunk.device as TD
import tidb_tpu_torch.types as TT


def _matrix(T):
    """(name, FieldType, [Datum] with a NULL) per column type."""
    D = T.Datum
    ci = T.new_varchar(16, collate=T.Collation.Utf8MB4GeneralCI)
    vb = T.FieldType(T.TypeCode.Varchar, T.Flag.Binary, flen=16, decimal=0,
                     charset="binary", collate=T.Collation.Binary)
    enum_ft = T.new_enum(("a", "b", "c"))
    return [
        ("int", T.new_longlong(), [D.i64(-5), D.NULL, D.i64(7), D.i64(-(2 ** 63))]),
        ("uint", T.new_longlong(unsigned=True), [D.u64(2 ** 64 - 6), D.NULL, D.u64(0), D.u64(3)]),
        ("float", T.new_float(), [D(T.DatumKind.Float32, 1.5), D.NULL, D(T.DatumKind.Float32, -0.5), D(T.DatumKind.Float32, 0.0)]),
        ("double", T.new_double(), [D.f64(2.25), D.NULL, D.f64(1e10), D.f64(-0.0)]),
        ("decimal", T.new_decimal(10, 2), [D.dec(T.MyDecimal("12345.67")), D.NULL, D.dec(T.MyDecimal("-0.01")), D.dec(T.MyDecimal("0"))]),
        ("datetime", T.new_datetime(), [D.time(T.MyTime.from_ymd(2024, 2, 29)), D.NULL, D.time(T.MyTime.from_ymd(1999, 12, 31)), D.time(T.MyTime.from_ymd(1970, 1, 1))]),
        ("date", T.new_date(), [D.time(T.MyTime.from_ymd(2024, 2, 29)), D.NULL, D.time(T.MyTime.from_ymd(1970, 1, 1)), D.time(T.MyTime.from_ymd(2000, 6, 15))]),
        ("enum", enum_ft, [D.enum_from(enum_ft.elems, 2), D.NULL, D.enum_from(enum_ft.elems, 3), D.enum_from(enum_ft.elems, 1)]),
        ("ci_string", ci, [D.string("Ab"), D.NULL, D.string("zz"), D.string("a much longer string!")]),
        ("varbinary", vb, [D.bytes_(b"\x00\xff\x10"), D.NULL, D.bytes_(b""), D.bytes_(b"\xff" * 12)]),
    ]


@pytest.mark.parametrize("idx", range(10), ids=[m[0] for m in _matrix(JT)])
@pytest.mark.parametrize("capacity", [None, 8])
def test_to_device_batch_matches_jax(idx, capacity):
    _, jft, jd = _matrix(JT)[idx]
    _, tft, td = _matrix(TT)[idx]
    jchunk = JC.Chunk.from_rows([jft], [[d] for d in jd])
    tchunk = TC.Chunk.from_rows([tft], [[d] for d in td])
    jb = JD.to_device_batch(jchunk, capacity=capacity)
    tb = TD.to_device_batch(tchunk, capacity=capacity, device="cpu")
    assert np.array_equal(tb.row_valid.numpy(), np.asarray(jb.row_valid))
    assert int(tb.n_rows) == int(jb.n_rows)
    jc, tc = jb.cols[0], tb.cols[0]
    jdata = np.asarray(jc.data)
    assert tc.data.numpy().dtype == jdata.dtype
    assert np.array_equal(tc.data.numpy(), jdata, equal_nan=jdata.dtype.kind == "f")
    assert np.array_equal(tc.null.numpy(), np.asarray(jc.null))
    assert (tc.length is None) == (jc.length is None)
    if tc.length is not None:
        assert np.array_equal(tc.length.numpy(), np.asarray(jc.length))
        # the packed compare words, too
        jw = np.asarray(JD.pack_string_words(jc.data, jc.length))
        assert np.array_equal(TD.pack_string_words(tc.data, tc.length).numpy(), jw)
    assert TD.device_dtype_for(tft) == getattr(torch, np.dtype(JD.device_dtype_for(jft)).name)


@pytest.mark.parametrize("width", [1, 7, 32, 40])
def test_pack_string_words_bit_equal(width):
    rng = np.random.default_rng(width)
    n = 300
    data = rng.integers(0, 256, (n, width)).astype(np.uint8)
    length = rng.integers(0, width + 1, n).astype(np.int32)
    want = np.asarray(JD.pack_string_words(jnp.asarray(data), jnp.asarray(length)))
    got = TD.pack_string_words(torch.from_numpy(data), torch.from_numpy(length)).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


def test_non_ascii_ci_data_is_refused_like_jax():
    ci_j = JT.new_varchar(8, collate=JT.Collation.Utf8MB4GeneralCI)
    ci_t = TT.new_varchar(8, collate=TT.Collation.Utf8MB4GeneralCI)
    with pytest.raises(NotImplementedError):
        JD.to_device_batch(JC.Chunk.from_rows([ci_j], [[JT.Datum.string("é")]]))
    with pytest.raises(NotImplementedError):
        TD.to_device_batch(TC.Chunk.from_rows([ci_t], [[TT.Datum.string("é")]]), device="cpu")


def test_shared_str_widths_matches_jax():
    v_j, v_t = JT.new_varchar(16), TT.new_varchar(16)
    jch = [JC.Chunk.from_rows([v_j], [[JT.Datum.string(s)]]) for s in ("a", "abcd", "")]
    tch = [TC.Chunk.from_rows([v_t], [[TT.Datum.string(s)]]) for s in ("a", "abcd", "")]
    assert TD.shared_str_widths(tch) == JD.shared_str_widths(jch)
