"""The port's copies of the row, key and datum codecs against the JAX
package's, and its C++ scan decoder against its Python decoder.

Seeded rows of every column class the store decodes (signed and unsigned
integers, doubles, decimals of two scales, datetimes, dates, durations,
strings, binary strings, enums, JSON, the handle column) with NULLs among
them: the two packages must encode the same bytes (rowcodec values, row and
index keys, flagged datums, comparable and not), and each package's
decoder must give back what was encoded. The port's native decoder must
give the very Chunk that its Python decoder (Chunk.from_rows over
decode_row_to_datum_map) gives, and the JAX package's native decoder's.
Tolerance: exact everywhere.
"""

import shutil

import numpy as np
import pytest

import tidb_tpu.codec as JCodec
import tidb_tpu.exec as JE
import tidb_tpu.types as JT
from tidb_tpu import native as JN
from tidb_tpu.chunk import Chunk as JChunk

import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import native as TN
from tidb_tpu_torch.chunk import Chunk as TChunk
from tidb_tpu_torch.codec.datum_codec import decode_datums, encode_datums

N_ROWS = 300


def _fts(T):
    return [
        T.new_longlong(),
        T.new_longlong(unsigned=True),
        T.new_double(),
        T.new_decimal(15, 2),
        T.new_decimal(20, 6),
        T.new_datetime(),
        T.new_date(),
        T.FieldType(T.TypeCode.Duration),
        T.new_varchar(32),
        _binary(T),
        T.new_enum(("x", "y", "z")),
        T.new_json(),
    ]


def _binary(T):
    ft = T.new_varchar(16)
    ft.charset = "binary"
    ft.collate = T.Collation.Binary
    return ft


# one generator of plain values per column (same draws for both packages)
def _values(seed: int):
    rng = np.random.default_rng(seed)
    n = N_ROWS
    ymd = ((rng.integers(1992, 1999, n) * 13 + rng.integers(1, 13, n)) << 5) | rng.integers(1, 29, n)
    return [
        rng.integers(-(1 << 62), 1 << 62, n).tolist(),
        rng.integers(0, 1 << 63, n, dtype=np.uint64).tolist(),
        (rng.standard_normal(n) * 1e6).tolist(),
        rng.integers(-10**13, 10**13, n).tolist(),
        rng.integers(-10**18, 10**18, n).tolist(),
        ((ymd << 17) << 24).tolist(),
        ((ymd << 17) << 24).tolist(),
        rng.integers(-(10**15), 10**15, n).tolist(),
        ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(0, 20))) for _ in range(n)],
        [bytes(rng.integers(0, 256, rng.integers(0, 12)).astype(np.uint8)) for _ in range(n)],
        rng.integers(1, 4, n).tolist(),
        rng.integers(0, 1000, n).tolist(),
    ]


def _datum(T, ci, v):
    D = T.Datum
    if ci == 0:
        return D.i64(v)
    if ci == 1:
        return D.u64(v)
    if ci == 2:
        return D.f64(v)
    if ci == 3:
        return D.dec(T.MyDecimal.from_scaled_int(v, 2))
    if ci == 4:
        return D.dec(T.MyDecimal.from_scaled_int(v, 6))
    if ci in (5, 6):
        return D.time(T.MyTime(v, 0))
    if ci == 7:
        return D.duration(v)
    if ci == 8:
        return D.string(v)
    if ci == 9:
        return D.bytes_(v)
    if ci == 10:
        return D.enum_from(("x", "y", "z"), v)
    from_json = __import__(T.__name__ + ".json_binary", fromlist=["encode"])
    return D.json(from_json.encode({"k": v, "l": [v, str(v)]}))


def _rows(T, seed: int):
    vals = _values(seed)
    nulls = np.random.default_rng(seed + 100).random((N_ROWS, len(vals))) < 0.15
    return [[T.Datum.NULL if nulls[i, ci] else _datum(T, ci, vals[ci][i]) for ci in range(len(vals))]
            for i in range(N_ROWS)]


COL_IDS = [3, 1, 7, 2, 300, 5, 9, 4, 6, 8, 11, 10]  # unsorted, one above 255 (the large layout)


def _canon(d):
    return None if d.is_null() else (int(d.kind), str(d.val) if not isinstance(d.val, bytes) else d.val.hex())


@pytest.mark.parametrize("seed", [0, 1])
def test_rowcodec_bytes_match_and_round_trip(seed):
    jrows, trows = _rows(JT, seed), _rows(TT, seed)
    tfts = _fts(TT)
    jenc, tenc = JCodec.RowEncoder(), TCodec.RowEncoder()
    for jr, tr in zip(jrows, trows):
        small = [c if c < 256 else 12 for c in COL_IDS]
        for ids in (COL_IDS, small):
            tb = tenc.encode(ids, tr)
            assert tb == jenc.encode(ids, jr)
            back = TCodec.decode_row_to_datum_map(tb, dict(zip(ids, tfts)))
            assert [_canon(back[c]) for c in ids] == [_canon(d) for d in tr]


@pytest.mark.parametrize("seed", [0, 1])
def test_keys_and_datums_match_and_round_trip(seed):
    jrows, trows = _rows(JT, seed), _rows(TT, seed)
    tfts = _fts(TT)
    for i, (jr, tr) in enumerate(zip(jrows, trows)):
        handle = int(np.random.default_rng(seed * 1000 + i).integers(-(1 << 63), 1 << 63))
        tk = TCodec.encode_row_key(77, handle)
        assert tk == JCodec.encode_row_key(77, handle)
        assert TCodec.decode_row_key(tk) == (77, handle)
        # index keys hold the comparable kinds (no binary, enum or JSON values)
        keyable = tr[:9]
        jkeyable = jr[:9]
        assert TCodec.encode_index_key(77, 2, keyable) == JCodec.encode_index_key(77, 2, jkeyable)
        for comparable in (True, False):
            tb = encode_datums(tr[:9], comparable)
            assert tb == JCodec.datum_codec.encode_datums(jr[:9], comparable)
            back = decode_datums(tb, tfts[:9])
            assert [_canon(d) for d in back] == [_canon(d) for d in tr[:9]]


def test_row_keys_sort_as_handles():
    handles = sorted(np.random.default_rng(5).integers(-(1 << 63), 1 << 63, 500).tolist())
    keys = [TCodec.encode_row_key(10, h) for h in handles]
    assert keys == sorted(keys)


@pytest.mark.skipif(shutil.which("g++") is None, reason="the native decoder needs g++")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_decoder_equals_the_python_decoder(seed):
    """Every column class but JSON (which the native path leaves to Python)
    plus the handle column: the C++ decoder's Chunk is the Python one's."""
    assert TN.available()
    cols = list(range(11))  # every class but JSON
    trows = _rows(TT, seed)
    tfts = _fts(TT)
    ids = [COL_IDS[c] for c in cols]
    enc = TCodec.RowEncoder()
    values = [enc.encode(ids, [r[c] for c in cols]) for r in trows]
    handles = list(range(1000, 1000 + N_ROWS))
    scan = [TE.ColumnInfo(ids[k], tfts[c]) for k, c in enumerate(cols)] + [TE.ColumnInfo(-1, TT.new_longlong())]
    got = TChunk(TN.decode_rows_columnar(values, handles, scan))
    py_rows = []
    for v, h in zip(values, handles):
        dmap = TCodec.decode_row_to_datum_map(v, {c.col_id: c.ft for c in scan[:-1]})
        py_rows.append([dmap[c.col_id] for c in scan[:-1]] + [TT.Datum.i64(h)])
    want = TChunk.from_rows([c.ft for c in scan], py_rows)
    for k, (g, w) in enumerate(zip(got.columns, want.columns)):
        assert g.ft == w.ft
        assert np.array_equal(g.null, w.null), k
        if w.is_varlen():
            assert np.array_equal(g.offsets, w.offsets) and np.array_equal(g.blob, w.blob), k
        else:
            assert g.data.dtype == w.data.dtype, k
            assert np.array_equal(np.where(w.null, 0, g.data.view(np.int64)),
                                  np.where(w.null, 0, w.data.view(np.int64))), k
    # and the JAX package's native decoder gives the same columns
    jscan = [JE.ColumnInfo(c.col_id, _fts(JT)[cols[k]] if k < len(cols) else JT.new_longlong())
             for k, c in enumerate(scan)]
    jgot = JChunk(JN.decode_rows_columnar(values, handles, jscan))
    for g, j in zip(got.columns, jgot.columns):
        assert np.array_equal(g.null, j.null)
        if g.is_varlen():
            assert np.array_equal(g.offsets, j.offsets) and np.array_equal(g.blob, j.blob)
        else:
            assert np.array_equal(g.data, j.data)


def test_native_library_builds_under_the_checkout_build_dir():
    if shutil.which("g++") is None:
        pytest.skip("the native decoder needs g++")
    assert TN.available()
    assert TN._SO.endswith("build/native/librowcodec.so")
    assert "tidb_tpu_torch" not in TN._SO.split("build/native")[1]
