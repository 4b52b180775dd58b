"""The port's window functions (tidb_tpu_torch/ops/window.py window_cols)
against the JAX package's (tidb_tpu/ops/window.py), column for column: every
function of tests/test_window.py's queries plus percent_rank and cume_dist,
each with and without PARTITION BY and under no ORDER BY, one key and two
keys, over nullable arguments, invalid rows, int / decimal / real / unsigned
/ string arguments; and the port raises NotImplementedError exactly where
the JAX package does. Int, decimal and string results are compared exactly;
a real SUM / AVG within a relative 1e-9 (the two packages may add a running
sum in another order; tests/test_window.py rounds floats to 9 digits)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.exec.dag as JD
import tidb_tpu.expr as JX
import tidb_tpu.ops.window as JW
import tidb_tpu.types as JT
from tidb_tpu.chunk.device import DeviceColumn as JColumn
from tidb_tpu.expr.compile import CompVal as JVal
from tidb_tpu.expr.compile import normalize_device_column as j_norm

import tidb_tpu_torch.exec.dag as TD
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.ops.window as TW
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.expr.compile import CompVal as TVal
from tidb_tpu_torch.expr.compile import normalize_device_column as t_norm
from tidb_tpu_torch.interop import device_batch_from_numpy

N = 300
REAL_RTOL = 1e-9

# the input columns: name -> FieldType maker
SCHEMA = {
    "id": lambda T: T.new_longlong(notnull=True),
    "dept": lambda T: T.new_longlong(),
    "sal": lambda T: T.new_longlong(),
    "price": lambda T: T.new_decimal(15, 2),
    "x": lambda T: T.new_double(),
    "u": lambda T: T.new_longlong(unsigned=True),
    "note": lambda T: T.new_varchar(8),
}


def _columns():
    """emp-shaped columns (tests/test_window.py's table, widened): a few
    departments with NULLs, repeating salaries with NULLs, decimals, reals
    with ties and zeros, unsigned values past 2^63, short strings."""
    rng = np.random.default_rng(zlib.crc32(b"window"))
    n = N
    note_len = rng.integers(0, 3, n).astype(np.int32)
    note = np.zeros((n, 8), np.uint8)
    note[:, 0] = np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, n)]
    note[note_len == 0, 0] = 0
    note[:, 1] = np.where(note_len == 2, ord("z"), 0)
    u = rng.integers(0, 1 << 62, n).astype(np.uint64) * np.uint64(3)
    u[rng.random(n) < 0.05] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return {
        "id": (np.arange(1, n + 1, dtype=np.int64), np.zeros(n, bool), None),
        "dept": (rng.choice([10, 20, 30, 40], n).astype(np.int64), rng.random(n) < 0.05, None),
        "sal": (rng.choice([100, 150, 200, 200, 300], n).astype(np.int64), rng.random(n) < 0.15, None),
        "price": (rng.integers(-50000, 900000, n).astype(np.int64), rng.random(n) < 0.1, None),
        "x": (rng.integers(-8, 8, n).astype(np.float64) / 8 + rng.random(n) * (rng.random(n) < 0.5),
              rng.random(n) < 0.1, None),
        "u": (u.view(np.int64), rng.random(n) < 0.1, None),
        "note": (note, rng.random(n) < 0.2, note_len),
    }


def _valid():
    return np.random.default_rng(zlib.crc32(b"window/valid")).random(N) < 0.9


def _vals(package):
    """name -> CompVal of `package` ("jax" or "torch") for every column."""
    cols = _columns()
    names = list(SCHEMA)
    if package == "jax":
        return {nm: j_norm(JColumn(jnp.asarray(cols[nm][0]), jnp.asarray(cols[nm][1]),
                                   None if cols[nm][2] is None else jnp.asarray(cols[nm][2]), SCHEMA[nm](JT)))
                for nm in names}
    b = device_batch_from_numpy([cols[nm] for nm in names], np.ones(N, bool), N,
                                [SCHEMA[nm](TT) for nm in names], device="cpu")
    return {nm: t_norm(c) for nm, c in zip(names, b.cols)}


def _const(package, value: int):
    if package == "jax":
        return JVal(jnp.full(N, value, jnp.int64), jnp.zeros(N, bool), JT.new_longlong())
    return TVal(torch.full((N,), value, dtype=torch.int64), torch.zeros(N, dtype=torch.bool), TT.new_longlong())


# (case id, function name, argument columns, offset, integer default)
FUNCS = [
    ("row_number", "row_number", (), 1, None),
    ("rank", "rank", (), 1, None),
    ("dense_rank", "dense_rank", (), 1, None),
    ("percent_rank", "percent_rank", (), 1, None),
    ("cume_dist", "cume_dist", (), 1, None),
    ("ntile3", "ntile", (), 3, None),
    ("ntile7", "ntile", (), 7, None),
    ("count_star", "count", (), 1, None),
    ("count_sal", "count", ("sal",), 1, None),
    ("sum_sal", "sum", ("sal",), 1, None),
    ("sum_price", "sum", ("price",), 1, None),
    ("sum_real", "sum", ("x",), 1, None),
    ("avg_sal", "avg", ("sal",), 1, None),
    ("avg_price", "avg", ("price",), 1, None),
    ("avg_real", "avg", ("x",), 1, None),
    ("min_sal", "min", ("sal",), 1, None),
    ("max_sal", "max", ("sal",), 1, None),
    ("min_price", "min", ("price",), 1, None),
    ("max_real", "max", ("x",), 1, None),
    ("min_real", "min", ("x",), 1, None),
    ("min_unsigned", "min", ("u",), 1, None),
    ("max_unsigned", "max", ("u",), 1, None),
    ("lead", "lead", ("sal",), 1, None),
    ("lag2_default", "lag", ("sal",), 2, -5),
    ("lead3", "lead", ("price",), 3, None),
    ("first_value", "first_value", ("sal",), 1, None),
    ("last_value", "last_value", ("sal",), 1, None),
    ("nth_value3", "nth_value", ("sal",), 3, None),
    ("first_value_string", "first_value", ("note",), 1, None),
    ("lead_string", "lead", ("note",), 1, None),
    ("lag_string", "lag", ("note",), 2, None),
]

PARTITIONS = {"no_partition": (), "by_dept": ("dept",)}
ORDERS = {"no_order": (), "by_sal": (("sal", False),), "by_sal_desc_id": (("sal", True), ("id", False))}


def _win_desc(dag, X, T, name, args, offset):
    """A WinDesc with the planner's result type (sql/planner.py _win_ft)."""
    if name in ("row_number", "rank", "dense_rank", "ntile", "count"):
        ft = T.new_longlong(notnull=True)
    elif name in ("percent_rank", "cume_dist"):
        ft = T.new_double()
    elif name in ("sum", "avg"):
        ft = X.AggDesc(name, tuple(X.col(i, SCHEMA[a](T)) for i, a in enumerate(args))).ft
    else:
        ft = SCHEMA[args[0]](T).clone_nullable()
    return dag.WinDesc(name, (), ft, offset)


def _window(package, part, order, funcs):
    """window_cols of `package` over the named partition / order / funcs."""
    dag, X, T, mod = (JD, JX, JT, JW) if package == "jax" else (TD, TX, TT, TW)
    vals = _vals(package)
    valid = jnp.asarray(_valid()) if package == "jax" else torch.from_numpy(_valid())
    fl = []
    for _cid, name, args, offset, default in funcs:
        argv = [vals[a] for a in args]
        if default is not None:
            argv.append(default if not isinstance(default, int) else _const(package, default))
        fl.append((_win_desc(dag, X, T, name, args, offset), argv))
    return mod.window_cols([vals[p] for p in PARTITIONS[part]],
                           [(vals[o], d) for o, d in ORDERS[order]], fl, valid)


@pytest.fixture(scope="module")
def frames():
    """Every function of FUNCS under every frame, both packages, each frame
    one window_cols call a package (as exec/builder.py makes it)."""
    out = {}
    for part in PARTITIONS:
        for order in ORDERS:
            out[(part, order)] = (_window("jax", part, order, FUNCS), _window("torch", part, order, FUNCS))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("part", list(PARTITIONS))
@pytest.mark.parametrize("fi", range(len(FUNCS)), ids=[f[0] for f in FUNCS])
def test_window_function_matches_jax(frames, fi, part, order):
    jout, tout = frames[(part, order)]
    j, t = jout[fi], tout[fi]
    cid = FUNCS[fi][0]
    jn, tn = _np(j.null), _np(t.null)
    assert (jn == tn).all(), f"{cid}: null masks differ"
    jv, tv = _np(j.value), _np(t.value)
    assert jv.shape == tv.shape and jv.dtype == tv.dtype, cid
    live = ~tn
    if cid in ("sum_real", "avg_real"):
        ok = np.abs(jv - tv) <= REAL_RTOL * np.maximum(1.0, np.abs(jv))
        assert ok[live].all(), f"{cid}: worst {np.abs(jv - tv)[live].max()}"
    else:
        assert (jv[live] == tv[live]).all(), cid
        assert (jv == tv).all() or jv.dtype.kind == "f", f"{cid}: values under NULL differ"
    assert (j.raw is None) == (t.raw is None)
    if t.raw is not None:
        for a, b in zip(j.raw, t.raw):
            assert (_np(a)[live] == _np(b)[live]).all(), cid


def test_window_columns_hold_sql_semantics(frames):
    """A spot check of the port against plain numpy on one frame
    (PARTITION BY dept ORDER BY sal DESC, id): row_number is 1.. in order
    within each partition, count(*) counts the partition's rows up to the
    current peer group, first_value is the partition's first sal."""
    _, tout = frames[("by_dept", "by_sal_desc_id")]
    cols, valid = _columns(), _valid()
    dept = np.where(cols["dept"][1], -1, cols["dept"][0])
    sal_null = cols["sal"][1]
    sal = cols["sal"][0]
    names = [f[0] for f in FUNCS]
    rn, cnt, fv = (tout[names.index(c)] for c in ("row_number", "count_star", "first_value"))
    for d in np.unique(dept[valid]):
        rows = np.nonzero(valid & (dept == d))[0]
        # ORDER BY sal DESC (NULLs last), id
        key = np.where(sal_null[rows], -1, sal[rows])  # salaries are positive
        order = rows[np.lexsort((rows, -key))]
        assert (rn.value.numpy()[order] == np.arange(1, len(order) + 1)).all()
        assert cnt.value.numpy()[order[-1]] == len(order)
        first = order[0]
        assert fv.null.numpy()[order].all() == bool(sal_null[first])
        if not sal_null[first]:
            assert (fv.value.numpy()[order] == sal[first]).all()


RAISES = [
    ("sum_string", "sum", ("note",), 1, None),
    ("avg_string", "avg", ("note",), 1, None),
    ("min_string", "min", ("note",), 1, None),
    ("max_string", "max", ("note",), 1, None),
    ("lag_string_default", "lag", ("note",), 1, "note"),
    ("unknown", "median", ("sal",), 1, None),
]


@pytest.mark.parametrize("case", RAISES, ids=[r[0] for r in RAISES])
def test_port_raises_where_jax_raises(case):
    cid, name, args, offset, default = case
    for package in ("jax", "torch"):
        # a string default: the note column itself stands in for the Const
        dflt = _vals(package)[default] if default is not None else None
        with pytest.raises(NotImplementedError):
            _window(package, "by_dept", "by_sal", [(cid, name, args, offset, dflt)])
