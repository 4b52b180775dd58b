"""Merge-mode, DISTINCT and BIT_* aggregation in the port (tidb_tpu_torch
ops/aggregate.py) against the JAX package on the CPU.

The same rows, made from a seed with numpy, go through both packages'
run_dag_on_chunk (the JAX side with Pallas off, its XLA routes) and
through the JAX row oracle:
  * the DISTINCT cases of tests/test_agg_holes.py (grouped, multi-arg,
    scalar, over strings) and DISTINCT in merge mode raising;
  * its partial -> merge round trip (first_row, string min);
  * a grouped and a scalar Partial1 -> Final merge of every state kind:
    count, sum, avg, min/max over ints, reals and strings, first_row,
    var/stddev and BIT_AND/OR/XOR;
  * the BIT_* cases of tests/test_ops.py (scalar incl. the empty-set
    identities, grouped) at the op level;
  * the stream kernel in merge mode at the op level;
  * a forced DISTINCT arg-hash collision: the overflow flag fires, and the
    salted retry clears it.
Tolerance: integer, decimal, count and BIT_* results are equal as
strings; DOUBLE results (AVG of a real, VAR/STDDEV) match to a relative
1e-12. The DOUBLE column holds multiples of 1/64 below 2^14: both
packages take a segment's sum as a difference of prefix sums, whose
round-off depends on the scan's association order (XLA's and torch's
differ); on these values every partial sum is exact, so the states
must agree and only the final division and square root round.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.distsql.root import _merge_aggregation as j_merge_agg
from tidb_tpu.expr.compile import CompVal as JVal
from tidb_tpu.ops import aggregate as JA

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.distsql.root import _merge_aggregation as t_merge_agg
from tidb_tpu_torch.expr.compile import CompVal as TVal
from tidb_tpu_torch.ops import aggregate as TA

REL = 1e-12


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


class Pkg:
    """One package's modules, so a DAG or a chunk is built alike in both."""

    def __init__(self, T, C, E, X, merge_agg):
        self.T, self.C, self.E, self.X, self.merge_agg = T, C, E, X, merge_agg

    def fts(self):
        T = self.T
        return [T.new_longlong(), T.new_varchar(12), T.new_decimal(10, 2), T.new_longlong(unsigned=True),
                T.new_double()]

    def col(self, i):
        return self.X.col(i, self.fts()[i])

    def scan(self):
        return self.E.TableScan(7, tuple(self.E.ColumnInfo(i + 1, ft) for i, ft in enumerate(self.fts())))


J = Pkg(JT, JC, JE, JX, j_merge_agg)
P = Pkg(TT, TC, TE, TX, t_merge_agg)
WORDS = ["alpha", "beta", "Gamma", "delta", "", "zz", "omega9", "a", "ab"]


def rows_of(pkg, n, seed, null_p=0.06, groups=6):
    """test_agg_holes.make_chunk's rows plus a DOUBLE column, in `pkg`'s
    Datums; the same draws for either package."""
    rng = np.random.default_rng(seed)
    D, T = pkg.T.Datum, pkg.T
    rows = []
    for _ in range(n):
        def maybe(d):
            return D.NULL if rng.random() < null_p else d

        rows.append([
            maybe(D.i64(int(rng.integers(0, groups)))),
            maybe(D.string(WORDS[int(rng.integers(len(WORDS)))])),
            maybe(D.dec(T.MyDecimal(f"{int(rng.integers(-5000, 5000)) / 100:.2f}"))),
            maybe(D.u64(int(rng.integers(0, 2**63 - 1, dtype=np.int64)) + int(rng.integers(0, 3)))),
            maybe(D.f64(float(rng.integers(-2**20, 2**20)) / 64.0)),
        ])
    return rows


def chunk_of(pkg, n=200, seed=3, **kw):
    return pkg.C.Chunk.from_rows(pkg.fts(), rows_of(pkg, n, seed, **kw))


def canon(rows):
    return [tuple(None if d.is_null() else d.val for d in r) for r in rows]


def assert_rows_match(got, want):
    """Row for row, in order: floats to REL, everything else as strings."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(canon(got), canon(want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None, (g, w)
                assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (g, w)
            else:
                assert (None if a is None else str(a)) == (None if b is None else str(b)), (g, w)


def sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple((d.is_null(), str(d.val)) for d in r))


def run_both(build, n=200, seed=3, group_capacity=4096, **kw):
    """build(pkg) -> DAG; the port's rows (CPU), the JAX package's rows and
    the JAX oracle's rows for the same chunk."""
    jdag, tdag = build(J), build(P)
    jch, tch = chunk_of(J, n, seed, **kw), chunk_of(P, n, seed, **kw)
    got = TE.run_dag_on_chunk(tdag, tch, device="cpu", group_capacity=group_capacity).rows()
    jax_rows = JE.run_dag_on_chunk(jdag, jch, group_capacity=group_capacity).rows()
    oracle = JE.run_dag_reference(jdag, jch)
    return got, jax_rows, oracle


# ---------------------------------------------------------------------------
# DISTINCT (tests/test_agg_holes.py TestDistinct)
# ---------------------------------------------------------------------------

def _distinct_grouped(p):
    A = p.X.AggDesc
    agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(
        A("count", (p.col(2),), distinct=True), A("sum", (p.col(2),), distinct=True),
        A("avg", (p.col(2),), distinct=True), A("count", (p.col(2),))))
    return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1, 2, 3, 4))


def _distinct_multi_arg(p):
    agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(p.X.AggDesc("count", (p.col(1), p.col(2)), distinct=True),))
    return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1))


def _distinct_scalar(p):
    A = p.X.AggDesc
    agg = p.E.Aggregation(group_by=(), aggs=(A("count", (p.col(1),), distinct=True),
                                             A("sum", (p.col(2),), distinct=True)))
    return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1))


def _distinct_string_count(p):
    agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(p.X.AggDesc("count", (p.col(1),), distinct=True),))
    return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1))


def _distinct_real_var(p):
    A = p.X.AggDesc
    agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(
        A("avg", (p.col(4),), distinct=True), A("var_pop", (p.col(4),), distinct=True),
        A("stddev_samp", (p.col(2),), distinct=True), A("sum", (p.col(0),), distinct=True)))
    return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1, 2, 3, 4))


@pytest.mark.parametrize("build,n", [
    (_distinct_grouped, 250), (_distinct_multi_arg, 180), (_distinct_scalar, 120),
    (_distinct_string_count, 140), (_distinct_real_var, 260),
], ids=["grouped_count_sum_avg", "count_multi_arg", "scalar", "string_count", "real_avg_var_int_sum"])
def test_distinct_matches_jax_and_oracle(build, n):
    got, jax_rows, oracle = run_both(build, n=n)
    assert_rows_match(got, jax_rows)
    assert_rows_match(sorted_rows(got), sorted_rows(oracle))


def test_distinct_with_repeats_counts_each_value_once():
    """Few distinct values, many repeats: the unique count is small."""
    got, jax_rows, _ = run_both(_distinct_grouped, n=300, seed=9, groups=2)
    assert_rows_match(got, jax_rows)
    assert all(int(str(r[0].val)) <= int(str(r[3].val)) for r in got if not r[0].is_null())


def test_distinct_merge_raises():
    def build(p):
        agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(
            p.X.AggDesc("sum", (p.col(2),), distinct=True, mode=p.X.AggMode.Final),), merge=True)
        return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1))

    with pytest.raises(NotImplementedError, match="not decomposable"):
        TE.run_dag_on_chunk(build(P), chunk_of(P, 30), device="cpu")
    with pytest.raises(NotImplementedError, match="not decomposable"):
        JE.run_dag_on_chunk(build(J), chunk_of(J, 30))


def test_group_concat_raises_for_the_oracle():
    def build(p):
        agg = p.E.Aggregation(group_by=(p.col(0),), aggs=(p.X.AggDesc("group_concat", (p.col(1),)),))
        return p.E.DAGRequest((p.scan(), agg), output_offsets=(0, 1))

    with pytest.raises(NotImplementedError, match="group_concat"):
        TE.run_dag_on_chunk(build(P), chunk_of(P, 20), device="cpu")


# ---------------------------------------------------------------------------
# Partial1 -> Final merge
# ---------------------------------------------------------------------------

def _two_phase(p, complete, halves):
    """Partial1 of `complete` on each half, states concatenated, then the
    root's Final merge (distsql/root.py _merge_aggregation) over them."""
    part = p.E.Aggregation(group_by=complete.group_by, aggs=complete.aggs, partial=True)
    pdag = p.E.DAGRequest((p.scan(), part), output_offsets=tuple(range(len(part.output_fts()))))
    run = (lambda d, c: TE.run_dag_on_chunk(d, c, device="cpu")) if p is P else JE.run_dag_on_chunk
    parts = [run(pdag, h) for h in halves]
    stacked = p.C.Chunk.concat(parts)
    pfts = stacked.field_types()
    merge = p.merge_agg(complete)
    root = p.E.DAGRequest((p.E.TableScan(0, tuple(p.E.ColumnInfo(i, ft) for i, ft in enumerate(pfts))), merge),
                          output_offsets=tuple(range(len(merge.output_fts()))))
    return run(root, stacked), stacked


def _halves(p, n, seed, cuts, **kw):
    rows = rows_of(p, n, seed, **kw)
    bounds = [0, *cuts, n]
    return [p.C.Chunk.from_rows(p.fts(), rows[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _every_state(p, grouped: bool):
    A = p.X.AggDesc
    aggs = (
        A("count", ()), A("count", (p.col(2),)),
        A("sum", (p.col(2),)), A("sum", (p.col(4),)), A("sum", (p.col(0),)),
        A("avg", (p.col(2),)), A("avg", (p.col(4),)),
        A("min", (p.col(2),)), A("max", (p.col(3),)), A("min", (p.col(4),)), A("max", (p.col(4),)),
        A("min", (p.col(1),)), A("max", (p.col(1),)),
        A("first_row", (p.col(1),)), A("first_row", (p.col(2),)),
        A("var_pop", (p.col(4),)), A("var_samp", (p.col(2),)), A("stddev_pop", (p.col(0),)),
        A("stddev_samp", (p.col(4),)),
        A("bit_and", (p.col(3),)), A("bit_or", (p.col(0),)), A("bit_xor", (p.col(3),)),
    )
    return p.E.Aggregation(group_by=(p.col(0), p.col(1)) if grouped else (), aggs=aggs)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "scalar"])
def test_partial_then_merge_every_state_kind(grouped):
    cuts = (70, 71, 190)  # one half of a single row
    got, tstates = _two_phase(P, _every_state(P, grouped), _halves(P, 260, 11, cuts))
    want, jstates = _two_phase(J, _every_state(J, grouped), _halves(J, 260, 11, cuts))
    # the partial states themselves, then the merged rows
    assert_rows_match(tstates.rows(), jstates.rows())
    assert_rows_match(got.rows(), want.rows())
    complete = _every_state(J, grouped)
    oracle = JE.run_dag_reference(
        J.E.DAGRequest((J.scan(), complete), output_offsets=tuple(range(len(complete.output_fts())))),
        chunk_of(J, 260, 11))
    assert_rows_match(sorted_rows(got.rows()), sorted_rows(oracle))


def test_partial_then_merge_roundtrip():
    """tests/test_agg_holes.py TestFirstRow: the merge-mode first_row
    [has, value] routing and the string min state merge."""
    def complete(p):
        A = p.X.AggDesc
        return p.E.Aggregation(group_by=(p.col(0),), aggs=(A("first_row", (p.col(1),)), A("min", (p.col(1),)),
                                                           A("first_row", (p.col(2),))))

    got, _ = _two_phase(P, complete(P), _halves(P, 160, 3, (80,)))
    want, _ = _two_phase(J, complete(J), _halves(J, 160, 3, (80,)))
    assert_rows_match(got.rows(), want.rows())
    oracle = JE.run_dag_reference(J.E.DAGRequest((J.scan(), complete(J)), output_offsets=(0, 1, 2, 3)),
                                  chunk_of(J, 160, 3))
    assert_rows_match(sorted_rows(got.rows()), sorted_rows(oracle))


def test_merge_of_all_null_and_empty_states():
    """Groups whose partial sum / avg states are all NULL merge to NULL
    (the avg count state is never NULL); BIT_* over an all-NULL group gives
    the identity, not NULL."""
    def complete(p):
        A = p.X.AggDesc
        return p.E.Aggregation(group_by=(p.col(0),), aggs=(
            A("sum", (p.col(2),)), A("avg", (p.col(4),)), A("bit_and", (p.col(3),)), A("bit_xor", (p.col(3),)),
            A("var_samp", (p.col(4),))))

    got, _ = _two_phase(P, complete(P), _halves(P, 90, 5, (30, 60), null_p=0.7, groups=12))
    want, _ = _two_phase(J, complete(J), _halves(J, 90, 5, (30, 60), null_p=0.7, groups=12))
    assert_rows_match(got.rows(), want.rows())
    assert any(r[0].is_null() for r in got.rows())


# ---------------------------------------------------------------------------
# op level: BIT_* (tests/test_ops.py TestBitAggs) and the stream kernel
# ---------------------------------------------------------------------------

U64 = TT.new_longlong(unsigned=True)
JU64 = JT.new_longlong(unsigned=True)


def _bit_descs(X, ft):
    return [X.AggDesc(nm, (X.col(0, ft),)) for nm in ("bit_and", "bit_or", "bit_xor")]


def test_scalar_bit_aggs():
    vals, nulls = [0b1100, 0b1010, 0b0110], [False, False, True]  # the NULL is ignored
    a = TVal(torch.tensor(vals, dtype=torch.int64), torch.tensor(nulls), U64)
    ja = JVal(jnp.asarray(vals, dtype=jnp.int64), jnp.asarray(nulls), JU64)
    for valid in ([True] * 3, [False] * 3):  # the second: the empty set
        sts, ovf = TA.scalar_aggregate([(d, [a]) for d in _bit_descs(TX, U64)], torch.tensor(valid))
        jsts, _ = JA.scalar_aggregate([(d, [ja]) for d in _bit_descs(JX, JU64)], jnp.asarray(valid))
        assert not bool(ovf)
        got = [(int(st[0][0][0]), bool(st[0][1][0])) for st in sts]
        assert got == [(int(st[0][0][0]), bool(st[0][1][0])) for st in jsts]
        assert got == ([(0b1000, False), (0b1110, False), (0b0110, False)] if valid[0]
                       else [(-1, False), (0, False), (0, False)])  # MySQL: never NULL


def test_grouped_bit_aggs_over_many_groups():
    """The doubling scan across segment boundaries: 300 rows, 37 groups,
    values over the whole 64-bit range, NULLs and filtered rows."""
    rng = np.random.default_rng(4)
    n = 300
    g = rng.integers(0, 37, n)
    v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    nl = rng.random(n) < 0.1
    valid = rng.random(n) < 0.9
    LL, JLL = TT.new_longlong(), JT.new_longlong()
    tg = TVal(torch.from_numpy(g), torch.zeros(n, dtype=torch.bool), LL)
    ta = TVal(torch.from_numpy(v), torch.from_numpy(nl), U64)
    jg = JVal(jnp.asarray(g), jnp.zeros(n, bool), JLL)
    jav = JVal(jnp.asarray(v), jnp.asarray(nl), JU64)
    res = TA.group_aggregate([tg], [(d, [ta]) for d in _bit_descs(TX, U64)], torch.from_numpy(valid), 64)
    jres = JA.group_aggregate([jg], [(d, [jav]) for d in _bit_descs(JX, JU64)], jnp.asarray(valid), 64)
    k = int(res.n_groups)
    assert k == int(jres.n_groups) == len(set(g[valid]))
    assert np.array_equal(res.group_rep[:k].numpy(), np.asarray(jres.group_rep)[:k])
    for st, jst in zip(res.states, jres.states):
        assert np.array_equal(st[0][0][:k].numpy(), np.asarray(jst[0][0])[:k])
        assert not st[0][1][:k].any()
    # against numpy
    for j in range(k):
        key = g[int(res.group_rep[j])]
        m = valid & (g == key) & ~nl
        vals = v[m].astype(np.uint64)
        assert int(res.states[0][0][0][j]) & (2**64 - 1) == int(np.bitwise_and.reduce(vals, initial=np.uint64(2**64 - 1)))
        assert int(res.states[1][0][0][j]) & (2**64 - 1) == int(np.bitwise_or.reduce(vals, initial=np.uint64(0)))
        assert int(res.states[2][0][0][j]) & (2**64 - 1) == int(np.bitwise_xor.reduce(vals, initial=np.uint64(0)))


def test_grouped_bit_or_small():
    g = [1, 2, 1, 2]
    vals = [0b11, 0b101, 0b10, 0b100]
    tg = TVal(torch.tensor(g), torch.zeros(4, dtype=torch.bool), TT.new_longlong())
    ta = TVal(torch.tensor(vals), torch.zeros(4, dtype=torch.bool), U64)
    res = TA.group_aggregate([tg], [(TX.AggDesc("bit_or", (TX.col(1, U64),)), [ta])], torch.ones(4, dtype=torch.bool), 8)
    assert sorted(int(x) for x in res.states[0][0][0][: int(res.n_groups)]) == [0b11, 0b101]


def test_stream_kernel_in_merge_mode():
    """Partial states sorted on the group key, merged by the stream kernel
    (no sort, no hash) in both packages: count, sum, avg, min, var, BIT_*
    and first_row states."""
    rng = np.random.default_rng(8)
    n = 120
    key = np.sort(rng.integers(0, 15, n))
    cnt = rng.integers(0, 5, n)
    s = rng.integers(-1000, 1000, n)
    s_null = cnt == 0
    q = rng.random(n) * 100
    bits = rng.integers(0, 2**62, n)
    valid = rng.random(n) < 0.85
    LL = (TT.new_longlong(), JT.new_longlong())
    DEC = (TT.new_decimal(20, 2), JT.new_decimal(20, 2))
    DBL = (TT.new_double(), JT.new_double())

    def side(k, mod, X, tensor, zeros):
        V = TVal if k == 0 else JVal
        c = lambda a, ft, nl=None: V(tensor(a), tensor(nl) if nl is not None else zeros(n), ft[k])
        A, F = X.AggDesc, X.AggMode.Final
        g = c(key, LL)
        cv, sv, qv, bv = c(cnt, LL), c(s, DEC, s_null), c(q, DBL, s_null), c(bits, (U64, JU64))
        aggs = [
            (A("count", (X.col(1, LL[k]),), mode=F), [cv]),
            (A("sum", (X.col(2, DEC[k]),), mode=F), [sv]),
            (A("avg", (X.col(1, LL[k]), X.col(2, DEC[k])), mode=F), [cv, sv]),
            (A("min", (X.col(2, DEC[k]),), mode=F), [sv]),
            (A("var_pop", (X.col(1, LL[k]), X.col(3, DBL[k]), X.col(3, DBL[k])), mode=F), [cv, qv, qv]),
            (A("bit_xor", (X.col(4, U64 if k == 0 else JU64),), mode=F), [bv]),
            (A("first_row", (X.col(1, LL[k]), X.col(2, DEC[k])), mode=F), [cv, sv]),
        ]
        return mod.group_aggregate([g], aggs, tensor(valid), 32, merge=True, stream=True)

    res = side(0, TA, TX, torch.from_numpy, lambda m: torch.zeros(m, dtype=torch.bool))
    jres = side(1, JA, JX, jnp.asarray, lambda m: jnp.zeros(m, bool))
    k = int(res.n_groups)
    assert k == int(jres.n_groups)
    assert not bool(res.overflow) and not bool(jres.overflow)
    assert np.array_equal(res.group_rep[:k].numpy(), np.asarray(jres.group_rep)[:k])
    for st, jst in zip(res.states, jres.states):
        if isinstance(st, TA.GatherState):
            assert np.array_equal(st.idx[:k].numpy(), np.asarray(jst.idx)[:k])
            assert np.array_equal(st.has[:k].numpy(), np.asarray(jst.has)[:k])
            continue
        for (v, nl), (jv, jnl) in zip(st, jst):
            assert np.array_equal(nl[:k].numpy(), np.asarray(jnl)[:k])
            live = ~nl[:k].numpy()
            a, b = v[:k].numpy()[live], np.asarray(jv)[:k][live]
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=REL, atol=0)
            else:
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# DISTINCT arg-hash collisions
# ---------------------------------------------------------------------------

def _collide_at(monkeypatch, salt):
    """Every arg hash of the given salt collides (a constant word): the
    neighbour compare on the second arg hash must see it."""
    real = TA.hash_words

    def hash_words(words, s):
        h = real(words, s)
        return torch.zeros_like(h) if s == salt else h

    monkeypatch.setattr(TA, "hash_words", hash_words)


def test_forced_distinct_collision_sets_overflow_and_the_salted_retry_clears_it(monkeypatch):
    n = 64
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.integers(0, 4, n))
    v = torch.from_numpy(rng.integers(0, 9, n))
    LL = TT.new_longlong()
    gv, av = TVal(g, torch.zeros(n, dtype=torch.bool), LL), TVal(v, torch.zeros(n, dtype=torch.bool), LL)
    desc = TX.AggDesc("count", (TX.col(1, LL),), distinct=True)
    valid = torch.ones(n, dtype=torch.bool)
    _collide_at(monkeypatch, 64 + 1)  # the arg hash at group capacity 64
    assert bool(TA.group_aggregate([gv], [(desc, [av])], valid, 64).overflow)
    assert not bool(TA.group_aggregate([gv], [(desc, [av])], valid, 256).overflow)  # re-salted
    _, ovf = TA.scalar_aggregate([(desc, [av])], valid, salt=64)
    assert bool(ovf)
    _, ovf = TA.scalar_aggregate([(desc, [av])], valid, salt=256)
    assert not bool(ovf)

    # through drive_program_info: the retry lands on the next rung and the rows
    # equal the JAX package's
    for build in (_distinct_grouped, _distinct_scalar):
        cache = TE.ProgramCache()
        got = TE.run_dag_on_chunk(build(P), chunk_of(P, 150, 6), cache=cache, device="cpu",
                                  group_capacity=64).rows()
        want = JE.run_dag_on_chunk(build(J), chunk_of(J, 150, 6), group_capacity=64).rows()
        assert_rows_match(got, want)
        assert cache.stats()["compiles"] == 2  # the flagged run and its retry
