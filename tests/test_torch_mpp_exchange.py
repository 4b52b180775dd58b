"""The port's MPP pieces (tidb_tpu_torch/mpp/fragment.py, the non-unique
radix expansion of ops/radix_join.py) against the JAX package's, on the
CPU: tests/test_mpp.py's TestFragmentPlanner (5) and
TestNonUniqueRadixBuild (5).

The fragment planner is a copy, so its plans must be the JAX package's
field for field. The non-unique radix join is held to the monolithic
sort-merge join of its own package and to the JAX package's radix join on
the same seeded inputs: the port's "search" mode against the JAX
package's "search", and the port's "kernel" route (the partitioned tables
with the dense broadcast-compare in plain torch, `_expand_partitioned`)
against the JAX package's "dense" strategy, output slot by output slot.
The session case runs a join keyed on a non-unique build column through
each package's Session with the mesh on (the JAX package takes its MPP
tier, the port its mesh select). Tolerance: exact (integer data).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.mpp.fragment as JF
import tidb_tpu.sql as JS
import tidb_tpu.types as JT
from tidb_tpu.expr.compile import CompVal as JCompVal
from tidb_tpu.ops.join import hash_join as j_hash_join
from tidb_tpu.ops.radix_join import radix_hash_join as j_radix
from tidb_tpu.util import metrics as JM

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.mpp.fragment as TF
import tidb_tpu_torch.sql as TS
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.expr.compile import CompVal as TCompVal
from tidb_tpu_torch.ops.join import hash_join as t_hash_join
from tidb_tpu_torch.ops.radix_join import radix_hash_join as t_radix
from tidb_tpu_torch.util import metrics as TM

J = SimpleNamespace(name="jax", C=JC, E=JE, X=JX, F=JF, T=JT, M=JM, session=lambda: JS.Session())
P = SimpleNamespace(name="torch", C=TC, E=TE, X=TX, F=TF, T=TT, M=TM,
                    session=lambda: TS.Session(device="cpu", mesh_devices=["cpu"] * 8))


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def both(case):
    return case(J), case(P)


def _scan(pkg, tid):
    I = pkg.T.new_longlong()
    return pkg.E.TableScan(tid, (pkg.E.ColumnInfo(1, I), pkg.E.ColumnInfo(2, I)))


def _chain_dag(pkg, n_joins=2):
    E, X, I = pkg.E, pkg.X, pkg.T.new_longlong()
    exs = [_scan(pkg, 10)]
    for j in range(n_joins):
        exs.append(E.Join(build=(_scan(pkg, 11 + j),), probe_keys=(X.col(0, I),), build_keys=(X.col(0, I),),
                          join_type="inner"))
    exs.append(E.Aggregation(group_by=(X.col(1, I),), aggs=(X.AggDesc("count", ()),)))
    return E.DAGRequest(tuple(exs), output_offsets=(0, 1))


def topology(fp):
    """A fragment plan as plain values: every fragment's index, executor
    kinds, receivers and sender (mode, key count, target)."""
    if fp is None:
        return None
    return (fp.n_tasks, fp.root, [
        (f.idx, [type(e).__name__ for e in f.executors], [r.source_fragment for r in f.receivers],
         (f.sender.exchange_type, len(f.sender.partition_keys), f.sender.target_fragment))
        for f in fp.fragments])


class TestFragmentPlanner:
    def test_q3_chain_cuts_into_exchange_linked_fragments(self):
        def case(pkg):
            fp = pkg.F.fragment_plan(_chain_dag(pkg, 2), n_tasks=8)
            assert fp is not None and fp.n_tasks == 8 and len(fp.fragments) == 6
            assert [r.source_fragment for r in fp.fragments[2].receivers] == [0, 1]
            assert [r.source_fragment for r in fp.fragments[4].receivers] == [2, 3]
            final = fp.fragments[fp.root]
            assert final.sender.exchange_type == pkg.F.EXCHANGE_PASSTHROUGH
            assert final.sender.target_fragment == pkg.F.ROOT_COLLECTOR
            assert fp.fragments[4].sender.target_fragment == fp.root
            return topology(fp)

        j, p = both(case)
        assert p == j

    def test_agg_shape_is_two_fragments(self):
        def case(pkg):
            E, X, I = pkg.E, pkg.X, pkg.T.new_longlong()
            dag = E.DAGRequest((_scan(pkg, 10), E.Selection((X.func("gt", I, X.col(1, I), X.lit(2, I)),)),
                                E.Aggregation(group_by=(X.col(0, I),), aggs=(X.AggDesc("count", ()),))),
                               output_offsets=(0, 1))
            fp = pkg.F.fragment_plan(dag, n_tasks=4)
            assert fp is not None and len(fp.fragments) == 2
            return topology(fp)

        j, p = both(case)
        assert p == j

    def test_join_inside_build_side_stays_off_mesh(self):
        def case(pkg):
            E, X, I = pkg.E, pkg.X, pkg.T.new_longlong()
            inner = E.Join(build=(_scan(pkg, 12),), probe_keys=(X.col(0, I),), build_keys=(X.col(0, I),),
                           join_type="inner")
            dag = E.DAGRequest((_scan(pkg, 10), E.Join(build=(_scan(pkg, 11), inner), probe_keys=(X.col(0, I),),
                                                       build_keys=(X.col(0, I),), join_type="inner"),
                                E.Aggregation(group_by=(X.col(1, I),), aggs=(X.AggDesc("count", ()),))),
                               output_offsets=(0, 1))
            return pkg.F.fragment_plan(dag, n_tasks=4)

        assert both(case) == (None, None)

    def test_scalar_agg_has_no_group_key_to_exchange(self):
        def case(pkg):
            dag = pkg.E.DAGRequest((_scan(pkg, 10), pkg.E.Aggregation(group_by=(), aggs=(pkg.X.AggDesc("count", ()),))),
                                   output_offsets=(0,))
            return pkg.F.fragment_plan(dag, n_tasks=4)

        assert both(case) == (None, None)

    def test_string_width_gate_measures_actual_bytes(self):
        def case(pkg):
            V = pkg.T.new_varchar(64)
            ok = pkg.C.Chunk.from_rows([V], [[pkg.T.Datum.string("x" * 32)]])
            wide = pkg.C.Chunk.from_rows([V], [[pkg.T.Datum.string("y" * 33)]])
            return pkg.F.chunks_exchange_safe([ok]), pkg.F.chunks_exchange_safe([wide])

        assert both(case) == ((True, False), (True, False))


class TestNonUniqueRadixBuild:
    @pytest.mark.parametrize("join_type", ["inner", "left_outer"])
    @pytest.mark.parametrize("strategy", ["search", "kernel"])
    def test_duplicate_build_keys_match_monolithic(self, join_type, strategy):
        """Duplicate build keys (escapes included: part_cap 256 against
        ~128 build rows a partition, esc_cap 2048) through the expansion,
        against the monolithic join of each package and against the JAX
        package's radix join ("dense" for the port's "kernel")."""
        rng = np.random.default_rng(11)
        nb, np_ = 512, 1024
        bk = rng.integers(0, 60, nb)
        pk = rng.integers(0, 80, np_)
        bvalid, pvalid = rng.random(nb) < 0.9, rng.random(np_) < 0.9
        bnull, pnull = rng.random(nb) < 0.05, rng.random(np_) < 0.05
        cap = 16384
        plan = (4, 256, 512, 2048)  # (n_parts, part_cap, probe_cap, esc_cap)

        def run(CompVal, I, arr, radix, mono, strat):
            bcv = [CompVal(arr(bk), arr(bnull), I)]
            pcv = [CompVal(arr(pk), arr(pnull), I)]
            res, _esc = radix(bcv, pcv, arr(bvalid), arr(pvalid), join_type, cap, plan, strategy=strat,
                              build_unique=False, out_capacity=cap)
            ref = mono(bcv, pcv, arr(bvalid), arr(pvalid), out_capacity=cap, join_type=join_type,
                       build_unique=False)
            assert not bool(res.overflow) and not bool(ref.overflow)
            return res, ref

        def pairs(r, ordered=False):
            ov = np.asarray(r.out_valid)
            pi, bi, nl = np.asarray(r.probe_idx)[ov], np.asarray(r.build_idx)[ov], np.asarray(r.build_null)[ov]
            out = [(int(p), -1 if n else int(b)) for p, b, n in zip(pi, bi, nl)]
            return out if ordered else sorted(out)

        jres, jref = run(JCompVal, JT.new_longlong(), jnp.asarray, j_radix, j_hash_join,
                         "dense" if strategy == "kernel" else "search")
        tres, tref = run(TCompVal, TT.new_longlong(), lambda a: torch.from_numpy(np.asarray(a)), t_radix,
                         t_hash_join, strategy)
        assert pairs(jres) == pairs(jref)
        assert pairs(tres) == pairs(tref)
        assert pairs(tres, ordered=True) == pairs(jres, ordered=True)
        assert int(tres.n_out) == int(jres.n_out)

    def test_non_unique_build_join_on_session_path(self):
        """A join keyed on a NON-unique build column: each session takes its
        MPP tier (whose exchange program counts MESH_SELECTS); rows equal in
        order, and equal to the mesh-off path."""
        def case(pkg):
            s = pkg.session()
            s.execute("create table cust (c_id bigint primary key, seg varchar(2))")
            s.execute("insert into cust values " + ",".join(f"({i}, '{'AB'[i % 2]}')" for i in range(12)))
            s.execute("create table ords (o_id bigint primary key, ckey bigint, odate bigint)")
            s.execute("insert into ords values " + ",".join(f"({i}, {i % 12}, {1000 + i % 9})" for i in range(40)))
            s.execute("create table items (i_id bigint primary key, oid bigint, v decimal(10,2))")
            s.execute("insert into items values " + ",".join(f"({i}, {(i * 3) % 44}, {i}.25)" for i in range(600)))
            sql = "select ckey, count(*), sum(v) from items join ords on oid = ckey group by ckey"
            m0 = pkg.M.MESH_SELECTS.value
            rows = [tuple(None if d.is_null() else str(d.val) for d in r) for r in s.execute(sql).rows]
            assert pkg.M.MESH_SELECTS.value == m0 + 1
            s.execute("set tidb_enable_tpu_mesh = OFF")
            off = [tuple(None if d.is_null() else str(d.val) for d in r) for r in s.execute(sql).rows]
            assert sorted(rows) == sorted(off)
            return rows

        j, p = both(case)
        assert p == j
