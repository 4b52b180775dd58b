"""Optimizer hints and SQL plan bindings through both packages (the
port's counterpart of tests/test_bindings_hints.py): a hint overrides the
optimizer's choice in EXPLAIN, and a binding applies it to un-hinted
statements by structural digest.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. `ast_digest` gets the same parsed
statements in both packages.
"""

import importlib

import pytest

from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import JAX, Both, both_pkgs


def _sess() -> Both:
    b = Both()
    b.execute("create table t (id bigint primary key, v bigint, w bigint)")
    b.execute("create index iv on t (v)")
    b.execute("insert into t values " + ",".join(f"({i},{i % 5},{i})" for i in range(60)))
    return b


def _access(s: Both, sql: str) -> str:
    return s.execute("explain " + sql).values()[0][0]


def test_use_index_hint_overrides():
    s = _sess()
    assert "index" in _access(s, "select w from t where v = 3")  # the selective predicate picks the index
    assert _access(s, "select /*+ IGNORE_INDEX(t, iv) */ w from t where v = 3") == "access: table"
    assert "iv" in _access(s, "select /*+ USE_INDEX(t, iv) */ w from t where v = 3")
    a = s.execute("select w from t where v = 3 order by w").values()
    b = s.execute("select /*+ IGNORE_INDEX(t, iv) */ w from t where v = 3 order by w").values()
    assert a == b


def test_join_probe_hint():
    s = _sess()
    s.execute("create table small (id bigint primary key, v bigint)")
    s.execute("insert into small values (1, 1), (2, 2)")
    plain = s.execute("select count(*) from t join small on t.v = small.v").values()
    hinted = s.execute("select /*+ HASH_JOIN_PROBE(small) */ count(*) from t join small on t.v = small.v").values()
    assert plain == hinted == [[24]]


def test_global_binding_with_backslash_literal_mirrors():
    """A bound statement with backslash-escaped string literals lands one
    row in mysql.bind_info."""
    s = _sess()
    s.execute("create table bs (w bigint, n varchar(10))")
    tgt = "select w from bs where n = 'x\\\\'"
    hint = "select /*+ HASH_AGG() */ w from bs where n = 'x\\\\'"
    s.execute(f"create global binding for {tgt} using {hint}")
    rows = s.execute("select original_sql from mysql.bind_info").values()
    assert any("x\\\\" in r[0] for r in rows), rows


def test_session_binding_applies_and_drops():
    s = _sess()
    s.execute("create binding for select w from t where v = 3 "
              "using select /*+ IGNORE_INDEX(t, iv) */ w from t where v = 3")
    # the un-hinted statement takes the bound plan, whatever its constant
    assert _access(s, "select w from t where v = 3") == "access: table"
    assert _access(s, "select w from t where v = 1") == "access: table"
    rows = s.execute("show bindings").values()
    assert len(rows) == 1 and "IGNORE_INDEX" in rows[0][1]
    s.execute("drop binding for select w from t where v = 3")
    assert "index" in _access(s, "select w from t where v = 3")


def test_global_binding_lands_in_bind_info():
    s = _sess()
    s.execute("create global binding for select w from t where v = 3 "
              "using select /*+ IGNORE_INDEX(t, iv) */ w from t where v = 3")
    assert _access(s, "select w from t where v = 3") == "access: table"
    assert s.execute("select count(*) from mysql.bind_info").values() == [[1]]
    assert len(s.execute("show global bindings").values()) == 1
    s.execute("drop global binding for select w from t where v = 3")
    assert s.execute("select count(*) from mysql.bind_info").values() == [[0]]


def test_binding_rejects_structural_mismatch():
    with pytest.raises(SQLError, match="structurally"):
        _sess().execute("create binding for select w from t where v = 3 "
                        "using select /*+ USE_INDEX(t, iv) */ w from t where v = 3 and w > 0")


def test_binding_keeps_query_constants():
    """A binding carries hints only: the statement's own literals stay."""
    s = _sess()
    s.execute("create binding for select w from t where v = 3 "
              "using select /*+ IGNORE_INDEX(t, iv) */ w from t where v = 3")
    assert s.execute("select w from t where v = 1 order by w").values() == [[i] for i in range(60) if i % 5 == 1]


def test_distinct_digest_differs():
    def digests(pkg):
        ast_digest = importlib.import_module(("tidb_tpu" if pkg is JAX else "tidb_tpu_torch") + ".sql.session").ast_digest
        return [ast_digest(pkg.parse_one(q)) for q in ("select w from t where v = 3",
                                                        "select distinct w from t where v = 3")]

    a, b = both_pkgs(digests)
    assert a != b


def test_hint_elsewhere_is_comment():
    s = _sess()
    s.execute("update /*+ NO_INDEX_MERGE() */ t set w = w + 0 where id = 1")
    s.execute("insert /*+ SET_VAR(x=1) */ into t values (1000, 0, 0)")
    assert s.execute("select count(*) from t").values() == [[61]]
