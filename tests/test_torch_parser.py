"""The port's parser against the JAX package's: every statement of the SQL
parity cases (tests/test_sql.py, tests/test_txn.py, the SQL cases of
tests/test_expr_breadth.py) and of chip_smoke.py's phase 11 lexes to the
same tokens and parses to the same AST in both packages. ASTs are compared
field by field, recursively, by class name and value (the two packages'
node classes are distinct objects)."""

import importlib.util
from pathlib import Path

import pytest

import tidb_tpu.parser as j_parser
import tidb_tpu_torch.parser as p_parser
from test_torch_sql import BREADTH_CASES, SQL_CASES
from test_torch_txn import PAIR, SESSION_CASES, SINGLE_CASES
from torch_sql_parity import Sql, norm, outcome, same

_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _texts(steps):
    out = []
    for st in steps:
        if isinstance(st, str):
            out.append(st)
        elif isinstance(st, Sql):
            out.append(st.text)
    return out


CASES = {f"sql_{k}": _texts(v) for k, v in SQL_CASES.items()}
CASES.update({f"breadth_{k}": _texts(v) for k, v in BREADTH_CASES.items()})
CASES.update({f"txn_{k}": _texts(PAIR + v) for k, v in SESSION_CASES.items()})
CASES.update({f"txn_{k}": _texts(v) for k, v in SINGLE_CASES.items()})
CASES["chip_smoke_phase_11"] = [
    chip_smoke.LINEITEM_DDL, chip_smoke.ORDERS_DDL, chip_smoke.CUSTOMER_DDL, chip_smoke.Q3_THREE_TABLES,
    *(text.format(d=arg) for text, arg in chip_smoke.SESSION_STATEMENTS.values()),
    *(f"PREPARE p FROM '{text.format(d='?').replace(chr(39), chr(39) * 2)}'"
      for text, _ in chip_smoke.SESSION_STATEMENTS.values()),
    "EXECUTE p USING @p", "LOAD DATA INFILE '/x.csv' INTO TABLE loaded FIELDS TERMINATED BY ','",
    "LOAD STATS '/x.json'", "ANALYZE TABLE loaded", "SET tidb_allow_batch_cop = 1",
    "CREATE CHANGEFEED f INTO 'memory://'", "BACKUP DATABASE * TO 'file:///tmp/b'",
    "ALTER TABLE t SET COLUMNAR REPLICA 1", "SHOW CHANGEFEEDS", "SHOW COLUMNAR TABLES",
]


@pytest.mark.parametrize("name", list(CASES))
def test_statements_parse_alike(name):
    texts = CASES[name]
    assert texts
    for text in texts:
        jt = outcome(lambda: [(t.kind.name, t.value) for t in j_parser.tokenize(text)])
        pt = outcome(lambda: [(t.kind.name, t.value) for t in p_parser.tokenize(text)])
        assert same(jt, pt), text
        j = outcome(lambda: j_parser.parse_one(text))
        p = outcome(lambda: p_parser.parse_one(text))
        assert j[0] == "ok", (text, j)
        assert same(j, p), f"{text}\n  jax  {j}\n  port {p}"


def test_parse_errors_alike():
    for text in ("SELEC 1", "SELECT 1 +", "INSERT INTO t VALUES (1", "CREATE TABLE (a INT)", "SELECT 'abc"):
        j = outcome(lambda: j_parser.parse_one(text))
        p = outcome(lambda: p_parser.parse_one(text))
        assert j[0] == "err" and same(j, p), (text, j, p)


def test_ast_walk_compares_fields():
    """norm() of a node carries its class name and every field, so two ASTs
    that differ in one literal are told apart."""
    a = norm(p_parser.parse_one("SELECT a FROM t WHERE b = 1"))
    b = norm(p_parser.parse_one("SELECT a FROM t WHERE b = 2"))
    assert not same(a, b)
    assert same(norm(j_parser.parse_one("SELECT a FROM t WHERE b = 2")), b)
