"""Foreign-key enforcement at DML time through both packages (the port's
counterpart of tests/test_foreign_key.py): INSERT / UPDATE checks, ON
DELETE RESTRICT / CASCADE / SET NULL, ON UPDATE CASCADE and the
foreign_key_checks gate.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values.
"""

import pytest

from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import Both

FAILS = "foreign key constraint fails"


def _schema(on_delete: str = "", on_update: str = "") -> Both:
    s = Both()
    s.execute("create table parent (id bigint primary key, v bigint)")
    s.execute("insert into parent values (1, 10), (2, 20)")
    clause = (f" on delete {on_delete}" if on_delete else "") + (f" on update {on_update}" if on_update else "")
    s.execute(f"create table child (cid bigint primary key, pid bigint, "
              f"foreign key fk_p (pid) references parent (id){clause})")
    return s


def test_insert_child_checks_parent():
    s = _schema()
    s.execute("insert into child values (1, 1)")
    s.execute("insert into child values (2, NULL)")  # NULL never violates
    with pytest.raises(SQLError, match=FAILS):
        s.execute("insert into child values (3, 99)")
    s.execute("set foreign_key_checks = OFF")
    s.execute("insert into child values (3, 99)")  # the gate is off


def test_update_child_checks_parent():
    s = _schema()
    s.execute("insert into child values (1, 1)")
    with pytest.raises(SQLError, match=FAILS):
        s.execute("update child set pid = 42 where cid = 1")
    s.execute("update child set pid = 2 where cid = 1")


def test_delete_parent_restrict():
    s = _schema()
    s.execute("insert into child values (1, 1)")
    with pytest.raises(SQLError, match=FAILS):
        s.execute("delete from parent where id = 1")
    s.execute("delete from parent where id = 2")  # an unreferenced row goes


def test_delete_parent_cascade():
    s = _schema(on_delete="cascade")
    s.execute("insert into child values (1, 1), (2, 1), (3, 2)")
    s.execute("delete from parent where id = 1")
    assert s.execute("select cid from child order by cid").values() == [[3]]


def test_delete_parent_set_null():
    s = _schema(on_delete="set null")
    s.execute("insert into child values (1, 1)")
    s.execute("delete from parent where id = 1")
    assert s.execute("select pid from child where cid = 1").values() == [[None]]


def test_update_parent_cascade():
    s = _schema(on_update="cascade")
    s.execute("insert into child values (1, 1)")
    s.execute("update parent set id = 7 where id = 1")
    assert s.execute("select pid from child where cid = 1").values() == [[7]]


def test_update_parent_restrict():
    s = _schema()
    s.execute("insert into child values (1, 1)")
    with pytest.raises(SQLError, match=FAILS):
        s.execute("update parent set id = 7 where id = 1")


def test_cascade_chain():
    s = Both()
    s.execute("create table a (id bigint primary key)")
    s.execute("insert into a values (1)")
    s.execute("create table b (id bigint primary key, aid bigint, foreign key (aid) references a (id) on delete cascade)")
    s.execute("insert into b values (10, 1)")
    s.execute("create table c (id bigint primary key, bid bigint, foreign key (bid) references b (id) on delete cascade)")
    s.execute("insert into c values (100, 10)")
    s.execute("delete from a where id = 1")
    assert s.execute("select count(*) from b").values() == [[0]]
    assert s.execute("select count(*) from c").values() == [[0]]
