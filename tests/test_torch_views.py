"""Views through both packages (the port's counterpart of
tests/test_views.py): CREATE / DROP, queries through a view, SHOW CREATE
VIEW and the view's persistence.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values.
"""

import pytest

from torch_sql_parity import JAX, PORT, Both


def _mk() -> Both:
    b = Both()
    b.execute("create table t (id bigint primary key, g varchar(8), v bigint)")
    b.execute("insert into t values (1,'a',10),(2,'b',20),(3,'a',30),(4,'c',40)")
    return b


def ints(res) -> list:
    return [int(x[0].val) for x in res.rows]


class TestViews:
    def test_create_and_query(self):
        s = _mk()
        s.execute("create view va as select g, sum(v) as total from t group by g")
        r = s.execute("select g, total from va order by g")
        assert [(str(x[0].val), int(str(x[1].val))) for x in r.rows] == [("a", 40), ("b", 20), ("c", 40)]
        # views join with tables
        assert ints(s.execute("select t.id from t join va on t.g = va.g where va.total > 30 order by t.id")) == [1, 3, 4]

    def test_view_with_column_list(self):
        s = _mk()
        s.execute("create view vc (grp, cnt) as select g, count(*) from t group by g")
        r = s.execute("select grp, cnt from vc order by grp")
        assert [(str(x[0].val), int(x[1].val)) for x in r.rows] == [("a", 2), ("b", 1), ("c", 1)]

    def test_view_over_view(self):
        s = _mk()
        s.execute("create view v1 as select id, v from t where v >= 20")
        s.execute("create view v2 as select id from v1 where v < 40")
        assert ints(s.execute("select * from v2 order by id")) == [2, 3]

    def test_show_create_view_and_show_tables(self):
        s = _mk()
        s.execute("create view va as select id from t")
        r = s.execute("show create view va")
        assert r.columns == ["View", "Create View"]
        assert "select id from t" in str(r.rows[0][1].val)
        names = [str(x[0].val) for x in s.execute("show tables").rows]
        assert "va" in names and "t" in names

    def test_or_replace_and_drop(self):
        s = _mk()
        s.execute("create view va as select id from t")
        with pytest.raises(Exception):
            s.execute("create view va as select v from t")
        s.execute("create or replace view va as select v from t")
        assert int(s.execute("select * from va order by v").rows[0][0].val) == 10
        s.execute("drop view va")
        with pytest.raises(Exception):
            s.execute("select * from va")
        s.execute("drop view if exists va")

    def test_view_sees_current_data(self):
        s = _mk()
        s.execute("create view va as select count(*) as n from t")
        assert ints(s.execute("select n from va")) == [4]
        s.execute("insert into t values (5,'d',50)")
        assert ints(s.execute("select n from va")) == [5]

    @pytest.mark.parametrize("sql", ["create table va (x bigint)", "drop table va", "create view t as select 1"],
                             ids=["table_over_view", "drop_table_of_a_view", "view_over_table"])
    def test_view_name_clashes(self, sql):
        s = _mk()
        s.execute("create view va as select id from t")
        with pytest.raises(Exception):
            s.execute(sql)

    @pytest.mark.parametrize("sql", ["create view bad as select nosuchcol from t",
                                     "create view bad (a, b) as select id from t"], ids=["column", "arity"])
    def test_create_view_validates_body(self, sql):
        with pytest.raises(Exception):
            _mk().execute(sql)

    def test_view_survives_restart(self):
        s = _mk()
        s.execute("create view va as select id from t where v > 15")
        s2 = Both({name: {"s": pkg.sql.Session(store=s.pair[name]["s"].store,
                                               **({"device": "cpu"} if pkg is PORT else {}))}
                   for name, pkg in (("jax", JAX), ("port", PORT))})
        assert ints(s2.execute("select * from va order by id")) == [2, 3, 4]

    def test_cte_shadows_view(self):
        s = _mk()
        s.execute("create view va as select id from t")
        assert ints(s.execute("with va as (select 99 as id) select id from va")) == [99]
