"""JSON values and functions, REGEXP, ENUM and SET through both packages
(the port's counterpart of tests/test_json_enum.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. The wire case reads the same table
through each package's MySQL server.
"""

import pytest

import tidb_tpu.server as j_server
import tidb_tpu_torch.server as p_server
from tidb_tpu_torch.types import json_binary as jb
from torch_sql_parity import JAX, PORT, Both, both_pkgs, session_pair

DDL = "create table j (id bigint primary key, doc json, tag enum('red','green','blue'), opts set('a','b','c'))"
ROWS = """insert into j values
    (1, '{"name": "alpha", "nums": [1, 2, 3], "deep": {"k": true}}', 'red', 'a,c'),
    (2, '{"name": "beta", "nums": [4], "deep": {"k": false}}', 'blue', ''),
    (3, '[10, 20, 30]', 'green', 'b')"""


def _mk(mesh: bool = False) -> Both:
    b = Both(session_pair(mesh=mesh))
    b.execute(DDL)
    b.execute(ROWS)
    return b


def ids(res) -> list:
    return [int(x[0].val) for x in res.rows]


class TestJSON:
    def test_json_extract_arrow_ops(self):
        s = _mk()
        r = s.execute("select id, doc->'$.name', doc->>'$.name' from j where id < 3 order by id")
        rows = [(int(x[0].val), jb.decode(x[1].val), str(x[2].val)) for x in r.rows]
        assert rows[0] == (1, "alpha", "alpha")
        assert rows[1][2] == "beta"

    def test_json_functions(self):
        s = _mk()
        r = s.execute("select json_type(doc), json_valid(doc), json_length(doc), "
                      "json_extract(doc, '$.nums[1]') from j where id = 1")
        row = r.rows[0]
        assert str(row[0].val) == "OBJECT"
        assert int(row[1].val) == 1
        assert int(row[2].val) == 3
        assert jb.decode(row[3].val) == 2

    def test_json_where_and_member_of(self):
        s = _mk()
        s.execute("select id from j where json_extract(doc, '$.deep.k') = true")
        assert ids(s.execute("select id from j where 20 member of (doc)")) == [3]

    def test_json_group_by_extract(self):
        s = _mk()
        r = s.execute("select json_type(doc), count(*) from j group by json_type(doc)")
        assert sorted((str(x[0].val), int(x[1].val)) for x in r.rows) == [("ARRAY", 1), ("OBJECT", 2)]

    def test_json_roundtrip_output(self):
        s = _mk()

        def over_the_wire(sess, pkg):
            m = j_server if pkg is JAX else p_server
            kw = {"device": "cpu"} if pkg is PORT else {}
            srv = m.MySQLServer(port=0, store=sess.store, catalog=sess.catalog, **kw)
            srv.start_background()
            try:
                return m.MiniClient(srv.host, srv.port).query("select doc from j where id = 3")
            finally:
                srv.close()

        _cols, rows = s.call(over_the_wire)
        assert rows[0][0] == "[10, 20, 30]"


class TestRegexp:
    def test_regexp_operator_and_like(self):
        s = _mk()
        assert ids(s.execute("select id from j where doc->>'$.name' regexp '^al'")) == [1]
        r = s.execute("select regexp_like('Hello', '^he', 'i'), regexp_like('Hello', '^he', 'c')")
        assert int(r.rows[0][0].val) == 1 and int(r.rows[0][1].val) == 0
        assert sorted(ids(s.execute("select id from j where tag not regexp 'e{2}'"))) == [1, 2]


class TestEnumSet:
    def test_enum_storage_and_compare(self):
        s = _mk()
        r = s.execute("select id, tag from j order by tag, id")
        # enum orders by member NUMBER: red(1) < green(2) < blue(3)
        assert [(int(x[0].val), str(x[1].val)) for x in r.rows] == [(1, "red"), (3, "green"), (2, "blue")]
        assert ids(s.execute("select id from j where tag = 'green'")) == [3]
        assert ids(s.execute("select id from j where tag > 'red' order by id")) == [2, 3]

    def test_set_storage(self):
        s = _mk()
        r = s.execute("select id, opts from j order by id")
        assert [(int(x[0].val), str(x[1].val)) for x in r.rows] == [(1, "a,c"), (2, ""), (3, "b")]

    def test_invalid_enum_rejected(self):
        s = _mk()
        with pytest.raises(Exception, match="(?i)enum"):
            s.execute("insert into j values (9, '1', 'purple', '')")

    def test_enum_survives_restart(self):
        s = _mk()

        def restarted(sess, pkg):
            kw = {"device": "cpu"} if pkg is PORT else {}
            return pkg.sql.Session(store=sess.store, **kw).execute("select tag from j where id = 1").rows[0][0].val

        assert str(s.call(restarted)) == "red"


class TestReviewRegressions:
    def test_json_scalar_string_args(self):
        s = _mk()
        r = s.execute("select json_object('k', 'v'), json_array('abc', '[1,2]'), json_unquote('abc')")
        assert jb.decode(r.rows[0][0].val) == {"k": "v"}
        assert jb.decode(r.rows[0][1].val) == ["abc", "[1,2]"]
        assert str(r.rows[0][2].val) == "abc"

    def test_member_of_string_scalar(self):
        s = _mk()
        assert int(s.execute("select 'alpha' member of (json_array('alpha', 'beta'))").rows[0][0].val) == 1

    def test_json_equals_string(self):
        s = _mk()
        assert ids(s.execute("select id from j where doc->>'$.name' = 'alpha'")) == [1]
        assert ids(s.execute("select id from j where doc->'$.name' = 'alpha'")) == [1]

    def test_enum_nonmember_literal_matches_nothing(self):
        assert _mk().execute("select id from j where tag = 'purple'").rows == []

    def test_undefined_named_window_errors(self):
        with pytest.raises(Exception, match="not defined"):
            _mk().execute("select rank() over w from j")

    def test_enum_nonmember_ne_matches_all(self):
        # != against a non-member matches every non-NULL row
        assert sorted(ids(_mk().execute("select id from j where tag != 'purple'"))) == [1, 2, 3]

    def test_enum_nonmember_in_list(self):
        assert ids(_mk().execute("select id from j where tag in ('purple', 'red')")) == [1]

    @pytest.mark.parametrize("q", ["select id from j where tag > 'purple'",
                                   "select id from j where tag between 'purple' and 'red'"])
    def test_enum_nonmember_ordering_raises(self, q):
        # `tag > 'purple'` must not lower to `tag > -1`: ordering against a
        # non-member raises
        with pytest.raises(Exception, match="non-member"):
            _mk().execute(q)

    def test_json_object_odd_arity_is_sql_error(self):
        # an odd argument count raises a SQL-level error, not IndexError
        with pytest.raises(Exception, match="json_object") as ei:
            _mk().execute("select json_object('k')")
        assert not isinstance(ei.value, IndexError)

    def test_named_window_referenced_from_order_by(self):
        s = _mk()
        r = s.execute("select id from j window w as (order by id desc) order by rank() over w")
        assert ids(r) == [3, 2, 1]

    def test_json_group_by_on_multidevice_mesh_falls_back(self):
        # host-only expressions in GROUP BY stay off the mesh program: the
        # mesh gate rejects them and the per-region path answers (the JAX
        # session on eight CPU devices, the port's on mesh_devices ["cpu"] * 8)
        s = _mk(mesh=True)
        assert s.call(lambda sess, _: sess.sysvars.get_bool("tidb_enable_tpu_mesh"))
        r = s.execute("select json_type(doc), count(*) from j group by json_type(doc)")
        assert sorted((str(x[0].val), int(x[1].val)) for x in r.rows) == [("ARRAY", 1), ("OBJECT", 2)]

    def test_named_window_block_scoped_in_order_by_subquery(self):
        # a same-named WINDOW in an ORDER BY subquery must not capture the
        # outer block's OVER w reference
        def outer_order_key(pkg):
            st = pkg.parse_one("select rank() over w as r from t window w as (order by id desc) "
                               "order by (select count(*) over w from t2 window w as (order by x asc))")
            bi = st.fields[0].expr.order_by[0]
            return bi.expr.name if hasattr(bi, "expr") else bi.name

        assert both_pkgs(outer_order_key) == "id"
        with pytest.raises(Exception, match="not defined"):
            both_pkgs(lambda pkg: pkg.parse_one(
                "select rank() over w from t order by "
                "(select count(*) over wi from t2 window wi as (order by x), w as (order by y))"))
