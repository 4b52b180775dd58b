"""Full-Unicode collations through both packages (the port's counterpart
of tests/test_collation.py): weight-based compare, group and sort, and
the guard that sends non-ASCII case-insensitive data to the oracle.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values.
"""

from torch_sql_parity import Both


def _s(collate: str) -> Both:
    b = Both()
    b.execute(f"create table t (id bigint primary key, v varchar(20) collate {collate})")
    return b


def test_general_ci_case_insensitive_unicode():
    s = _s("utf8mb4_general_ci")
    s.execute("insert into t values (1, 'Müller'), (2, 'MÜLLER'), (3, 'muller')")
    # ü and Ü equal under general_ci; u differs (no accent folding)
    assert s.execute("select count(*) from t where v = 'müller'").values() == [[2]]
    assert s.execute("select count(*), min(id) from t group by v order by 2").values() == [[2, 1], [1, 3]]


def test_unicode_ci_accent_insensitive():
    s = _s("utf8mb4_unicode_ci")
    s.execute("insert into t values (1, 'café'), (2, 'CAFE'), (3, 'cafe'), (4, 'caffè')")
    # unicode_ci folds accents and case: café == CAFE == cafe
    assert s.execute("select count(*) from t where v = 'cafe'").values() == [[3]]
    assert s.execute("select count(*) from t group by v order by 1 desc").values() == [[3], [1]]


def test_general_ci_ascii_still_on_device():
    """Pure-ASCII case-insensitive data keeps the device path."""
    s = _s("utf8mb4_general_ci")
    s.execute("insert into t values " + ",".join(f"({i}, '{'AbCd'[i % 4]}x')" for i in range(64)))
    assert s.execute("select count(*) from t where v = 'AX'").values() == [[16]]
    assert s.execute("select count(distinct v) from t").values() == [[4]]


def test_bin_collation_unaffected():
    s = _s("utf8mb4_bin")
    s.execute("insert into t values (1, 'a'), (2, 'A'), (3, 'é')")
    assert s.execute("select count(*) from t where v = 'a'").values() == [[1]]
    assert s.execute("select count(*) from t where v = 'é'").values() == [[1]]


def test_german_sharp_s_unicode_ci():
    s = _s("utf8mb4_unicode_ci")
    s.execute("insert into t values (1, 'straße'), (2, 'STRASSE')")
    # casefold expands ß to ss (the UCA expansion unicode_ci implements)
    assert s.execute("select count(*) from t where v = 'strasse'").values() == [[2]]


def test_order_by_ci_groups_equal_keys():
    s = _s("utf8mb4_unicode_ci")
    s.execute("insert into t values (1, 'b'), (2, 'É'), (3, 'a'), (4, 'e')")
    # weight order: a < b < (e == É, the tie broken by id)
    assert [r[0] for r in s.execute("select v from t order by v, id").values()] == ["a", "b", "É", "e"]
