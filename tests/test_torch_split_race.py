"""A region split between a request's epoch check and its read (a fault
of the port repaired here; the reference keeps it).

`Cluster.split` mutates the Region object in place. The store looked the
region up, checked the request's epoch against it, then decoded the rows
between the region's bounds: a split landing in between made the request
read half its range and answer without the other half's rows (seen on
the card in `chip_smoke.py` phase 13's split storm, one 2^16-row region
missing from Q1). The port's store now checks and reads one snapshot of
the region (`Cluster.region_snapshot`). Each case wraps the store's
`region_chunk` so that the first decode splits its region first.
"""

import pytest

from torch_sql_parity import JAX, PORT, session_pair

ROWS = "INSERT INTO t VALUES " + ",".join(f"({i}, {i % 7})" for i in range(100))


def split_on_first_decode(pkg, s):
    """The store's first region decode splits that region in the middle
    of the table's rows before it reads."""
    real = s.store.region_chunk
    done = []

    def splitting(region, *a, **k):
        if not done:
            done.append(True)
            s.store.cluster.split(pkg.tablecodec.encode_row_key(s.catalog.table("t").table_id, 50))
        return real(region, *a, **k)

    s.store.region_chunk = splitting
    return done


@pytest.mark.parametrize("sql, want", [("SELECT count(*) FROM t", 100), ("SELECT sum(v) FROM t", 295)])
def test_a_split_after_the_epoch_check_loses_no_rows(sql, want):
    pair = session_pair()
    got = {}
    for pkg in (JAX, PORT):
        s = pair[pkg.name]["s"]
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute(ROWS)
        s.store.evict_caches()
        done = split_on_first_decode(pkg, s)
        got[pkg.name] = int(str(s.execute(sql).rows[0][0].val))
        assert done and len(s.store.cluster.regions()) == 2
    assert got["port"] == want
    # the reference answers without the split-off half (ROADMAP §3)
    assert got["jax"] < want


def test_region_snapshot_is_a_copy():
    from tidb_tpu_torch.store.region import Cluster

    c = Cluster()
    snap = c.region_snapshot(1)
    c.split(b"m")
    live = c.region_by_id(1)
    assert (snap.end_key, snap.epoch) != (live.end_key, live.epoch) and live.end_key == b"m"
    assert c.region_snapshot(999) is None
