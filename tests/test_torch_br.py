"""BR and point-in-time recovery of the port (tidb_tpu_torch/tools/br.py,
tidb_tpu_torch/br/) on the CPU.

- The six BR cases of tests/test_tools.py (test_backup_restore_roundtrip
  through test_backup_restore_views) over a port `Session(device="cpu")`.
- The cases of tests/test_pitr.py but test_pitr_chaos_storm_acceptance,
  which runs over the port's tidb_tpu_torch/tools/chaos.py in
  tests/test_torch_storms.py (as does tests/test_cdc.py's
  test_resume_after_stall_redelivers_exactly_once_in_order): log backup as a raw
  changefeed with atomic segments, RESTORE ... UNTIL TS with typed gaps
  and a resumable replay checkpoint, the GC safepoint, the pd.pitr phase.
- Parity: the same statements on one thread through both packages give
  equal full-backup manifests (schema, views, snapshot ts, segment
  SHA-256s) and equal log-backup segments; each package restores the
  other's backup and answers the same SELECTs.
- The cache traps of the port, whose decoded-region, device-batch and
  result caches are keyed by data version: a table read, dropped, restored
  and read again answers the restored rows, and a read after a PITR replay
  sees the replayed rows.

Tolerance: exact.
"""

import json
import os
import sys

import pytest

from tidb_tpu_torch.br import (
    LogGapError,
    ReplayInterrupted,
    log_backup_views,
    restore_until,
    start_log_backup,
)
from tidb_tpu_torch.codec import tablecodec
from tidb_tpu_torch.sql.catalog import Catalog
from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.store import TPUStore
from tidb_tpu_torch.util import failpoint, metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def make_session():
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))")
    return s


def rows_of(s, table="t"):
    return s.execute(f"SELECT * FROM {table} ORDER BY 1").values()


def pitr_cluster(tmp_path, n=6):
    """Session + full backup + attached log backup under tmp_path; n
    seed rows land BEFORE the full backup."""
    s = make_session()
    if n:
        s.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{i * 10},'r{i}')" for i in range(n)))
    root = str(tmp_path / "bk")
    s.execute(f"BACKUP DATABASE * TO '{os.path.join(root, 'full', 'b0')}'")
    s.execute(f"BACKUP LOG TO 'file://{root}'")
    return s, root


@pytest.fixture()
def sess():
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT, name VARCHAR(16))")
    s.execute("CREATE UNIQUE INDEX uv ON t (v)")
    s.execute("INSERT INTO t VALUES (1,10,'a'),(2,20,'b,c'),(3,NULL,NULL)")
    return s


# ---------------------------------------------------------------- backup/restore


def test_backup_restore_roundtrip(sess, tmp_path):
    bdir = str(tmp_path / "bk")
    r = sess.execute(f"BACKUP DATABASE * TO '{bdir}'")
    assert r.columns == ["Destination", "Keys", "SnapshotTS"]
    store2, cat2 = TPUStore(device="cpu"), Catalog()
    s2 = Session(store2, cat2)
    r2 = s2.execute(f"RESTORE DATABASE * FROM '{bdir}'")
    assert r2.values()[0][2] == 1  # one table
    assert s2.execute("SELECT id, v, name FROM t ORDER BY id").values() == \
        sess.execute("SELECT id, v, name FROM t ORDER BY id").values()
    # index + autoid survive
    assert s2.execute("SELECT id FROM t WHERE v = 20").values() == [[2]]
    s2.execute("INSERT INTO t (v, name) VALUES (77, 'new')")
    assert s2.execute("SELECT max(id) FROM t").values() == [[4]]


def test_restore_rejects_existing_table(sess, tmp_path):
    bdir = str(tmp_path / "bk")
    sess.execute(f"BACKUP DATABASE * TO '{bdir}'")
    with pytest.raises(Exception, match="already exists"):
        sess.execute(f"RESTORE DATABASE * FROM '{bdir}'")


def test_restore_detects_corruption(sess, tmp_path):
    bdir = tmp_path / "bk"
    sess.execute(f"BACKUP DATABASE * TO '{bdir}'")
    seg = json.load(open(bdir / "manifest.json"))["segments"][0]["file"]
    data = bytearray((bdir / seg).read_bytes())
    data[-1] ^= 0xFF
    (bdir / seg).write_bytes(bytes(data))
    s2 = Session(TPUStore(device="cpu"), Catalog())
    with pytest.raises(Exception, match="checksum"):
        s2.execute(f"RESTORE DATABASE * FROM '{bdir}'")


def test_backup_resume_skips_valid_segments(sess, tmp_path):
    from tidb_tpu_torch.tools import backup

    bdir = str(tmp_path / "bk")
    m1 = backup(sess.store, sess.catalog, bdir)
    m2 = backup(sess.store, sess.catalog, bdir)  # second run: resume path
    assert [s["sha256"] for s in m1["segments"]] == [s["sha256"] for s in m2["segments"]]


def test_brie_requires_super(sess, tmp_path):
    sess.execute("CREATE USER 'u'")
    store, cat = sess.store, sess.catalog
    u = Session(store, cat)
    u.user = "u"
    with pytest.raises(SQLError, match="SUPER"):
        u.execute(f"BACKUP DATABASE * TO '{tmp_path}/x'")


def test_backup_restore_views(sess, tmp_path):
    sess.execute("CREATE VIEW v_hi AS SELECT id, v FROM t WHERE v >= 20")
    bdir = str(tmp_path / "bk")
    sess.execute(f"BACKUP DATABASE * TO '{bdir}'")
    s2 = Session(TPUStore(device="cpu"), Catalog())
    s2.execute(f"RESTORE DATABASE * FROM '{bdir}'")
    assert s2.execute("SELECT id FROM v_hi ORDER BY id").values() == [[2]]


# ------------------------------------------------------------- log backup

class TestLogBackup:
    def test_sql_lifecycle_and_show(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        row = s.execute("SHOW BACKUP LOGS").values()[0]
        assert row[0] == f"file://{root}" and row[2] == "normal"
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.store.pd.tick()  # the pd.cdc phase drives the raw feed
        row = s.execute("SHOW BACKUP LOGS").values()[0]
        assert row[6] >= 1 and row[7] >= 1  # segments, events
        assert row[4] >= s.store.kv.max_committed()  # checkpoint caught up
        with pytest.raises(SQLError):  # second attach to the same dest
            s.execute(f"BACKUP LOG TO 'file://{root}'")
        s.execute(f"STOP BACKUP LOG TO 'file://{root}'")
        assert s.execute("SHOW BACKUP LOGS").values() == []
        with pytest.raises(SQLError):
            s.execute(f"STOP BACKUP LOG TO 'file://{root}'")

    def test_segments_chain_and_end_in_resolved_marks(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        for i in range(3):
            s.execute(f"INSERT INTO t VALUES ({60 + i}, {i}, 'w')")
            s.store.pd.tick()
        man = json.loads(open(os.path.join(root, "log", "manifest.json")).read())
        segs = man["segments"]
        assert len(segs) >= 2
        prev_resolved = 0
        for seg in segs:
            # the chain: each link starts where the previous segment ended
            assert seg["base_ts"] == prev_resolved
            assert seg["min_ts"] > seg["base_ts"]
            assert seg["max_ts"] <= seg["resolved_ts"]
            prev_resolved = seg["resolved_ts"]
            lines = open(os.path.join(root, "log", seg["file"])).read().splitlines()
            last = json.loads(lines[-1])
            assert last == {"t": "resolved", "ts": seg["resolved_ts"]}
            assert sum(1 for ln in lines if json.loads(ln).get("t") == "kv") == seg["events"]
        assert man["checkpoint_ts"] >= prev_resolved

    def test_reattach_resumes_chain_without_duplicates(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.store.pd.tick()
        s.execute(f"STOP BACKUP LOG TO 'file://{root}'")
        s.execute("INSERT INTO t VALUES (51, 2, 'y')")  # while detached
        s.execute(f"BACKUP LOG TO 'file://{root}'")  # re-attach resumes
        s.store.pd.tick()
        lb = next(iter(s.store.log_backups.values()))
        seen = set()
        for rec in lb.sink.writer.read_records():
            if rec.get("t") != "kv":
                continue
            assert (rec["k"], rec["ts"]) not in seen
            seen.add((rec["k"], rec["ts"]))
        # the detach-window write was recovered by the incremental scan
        assert lb.sink.checkpoint_ts >= s.store.kv.max_committed()
        until = s.store.next_ts()
        s.store.pd.tick()  # the checkpoint must pass the cut to prove it
        r = Session(device="cpu")
        r.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {until}")
        assert rows_of(r) == rows_of(s)

    def test_checkpoint_slides_the_gc_safepoint(self, tmp_path):
        s, root = pitr_cluster(tmp_path, n=0)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.execute("UPDATE t SET v = 11 WHERE id = 1")  # two versions
        key = tablecodec.encode_row_key(s.catalog.table("t").table_id, 1)
        s.store.run_gc(safepoint=s.store.kv.max_committed() + 1)
        with s.store.kv.lock:
            n_held = len(s.store.kv._data.get(key, ()))
        assert n_held == 2  # the feed's safepoint pinned the old version
        s.store.pd.tick()  # flush: the checkpoint (and safepoint) slide
        s.store.run_gc(safepoint=s.store.kv.max_committed() + 1)
        with s.store.kv.lock:
            n_after = len(s.store.kv._data.get(key, ()))
        assert n_after == 1  # released: GC may fold history the log holds


# -------------------------------------------------------- replay-to-ts

class TestRestoreUntil:
    def test_restore_to_mid_ts_is_byte_exact(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.execute("UPDATE t SET v = 2 WHERE id = 50")
        s.store.pd.tick()
        mid_ts = s.store.next_ts()
        oracle_mid = rows_of(s)
        s.execute("DELETE FROM t WHERE id = 0")
        s.execute("INSERT INTO t VALUES (51, 3, 'y')")
        s.store.pd.tick()
        end_ts = s.store.next_ts()
        oracle_end = rows_of(s)
        s.store.pd.tick()  # the checkpoint must pass end_ts to prove it

        r1 = Session(device="cpu")
        res = r1.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {mid_ts}")
        assert rows_of(r1) == oracle_mid  # no id=51, no delete, v=2
        assert int(res.values()[0][1]) == mid_ts
        r2 = Session(device="cpu")
        r2.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {end_ts}")
        assert rows_of(r2) == oracle_end
        # the restored cluster is live: TSO moved past the cut
        r2.execute("INSERT INTO t VALUES (99, 9, 'z')")
        assert len(rows_of(r2)) == len(oracle_end) + 1

    def test_ddl_replays_through_the_feed_to_the_right_cut(self, tmp_path):
        s, root = pitr_cluster(tmp_path, n=2)
        s.store.pd.tick()
        pre_ddl_ts = s.store.next_ts()
        pre_rows = rows_of(s)
        s.execute("ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 7")
        s.execute("INSERT INTO t VALUES (50, 1, 'x', 8)")
        s.store.pd.tick()
        post_ddl_ts = s.store.next_ts()
        post_rows = rows_of(s)
        s.store.pd.tick()  # the checkpoint must pass post_ddl_ts

        r_old = Session(device="cpu")
        r_old.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {pre_ddl_ts}")
        assert rows_of(r_old) == pre_rows  # 3-column shape: DDL not yet
        assert len(r_old.catalog.table("t").columns) == 3
        r_new = Session(device="cpu")
        r_new.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {post_ddl_ts}")
        assert rows_of(r_new) == post_rows  # old rows backfill w=7
        assert [c.name for c in r_new.catalog.table("t").columns][-1] == "w"

    def test_log_gap_is_typed_never_silently_short(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        for i in range(3):
            s.execute(f"INSERT INTO t VALUES ({60 + i}, {i}, 'w')")
            s.store.pd.tick()
        until = s.store.next_ts()
        g0 = metrics.PITR_LOG_GAPS.value
        r = Session(device="cpu")
        failpoint.enable("br/log-gap", 1)
        try:
            with pytest.raises(LogGapError) as ei:
                restore_until(r.store, r.catalog, root, until)
        finally:
            failpoint.disable("br/log-gap")
        assert ei.value.covered_ts < ei.value.target_ts == until
        assert metrics.PITR_LOG_GAPS.value > g0
        # the SQL surface maps it to a typed SQLError, same failpoint
        failpoint.enable("br/log-gap", 1)
        try:
            with pytest.raises(SQLError):
                Session(device="cpu").execute(
                    f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {until}")
        finally:
            failpoint.disable("br/log-gap")

    def test_restore_past_log_end_is_typed(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.store.pd.tick()
        beyond = s.store.next_ts() + 100_000  # no log covers this
        with pytest.raises(LogGapError):
            r = Session(device="cpu")
            restore_until(r.store, r.catalog, root, beyond)

    def test_no_full_backup_under_ts_is_typed(self, tmp_path):
        s = make_session()
        root = str(tmp_path / "bk")
        s.execute(f"BACKUP LOG TO 'file://{root}'")  # log only, no full
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.pd.tick()
        r = Session(device="cpu")
        with pytest.raises(LogGapError):
            restore_until(r.store, r.catalog, root, s.store.next_ts())

    def test_replay_crash_resumes_idempotently(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        for i in range(3):  # several segments so the crash lands mid-chain
            s.execute(f"INSERT INTO t VALUES ({60 + i}, {i}, 'w')")
            s.store.pd.tick()
        until = s.store.next_ts()
        oracle = rows_of(s)
        s.store.pd.tick()  # the checkpoint must pass the cut to prove it
        r = Session(device="cpu")
        r0 = metrics.PITR_REPLAY_RESUMES.value
        failpoint.enable("restore/replay-crash", 1)
        try:
            with pytest.raises(ReplayInterrupted):
                restore_until(r.store, r.catalog, root, until)
        finally:
            failpoint.disable("restore/replay-crash")
        ckpt = os.path.join(root, f"restore-ckpt-{until}.json")
        assert os.path.exists(ckpt)  # the per-segment checkpoint survived
        rep = restore_until(r.store, r.catalog, root, until)
        assert rep["resumed"] is True
        assert metrics.PITR_REPLAY_RESUMES.value > r0
        assert rows_of(r) == oracle  # re-run is idempotent, not doubled
        assert not os.path.exists(ckpt)  # done: a fresh run starts clean


# ----------------------------------------- atomic segments (satellite 1)

class TestKillMidFlush:
    def test_kill_mid_flush_leaves_no_torn_tail(self, tmp_path):
        """The torn-tail crash this PR fixes: a kill between tmp write
        and rename must leave NOTHING a consumer reads — and the
        re-queued window must land exactly once after RESUME."""
        from tidb_tpu_torch.cdc import FileSink

        s = make_session()
        s.execute(f"CREATE CHANGEFEED cf INTO 'file://{tmp_path}/out' FOR TABLE t WITH start_ts = 0")
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        failpoint.enable("cdc/segment-crash", 1)
        s.store.cdc.tick()
        feed = s.store.cdc.get("cf")
        assert feed.view(s.store)["state"] == "error"
        sink_dir = f"{tmp_path}/out/cf"
        assert any(f.endswith(".tmp") for f in os.listdir(sink_dir))
        recs = FileSink(f"{tmp_path}/out", "cf").read_records()
        assert recs == []  # the torn tmp is invisible, not a broken read
        s.store.cdc.resume("cf")
        s.store.cdc.tick()
        assert feed.view(s.store)["state"] == "normal"
        recs = FileSink(f"{tmp_path}/out", "cf").read_records()
        assert sum(1 for r in recs if r.get("type") == "row") == 1  # once


# --------------------------------- snapshot backup safepoint (satellite 2)

class TestSnapshotBackupSafepoint:
    def test_backup_and_restore_pin_then_release(self, tmp_path, monkeypatch):
        from tidb_tpu_torch.tools import backup, restore

        s = make_session()
        s.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b')")
        calls = []
        orig_reg, orig_unreg = s.store.register_snapshot, s.store.unregister_snapshot
        monkeypatch.setattr(s.store, "register_snapshot",
                            lambda ts: (calls.append(("reg", ts)), orig_reg(ts))[1])
        monkeypatch.setattr(s.store, "unregister_snapshot",
                            lambda ts: (calls.append(("unreg", ts)), orig_unreg(ts))[1])
        bdir = str(tmp_path / "full")
        backup(s.store, s.catalog, bdir)
        assert ("reg", calls[0][1]) in calls and ("unreg", calls[0][1]) in calls
        with s.store._tso_lock:
            assert calls[0][1] not in s.store._active_snapshots  # released
        calls.clear()
        r = Session(device="cpu")
        rcalls = []
        r_reg, r_unreg = r.store.register_snapshot, r.store.unregister_snapshot
        monkeypatch.setattr(r.store, "register_snapshot",
                            lambda ts: (rcalls.append(("reg", ts)), r_reg(ts))[1])
        monkeypatch.setattr(r.store, "unregister_snapshot",
                            lambda ts: (rcalls.append(("unreg", ts)), r_unreg(ts))[1])
        restore(r.store, r.catalog, bdir)
        assert [c[0] for c in rcalls] == ["reg", "unreg"]
        assert rows_of(r) == rows_of(s)


# ------------------------------------------------------ surfaces + metrics

class TestSurfaces:
    def test_pd_tick_has_pitr_phase(self, tmp_path):
        s, _root = pitr_cluster(tmp_path, n=1)
        s.store.pd.tick()
        root = s.store.pd.last_tick_root
        assert any(c.name == "pd.pitr" for c in root.children)

    def test_pitr_tick_trims_the_schema_journal(self, tmp_path):
        s, _root = pitr_cluster(tmp_path, n=1)
        s.execute("ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 7")
        assert len(s.store.schema_journal) == 1
        s.store.pd.tick()  # checkpoint passes the DDL; pd.pitr trims below
        assert len(s.store.schema_journal) == 0

    def test_metric_families_pass_scrape_check(self, tmp_path):
        from scrape_check import validate

        s, root = pitr_cluster(tmp_path)
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.store.pd.tick()
        until = s.store.next_ts()
        s.store.pd.tick()
        r = Session(device="cpu")
        restore_until(r.store, r.catalog, root, until)
        text = metrics.REGISTRY.dump()
        for family in (
            "tidb_tpu_log_backup_segments_total",
            "tidb_tpu_log_backup_events_total",
            "tidb_tpu_log_backup_checkpoint_ts",
            "tidb_tpu_log_backup_resolved_lag",
            "tidb_tpu_pitr_restores_total",
            "tidb_tpu_pitr_segments_replayed_total",
            "tidb_tpu_pitr_replayed_events_total",
            "tidb_tpu_cdc_schema_events_total",
        ):
            assert f"# TYPE {family}" in text, family
        assert 'tidb_tpu_log_backup_checkpoint_ts{changefeed="log-backup:' in text
        assert validate(text) == []

    def test_views_surface(self, tmp_path):
        s, root = pitr_cluster(tmp_path)
        s.execute("INSERT INTO t VALUES (50, 1, 'x')")
        s.store.pd.tick()
        v = log_backup_views(s.store)[0]
        assert v["destination"] == f"file://{root}"
        assert v["state"] == "normal" and v["resolved_lag"] == 0
        assert v["segments"] >= 1 and v["events"] >= 1


# ------------------------------------------------------ parity with the JAX package

HISTORY = [
    "CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))",
    "CREATE TABLE u (id INT PRIMARY KEY AUTO_INCREMENT, d DECIMAL(9,2), f DOUBLE, "
    "dt DATETIME, s VARCHAR(8) DEFAULT 'z', UNIQUE KEY ud (d))",
    "INSERT INTO t VALUES " + ",".join(f"({i},{i * 10},'r{i}')" for i in range(40)),
    "INSERT INTO u (d, f, dt) VALUES (1.25, 0.1, '2024-01-02 03:04:05'), (-7.50, 1e300, NULL), (NULL, NULL, '1999-12-31 23:59:59')",
    "UPDATE t SET v = v + 1 WHERE id < 5",
    "DELETE FROM t WHERE id = 7",
    "CREATE VIEW vt AS SELECT id, v FROM t WHERE v > 100",
    "ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 3",
]
AFTER = [
    "INSERT INTO t VALUES (100, 1, 'late', 9)",
    "UPDATE u SET s = 'y' WHERE id = 2",
    "DELETE FROM t WHERE id = 0",
]
ANSWERS = [
    "SELECT * FROM t ORDER BY id", "SELECT * FROM u ORDER BY id",
    "SELECT sum(v), count(*), max(w) FROM t", "SELECT id FROM vt ORDER BY id",
    "SELECT id FROM u WHERE d = 1.25",
]


def _session(pkg):
    import tidb_tpu.sql as j_sql

    s = j_sql.Session() if pkg == "jax" else Session(device="cpu")
    s.execute("SET tidb_enable_tpu_mesh = 0")
    return s


def _answers(s):
    return [[[None if v is None else str(v) for v in row] for row in s.execute(q).values()]
            for q in ANSWERS]


def _with_pitr(pkg, root):
    """One package's history: a full backup under <root>/full/b0, a log
    backup on <root>, then AFTER with a PD tick each; returns the session
    and the cut ts before and after AFTER."""
    s = _session(pkg)
    for q in HISTORY:
        s.execute(q)
    s.execute(f"BACKUP DATABASE * TO '{os.path.join(root, 'full', 'b0')}'")
    s.execute(f"BACKUP LOG TO 'file://{root}'")
    s.store.pd.tick()
    before = s.store.next_ts()
    for q in AFTER:
        s.execute(q)
        s.store.pd.tick()
    after = s.store.next_ts()
    s.store.pd.tick()
    return s, before, after


def test_backups_equal_the_jax_package(tmp_path):
    """The same single-thread history: equal full-backup manifests (schema,
    views, snapshot ts, key counts, segment names and SHA-256s), equal
    segment bytes, and equal log-backup manifests and segments."""
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        _with_pitr(pkg, root)
        full = os.path.join(root, "full", "b0")
        man = json.load(open(os.path.join(full, "manifest.json")))
        segs = {f: open(os.path.join(full, f), "rb").read() for f in sorted(os.listdir(full)) if f.endswith(".bak")}
        log = json.load(open(os.path.join(root, "log", "manifest.json")))
        out[pkg] = (man, segs, log)
    j, p = out["jax"], out["port"]
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert p[0]["segments"] and p[0]["total_keys"] > 40
    assert [s["sha256"] for s in p[2]["segments"]] == [s["sha256"] for s in j[2]["segments"]]
    assert p[2] == j[2]
    assert len(p[2]["segments"]) >= len(AFTER)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_restore(tmp_path, direction):
    """Each package restores the other's full backup, and replays the
    other's log to a cut: the SELECT answers equal the source's at that
    cut."""
    src_pkg, dst_pkg = direction.split("_to_")
    root = str(tmp_path / "bk")
    src, before, after = _with_pitr(src_pkg, root)
    dst = _session(dst_pkg)
    dst.execute(f"RESTORE DATABASE * FROM '{os.path.join(root, 'full', 'b0')}'")
    ref = _session(src_pkg)
    ref.execute(f"RESTORE DATABASE * FROM '{os.path.join(root, 'full', 'b0')}'")
    assert _answers(dst) == _answers(ref)
    for cut in (before, after):
        dst = _session(dst_pkg)
        dst.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {cut}")
        src.execute(f"SET tidb_snapshot = '{cut}'")
        want = _answers(src)
        src.execute("SET tidb_snapshot = ''")
        assert _answers(dst) == want, cut
    assert _answers(dst) == _answers(src)


# ------------------------------------------------------------ the cache traps

def sum_count(s):
    return [int(str(v)) for v in s.execute("SELECT sum(v), count(*) FROM t").values()[0]]


def test_restore_after_drop_answers_the_restored_rows(tmp_path):
    """A table read (decoded region and device batch cached), written,
    dropped and restored from a backup taken before the write: the next
    read answers the restored rows, not the cached ones. It equals the
    JAX package's answer to the same history and the port's own answer
    with every cache dropped. (DROP TABLE leaves the table's keys in KV in
    both packages, and RESTORE recreates the table under its original id,
    so a row inserted after the backup shows again beside the restored
    ones.)"""
    history = [
        "CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))",
        "INSERT INTO t VALUES " + ",".join(f"({i},{i * 10},'r{i}')" for i in range(32)),
        "BACKUP DATABASE * TO '{bdir}'",
        "INSERT INTO t VALUES (100, 1, 'late')",
        "UPDATE t SET v = -1 WHERE id < 8",
        "SELECT sum(v), count(*) FROM t",
        "DROP TABLE t",
        "RESTORE DATABASE * FROM '{bdir}'",
    ]
    got = {}
    for pkg in ("jax", "port"):
        s = _session(pkg)
        bdir = str(tmp_path / pkg)
        for q in history:
            s.execute(q.format(bdir=bdir))
            if pkg == "port" and q.startswith("SELECT"):
                cached = sum_count(s)
                assert s.store.stats()["device_uploads"] >= 1 and s.store._batch_cache
        got[pkg] = (sum_count(s), [[str(v) for v in r] for r in rows_of(s)])
    assert got["port"][0] != cached
    assert got["port"] == got["jax"]
    assert got["port"][0] == [sum(i * 10 for i in range(32)) + 1, 33]
    s.store.evict_caches()
    s.store.clear_result_cache()
    assert sum_count(s) == got["port"][0]


def test_read_after_replay_sees_the_replayed_rows(tmp_path):
    """A PITR replay writes raw bytes at their source commit ts. A read
    between a crashed replay and its resume caches the partial state; the
    resumed replay must leave no cached answer behind."""
    s, root = pitr_cluster(tmp_path, n=8)
    for i in range(3):
        s.execute(f"INSERT INTO t VALUES ({60 + i}, {i}, 'w')")
        s.execute(f"UPDATE t SET v = v + 100 WHERE id = {i}")
        s.store.pd.tick()
    until = s.store.next_ts()
    want = sum_count(s)
    s.store.pd.tick()
    r = Session(device="cpu")
    failpoint.enable("restore/replay-crash", 1)
    try:
        with pytest.raises(ReplayInterrupted):
            restore_until(r.store, r.catalog, root, until)
    finally:
        failpoint.disable("restore/replay-crash")
    partial = sum_count(r)
    assert partial != want  # the crash left the replay short
    restore_until(r.store, r.catalog, root, until)
    assert sum_count(r) == want
    assert rows_of(r) == rows_of(s)
