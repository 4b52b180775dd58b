"""The PyTorch port stands alone: no module of tidb_tpu_torch imports jax
or anything of the JAX package (tidb_tpu), importing it leaves jax
unloaded, and its entry points refuse a CUDA device that is not there
rather than quietly running on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tidb_tpu_torch

PKG = Path(tidb_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "tidb_tpu")


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")))
def test_module_imports_no_jax_and_no_jax_package(path):
    bad = [m for m in _imported_modules(REPO / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    bad = [m for m in _imported_modules(REPO / "chip_smoke.py") if _forbidden(m)]
    assert not bad


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import tidb_tpu_torch, tidb_tpu_torch.exec, tidb_tpu_torch.ops.dense_agg\n"
        "import tidb_tpu_torch.interop, tidb_tpu_torch.workloads, tidb_tpu_torch.kernels\n"
        "import tidb_tpu_torch.ops.join, tidb_tpu_torch.ops.joinagg, tidb_tpu_torch.ops.joinscan\n"
        "import tidb_tpu_torch.ops.join_probe, tidb_tpu_torch.ops.radix_join\n"
        "import tidb_tpu_torch.ops.topn, tidb_tpu_torch.ops.window\n"
        "import tidb_tpu_torch.distsql, tidb_tpu_torch.util.metrics\n"
        "import tidb_tpu_torch.distsql.planner, tidb_tpu_torch.distsql.runaway, tidb_tpu_torch.topsql\n"
        "import tidb_tpu_torch.util.backoff, tidb_tpu_torch.util.failpoint, tidb_tpu_torch.util.tracing\n"
        "import tidb_tpu_torch.parser, tidb_tpu_torch.sql, tidb_tpu_torch.store.txn, tidb_tpu_torch.config\n"
        "import tidb_tpu_torch.server, tidb_tpu_torch.tools, tidb_tpu_torch.util.memory, tidb_tpu_torch.util.stmtlog\n"
        "import tidb_tpu_torch.parallel, tidb_tpu_torch.parallel.sql, tidb_tpu_torch.parallel.joinmesh\n"
        "import tidb_tpu_torch.mpp.exchange_op, tidb_tpu_torch.mpp.dispatch, tidb_tpu_torch.mpp.fragment\n"
        "import tidb_tpu_torch.replication, tidb_tpu_torch.pd, tidb_tpu_torch.pd.schedulers\n"
        "import tidb_tpu_torch.background, tidb_tpu_torch.interop\n"
        "import tidb_tpu_torch.server.server, tidb_tpu_torch.server.client, tidb_tpu_torch.server.http_api\n"
        "import tidb_tpu_torch.server.coalesce, tidb_tpu_torch.server.protocol\n"
        "import tidb_tpu_torch.br, tidb_tpu_torch.br.pitr, tidb_tpu_torch.tools.br\n"
        "import tidb_tpu_torch.cdc, tidb_tpu_torch.columnar\n"
        "import tidb_tpu_torch.analysis, tidb_tpu_torch.analysis.common, tidb_tpu_torch.analysis.guards\n"
        "import tidb_tpu_torch.analysis.lockwatch, tidb_tpu_torch.tools.chaos\n"
        "import tidb_tpu_torch.analysis.dataflow, tidb_tpu_torch.analysis.progaudit, tidb_tpu_torch.tools.vet\n"
        "from tidb_tpu_torch import analysis; analysis.PASSES\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch import workloads as W
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.chunk.device import to_device_batch
    from tidb_tpu_torch.exec import run_dag_on_chunk, run_dag_on_chunks
    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X
    from tidb_tpu_torch.interop import device_batch_from_numpy

    _no_cuda(monkeypatch)
    dag, fts = W.q6_dag(E, X, T)
    cols = W.q6_columns(W.make_tables(16))
    chunk = W.make_chunk(__import__("tidb_tpu_torch.chunk", fromlist=["Chunk"]), fts, cols)
    assert isinstance(chunk, Chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device_batch(chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_batch_from_numpy(cols, np.ones(16, bool), 16, fts)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dag_on_chunk(dag, chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dag_on_chunks(dag, [chunk])
    # asked for explicitly, the CPU runs
    out = run_dag_on_chunk(dag, chunk, device="cpu")
    assert out.num_rows() == 1
    out = run_dag_on_chunks(dag, [chunk], device="cpu")
    assert out.num_rows() == 1


@pytest.mark.parametrize("dag_kind", ["spill", "host_only"])
def test_run_dag_on_chunks_fallbacks_do_not_catch_the_no_cuda_error(dag_kind, monkeypatch):
    """run_dag_on_chunks catches OverflowRetryError (spill, then the
    oracle) and NotImplementedError (the oracle); the no-CUDA error is
    neither and propagates, from the first pass and from inside a spill
    (the device passes through every recursive call)."""
    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X
    from tidb_tpu_torch import chunk as C
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch.exec import executor

    LL = T.new_longlong()
    scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    agg_name = "count" if dag_kind == "spill" else "group_concat"
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc(agg_name, (X.col(1, LL),)),))
    dag = E.DAGRequest((scan, agg), output_offsets=(0, 1))
    chunk = C.Chunk.from_rows([LL, LL], [[T.Datum.i64(i % 7), T.Datum.i64(i)] for i in range(40)])
    assert executor.run_dag_on_chunks(dag, [chunk], device="cpu").num_rows() == 7  # device or oracle
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.run_dag_on_chunks(dag, [chunk])
    if dag_kind == "spill":
        # the first pass runs on the CPU and "overflows"; each spill part
        # then asks for the card
        real_drive, real_batch = executor.drive_program, executor.to_device_batch
        overflowed = []

        def drive(*a, **k):
            if not overflowed:
                overflowed.append(True)
                raise executor.OverflowRetryError("forced")
            return real_drive(*a, **k)

        def batch(c, capacity, device):
            return real_batch(c, capacity=capacity, device=device if overflowed else "cpu")

        monkeypatch.setattr(executor, "drive_program", drive)
        monkeypatch.setattr(executor, "to_device_batch", batch)
        with pytest.raises(RuntimeError, match="CUDA") as ei:
            executor.run_dag_on_chunks(dag, [chunk])
        assert not isinstance(ei.value, executor.OverflowRetryError)
        assert overflowed == [True]


@pytest.mark.parametrize("exc", [RuntimeError("kernel build failed: nvcc exited 1"),
                                 ValueError("kernel input must be a CUDA tensor")], ids=["build", "launch"])
def test_run_dag_on_chunks_lets_kernel_errors_through(exc, monkeypatch):
    """A kernel's build or launch failure is not a fallback case: neither
    the spill nor the oracle answers in its place."""
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch import workloads as W
    from tidb_tpu_torch.exec import executor
    import tidb_tpu_torch.chunk as C
    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X

    def fail(*a, **k):
        raise exc

    dag, fts = W.q6_dag(E, X, T)
    chunk = W.make_chunk(C, fts, W.q6_columns(W.make_tables(16)))
    monkeypatch.setattr(executor, "drive_program", fail)
    with pytest.raises(type(exc), match="kernel") as ei:
        executor.run_dag_on_chunks(dag, [chunk], device="cpu")
    assert ei.value is exc


@pytest.mark.parametrize("which", ["q3", "join_bench"])
def test_join_workloads_default_to_cuda_and_raise_without_it(which, monkeypatch):
    from tidb_tpu_torch import chunk as C
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch import workloads as W
    from tidb_tpu_torch.exec import run_dag_on_chunks
    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X
    from tidb_tpu_torch.interop import device_batch_from_numpy

    _no_cuda(monkeypatch)
    if which == "q3":
        dag, fts = W.q3_dag(E, X, T)
        cols = W.q3_columns(256)
    else:
        dag, fts = W.join_bench_dag(E, X, T)
        cols = W.join_bench_columns(256, 32, False)
    chunks = [W.make_chunk(C, f, c) for c, f in zip(cols, fts)]
    with pytest.raises(RuntimeError, match="CUDA"):
        device_batch_from_numpy(cols[0], np.ones(len(cols[0][0][0]), bool), len(cols[0][0][0]), fts[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dag_on_chunks(dag, chunks)
    out = run_dag_on_chunks(dag, chunks, device="cpu")
    assert out.num_rows() >= 1


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; on any other
    device it launches its kernel (CUDA) or raises."""
    from tidb_tpu_torch.ops.join_probe import probe_tables
    from tidb_tpu_torch.ops.joinscan import membership_segscan, postsort_segscan

    m = torch.empty(8, dtype=torch.int32, device="meta")
    b = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        postsort_segscan(m, [m], b)
    with pytest.raises(ValueError, match="unsupported device"):
        membership_segscan(m, b)
    k = torch.empty((2, 8), dtype=torch.int64, device="meta")
    ok = torch.empty((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probe_tables(k, ok, k, ok)


def test_kernel_builds_land_in_an_ignored_directory():
    from tidb_tpu_torch import kernels

    assert set(kernels.SOURCES) == {"dense_agg", "joinscan", "join_probe"}
    for src in kernels.SOURCES.values():
        assert (PKG / src).is_file()
    assert kernels.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_a_session_leaves_jax_unloaded(tmp_path):
    """The SQL session's lazy imports (inside its functions) run too: DDL,
    DML in a transaction, a join, a window, a subquery, PREPARE / EXECUTE,
    LOAD DATA, ANALYZE, SHOW CREATE TABLE and EXPLAIN on the CPU."""
    csv = tmp_path / "rows.csv"
    csv.write_text("7,2\n8,4\n")
    stmts = [
        "CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)", "BEGIN", "INSERT INTO t VALUES (1, 2), (2, 3)",
        "UPDATE t SET b = b + 1 WHERE a = 1", "COMMIT", "SELECT x.a, y.b FROM t x JOIN t y ON x.a = y.a",
        "SELECT a, row_number() OVER (ORDER BY b) FROM t", "SELECT a FROM t WHERE b IN (SELECT b FROM t)",
        "PREPARE p FROM 'SELECT b FROM t WHERE a = ?'", "SET @x = 1", "EXECUTE p USING @x",
        f"LOAD DATA INFILE '{csv}' INTO TABLE t FIELDS TERMINATED BY ','", "ANALYZE TABLE t",
        "SHOW CREATE TABLE t", "EXPLAIN SELECT sum(b) FROM t",
    ]
    code = (
        "import sys\n"
        "from tidb_tpu_torch.sql import Session\n"
        "s = Session(device='cpu')\n"
        f"for q in {stmts!r}:\n"
        "    s.execute(q)\n"
        "assert s.execute('SELECT count(*) FROM t').scalar() == 4\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("how", ["no_args", "store_none"])
def test_session_defaults_to_cuda_and_raises_without_it(how, monkeypatch):
    from tidb_tpu_torch.sql import Session

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session() if how == "no_args" else Session(store=None)
    s = Session(device="cpu")
    assert s.store.device.type == "cpu"


def test_brie_statements_run_through_sql(tmp_path):
    """BACKUP, RESTORE, BACKUP LOG, STOP BACKUP LOG and RESTORE ... UNTIL
    TS succeed through the port's SQL, with the statement tiers and the
    columnar engine switched on, and an error of a statement itself still
    reaches the caller."""
    from tidb_tpu_torch.sql import CatalogError, PlanError, Session

    s = Session(device="cpu")
    for q in ("SET tidb_enable_tpu_mesh = 1", "SET tidb_allow_mpp = 1",
              "SET tidb_isolation_read_engines = 'tpu,columnar'"):
        s.execute(q)
    s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, g INT)")
    s.execute("INSERT INTO t VALUES (1, 1), (2, 1), (3, 2)")
    root = str(tmp_path / "bk")
    full = str(tmp_path / "bk" / "full" / "b0")
    r = s.execute(f"BACKUP DATABASE * TO '{full}'")
    assert r.columns == ["Destination", "Keys", "SnapshotTS"] and r.values()[0][1] > 0
    r = s.execute(f"BACKUP LOG TO 'file://{root}'")
    assert r.columns == ["Destination", "Changefeed", "StartTS"]
    assert [row[0] for row in s.execute("SHOW BACKUP LOGS").values()] == [f"file://{root}"]
    s.execute("INSERT INTO t VALUES (4, 2)")
    s.store.pd.tick()
    cut = s.store.next_ts()
    s.store.pd.tick()
    s.execute(f"STOP BACKUP LOG TO 'file://{root}'")
    assert s.execute("SHOW BACKUP LOGS").rows == []
    r1 = Session(device="cpu")
    assert r1.execute(f"RESTORE DATABASE * FROM '{full}'").values()[0][2] == 1
    assert r1.execute("SELECT g, count(*) FROM t GROUP BY g ORDER BY g").values() == [[1, 2], [2, 1]]
    r2 = Session(device="cpu")
    r = r2.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {cut}")
    assert r.columns == ["Source", "UntilTS", "Segments", "Events"] and r.values()[0][1] == cut
    assert r2.execute("SELECT g, count(*) FROM t GROUP BY g ORDER BY g").values() == [[1, 2], [2, 2]]
    with pytest.raises(CatalogError):
        s.execute("SELECT * FROM missing")
    with pytest.raises(PlanError):
        s.execute("SELECT nope FROM t")


@pytest.mark.parametrize("sql", [
    "BACKUP DATABASE * TO '{d}/x'", "RESTORE DATABASE * FROM '{d}/x'", "BACKUP LOG TO 'file://{d}/l'",
])
def test_brie_needs_super_as_in_the_jax_package(tmp_path, sql):
    """A user without SUPER gets the JAX package's access error, word for
    word, and the statement does nothing."""
    import tidb_tpu.sql as j_sql

    from tidb_tpu_torch.sql import Session, SQLError

    errs = []
    for s in (j_sql.Session(), Session(device="cpu")):
        s.execute("CREATE USER 'u'")
        u = type(s)(s.store, s.catalog)
        u.user = "u"
        with pytest.raises(Exception) as ei:
            u.execute(sql.format(d=tmp_path))
        errs.append((type(ei.value).__name__, getattr(ei.value, "code", None), str(ei.value)))
    assert errs[1] == errs[0]
    assert errs[1][0] == SQLError.__name__ and "SUPER" in errs[1][2]
    assert not os.path.exists(tmp_path / "x") and not os.path.exists(tmp_path / "l")


def test_mysql_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """MySQLServer() builds its store on "cuda": without CUDA it raises
    rather than serving from the CPU, and opens no socket."""
    from tidb_tpu_torch.server import MySQLServer

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        MySQLServer()
    srv = MySQLServer(device="cpu")
    try:
        assert srv.store.device.type == "cpu"
    finally:
        srv.close()


def test_mysql_server_device_must_name_its_store_device():
    """Given a store, MySQLServer serves on that store's device: a `device`
    that names another raises before a socket opens, and one that names
    the same device (or none) is accepted."""
    from tidb_tpu_torch.server import MySQLServer
    from tidb_tpu_torch.store import TPUStore

    store = TPUStore(device="cpu")
    with pytest.raises(ValueError, match="store's device"):
        MySQLServer(store=store, device="cuda")
    for device in (None, "cpu"):
        srv = MySQLServer(store=store, device=device)
        try:
            assert srv.store is store
        finally:
            srv.close()


def test_mesh_devices_resolve_to_cuda_and_raise_without_it(monkeypatch):
    """TPUStore() and Session() shard their mesh over every visible CUDA
    device by default, a cpu store over its own device; a cuda entry in
    mesh_devices raises without CUDA, as the store's own device does."""
    from tidb_tpu_torch import runtime
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.store import TPUStore

    assert TPUStore(device="cpu").mesh_devices == [torch.device("cpu")]
    assert TPUStore(device="cpu", mesh_devices=["cpu"] * 8).mesh_devices == [torch.device("cpu")] * 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert runtime.mesh_devices("cuda") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert runtime.mesh_devices("cuda", ["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPUStore()
    with pytest.raises(RuntimeError, match="CUDA"):
        TPUStore(device="cpu", mesh_devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(device="cpu", mesh_devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        runtime.mesh_devices("cpu", [])


def test_a_mesh_session_leaves_jax_unloaded():
    """The mesh paths' lazy imports run too: the store's mesh tier, the
    mesh select's grouped and join exchange programs, on four CPU shards."""
    code = (
        "import sys\n"
        "from tidb_tpu_torch.sql import Session\n"
        "from tidb_tpu_torch.util import metrics\n"
        "from tidb_tpu_torch.codec import tablecodec\n"
        "s = Session(device='cpu', mesh_devices=['cpu'] * 4)\n"
        "s.execute('CREATE TABLE t (a BIGINT PRIMARY KEY, g INT, v BIGINT)')\n"
        "s.execute('CREATE TABLE d (g INT PRIMARY KEY, name VARCHAR(8))')\n"
        "s.execute('INSERT INTO t VALUES ' + ','.join(f'({i}, {i % 5}, {i})' for i in range(64)))\n"
        "s.execute('INSERT INTO d VALUES ' + ','.join(f\"({g}, 'g{g}')\" for g in range(5)))\n"
        "tid = s.catalog.table('t').table_id\n"
        "for h in (16, 32, 48):\n"
        "    s.store.cluster.split(tablecodec.encode_row_key(tid, h))\n"
        "m0 = metrics.MESH_SELECTS.value\n"
        "assert len(s.execute('SELECT g, count(*) FROM t GROUP BY g').rows) == 5\n"
        "assert len(s.execute('SELECT name, sum(v) FROM t JOIN d ON t.g = d.g GROUP BY name').rows) == 5\n"
        "assert metrics.MESH_SELECTS.value == m0 + 2\n"
        "assert str(s.execute('SELECT sum(v) FROM t').scalar()) == '2016'\n"
        "assert s.store.stats()['mesh_batches'] >= 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_a_store_carries_its_control_plane():
    """TPUStore(device="cpu") attaches the placement driver and the
    replication manager, as the reference's store does; the cluster points
    back at both, and the transaction engine's write hooks are the store's
    quorum gate and write-flow recorders."""
    from tidb_tpu_torch.pd import PlacementDriver
    from tidb_tpu_torch.replication import ReplicaManager
    from tidb_tpu_torch.store import TPUStore

    store = TPUStore(device="cpu")
    assert isinstance(store.pd, PlacementDriver) and isinstance(store.replication, ReplicaManager)
    assert store.cluster.pd is store.pd and store.cluster.replica is store.replication
    assert store.txn._pre_apply == store._check_write_quorum
    assert store.txn._on_apply == store.record_applied_writes
    assert store.txn._on_apply_group == store.record_applied_writes_grouped


def test_control_plane_leaves_jax_unloaded():
    """A follower read, a failover, a PD tick (split, merge, balance) and
    the MPP tier run in a fresh process with nothing of JAX loaded."""
    code = (
        "import sys\n"
        "from tidb_tpu_torch.sql import Session\n"
        "from tidb_tpu_torch.util import metrics\n"
        "from tidb_tpu_torch.codec import tablecodec\n"
        "s = Session(device='cpu', mesh_devices=['cpu'] * 4)\n"
        "s.execute('CREATE TABLE t (a BIGINT PRIMARY KEY, g INT, v BIGINT)')\n"
        "s.execute('INSERT INTO t VALUES ' + ','.join(f'({i}, {i % 5}, {i})' for i in range(64)))\n"
        "tid = s.catalog.table('t').table_id\n"
        "for h in (16, 32, 48):\n"
        "    s.store.cluster.split(tablecodec.encode_row_key(tid, h))\n"
        "s.store.cluster.set_stores(3)\n"
        "s.execute(\"SET tidb_replica_read = 'follower'\")\n"
        "assert str(s.execute('SELECT sum(v) FROM t').scalar()) == '2016'\n"
        "s.store.set_down(s.store.cluster.leader_of(s.store.cluster.regions()[1].region_id))\n"
        "s.execute(\"SET tidb_replica_read = 'leader'\")\n"
        "assert str(s.execute('SELECT sum(v) FROM t').scalar()) == '2016'\n"
        "assert metrics.PD_FAILOVERS.value > 0\n"
        "s.store.pd.conf.max_region_keys = 8\n"
        "s.store.pd.tick()\n"
        "m0 = metrics.MPP_SELECTS.value\n"
        "assert len(s.execute('SELECT g, count(*) FROM t GROUP BY g').rows) == 5\n"
        "assert metrics.MPP_SELECTS.value == m0 + 1\n"
        "assert len(s.execute('SHOW PLACEMENT').rows) > 3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_cdc_and_columnar_leave_jax_unloaded(tmp_path):
    """The changefeed and columnar replica paths' lazy imports run too:
    CREATE / PAUSE / RESUME / DROP CHANGEFEED into a file sink, ALTER TABLE
    ... SET COLUMNAR REPLICA, a PD tick (pd.cdc, pd.columnar, pd.pitr), a
    routed read from the stable batch, a mid-feed ALTER and the MPP tier's
    probe from the replica, on four CPU shards."""
    code = (
        "import sys\n"
        "from tidb_tpu_torch.sql import Session\n"
        "from tidb_tpu_torch.util import metrics\n"
        "s = Session(device='cpu', mesh_devices=['cpu'] * 4)\n"
        "s.execute('CREATE TABLE t (a BIGINT PRIMARY KEY, g INT, v BIGINT)')\n"
        "s.execute('INSERT INTO t VALUES ' + ','.join(f'({i}, {i % 5}, {i})' for i in range(64)))\n"
        f"s.execute(\"CREATE CHANGEFEED f INTO 'file://{tmp_path}' FOR TABLE t\")\n"
        "s.execute('PAUSE CHANGEFEED f')\n"
        "s.execute('RESUME CHANGEFEED f')\n"
        "s.execute('ALTER TABLE t SET COLUMNAR REPLICA 1')\n"
        "s.store.pd.tick()\n"
        "c0, m0 = metrics.COLUMNAR_SCANS.value, metrics.MPP_SELECTS.value\n"
        "s.execute('SET tidb_allow_mpp = 0')\n"
        "assert str(s.execute('SELECT sum(v) FROM t').scalar()) == '2016'\n"
        "s.execute('SET tidb_allow_mpp = 1')\n"
        "s.execute('CREATE TABLE d (g INT PRIMARY KEY, name VARCHAR(8))')\n"
        "s.execute('INSERT INTO d VALUES ' + ','.join(f\"({g}, 'g{g}')\" for g in range(5)))\n"
        "s.store.pd.tick()\n"
        "assert len(s.execute('SELECT name, sum(v) FROM t JOIN d ON t.g = d.g GROUP BY name').rows) == 5\n"
        "assert metrics.COLUMNAR_SCANS.value == c0 + 1 and metrics.MPP_SELECTS.value == m0 + 1\n"
        "s.execute('ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 1')\n"
        "s.store.pd.tick()\n"
        "assert [r[1] for r in s.execute('SHOW COLUMNAR TABLES').values()] == ['normal']\n"
        "assert len(s.execute('SHOW CHANGEFEEDS').rows) == 2\n"
        "s.execute('DROP CHANGEFEED f')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_a_store_carries_its_changefeed_hub_and_columnar_replica():
    """TPUStore(device="cpu") attaches the changefeed hub, the columnar
    replica and the schema journal, as the reference's store does; the
    cluster points back at the hub, and the transaction engine's write
    guard is the hub's."""
    from tidb_tpu_torch.cdc import ChangefeedHub, SchemaJournal
    from tidb_tpu_torch.columnar import ColumnarReplica
    from tidb_tpu_torch.store import TPUStore

    store = TPUStore(device="cpu")
    assert isinstance(store.cdc, ChangefeedHub) and isinstance(store.columnar, ColumnarReplica)
    assert isinstance(store.schema_journal, SchemaJournal)
    assert store.cluster.cdc is store.cdc
    assert store.txn._write_guard == store.cdc.guard.writing
