"""Shared harness of the SQL parity tests (test_torch_sql.py,
test_torch_txn.py): the same statements go through the JAX package's
`tidb_tpu.sql.Session` and the port's `tidb_tpu_torch.sql.Session(
device="cpu")`, and what comes back must agree.

A case is a list of steps. A step is a SQL string (run on session "s"), a
`Sql(text, on=..., err=...)`, or a `Call(fn)` that does something the SQL
cannot (split a region, draw a timestamp) through each package's own
objects. Each step's outcome is compared between the packages: a Result's
column names, field types, rows (each Datum by kind and value) and
affected count, the plan-cache status of the statement, or, for an error,
the exception's class name, MySQL code and message. Values are exact, but
reals, which agree to 1e-12 relative. A step not marked `err=True` must
succeed in the JAX package, and one marked so must fail there, so no case
passes by both packages failing alike.

By default both packages run with `tidb_enable_tpu_mesh = 0`, so the
statements take the per-region tiers. `session_pair(mesh=True)` leaves
the mesh on: the JAX session runs on the eight virtual CPU devices of
tests/conftest.py (its MPP tier, or its mesh select, and its store's mesh
tier), the port's on `mesh_devices=["cpu"] * 8` (its MPP seam declines,
and the mesh select and the store's mesh tier run), and rows must agree
in order all the same.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, fields, is_dataclass
from types import SimpleNamespace

import tidb_tpu.background as j_background
import tidb_tpu.codec.tablecodec as j_tablecodec
import tidb_tpu.codec.wire as j_wire
import tidb_tpu.distsql.dispatch as j_dispatch
import tidb_tpu.exec.dag as j_dag
import tidb_tpu.expr as j_expr
import tidb_tpu.mpp.fragment as j_fragment
import tidb_tpu.parser as j_parser
import tidb_tpu.pd.core as j_pd
import tidb_tpu.replication as j_replication
import tidb_tpu.sql as j_sql
import tidb_tpu.sql.catalog as j_catalog
import tidb_tpu.store as j_store
import tidb_tpu.store.kv as j_kv
import tidb_tpu.store.region as j_region
import tidb_tpu.store.txn as j_txn
import tidb_tpu.types as j_types
import tidb_tpu.util.failpoint as j_failpoint
import tidb_tpu.util.metrics as j_metrics

import tidb_tpu_torch.background as p_background
import tidb_tpu_torch.codec.tablecodec as p_tablecodec
import tidb_tpu_torch.codec.wire as p_wire
import tidb_tpu_torch.distsql.dispatch as p_dispatch
import tidb_tpu_torch.exec.dag as p_dag
import tidb_tpu_torch.expr as p_expr
import tidb_tpu_torch.interop as p_interop
import tidb_tpu_torch.mpp.fragment as p_fragment
import tidb_tpu_torch.parser as p_parser
import tidb_tpu_torch.pd.core as p_pd
import tidb_tpu_torch.replication as p_replication
import tidb_tpu_torch.sql as p_sql
import tidb_tpu_torch.sql.catalog as p_catalog
import tidb_tpu_torch.store as p_store
import tidb_tpu_torch.store.kv as p_kv
import tidb_tpu_torch.store.region as p_region
import tidb_tpu_torch.store.txn as p_txn
import tidb_tpu_torch.types as p_types
import tidb_tpu_torch.util.failpoint as p_failpoint
import tidb_tpu_torch.util.metrics as p_metrics

REL = 1e-12

JAX = SimpleNamespace(
    name="jax", sql=j_sql, catalog=j_catalog, store=j_store, kv=j_kv, txn=j_txn, tablecodec=j_tablecodec,
    parse_one=j_parser.parse_one, new_store=lambda: j_store.TPUStore(),
    new_session=lambda store=None, catalog=None, mesh=False: j_sql.Session(store, catalog),
    background=j_background, wire=j_wire, dispatch=j_dispatch, dag=j_dag, expr=j_expr, fragment=j_fragment,
    pd=j_pd, replication=j_replication, region=j_region, types=j_types, fp=j_failpoint, metrics=j_metrics)
PORT = SimpleNamespace(
    name="port", sql=p_sql, catalog=p_catalog, store=p_store, kv=p_kv, txn=p_txn, tablecodec=p_tablecodec,
    parse_one=p_parser.parse_one, new_store=lambda: p_store.TPUStore(device="cpu"),
    new_session=lambda store=None, catalog=None, mesh=False: p_sql.Session(
        store, catalog, device="cpu", mesh_devices=["cpu"] * 8 if mesh else None),
    background=p_background, wire=p_wire, dispatch=p_dispatch, dag=p_dag, expr=p_expr, fragment=p_fragment,
    pd=p_pd, replication=p_replication, region=p_region, types=p_types, fp=p_failpoint, metrics=p_metrics)


@dataclass
class Sql:
    text: str
    on: str = "s"
    err: bool = False


@dataclass
class Call:
    """fn(pkg, sessions) -> a value compared between the packages."""

    fn: object
    err: bool = False


def norm(v):
    """A value of either package as plain Python: Datums by kind and
    value, the types' own classes by class name and fields."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return v
    if isinstance(v, float):
        return ("real", v)
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    kind = getattr(v, "kind", None)
    if kind is not None and hasattr(v, "val") and type(v).__name__ == "Datum":
        return ("datum", kind.name, norm(v.val))
    if is_dataclass(v):
        return (type(v).__name__, {f.name: norm(getattr(v, f.name)) for f in fields(v)})
    return (type(v).__name__, str(v))


def same(a, b) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple) and a[:1] == b[:1] == ("real",):
        x, y = a[1], b[1]
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        return x == y or abs(x - y) <= REL * max(abs(x), abs(y))
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def _result(r):
    if type(r).__name__ == "Result":
        return {
            "columns": list(r.columns),
            "rows": norm(r.rows),
            "affected": r.affected,
            "fts": None if r.fts is None else [(ft.tp.name, int(ft.flag), ft.flen, ft.decimal) for ft in r.fts],
        }
    return norm(r)


def attempt(fn):
    """fn()'s outcome (("ok", the value as plain values) or ("err", the
    exception's class name, MySQL code and message)), its value and its
    exception."""
    try:
        val = fn()
        return ("ok", _result(val)), val, None
    except Exception as exc:  # noqa: BLE001 — the outcome itself is compared
        return ("err", type(exc).__name__, getattr(exc, "code", None), str(exc)), None, exc


def outcome(fn):
    return attempt(fn)[0]


def _apply(pkg, sessions: dict, step):
    if isinstance(step, str):
        step = Sql(step)
    if isinstance(step, Sql):
        s = sessions[step.on]
        return step, outcome(lambda: s.execute(step.text)), norm(getattr(s, "_last_plan_cache", None))
    return step, outcome(lambda: step.fn(pkg, sessions)), None


def session_pair(shared: bool = False, names=("s",), mesh: bool = False) -> dict:
    """Fresh sessions of each package, mesh off unless `mesh`. With
    shared=True all the sessions of a package share one store and one
    catalog."""
    out = {}
    for pkg in (JAX, PORT):
        if shared:
            store, cat = pkg.new_store(), pkg.catalog.Catalog()
            ss = {n: pkg.new_session(store, cat) for n in names}
        else:
            ss = {n: pkg.new_session(mesh=mesh) for n in names}
        if not mesh:
            for s in ss.values():
                s.execute("SET tidb_enable_tpu_mesh = 0")
        out[pkg.name] = ss
    return out


def run_case(steps, sessions: dict | None = None) -> None:
    """Run the steps through both packages, step by step, and compare."""
    sessions = sessions or session_pair()
    for i, step in enumerate(steps):
        step, j_out, j_pc = _apply(JAX, sessions["jax"], step)
        _, p_out, p_pc = _apply(PORT, sessions["port"], step)
        where = f"step {i}: {step}"
        assert (j_out[0] == "err") == step.err, f"{where}: the JAX package gave {j_out}"
        assert same(j_out, p_out), f"{where}:\n  jax  {j_out}\n  port {p_out}"
        assert same(j_pc, p_pc), f"{where}: plan cache jax {j_pc} port {p_pc}"


def split_at(table: str, *handles):
    """A step that splits the table's region at each row handle."""

    def fn(pkg, sessions):
        s = sessions["s"]
        tid = s.catalog.table(table).table_id
        for h in handles:
            s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))

    return Call(fn)


# ----------------------------------------------------------- control plane
# The store-level cases of the control-plane tests (test_torch_replication,
# test_torch_pd, test_torch_chaos, test_torch_mpp): both packages' stores
# start from one plain state through the port's interop (load_store_state
# on a JAX TPUStore, store_from_state for the port's), then one scenario
# runs on each, each package arming its own failpoints and reading its own
# metrics, and what the scenario returns must agree exactly.


def row_kv(tid: int, rows: int, ts: int = 10, value=lambda h: h) -> list:
    """Plain (row key, value, ts) pairs of a one-BIGINT-column table
    (column id 1), encoded by the port's codec (byte-equal to the JAX
    package's, tests/test_torch_codec.py)."""
    from tidb_tpu_torch.codec.rowcodec import RowEncoder

    enc = RowEncoder()
    return [(p_tablecodec.encode_row_key(tid, h), enc.encode([1], [p_types.Datum.i64(value(h))]), ts)
            for h in range(rows)]


def region_table(split_keys, n_stores: int) -> list:
    """The plain region table [(region_id, start, end, epoch, peers,
    leader)] of a cluster split at `split_keys` (in that order) and
    scattered over `n_stores` stores, as the reference tests' fill_store
    lays it out."""
    c = p_region.Cluster()
    for k in split_keys:
        c.split(k)
    c.set_stores(n_stores)
    c.scatter()
    return p_interop.region_table(c)


def store_pair(kv, regions, n_stores: int, flows: dict | None = None, mesh: bool = False) -> dict:
    """A JAX TPUStore and a port TPUStore(device="cpu") started from the
    same plain state."""
    j = p_interop.load_store_state(j_store.TPUStore(), kv, regions, n_stores, flows)
    p = p_interop.store_from_state(kv, regions, n_stores, flows, device="cpu",
                                   mesh_devices=["cpu"] * 8 if mesh else None)
    return {"jax": j, "port": p}


def fill_pair(tid: int, rows: int = 120, regions: int = 4, stores: int = 4, pin_store=None) -> dict:
    """The reference tests' fill_store, carried across: a JAX TPUStore
    filled as they fill it (`rows` one-column rows put at ts 10, split
    into `regions` regions at i * rows // regions, over `stores` stores,
    every region's leader moved to `pin_store` when given), its state read
    out as plain values (interop.store_state: versions, region table with
    the store count and the PD's per-region flow), and both packages'
    stores started from that state."""
    ref = j_store.TPUStore()
    for h in range(rows):
        ref.put_row(tid, h, [1], [j_types.Datum.i64(h)], ts=10)
    for i in range(1, regions):
        ref.cluster.split(j_tablecodec.encode_row_key(tid, i * rows // regions))
    ref.cluster.set_stores(stores)
    ref.cluster.scatter()
    if pin_store is not None:
        for r in ref.cluster.regions():
            ref.cluster.set_store(r.region_id, pin_store)
    return store_pair(**p_interop.store_state(ref))


def layout(store) -> list:
    """A store's region table as plain values (ids, keys, epochs, peers,
    leaders)."""
    return p_interop.region_table(store.cluster)


def chunk_rows(chunks) -> list:
    """Every row of a select's chunks, in order, as plain values."""
    return norm([r for c in chunks if c is not None for r in c.rows()])


def run_both(scenario, stores: dict | None = None, err: bool = False):
    """Run scenario(pkg) (or scenario(pkg, store) with `stores`) on each
    package and hold the outcomes equal; the JAX package's must succeed
    (or fail, with err=True). Returns the JAX outcome."""
    outs = {}
    for pkg in (JAX, PORT):
        args = (pkg,) if stores is None else (pkg, stores[pkg.name])
        outs[pkg.name] = outcome(lambda: scenario(*args))
    j_out, p_out = outs["jax"], outs["port"]
    assert (j_out[0] == "err") == err, f"the JAX package gave {j_out}"
    assert same(j_out, p_out), f"\n  jax  {j_out}\n  port {p_out}"
    return j_out


# ------------------------------------------------------- sessions as one
# The reference SQL test files ported as parity tests (test_torch_ddl.py,
# test_torch_views.py, ...) drive a `Both`: each statement runs on the JAX
# session and on the port's, the two outcomes are held equal as run_case
# holds them, and the port's Result (or exception) comes back, so the
# reference's own assertions then read the port's values.


class Both:
    def __init__(self, sessions: dict | None = None, on: str = "s"):
        self.pair = sessions or session_pair()
        self.on = on

    @property
    def jax(self):
        return self.pair["jax"][self.on]

    @property
    def port(self):
        return self.pair["port"][self.on]

    def session(self, on: str) -> "Both":
        """The pair's other named sessions (session_pair(names=...))."""
        return Both(self.pair, on)

    def execute(self, sql: str):
        """Run `sql` on both sessions; equal outcomes and plan-cache
        status; the port's Result, or the port's exception re-raised when
        both failed alike."""
        j_out = outcome(lambda: self.jax.execute(sql))
        j_pc = norm(getattr(self.jax, "_last_plan_cache", None))
        p_out, res, exc = attempt(lambda: self.port.execute(sql))
        p_pc = norm(getattr(self.port, "_last_plan_cache", None))
        assert same(j_out, p_out), f"{sql}:\n  jax  {j_out}\n  port {p_out}"
        assert same(j_pc, p_pc), f"{sql}: plan cache jax {j_pc} port {p_pc}"
        if exc is not None:
            raise exc
        return res

    def call(self, fn):
        """fn(session, pkg) on both packages; equal (plain) values; the
        port's value."""
        j, p = fn(self.jax, JAX), fn(self.port, PORT)
        assert same(norm(j), norm(p)), f"\n  jax  {norm(j)}\n  port {norm(p)}"
        return p


def both_pkgs(fn):
    """fn(pkg) on both packages (unit-level cases): equal plain values or
    equal failures; the port's value, or the port's exception."""
    j_out = outcome(lambda: fn(JAX))
    p_out, p_val, exc = attempt(lambda: fn(PORT))
    assert same(j_out, p_out), f"\n  jax  {j_out}\n  port {p_out}"
    if exc is not None:
        raise exc
    return p_val
