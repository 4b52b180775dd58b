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

import tidb_tpu.codec.tablecodec as j_tablecodec
import tidb_tpu.parser as j_parser
import tidb_tpu.sql as j_sql
import tidb_tpu.sql.catalog as j_catalog
import tidb_tpu.store as j_store
import tidb_tpu.store.kv as j_kv
import tidb_tpu.store.txn as j_txn

import tidb_tpu_torch.codec.tablecodec as p_tablecodec
import tidb_tpu_torch.parser as p_parser
import tidb_tpu_torch.sql as p_sql
import tidb_tpu_torch.sql.catalog as p_catalog
import tidb_tpu_torch.store as p_store
import tidb_tpu_torch.store.kv as p_kv
import tidb_tpu_torch.store.txn as p_txn

REL = 1e-12

JAX = SimpleNamespace(
    name="jax", sql=j_sql, catalog=j_catalog, store=j_store, kv=j_kv, txn=j_txn, tablecodec=j_tablecodec,
    parse_one=j_parser.parse_one, new_store=lambda: j_store.TPUStore(),
    new_session=lambda store=None, catalog=None, mesh=False: j_sql.Session(store, catalog))
PORT = SimpleNamespace(
    name="port", sql=p_sql, catalog=p_catalog, store=p_store, kv=p_kv, txn=p_txn, tablecodec=p_tablecodec,
    parse_one=p_parser.parse_one, new_store=lambda: p_store.TPUStore(device="cpu"),
    new_session=lambda store=None, catalog=None, mesh=False: p_sql.Session(
        store, catalog, device="cpu", mesh_devices=["cpu"] * 8 if mesh else None))


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


def outcome(fn):
    try:
        return ("ok", _result(fn()))
    except Exception as exc:  # noqa: BLE001 — the outcome itself is compared
        return ("err", type(exc).__name__, getattr(exc, "code", None), str(exc))


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
