"""`prog-audit` — run the exec builder's programs on a device and inspect
the ops they issue: the port's counterpart of the JAX package's jaxpr
auditor (`jax-audit`). Where the reference traces each program to a closed
jaxpr and walks its equations, this auditor runs each program once under a
`TorchDispatchMode` that records every op it dispatches (the port's
`torch.library` kernels — `tidb_tpu_torch::dense_agg`, `::postsort_segscan`,
`::membership_segscan`, `::probe_tables` — appear as themselves).

A catalog of programs — the reference's nine builder shapes (selection,
hashagg, streamagg, topn, hashjoin, radix_join, partial_scalar_agg,
partial_hashagg, columnar_scan), each single and region-batched
(`vmap_batch=3`) and, where `distsql/planner.py mesh_merge_kind` gives a
kind, as a mesh program over two shards of the device; the MPP exchange
join; three programs that reach the hand-written kernels (TPC-H Q1 with
the small-G hint: K1; Q3's packed chain: K2 and K3; the join bench at the
smallest probe capacity the K4 gate takes); and Q1 with the hint 64, which
K1 refuses, on the sort-free small-G route — goes through six checks:

  * **f64-leak** — an op's output is float64 or complex128 although no
    input of the program carries either: the integer program picked up a
    Python float promotion, a true divide or an astype.
  * **host-sync** — `aten::_local_scalar_dense` (`.item()`, `bool()`,
    `int()` of a tensor) and ops whose output shape depends on the data
    (`nonzero`, `masked_select`, `unique`, boolean-mask indexing, …) stall
    the host on the device inside the program. On a CUDA device the
    program also runs once under `torch.cuda.set_sync_debug_mode("error")`.
    The driver's own flag reads lie outside `cd.fn` and are not counted.
  * **device-leak** — an op output on another device than the program's
    batches, or a cross-device `_to_copy` / `copy_` inside the program
    (the counterpart of the reference's `device_put` and host callbacks).
  * **vmap-lanewise** — an op that `torch.func.vmap` ran lane by lane for
    want of a batching rule (torch warns for each; `vmap_fallbacks`).
  * **region-axis** — every output of the region-batched variant is
    `(3,) + ` the single variant's shape, with the same dtype.
  * **build-stability** — two fresh builds of one DAG, run on the same
    inputs, issue the same op sequence (name, dtype, shape) and give equal
    outputs; a tensor over 4 KiB captured in `cd.fn`'s closure is operand
    data baked into the program (every ProgramCache miss re-captures it).

Findings read `program '<name>': <check> `<op>` x<count> — <why>` and
anchor on `tidb_tpu_torch/exec/builder.py:1`. A finding the port cannot yet
repair without changing its bytes stands in KNOWN below with its reason;
the suppressions audit flags an entry that no longer fires.

Fixture mode (`--files`): a fixture module exports `PROG_AUDIT_CATALOG`, a
list of `{"name": str, "make": callable}` entries (optionally "line" and
"make_batched"): `make()` returns `(fn, args)`, run through the op checks
and the stability check; `make_batched()` returns the region-batched
`(fn, args)` of the same program, run through the vmap and region-axis
checks against it.

`audit_live(device="cuda")` raises without CUDA; pass `device="cpu"` to
audit the plain versions on the host.
"""

from __future__ import annotations

import fnmatch
import importlib.util
import os
import re
import sys
import time
from dataclasses import dataclass, field

from .common import REPO, Finding

PASS = "prog-audit"
CHECKS = ("f64-leak", "host-sync", "device-leak", "vmap-lanewise", "region-axis", "build-stability")

# where live findings anchor: the program builder is the artifact under audit
_BUILDER_REL = "tidb_tpu_torch/exec/builder.py"

_VMAP_BATCH = 3
_CAPACITY = 8
_RADIX_CAPACITY = 512  # probe capacity satisfying the radix ratio gate
_GROUP_CAPACITY = 16
_MESH_SHARDS = 2
_CONST_LIMIT_BYTES = 4096
# the kernel entries: Q1 at 1024 rows with the small-G hint 16 (K1) and 64
# (the sort-free small-G route), Q3's packed chain at 1024 lineitem rows
# (K2, K3), the 1:32 join bench at 4096 probe rows, the smallest whose
# radix plan passes the K4 gate
# (ops/join_probe.py probe_kernel_eligible: probe_cap % 1024 == 0)
_K1_ROWS = 1024
_K23_ROWS = 1024
_K4_ROWS = 4096
_K_GROUP_CAPACITY = 1024

_SYNC_OPS = {"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero", "aten::equal"}
_DATA_SHAPE_OPS = {
    "aten::nonzero", "aten::nonzero_numpy", "aten::argwhere", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive", "aten::bincount",
}
_COPY_OPS = {"aten::_to_copy", "aten::copy_", "aten::_copy_from", "aten::_copy_from_and_resize"}
_WIDE = ("torch.float64", "torch.complex128")
_FINDING = re.compile(r"^program '(?P<prog>[^']*)': (?P<check>[a-z0-9-]+) `(?P<op>[^`]*)`")

# Findings of the live catalog that stand until the port can repair them
# without changing its bytes: (program glob, check, op, device type glob,
# reason). Each one is listed in ROADMAP.md and pinned by
# tests/test_torch_vet.py.
KNOWN: tuple = ()


# ----------------------------------------------------------- op recording

@dataclass
class OpRecord:
    name: str  # "aten::add.Tensor" / "tidb_tpu_torch::dense_agg"
    base: str  # the op without its overload: "aten::add"
    outs: tuple  # (dtype, shape, device) of each output tensor
    in_devices: tuple
    bool_index: bool = False  # an index / index_put_ by a boolean mask
    size_arg: bool = False  # repeat_interleave given its output_size


def _tensors(x):
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _recorder_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        """Records every op dispatched while it is active; the ops inside
        an op (a custom op's implementation) are not re-dispatched to it."""

        def __init__(self):
            super().__init__()
            self.records: list[OpRecord] = []
            self.failed: str | None = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch

            kwargs = kwargs or {}
            try:
                out = func(*args, **kwargs)
            except Exception:
                self.failed = func.name()
                raise
            base = func._schema.name
            bool_index = False
            if base in ("aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"):
                idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
                bool_index = any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
                                 for t in (idx or ()))
            self.records.append(OpRecord(
                func.name(), base,
                tuple((str(t.dtype), tuple(t.shape), str(t.device)) for t in _tensors(out)),
                tuple(str(t.device) for t in _tensors((args, kwargs))),
                bool_index, kwargs.get("output_size") is not None))
            return out

    return OpRecorder


def record(fn, args):
    """(outputs of fn(*args), [OpRecord]) with every dispatched op recorded."""
    rec = _recorder_class()()
    with rec:
        out = fn(*args)
    return out, rec.records


def vmap_fallbacks(fn):
    """(fn(), the ops that torch.func.vmap ran lane by lane inside it):
    torch warns "There is a performance drop because we have not yet
    implemented the batching rule for <op>" for each such op."""
    import warnings

    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out = fn()
    names = set()
    for w in ws:
        m = re.search(r"batching rule for (\S+)\.", str(w.message))
        if m:
            names.add(m.group(1))
    return out, sorted(names)


# ----------------------------------------------------------- the checks

def _msg(name: str, check: str, op: str, n: int | None, why: str) -> str:
    count = f" x{n}" if n is not None else ""
    return f"program {name!r}: {check} `{op}`{count} — {why}"


def _failed(name: str, check: str, exc: Exception, anchor: tuple) -> list:
    """A program that fails to build or run IS a finding."""
    return [Finding(anchor[0], anchor[1], PASS, _msg(
        name, check, type(exc).__name__, None, f"the program failed to run: {exc}"))]


def _count(records, pred) -> dict:
    out: dict = {}
    for r in records:
        if pred(r):
            out[r.name] = out.get(r.name, 0) + 1
    return out


def _is_sync(r: OpRecord) -> bool:
    if r.base in _SYNC_OPS or r.base in _DATA_SHAPE_OPS:
        return True
    if r.base == "aten::index" and r.bool_index:
        return True  # a boolean-mask gather: its row count is data
    if r.base in ("aten::index_put", "aten::index_put_", "aten::_index_put_impl_") and r.bool_index:
        return True  # a boolean-mask scatter finds its rows with nonzero
    return r.base == "aten::repeat_interleave" and not r.size_arg


def check_ops(name: str, records, device: str, in_wide: bool, anchor: tuple) -> list:
    """f64-leak, host-sync and device-leak over one run's op records.
    `device` is the program's device (str), `in_wide` whether any input
    carries float64/complex128."""
    rel, line = anchor
    findings: list = []
    if not in_wide:
        for op, n in sorted(_count(records, lambda r: any(o[0] in _WIDE for o in r.outs)).items()):
            findings.append(Finding(rel, line, PASS, _msg(
                name, "f64-leak", op, n,
                "float64/complex128 output in a program whose inputs carry none — a Python "
                "float promotion, a true divide or an astype doubled the integer math")))
    for op, n in sorted(_count(records, _is_sync).items()):
        findings.append(Finding(rel, line, PASS, _msg(
            name, "host-sync", op, n,
            "the host waits on the device inside the program (a scalar read or a "
            "data-sized output) — keep it on the device as a mask or a fixed-size result")))

    def leaks(r: OpRecord) -> bool:
        if any(o[2] != device for o in r.outs):
            return True
        return r.base in _COPY_OPS and any(d != device for d in r.in_devices)

    for op, n in sorted(_count(records, leaks).items()):
        findings.append(Finding(rel, line, PASS, _msg(
            name, "device-leak", op, n,
            f"a tensor on another device than the program's ({device}) or a cross-device "
            f"copy inside the program — every launch round-trips; make it on the program's device")))
    return findings


def _signature(records) -> list:
    return [(r.name, tuple((o[0], o[1]) for o in r.outs)) for r in records]


def _outputs_equal(a, b) -> bool:
    import torch

    ta, tb = _tensors(a), _tensors(b)
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if "meta" not in (x.device.type, y.device.type) and not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def closure_tensors(fn, limit: int = _CONST_LIMIT_BYTES) -> list:
    """(path, nbytes) of every tensor over `limit` bytes reachable from
    fn's closure: through nested functions, containers and the port's own
    objects (a DAG, a compiled program)."""
    import torch

    found: list = []
    seen: set = set()

    def walk(obj, path: str, depth: int):
        if depth > 10 or id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            nbytes = obj.numel() * obj.element_size()
            if nbytes > limit:
                found.append((path, nbytes))
            return
        if callable(obj) and getattr(obj, "__closure__", None):
            for name, cell in zip(obj.__code__.co_freevars, obj.__closure__):
                try:
                    walk(cell.cell_contents, f"{path}.{name}", depth + 1)
                except ValueError:  # an empty cell
                    pass
            return
        if isinstance(obj, (list, tuple, set, frozenset)):
            for i, x in enumerate(obj):
                walk(x, f"{path}[{i}]", depth + 1)
        elif isinstance(obj, dict):
            for k, x in obj.items():
                walk(x, f"{path}[{k!r}]", depth + 1)
        elif type(obj).__module__.startswith("tidb_tpu_torch") and hasattr(obj, "__dict__"):
            for k, x in vars(obj).items():
                walk(x, f"{path}.{k}", depth + 1)

    walk(fn, getattr(fn, "__name__", "fn"), 0)
    return found


def check_stability(name: str, make, anchor: tuple) -> tuple:
    """Build twice, run both builds on the first build's inputs and compare
    op sequences and outputs; flag large closure-captured tensors. Returns
    (findings, fn, args, outputs, records) of the first build."""
    rel, line = anchor
    fn1, args = make()
    fn2, _args2 = make()
    out1, rec1 = record(fn1, args)
    out2, rec2 = record(fn2, args)
    findings: list = []
    s1, s2 = _signature(rec1), _signature(rec2)
    if s1 != s2:
        i = next((k for k, (x, y) in enumerate(zip(s1, s2)) if x != y), min(len(s1), len(s2)))
        op = s1[i][0] if i < len(s1) else s2[i][0]
        findings.append(Finding(rel, line, PASS, _msg(
            name, "build-stability", op, None,
            f"two identical builds issued DIFFERENT op sequences (first difference at op #{i} "
            f"of {len(s1)} / {len(s2)}) — a closure-captured Python value (a counter, a "
            f"timestamp, an id) steers the program; every build behaves differently")))
    elif not _outputs_equal(out1, out2):
        findings.append(Finding(rel, line, PASS, _msg(
            name, "build-stability", "outputs", None,
            "two identical builds run on the same inputs gave DIFFERENT outputs — the program "
            "reads state outside its arguments (or leaves bytes unwritten)")))
    for path, nbytes in closure_tensors(fn1):
        findings.append(Finding(rel, line, PASS, _msg(
            name, "build-stability", path, None,
            f"a {nbytes}-byte tensor is captured in the program's closure — operand data "
            f"baked into the program is re-captured (and re-uploaded) per build; pass it as "
            f"an argument")))
    return findings, fn1, args, out1, rec1


def check_region_axis(name: str, single_out, batched_out, anchor: tuple, batch: int = _VMAP_BATCH) -> list:
    rel, line = anchor
    s, v = _tensors(single_out), _tensors(batched_out)
    if len(s) != len(v):
        return [Finding(rel, line, PASS, _msg(
            name, "region-axis", "outputs", None,
            f"the region-batched variant has {len(v)} outputs vs {len(s)} single — outputs "
            f"dropped or added along the region axis"))]
    out: list = []
    for i, (a, b) in enumerate(zip(s, v)):
        want = (batch,) + tuple(a.shape)
        if tuple(b.shape) != want or a.dtype != b.dtype:
            out.append(Finding(rel, line, PASS, _msg(
                name, "region-axis", f"output#{i}", None,
                f"rank/dtype inconsistent along the region axis — single {tuple(a.shape)}/{a.dtype} "
                f"vs batched {tuple(b.shape)}/{b.dtype} (expected {want} with the same dtype)")))
    return out


def check_lanewise(name: str, ops, anchor: tuple) -> list:
    rel, line = anchor
    return [Finding(rel, line, PASS, _msg(
        name, "vmap-lanewise", op, None,
        "torch.func.vmap ran this op lane by lane (no batching rule) — the region-batched "
        "program loops over its regions on the host")) for op in ops]


def _in_wide(args) -> bool:
    return any(str(t.dtype) in _WIDE for t in _tensors(args))


def _device_of(args) -> str:
    ts = _tensors(args)
    return str(ts[0].device) if ts else "cpu"


def sync_debug_findings(name: str, fn, args, anchor: tuple) -> list:
    """On a CUDA device: run fn once with synchronizing CUDA calls turned
    into errors; the op that raised is the finding."""
    import torch

    rel, line = anchor
    prev = torch.cuda.get_sync_debug_mode()
    rec = _recorder_class()()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            fn(*args)
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        return [Finding(rel, line, PASS, _msg(
            name, "host-sync", rec.failed or "cuda-sync", None,
            "a synchronizing CUDA call inside the program (torch.cuda.set_sync_debug_mode "
            "'error') — the host waits on the card mid-program"))]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return []


# ----------------------------------------------------------- live catalog

def _int_chunk(n: int = 6):
    from ..chunk import Chunk
    from ..types import Datum, new_longlong

    I = new_longlong()
    rows = [[Datum.i64(i % 3), Datum.i64(i * 7 % 11)] for i in range(n)]
    return Chunk.from_rows([I, I], rows), I


def _scan(table_id: int, I):
    from ..exec.dag import ColumnInfo, TableScan

    return TableScan(table_id, (ColumnInfo(1, I), ColumnInfo(2, I)))


def live_catalog() -> list:
    """(name, dag, n_batches, capacities or None) for every exec-op builder
    path of the reference's catalog."""
    from ..exec.dag import Aggregation, ColumnInfo, DAGRequest, Join, Selection, TableScan, TopN
    from ..expr import AggDesc, col, func, lit

    _ch, I = _int_chunk()
    scan = _scan(31, I)
    sel = DAGRequest(
        (scan, Selection((func("gt", I, col(1, I), lit(2, I)),))),
        output_offsets=(0, 1))
    hashagg = DAGRequest(
        (scan, Aggregation(group_by=(col(0, I),),
                           aggs=(AggDesc("sum", (col(1, I),)),
                                 AggDesc("count", (col(1, I),))))),
        output_offsets=(0, 1, 2))
    streamagg = DAGRequest(
        (scan, Aggregation(group_by=(col(0, I),),
                           aggs=(AggDesc("max", (col(1, I),)),), stream=True)),
        output_offsets=(0, 1))
    topn = DAGRequest(
        (scan, TopN(order_by=((col(1, I), True),), limit=4)),
        output_offsets=(0, 1))
    join = DAGRequest(
        (scan, Join(build=(_scan(32, I),), probe_keys=(col(0, I),),
                    build_keys=(col(0, I),), join_type="inner")),
        output_offsets=(0, 1, 2, 3))
    # the radix-partitioned join: a planner-proven unique build with int
    # keys takes ops/radix_join.py when the build/probe capacity ratio
    # passes, so the probe batch is padded wide (_RADIX_CAPACITY); the
    # grouped partial tail gives it a mesh variant ("group" kind)
    radix_join = DAGRequest(
        (TableScan(33, (ColumnInfo(1, I), ColumnInfo(2, I))),
         Join(build=(_scan(34, I),), probe_keys=(col(0, I),),
              build_keys=(col(0, I),), join_type="inner",
              build_unique=True),
         Aggregation(group_by=(col(1, I),),
                     aggs=(AggDesc("sum", (col(2, I),)),), partial=True)),
        output_offsets=(0, 1))
    # partial-mode shapes: what the dispatch planner's mesh tier runs
    partial_scalar = DAGRequest(
        (scan, Aggregation(group_by=(),
                           aggs=(AggDesc("sum", (col(1, I),)),
                                 AggDesc("count", ())), partial=True)),
        output_offsets=(0, 1))
    partial_hashagg = DAGRequest(
        (scan, Aggregation(group_by=(col(0, I),),
                           aggs=(AggDesc("sum", (col(1, I),)),
                                 AggDesc("count", ())), partial=True)),
        output_offsets=(0, 1, 2))
    # the columnar-replica scan shape: scan -> selection -> complete
    # aggregation as one program over the replica's stable chunk
    columnar_scan = DAGRequest(
        (scan, Selection((func("gt", I, col(1, I), lit(2, I)),)),
         Aggregation(group_by=(col(0, I),),
                     aggs=(AggDesc("sum", (col(1, I),)),
                           AggDesc("count", ())))),
        output_offsets=(0, 1, 2))
    return [
        ("selection", sel, 1, None),
        ("hashagg", hashagg, 1, None),
        ("streamagg", streamagg, 1, None),
        ("topn", topn, 1, None),
        ("hashjoin", join, 2, None),
        ("radix_join", radix_join, 2, (_RADIX_CAPACITY, _CAPACITY)),
        ("partial_scalar_agg", partial_scalar, 1, None),
        ("partial_hashagg", partial_hashagg, 1, None),
        ("columnar_scan", columnar_scan, 1, None),
    ]


@dataclass
class Entry:
    """One catalog program: its DAG, the batches it runs on (probe first,
    in dag.collect_scans order) and build_program's keyword arguments."""

    name: str
    dag: object
    batches: list
    build_kw: dict = field(default_factory=dict)
    group_capacity: int = _GROUP_CAPACITY


def _catalog_entries(device) -> list:
    from ..chunk.device import to_device_batch

    ch, _I = _int_chunk()
    out = []
    for name, dag, n_batches, caps in live_catalog():
        caps = tuple(caps) if caps else (_CAPACITY,) * n_batches
        out.append(Entry(name, dag, [to_device_batch(ch, capacity=c, device=device) for c in caps]))
    return out


def kernel_entries(device) -> list:
    """The programs that reach K1-K4 and the sort-free small-G route (Q1
    with a hint K1 refuses), from tidb_tpu_torch/workloads.py."""
    import numpy as np

    from .. import exec as E
    from .. import expr as X
    from .. import types as T
    from .. import workloads as W
    from ..interop import device_batch_from_numpy

    def batches(cols_list, fts_list):
        return [device_batch_from_numpy(c, np.ones(len(c[0][0]), bool), len(c[0][0]), f, device=device)
                for c, f in zip(cols_list, fts_list)]

    q1, q1_fts = W.q1_dag(E, X, T)
    q3, q3_fts = W.q3_dag(E, X, T)
    jb, jb_fts = W.join_bench_dag(E, X, T)
    return [
        Entry("q1_small_g", q1, batches([W.q1_columns(W.make_tables(_K1_ROWS))], [q1_fts]),
              {"small_groups": 16}, _K_GROUP_CAPACITY),
        Entry("q1_dense_route", q1, batches([W.q1_columns(W.make_tables(_K1_ROWS))], [q1_fts]),
              {"small_groups": 64}, _K_GROUP_CAPACITY),
        Entry("q3_chain", q3, batches(W.q3_columns(_K23_ROWS), q3_fts), {}, _K_GROUP_CAPACITY),
        Entry("radix_join_kernel", jb, batches(W.join_bench_columns(_K4_ROWS, 32, False), jb_fts), {},
              _K_GROUP_CAPACITY),
    ]


def _stack(batch, lanes: int):
    """The batch repeated over a leading region axis of `lanes`."""
    import torch

    from ..exec.builder import _flatten_batch, _unflatten_batch

    leaves, spec = _flatten_batch(batch)
    return _unflatten_batch([torch.stack([x] * lanes) for x in leaves], spec)


def _make(entry: Entry, vmap: bool):
    """A `make` thunk: a fresh build_program each call — exactly what a
    ProgramCache miss does."""
    from ..exec.builder import build_program

    caps = tuple(b.capacity for b in entry.batches)

    def make():
        cd = build_program(entry.dag, caps, group_capacity=entry.group_capacity,
                           vmap_batch=_VMAP_BATCH if vmap else None, **entry.build_kw)
        args = ([_stack(entry.batches[0], _VMAP_BATCH)] + entry.batches[1:]) if vmap else list(entry.batches)
        return cd.fn, args
    return make


@dataclass
class ProgramReport:
    name: str
    ops: int = 0
    kernels: dict = field(default_factory=dict)  # custom op -> dispatches
    findings: list = field(default_factory=list)

    def line(self) -> str:
        checks = {c: 0 for c in CHECKS}
        for f in self.findings:
            m = _FINDING.match(f.message)
            if m:
                checks[m.group("check")] = checks.get(m.group("check"), 0) + 1
        status = " ".join(f"{c}={'ok' if n == 0 else n}" for c, n in checks.items())
        kern = ", ".join(f"{k} x{n}" for k, n in sorted(self.kernels.items())) or "none"
        return f"{self.name}: {self.ops} ops, kernels {kern}; {status}"


def _report(name: str, records, findings) -> ProgramReport:
    kernels = {}
    for r in records:
        if r.base.startswith("tidb_tpu_torch::"):
            kernels[r.base] = kernels.get(r.base, 0) + 1
    return ProgramReport(name, len(records), kernels, list(findings))


def _audit_entry(entry: Entry, device: str, anchor: tuple, reports: list) -> list:
    """Single (with the stability double-build), region-batched and, where
    the planner routes the shape there, mesh."""
    import torch

    from ..distsql.planner import mesh_merge_kind

    findings: list = []
    variant = f"{entry.name}/single"
    try:
        fs, fn, args, single_out, recs = check_stability(variant, _make(entry, False), anchor)
        fs += check_ops(variant, recs, device, _in_wide(args), anchor)
        if torch.device(device).type == "cuda":
            fs += sync_debug_findings(variant, fn, args, anchor)
    except Exception as exc:  # noqa: BLE001
        fs, single_out, recs = _failed(variant, "build-stability", exc, anchor), None, []
    reports.append(_report(variant, recs, fs))
    findings += fs

    variant = f"{entry.name}/vmap"
    try:
        fn, args = _make(entry, True)()
        (out, recs), lanewise = vmap_fallbacks(lambda: record(fn, args))
        fs = check_ops(variant, recs, device, _in_wide(args), anchor)
        fs += check_lanewise(variant, lanewise, anchor)
        if single_out is not None:
            fs += check_region_axis(variant, single_out, out, anchor)
    except Exception as exc:  # noqa: BLE001
        fs, recs = _failed(variant, "region-axis", exc, anchor), []
    reports.append(_report(variant, recs, fs))
    findings += fs

    kind = mesh_merge_kind(entry.dag)
    if kind is not None:
        findings += _audit_mesh(entry, kind, device, anchor, reports)
    return findings


def _audit_mesh(entry: Entry, kind: str, device: str, anchor: tuple, reports: list) -> list:
    """The mesh tier's program over `_MESH_SHARDS` shards of the device
    (the lanes padded to divide over them)."""
    from ..exec.builder import build_program
    from ..parallel.mesh import region_mesh

    variant = f"{entry.name}/mesh-{kind}"
    lanes = -(-_VMAP_BATCH // _MESH_SHARDS) * _MESH_SHARDS
    caps = tuple(b.capacity for b in entry.batches)
    try:
        cd = build_program(entry.dag, caps, group_capacity=entry.group_capacity, mesh_lanes=lanes,
                           mesh_devices=region_mesh([device] * _MESH_SHARDS), mesh_kind=kind, **entry.build_kw)
        args = [_stack(entry.batches[0], lanes)] + entry.batches[1:]
        _out, recs = record(cd.fn, args)
        fs = check_ops(variant, recs, device, _in_wide(args), anchor)
    except Exception as exc:  # noqa: BLE001
        fs, recs = _failed(variant, "build-stability", exc, anchor), []
    reports.append(_report(variant, recs, fs))
    return fs


def _audit_exchange(device: str, anchor: tuple, reports: list) -> list:
    """The MPP exchange join (mpp/exchange_op.py exchange_join_program):
    hash-partition both sides, exchange, join each shard's partition and
    run the grouped aggregate's phases, as ONE program over two shards."""
    from ..exec.dag import Aggregation, DAGRequest, Join
    from ..expr import AggDesc, col
    from ..mpp.exchange_op import exchange_join_program
    from ..parallel.mesh import region_mesh, stack_region_batches

    ch, I = _int_chunk()
    dag = DAGRequest(
        (_scan(41, I),
         Join(build=(_scan(42, I),), probe_keys=(col(0, I),),
              build_keys=(col(0, I),), join_type="inner"),
         Aggregation(group_by=(col(1, I),),
                     aggs=(AggDesc("sum", (col(2, I),)),
                           AggDesc("count", ())))),
        output_offsets=(0, 1, 2))
    variant = "exchange_join/mesh"
    try:
        mesh = region_mesh([device] * _MESH_SHARDS)
        args = [stack_region_batches([ch] * _MESH_SHARDS, n_total=_MESH_SHARDS, device=device) for _ in range(2)]
        fn = exchange_join_program(dag, mesh, group_capacity=_GROUP_CAPACITY)
        _out, recs = record(fn, args)
        fs = check_ops(variant, recs, device, _in_wide(args), anchor)
    except Exception as exc:  # noqa: BLE001
        fs, recs = _failed(variant, "build-stability", exc, anchor), []
    reports.append(_report(variant, recs, fs))
    return fs


# ----------------------------------------------------------- KNOWN findings

def _device_type(device) -> str:
    return str(device).split(":")[0]


def _entries_for(device) -> list:
    """(index, entry) of the KNOWN entries that apply on `device`."""
    return [(i, e) for i, e in enumerate(KNOWN) if fnmatch.fnmatch(_device_type(device), e[3])]


def known_index(f: Finding, device) -> int | None:
    """Index of the KNOWN entry that excuses finding `f` of a run on
    `device`, or None."""
    m = _FINDING.match(f.message)
    if m is None or f.passname != PASS:
        return None
    for i, (prog, check, op, _dev, _why) in _entries_for(device):
        if fnmatch.fnmatch(m.group("prog"), prog) and check == m.group("check") and op == m.group("op"):
            return i
    return None


def apply_known(findings, device, used: set | None = None) -> list:
    """Findings of a run on `device` that no KNOWN entry excuses; the
    indices of the entries that excused something are added to `used`."""
    out = []
    for f in findings:
        i = known_index(f, device)
        if i is None:
            out.append(f)
        elif used is not None:
            used.add(i)
    return out


def _known_line(i: int) -> int:
    """Line of KNOWN entry `i` in this module (the line of KNOWN itself
    when the entry is not found)."""
    prog = KNOWN[i][0]
    first = 1
    try:
        with open(__file__, encoding="utf-8") as f:
            for ln, text in enumerate(f, 1):
                if text.startswith("KNOWN"):
                    first = ln
                elif first > 1 and f'"{prog}"' in text:
                    return ln
    except OSError:
        pass
    return first


def stale_known(used: set, device) -> list:
    """The suppressions audit's findings for KNOWN entries of `device`
    that excused no live finding in a run of the auditor there."""
    here = os.path.relpath(os.path.abspath(__file__), REPO)
    return [Finding(here, _known_line(i), "suppressions",
                    f"stale KNOWN entry {e[:4]!r}: prog-audit no longer reports it — the "
                    f"fault is repaired; remove the entry (and its ROADMAP.md line)")
            for i, e in _entries_for(device) if i not in used]


# ----------------------------------------------------------- the live run

@dataclass
class AuditReport:
    device: str
    programs: list  # ProgramReport, in catalog order
    raw: list  # every finding, KNOWN ones included
    findings: list  # the findings no KNOWN entry excuses
    used_known: set
    seconds: float

    @property
    def stale(self) -> list:
        return stale_known(self.used_known, self.device)


def resolve_device(device) -> str:
    """The device string the audit runs on ("cuda:0", "cpu"); raises
    without CUDA unless the caller asks for the CPU."""
    from ..runtime import resolve_device as _resolve

    dev = _resolve(device)
    if dev.type == "cuda" and dev.index is None:
        import torch

        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def audit_live(device="cuda") -> AuditReport:
    """Build and run the whole catalog on `device` through every check.
    Raises without CUDA unless `device="cpu"`."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    anchor = (_BUILDER_REL, 1)
    reports: list = []
    raw: list = []
    for entry in _catalog_entries(dev) + kernel_entries(dev):
        raw += _audit_entry(entry, dev, anchor, reports)
    raw += _audit_exchange(dev, anchor, reports)
    used: set = set()
    kept = apply_known(raw, dev, used)
    return AuditReport(dev, reports, raw, kept, used, time.perf_counter() - t0)


# ----------------------------------------------------------- fixture mode

def _load_fixture_catalog(sf):
    spec = importlib.util.spec_from_file_location(f"_progaudit_fixture_{abs(hash(sf.path))}", sf.path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)
    return getattr(mod, "PROG_AUDIT_CATALOG", [])


def audit_files(files) -> list:
    findings: list = []
    for sf in files:
        if "PROG_AUDIT_CATALOG" not in getattr(sf, "text", ""):
            continue  # never import modules that don't opt in — fixture
            # files for OTHER passes may have import side effects
        try:
            catalog = _load_fixture_catalog(sf)
        except Exception:  # noqa: BLE001 — non-catalog fixture files
            continue
        for entry in catalog:
            name = entry["name"]
            anchor = (sf.rel, entry.get("line", 1))
            try:
                fs, fn, args, out, recs = check_stability(name, entry["make"], anchor)
                fs += check_ops(name, recs, _device_of(args), _in_wide(args), anchor)
                if "make_batched" in entry:
                    bfn, bargs = entry["make_batched"]()
                    (bout, brecs), lanewise = vmap_fallbacks(lambda: record(bfn, bargs))
                    fs += check_ops(f"{name}/vmap", brecs, _device_of(bargs), _in_wide(bargs), anchor)
                    fs += check_lanewise(f"{name}/vmap", lanewise, anchor)
                    fs += check_region_axis(f"{name}/vmap", out, bout, anchor)
            except Exception as exc:  # noqa: BLE001
                fs = _failed(name, "build-stability", exc, anchor)
            findings.extend(fs)
    return findings


def run(files=None, device="cuda") -> list:
    """Vet-pass entry point: no `files` = the live catalog on `device`
    (every finding, KNOWN ones included: run_all applies KNOWN, as it
    applies suppression markers); explicit files = fixture catalogs
    (`PROG_AUDIT_CATALOG` modules)."""
    if files:
        return audit_files(files)
    return audit_live(device).raw
