"""Wire serialization for the coprocessor seam — this framework's tipb.

The reference crosses its store boundary with protobuf: `tipb.DAGRequest`
in, `tipb.SelectResponse` (datum rows or raw columnar chunk buffers) out
(ref: cophandler/cop_handler.go:249-267 encode paths, pkg/util/chunk/
codec.go:37 raw-column wire layout, negotiated at distsql.SetEncodeType
distsql.go:201-235). Here the same contract is a compact tagged binary
format over the ir.Expr/DAG dataclasses plus the Chunk's raw buffers —
little-endian, alignment-free, so a sidecar process (or another host) can
serve cop requests without sharing Python objects.

Layout conventions: u8 tags, little-endian fixed-width ints, length-prefixed
byte strings, numpy buffers verbatim (the chunk columns go on the wire as
their raw data — the reference's TypeChunk encoding does exactly this).

Copy of `tidb_tpu/codec/wire.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import struct

import numpy as np

from ..chunk import Chunk
from ..chunk.column import Column, numpy_dtype_for
from ..expr.agg import AggDesc, AggMode
from ..expr.ir import ColumnRef, Const, Expr, ScalarFunc
from ..types import Collation, Datum, DatumKind, FieldType, Flag, MyDecimal, MyTime, TypeCode


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def i32(self, v: int):
        self.buf += struct.pack("<i", v)

    def i64(self, v: int):
        self.buf += struct.pack("<q", v)

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v & ((1 << 64) - 1))

    def f64(self, v: float):
        self.buf += struct.pack("<d", v)

    def blob(self, b: bytes):
        self.i32(len(b))
        self.buf += b

    def s(self, v: str):
        self.blob(v.encode("utf-8"))

    def bool_(self, v: bool):
        self.u8(1 if v else 0)

    def done(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, b: bytes):
        self.b = memoryview(b)
        self.i = 0

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def i32(self) -> int:
        v = struct.unpack_from("<i", self.b, self.i)[0]
        self.i += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from("<q", self.b, self.i)[0]
        self.i += 8
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.b, self.i)[0]
        self.i += 8
        return v

    def f64(self) -> float:
        v = struct.unpack_from("<d", self.b, self.i)[0]
        self.i += 8
        return v

    def blob(self) -> bytes:
        n = self.i32()
        v = bytes(self.b[self.i : self.i + n])
        self.i += n
        return v

    def s(self) -> str:
        return self.blob().decode("utf-8")

    def bool_(self) -> bool:
        return self.u8() != 0


# -------------------------------------------------------------- field types

def w_ft(w: Writer, ft: FieldType):
    w.u8(int(ft.tp))
    w.i32(int(ft.flag))
    w.i32(ft.flen)
    w.i32(ft.decimal)
    w.s(ft.charset)
    w.i32(int(ft.collate))
    w.i32(len(ft.elems))
    for e in ft.elems:
        w.s(e)


def r_ft(r: Reader) -> FieldType:
    tp = TypeCode(r.u8())
    flag = Flag(r.i32())
    flen = r.i32()
    dec = r.i32()
    charset = r.s()
    collate = Collation(r.i32())
    elems = tuple(r.s() for _ in range(r.i32()))
    return FieldType(tp, flag, flen, dec, charset, collate, elems)


# -------------------------------------------------------------- datums

def w_datum(w: Writer, d: Datum):
    w.u8(int(d.kind))
    k = d.kind
    if k == DatumKind.Null:
        return
    if k in (DatumKind.Int64, DatumKind.MysqlDuration):
        w.i64(int(d.val))
    elif k == DatumKind.Uint64:
        w.u64(int(d.val))
    elif k in (DatumKind.Float64, DatumKind.Float32):
        w.f64(float(d.val))
    elif k in (DatumKind.String, DatumKind.Bytes, DatumKind.MysqlJSON):
        v = d.val
        w.blob(v.encode("utf-8") if isinstance(v, str) else bytes(v))
    elif k == DatumKind.MysqlDecimal:
        w.s(str(d.val))
    elif k == DatumKind.MysqlTime:
        w.u64(d.val.packed)
        w.u8(d.val.fsp)
    else:
        raise NotImplementedError(f"wire datum kind {k}")


def w_opt_datum(w: Writer, d):
    """Optional datum (ColumnInfo.default — tipb default_val analog)."""
    if d is None:
        w.u8(0)
    else:
        w.u8(1)
        w_datum(w, d)


def r_opt_datum(r: Reader):
    return r_datum(r) if r.u8() else None


def r_datum(r: Reader) -> Datum:
    k = DatumKind(r.u8())
    if k == DatumKind.Null:
        return Datum.NULL
    if k == DatumKind.Int64:
        return Datum.i64(r.i64())
    if k == DatumKind.MysqlDuration:
        return Datum(DatumKind.MysqlDuration, r.i64())
    if k == DatumKind.Uint64:
        return Datum.u64(r.u64())
    if k == DatumKind.Float64:
        return Datum.f64(r.f64())
    if k == DatumKind.Float32:
        return Datum(DatumKind.Float32, r.f64())
    if k == DatumKind.String:
        return Datum.string(r.blob().decode("utf-8", "surrogateescape"))
    if k in (DatumKind.Bytes, DatumKind.MysqlJSON):
        return Datum(k, r.blob())
    if k == DatumKind.MysqlDecimal:
        return Datum.dec(MyDecimal(r.s()))
    if k == DatumKind.MysqlTime:
        packed = r.u64()
        fsp = r.u8()
        return Datum.time(MyTime(packed, fsp))
    raise NotImplementedError(f"wire datum kind {k}")


# -------------------------------------------------------------- expressions

_EXPR_COL, _EXPR_CONST, _EXPR_FUNC = 1, 2, 3


def w_expr(w: Writer, e: Expr):
    if isinstance(e, ColumnRef):
        w.u8(_EXPR_COL)
        w.i32(e.index)
        w_ft(w, e.ft)
    elif isinstance(e, Const):
        w.u8(_EXPR_CONST)
        w_datum(w, e.datum)
        w_ft(w, e.ft)
    elif isinstance(e, ScalarFunc):
        w.u8(_EXPR_FUNC)
        w.s(e.op)
        w.i32(len(e.args))
        for a in e.args:
            w_expr(w, a)
        w_ft(w, e.ft)
    else:
        raise NotImplementedError(f"wire expr {type(e).__name__}")


def r_expr(r: Reader) -> Expr:
    tag = r.u8()
    if tag == _EXPR_COL:
        idx = r.i32()
        return ColumnRef(idx, r_ft(r))
    if tag == _EXPR_CONST:
        d = r_datum(r)
        return Const(d, r_ft(r))
    if tag == _EXPR_FUNC:
        op = r.s()
        args = tuple(r_expr(r) for _ in range(r.i32()))
        return ScalarFunc(op, args, r_ft(r))
    raise ValueError(f"bad expr tag {tag}")


def w_agg_desc(w: Writer, d: AggDesc):
    w.s(d.name)
    w.u8(int(d.mode))
    w.bool_(d.distinct)
    w.bool_(d.extra is not None)
    if d.extra is not None:
        w.s(d.extra)
    w.i32(len(d.args))
    for a in d.args:
        w_expr(w, a)
    w_ft(w, d.ft)


def r_agg_desc(r: Reader) -> AggDesc:
    name = r.s()
    mode = AggMode(r.u8())
    distinct = r.bool_()
    extra = r.s() if r.bool_() else None
    args = tuple(r_expr(r) for _ in range(r.i32()))
    ft = r_ft(r)
    return AggDesc(name, args, mode=mode, distinct=distinct, ft=ft, extra=extra)


# -------------------------------------------------------------- executors

_EX_SCAN, _EX_SEL, _EX_PROJ, _EX_AGG, _EX_TOPN, _EX_LIMIT, _EX_JOIN, _EX_ISCAN, _EX_SORT = range(1, 10)


def w_executor(w: Writer, ex):
    from ..exec.dag import Aggregation, ColumnInfo, IndexScan, Join, Limit, Projection, Selection, Sort, TableScan, TopN

    if isinstance(ex, IndexScan):
        w.u8(_EX_ISCAN)
        w.i64(ex.table_id)
        w.i64(ex.index_id)
        w.bool_(ex.desc)
        w.i32(len(ex.columns))
        for c in ex.columns:
            w.i64(c.col_id)
            w_ft(w, c.ft)
            w_opt_datum(w, c.default)
    elif isinstance(ex, TableScan):
        w.u8(_EX_SCAN)
        w.i64(ex.table_id)
        w.bool_(ex.desc)
        w.i32(len(ex.columns))
        for c in ex.columns:
            w.i64(c.col_id)
            w_ft(w, c.ft)
            w_opt_datum(w, c.default)
    elif isinstance(ex, Selection):
        w.u8(_EX_SEL)
        w.i32(len(ex.conditions))
        for c in ex.conditions:
            w_expr(w, c)
    elif isinstance(ex, Projection):
        w.u8(_EX_PROJ)
        w.i32(len(ex.exprs))
        for e in ex.exprs:
            w_expr(w, e)
    elif isinstance(ex, Aggregation):
        w.u8(_EX_AGG)
        w.bool_(ex.stream)
        w.bool_(ex.partial)
        w.bool_(ex.merge)
        w.i32(len(ex.group_by))
        for g in ex.group_by:
            w_expr(w, g)
        w.i32(len(ex.aggs))
        for a in ex.aggs:
            w_agg_desc(w, a)
    elif isinstance(ex, TopN):
        w.u8(_EX_TOPN)
        w.i64(ex.limit)
        w.i32(len(ex.order_by))
        for e, desc in ex.order_by:
            w_expr(w, e)
            w.bool_(desc)
    elif isinstance(ex, Limit):
        w.u8(_EX_LIMIT)
        w.i64(ex.limit)
    elif isinstance(ex, Sort):
        w.u8(_EX_SORT)
        w.i32(len(ex.order_by))
        for e, desc in ex.order_by:
            w_expr(w, e)
            w.bool_(desc)
    elif isinstance(ex, Join):
        w.u8(_EX_JOIN)
        w.s(ex.join_type)
        w.bool_(ex.build_unique)
        w.i32(len(ex.build))
        for b in ex.build:
            w_executor(w, b)
        w.i32(len(ex.probe_keys))
        for k in ex.probe_keys:
            w_expr(w, k)
        for k in ex.build_keys:
            w_expr(w, k)
    else:
        raise NotImplementedError(f"wire executor {type(ex).__name__}")


def r_executor(r: Reader):
    from ..exec.dag import Aggregation, ColumnInfo, IndexScan, Join, Limit, Projection, Selection, Sort, TableScan, TopN

    tag = r.u8()
    if tag == _EX_ISCAN:
        tid = r.i64()
        iid = r.i64()
        desc = r.bool_()
        cols = tuple(ColumnInfo(r.i64(), r_ft(r), r_opt_datum(r)) for _ in range(r.i32()))
        return IndexScan(tid, iid, cols, desc)
    if tag == _EX_SCAN:
        tid = r.i64()
        desc = r.bool_()
        cols = tuple(ColumnInfo(r.i64(), r_ft(r), r_opt_datum(r)) for _ in range(r.i32()))
        return TableScan(tid, cols, desc)
    if tag == _EX_SEL:
        return Selection(tuple(r_expr(r) for _ in range(r.i32())))
    if tag == _EX_PROJ:
        return Projection(tuple(r_expr(r) for _ in range(r.i32())))
    if tag == _EX_AGG:
        stream = r.bool_()
        partial = r.bool_()
        merge = r.bool_()
        group_by = tuple(r_expr(r) for _ in range(r.i32()))
        aggs = tuple(r_agg_desc(r) for _ in range(r.i32()))
        return Aggregation(group_by, aggs, stream, partial, merge)
    if tag == _EX_TOPN:
        limit = r.i64()
        order = tuple((r_expr(r), r.bool_()) for _ in range(r.i32()))
        return TopN(order, limit)
    if tag == _EX_LIMIT:
        return Limit(r.i64())
    if tag == _EX_SORT:
        return Sort(tuple((r_expr(r), r.bool_()) for _ in range(r.i32())))
    if tag == _EX_JOIN:
        jt = r.s()
        bu = r.bool_()
        build = tuple(r_executor(r) for _ in range(r.i32()))
        nk = r.i32()
        pks = tuple(r_expr(r) for _ in range(nk))
        bks = tuple(r_expr(r) for _ in range(nk))
        return Join(build, pks, bks, jt, build_unique=bu)
    raise ValueError(f"bad executor tag {tag}")


def encode_dag(dag) -> bytes:
    """DAGRequest -> bytes (the tipb.DAGRequest analog)."""
    w = Writer()
    w.i32(len(dag.executors))
    for ex in dag.executors:
        w_executor(w, ex)
    w.i32(len(dag.output_offsets))
    for o in dag.output_offsets:
        w.i32(o)
    w.s(dag.time_zone)
    w.i64(dag.flags)
    return w.done()


def decode_dag(b: bytes):
    from ..exec.dag import DAGRequest

    r = Reader(b)
    executors = tuple(r_executor(r) for _ in range(r.i32()))
    offsets = tuple(r.i32() for _ in range(r.i32()))
    tz = r.s()
    flags = r.i64()
    return DAGRequest(executors, offsets, tz, flags)


# ------------------------------------------------------- mpp fragment frames

# exchange partition-mode tags (ref: tipb.ExchangeType — PassThrough /
# Broadcast / Hash; mpp/fragment.py mirrors the same three modes)
_EXCH_MODES = ("hash", "broadcast", "passthrough")


def w_exchange_sender(w: Writer, s):
    w.u8(_EXCH_MODES.index(s.exchange_type))
    w.i32(s.target_fragment)
    w.i32(len(s.partition_keys))
    for k in s.partition_keys:
        w_expr(w, k)


def r_exchange_sender(r: Reader):
    from ..mpp.fragment import ExchangeSender

    mode = _EXCH_MODES[r.u8()]
    target = r.i32()
    keys = tuple(r_expr(r) for _ in range(r.i32()))
    return ExchangeSender(mode, keys, target)


def encode_fragment_plan(fplan) -> bytes:
    """FragmentPlan -> bytes — the per-query ExchangeSender wire seam (the
    tipb.DispatchTaskRequest analog: fragment topology + per-fragment plan
    slices). mpp/dispatch.py round-trips every dispatched plan through
    this frame, so the fragment graph is proven wire-clean per query, the
    way use_wire proves the cop DAG."""
    w = Writer()
    w.i32(fplan.n_tasks)
    w.i32(fplan.root)
    w.i32(len(fplan.fragments))
    for f in fplan.fragments:
        w.i32(f.idx)
        w.i32(len(f.executors))
        for ex in f.executors:
            w_executor(w, ex)
        w.i32(len(f.receivers))
        for rcv in f.receivers:
            w.i32(rcv.source_fragment)
        w_exchange_sender(w, f.sender)
    return w.done()


def decode_fragment_plan(b: bytes):
    from ..mpp.fragment import ExchangeReceiver, Fragment, FragmentPlan

    r = Reader(b)
    n_tasks = r.i32()
    root = r.i32()
    frags = []
    for _ in range(r.i32()):
        idx = r.i32()
        executors = tuple(r_executor(r) for _ in range(r.i32()))
        receivers = tuple(ExchangeReceiver(r.i32()) for _ in range(r.i32()))
        sender = r_exchange_sender(r)
        frags.append(Fragment(idx, executors, receivers, sender))
    return FragmentPlan(tuple(frags), n_tasks, root)


# -------------------------------------------------------------- chunks

def encode_chunk(ch: Chunk) -> bytes:
    """Chunk -> bytes: per column, FieldType + null bitmap + raw buffers —
    the TypeChunk idea (ref: pkg/util/chunk/codec.go:37 — raw little-endian
    column buffers on the wire, no per-datum encoding)."""
    w = Writer()
    w.i32(len(ch.columns))
    w.i32(ch.num_rows())
    for col in ch.columns:
        w_ft(w, col.ft)
        w.blob(np.packbits(np.asarray(col.null, bool)).tobytes())
        if col.is_varlen():
            w.u8(1)
            w.blob(np.asarray(col.offsets, np.int64).tobytes())
            w.blob(np.asarray(col.blob, np.uint8).tobytes())
        else:
            w.u8(0)
            data = col.data
            w.s(data.dtype.str)
            w.blob(data.tobytes())
    return w.done()


def decode_chunk(b: bytes) -> Chunk:
    r = Reader(b)
    n_cols = r.i32()
    n_rows = r.i32()
    cols = []
    for _ in range(n_cols):
        ft = r_ft(r)
        null = np.unpackbits(np.frombuffer(r.blob(), np.uint8), count=n_rows).astype(bool)
        if r.u8():
            offsets = np.frombuffer(r.blob(), np.int64).copy()
            blob = np.frombuffer(r.blob(), np.uint8).copy()
            cols.append(Column(ft, None, null, offsets, blob))
        else:
            dt = np.dtype(r.s())
            data = np.frombuffer(r.blob(), dt).copy()
            cols.append(Column(ft, data, null))
    return Chunk(cols)


# -------------------------------------------------------------- cop seam

def encode_cop_request(req, _aux_index=None) -> bytes:
    """_aux_index (chunk -> table index) switches the aux section to
    back-references into a frame-level chunk table: a batch frame carries
    each distinct broadcast build side ONCE instead of once per region
    request (N regions x one 64MB build side must not make an N*64MB
    frame). None keeps the self-contained single-request layout."""
    w = Writer()
    b = encode_dag(req.dag)
    w.blob(b)
    w.i32(len(req.ranges))
    for rg in req.ranges:
        w.blob(rg.start)
        w.blob(rg.end)
    w.i64(req.start_ts)
    w.i64(req.region_id)
    w.i64(req.region_epoch)
    w.i32(len(req.aux_chunks))
    for c in req.aux_chunks:
        if _aux_index is None:
            w.blob(encode_chunk(c))
        else:
            w.i32(_aux_index(c))
    w.i32(-1 if req.paging_size is None else req.paging_size)
    w.i32(-1 if req.small_groups is None else req.small_groups)
    w.i32(req.peer_store)
    w.bool_(req.replica_read)
    w.bool_(req.mesh)
    # i64: the tidb_tpu_mesh_min_rows sysvar range (up to 1<<40) exceeds i32
    w.i64(req.mesh_min_rows)
    return w.done()


def decode_cop_request(b: bytes, _aux_table: list | None = None):
    """_aux_table is the batch frame's shared chunk table: every region
    task of a broadcast join references the SAME decoded build side, which
    restores the object identity the store's batch grouping and aux-upload
    cache key on — without it, wire-mode batching would decode N distinct
    copies and every group would collapse to a singleton."""
    from ..store.store import CopRequest, KeyRange

    r = Reader(b)
    dag = decode_dag(r.blob())
    ranges = [KeyRange(r.blob(), r.blob()) for _ in range(r.i32())]
    start_ts = r.i64()
    region_id = r.i64()
    epoch = r.i64()
    n_aux = r.i32()
    if _aux_table is None:
        aux = [decode_chunk(r.blob()) for _ in range(n_aux)]
    else:
        aux = [_aux_table[r.i32()] for _ in range(n_aux)]
    paging = r.i32()
    smg = r.i32()
    peer_store = r.i32()
    replica_read = r.bool_()
    mesh = r.bool_() if r.i < len(r.b) else False
    mesh_min_rows = r.i64() if r.i < len(r.b) else 0
    return CopRequest(dag, ranges, start_ts, region_id, epoch, aux,
                      None if paging < 0 else paging,
                      None if smg < 0 else smg,
                      peer_store=peer_store, replica_read=replica_read,
                      mesh=mesh, mesh_min_rows=mesh_min_rows)


def encode_cop_response(resp) -> bytes:
    w = Writer()
    w.bool_(resp.chunk is not None)
    if resp.chunk is not None:
        w.blob(encode_chunk(resp.chunk))
    w.s(resp.region_error or "")
    w.s(resp.other_error or "")
    w.i32(len(resp.exec_summaries))
    for sm in resp.exec_summaries:
        w.i64(sm.time_processed_ns)
        w.i64(sm.num_produced_rows)
        w.i64(sm.num_iterations)
        w.i64(sm.time_compile_ns)
        w.bool_(sm.cache_hit)
        w.i64(sm.num_bytes)
        w.i64(sm.radix_partitions)
        w.i64(sm.radix_rung)
        w.i64(sm.radix_escapes)
    w.bool_(resp.last_range is not None)
    if resp.last_range is not None:
        w.i32(len(resp.last_range))
        for rg in resp.last_range:
            w.blob(rg.start)
            w.blob(rg.end)
    w.i32(int(getattr(resp, "batched", 0)))
    w.i32(int(getattr(resp, "mesh_merged", 0)))
    return w.done()


def decode_cop_response(b: bytes):
    from ..store.store import CopResponse, ExecSummary, KeyRange

    r = Reader(b)
    chunk = decode_chunk(r.blob()) if r.bool_() else None
    region_error = r.s() or None
    other_error = r.s() or None
    summaries = [
        ExecSummary(r.i64(), r.i64(), r.i64(), r.i64(), r.bool_(), r.i64(),
                    r.i64(), r.i64(), r.i64())
        for _ in range(r.i32())
    ]
    last_range = None
    if r.bool_():
        last_range = [KeyRange(r.blob(), r.blob()) for _ in range(r.i32())]
    batched = r.i32() if r.i < len(r.b) else 0
    mesh_merged = r.i32() if r.i < len(r.b) else 0
    return CopResponse(chunk, region_error, other_error, summaries, last_range, batched,
                       mesh_merged)


# ----------------------------------------------------- batched cop frames

def encode_batch_cop_request(reqs) -> bytes:
    """N cop requests in one frame — the batch-coprocessor wire shape (ref:
    copr/batch_coprocessor.go batching all of a store's region tasks into
    one RPC). Layout: request frames with aux back-references, then the
    shared chunk table — each DISTINCT broadcast build side travels once
    per frame, however many region requests carry it."""
    w = Writer()
    w.i32(len(reqs))
    table: list = []
    index: dict[int, int] = {}

    def aux_index(c) -> int:
        k = id(c)  # objects stay alive for the duration of this call
        if k not in index:
            index[k] = len(table)
            table.append(c)
        return index[k]

    for req in reqs:
        w.blob(encode_cop_request(req, _aux_index=aux_index))
    w.i32(len(table))
    for c in table:
        w.blob(encode_chunk(c))
    return w.done()


def decode_batch_cop_request(b: bytes) -> list:
    r = Reader(b)
    blobs = [r.blob() for _ in range(r.i32())]
    table = [decode_chunk(r.blob()) for _ in range(r.i32())]
    return [decode_cop_request(bb, _aux_table=table) for bb in blobs]


def encode_batch_cop_response(resps) -> bytes:
    """N cop responses in one frame, request order preserved."""
    w = Writer()
    w.i32(len(resps))
    for resp in resps:
        w.blob(encode_cop_response(resp))
    return w.done()


def decode_batch_cop_response(b: bytes) -> list:
    r = Reader(b)
    return [decode_cop_response(r.blob()) for _ in range(r.i32())]
