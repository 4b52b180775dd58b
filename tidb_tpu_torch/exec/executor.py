"""Host-side DAG drivers (port of the device half of tidb_tpu/exec/executor.py).

run_dag_on_chunk(s): pad host Chunks into DeviceBatches, run the program,
decode outputs back to a host Chunk. drive_program_info handles the
overflow contract: on overflow it retries on the capacity ladder
(exec/ladder.py), drops a wrong small-G hint, drops the unique-build and
radix join hints when no rung can clear a join overflow, and rebuilds a
TopN whose sampled threshold missed as the exact full sort. There is no
spill and no row-at-a-time oracle in this port: exhausted retries raise
OverflowRetryError, and host-only operators raise NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..chunk import Chunk, Column, to_device_batch
from .builder import DEFAULT_GROUP_CAPACITY, ProgramCache
from .dag import DAGRequest
from .ladder import overflow_step, rung_for


def _pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_outputs(packed, valid, out_fts) -> Chunk:
    valid = _np(valid)
    idx = np.nonzero(valid)[0]
    cols = []
    for ft, out in zip(out_fts, packed):
        if len(out) == 4:  # string: words, null, raw bytes, lengths
            _, null, data, length = out
            null = _np(null)[idx]
            data = _np(data)[idx]
            length = _np(length)[idx]
            offs = np.zeros(len(idx) + 1, np.int64)
            np.cumsum(np.where(null, 0, length), out=offs[1:])
            blob = np.zeros(int(offs[-1]), np.uint8)
            for j in range(len(idx)):
                if not null[j]:
                    blob[offs[j] : offs[j + 1]] = data[j, : length[j]]
            cols.append(Column(ft, None, null, offs, blob))
        elif ft.is_string() and out[0].ndim == 2:
            # string column without raw bytes (e.g. CASE/IF over string
            # operands): reconstruct from the packed compare words — covers
            # the first STRING_WORDS*8 bytes, the packed-key contract
            words, null = _np(out[0]), _np(out[1])
            words, null = words[idx], null[idx]
            w = words.shape[1] - 1
            payload = (words[:, :w].astype(np.uint64) ^ np.uint64(1 << 63))
            length = np.minimum(np.maximum(words[:, w], 0), w * 8).astype(np.int64)
            length = np.where(null, 0, length)
            byte_mat = np.zeros((len(idx), w * 8), np.uint8)
            for k in range(w):
                for b in range(8):
                    byte_mat[:, k * 8 + b] = ((payload[:, k] >> np.uint64(56 - 8 * b)) & np.uint64(0xFF)).astype(np.uint8)
            offs = np.zeros(len(idx) + 1, np.int64)
            np.cumsum(length, out=offs[1:])
            blob = np.zeros(int(offs[-1]), np.uint8)
            for j in range(len(idx)):
                blob[offs[j] : offs[j + 1]] = byte_mat[j, : length[j]]
            cols.append(Column(ft, None, null.copy(), offs, blob))
        else:
            v, null = out
            v = _np(v)[idx]
            null = _np(null)[idx]
            if ft.is_unsigned() or ft.is_time():
                v = v.view(np.uint64) if v.dtype == np.int64 else v.astype(np.uint64)
            cols.append(Column(ft, v.copy(), null.copy()))
    return Chunk(cols)


# Shared default so repeated executions of the same plan shape reuse the
# built program.
DEFAULT_PROGRAM_CACHE = ProgramCache()


class OverflowRetryError(RuntimeError):
    """Capacity growth retries exhausted (this port has no spill and no
    oracle to fall back to)."""


def drive_program(cache: ProgramCache, dag: DAGRequest, batches, group_capacity: int, max_retries: int = 3, join_capacity: int | None = None, small_groups: int | None = None):
    """drive_program_info without the attribution dict:
    (chunk, per-executor produced-row counts, scan first)."""
    chunk, counts, _ = drive_program_info(cache, dag, batches, group_capacity, max_retries, join_capacity, small_groups)
    return chunk, counts


def _radix_attribution(prog, jc: int, radix_esc, info: dict):
    """info["radix"]: what the first radix join of the program ran
    (partitions, probe strategy), the join-capacity rung, and the escaped
    row count, which arrived in the same fetch as the overflow flags."""
    ri = prog.radix_info
    if ri:
        info["radix"] = {"partitions": ri.get("partitions", 0), "rung": jc,
                         "escapes": int(radix_esc), "strategy": ri.get("strategy")}


def drive_program_info(cache: ProgramCache, dag: DAGRequest, batches, group_capacity: int, max_retries: int = 3, join_capacity: int | None = None, small_groups: int | None = None):
    """Run the program, growing capacity on overflow; returns (chunk,
    counts, {"cache_hit", "compile_ns"[, "radix"]}). batches: one
    DeviceBatch per scan in canonical order (a single batch for single-scan
    DAGs); the program runs on their device.

    Capacities snap to the ladder rungs; an overflow retry consults the
    program's NEED hints to re-dispatch the exact rung. A group overflow
    also drops the small-G hint (`smg = None`): the driver cannot tell
    whether the one-pass kernel ran, so doing both never wastes a retry. A
    join overflow that no rung can clear (a violated unique-build hint, a
    hash collision) drops the unique-build and radix hints, so the retry
    lands on the general kernel (ops/join.py). A TopN overflow (its sampled
    threshold missed) rebuilds with topn_full=True, the exact full sort."""
    if not isinstance(batches, (list, tuple)):
        batches = [batches]
    device = batches[0].row_valid.device
    caps = tuple(b.capacity for b in batches)
    gc = rung_for(group_capacity)
    jc = rung_for(join_capacity or max(caps))
    tf = False
    smg = small_groups
    uj = True
    rj = True
    info = {"cache_hit": True, "compile_ns": 0}
    for _ in range(max_retries + 1):
        prog, hit, build_ns = cache.get_info(dag, caps, gc, jc, tf, smg, device=device, unique_joins=uj,
                                             radix_joins=rj)
        t0 = time.perf_counter_ns()
        packed, valid, n, (g_ovf, j_ovf, t_ovf, g_need, j_need, radix_esc), ex_rows = prog.fn(*batches)
        g_ovf, j_ovf, t_ovf = bool(g_ovf), bool(j_ovf), bool(t_ovf)
        if not hit:
            info["cache_hit"] = False
            info["compile_ns"] += build_ns + (time.perf_counter_ns() - t0)
        if not g_ovf and not j_ovf and not t_ovf:
            counts = [int(x) for x in _np(ex_rows)]
            _radix_attribution(prog, jc, radix_esc, info)
            return decode_outputs(packed, valid, prog.out_fts), counts, info
        if g_ovf:
            smg = None
        gc, jc, drop = overflow_step(gc, jc, g_ovf, j_ovf, int(g_need), int(j_need))
        if drop:
            uj = False
            rj = False
        if t_ovf:
            tf = True  # TopN candidate overflow: the exact full-sort variant
    raise OverflowRetryError("DAG overflow not resolved after retries")


def run_dag_on_chunks(
    dag: DAGRequest,
    chunks: list,
    cache: ProgramCache | None = None,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    max_retries: int = 3,
    small_groups: int | None = None,
    device="cuda",
) -> Chunk:
    """Device path over one chunk per scan."""
    cache = cache or DEFAULT_PROGRAM_CACHE
    batches = [to_device_batch(c, capacity=_pow2(max(c.num_rows(), 1)), device=device) for c in chunks]
    return drive_program(cache, dag, batches, group_capacity, max_retries, small_groups=small_groups)[0]


def run_dag_on_chunk(
    dag: DAGRequest,
    chunk: Chunk,
    cache: ProgramCache | None = None,
    capacity: int | None = None,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    max_retries: int = 3,
    device="cuda",
) -> Chunk:
    cache = cache or DEFAULT_PROGRAM_CACHE
    cap = capacity or _pow2(max(chunk.num_rows(), 1))
    batch = to_device_batch(chunk, capacity=cap, device=device)
    return drive_program(cache, dag, batch, group_capacity, max_retries)[0]
