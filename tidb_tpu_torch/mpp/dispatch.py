"""The exchange plan's execution core (port of tidb_tpu/mpp/dispatch.py's
execute_exchange_plan; ref: pkg/executor/mpp_gather.go MPPGather).

`execute_exchange_plan` runs an exchange program over already-scanned
region chunks: the chunks play the task lanes (stacked and padded to a
multiple of the mesh width), each join's build table is sliced over the
shards so each slice plays a region shard, and an overflow retries on a
3-rung capacity ladder that reuses the scanned chunks. The session's mesh
select (parallel/sql.py) calls it.

The MPP tier's own dispatch (`try_mpp_select`: the fragment plan through
the wire codec's fragment frames, the columnar replica as the probe
source) is not ported; the session's seam declines it, as the reference
does when its MPP tier declines, and the mesh select runs next.
"""

from __future__ import annotations

from ..chunk import Chunk
from .fragment import chunks_exchange_safe

# (encoded dag, n devices, base group capacity) -> the last successful
# (gc, scale) ladder rung; a bounded FIFO, see execute_exchange_plan
_LADDER_HINTS: dict[tuple, tuple[int, int]] = {}


def execute_exchange_plan(dag, chunks, aux_chunks, kind, devs, group_capacity: int = 1024) -> Chunk | None:
    """Launch the exchange program over the scanned chunks, on the mesh of
    `devs` (a list of devices, one shard each; the lead holds the stacked
    input). Overflow (too many groups, a full exchange bucket, join
    fan-out) retries with 4x capacity — the capacity also salts the group
    hash — reusing the scanned chunks. Returns the projected result Chunk,
    or None for a fallback to the per-region path."""
    from ..parallel.grouped import run_sharded_grouped_agg
    from ..parallel.mesh import region_mesh, stack_region_batches
    from ..util import metrics

    agg = dag.executors[-1]
    out_fts = agg.output_fts()
    if not chunks:
        # zero rows scanned: grouped aggregation of nothing is no groups
        return Chunk.empty([out_fts[i] for i in dag.output_offsets])
    if not chunks_exchange_safe(chunks):
        return None  # wide strings cannot ride the exchange byte-exactly

    n = len(devs)
    mesh = region_mesh(devs)
    n_total = ((len(chunks) + n - 1) // n) * n
    try:
        stacked = stack_region_batches(chunks, n_total=n_total, device=mesh.lead)
    except NotImplementedError:
        return None  # e.g. non-ASCII CI data: the per-region path's oracle owns it

    stacked_builds = None
    if kind == "join":
        from .fragment import split_join_dag

        n_stages = len(split_join_dag(dag)[2])
        if aux_chunks is None or len(aux_chunks) < n_stages:
            return None
        stacked_builds = []
        for build in aux_chunks[:n_stages]:
            if not chunks_exchange_safe([build]):
                return None
            if build.num_rows() == 0:
                bslices = [build]
            else:
                step = (build.num_rows() + n - 1) // n
                bslices = [build.slice(i * step, min((i + 1) * step, build.num_rows()))
                           for i in range(n) if i * step < build.num_rows()]
            try:
                stacked_builds.append(stack_region_batches(bslices, n_total=n, device=mesh.lead))
            except NotImplementedError:
                return None

    # the ladder's start rung is remembered per plan identity: a repeated
    # digest starts at the rung that last succeeded. The rung salts the
    # hash, so the hint changes the output order: it is keyed as the
    # reference keys it.
    from ..codec.wire import encode_dag

    hint_key = (encode_dag(dag), n, group_capacity)
    gc, scale = _LADDER_HINTS.get(hint_key, (group_capacity, 1))
    for _ in range(3):
        try:
            if kind == "join":
                from .exchange_op import run_exchange_join_agg

                chunk, overflow = run_exchange_join_agg(dag, stacked, stacked_builds, mesh, group_capacity=gc,
                                                        scale=scale)
            else:
                chunk, overflow = run_sharded_grouped_agg(dag, stacked, mesh, group_capacity=gc)
        except NotImplementedError:
            # an op the device compiler refuses slipped past the static
            # gate: the per-region path keeps host-only work at root
            return None
        if not overflow:
            if len(_LADDER_HINTS) >= 256:
                _LADDER_HINTS.pop(next(iter(_LADDER_HINTS)))
            _LADDER_HINTS[hint_key] = (gc, scale)
            metrics.MESH_SELECTS.inc()
            return Chunk([chunk.columns[i] for i in dag.output_offsets])
        # one overflow flag covers groups, exchange buckets and join
        # fan-out: the middle rung grows scale alone, the last both
        if scale >= 4:
            gc *= 4
        scale *= 4
    return None  # the caller falls back to the per-region path


def ladder_rung(dag, n_devices: int, group_capacity: int) -> tuple[int, int] | None:
    """The (group capacity, scale) rung the last successful run of this
    plan ended on, or None before its first."""
    from ..codec.wire import encode_dag

    return _LADDER_HINTS.get((encode_dag(dag), n_devices, group_capacity))
