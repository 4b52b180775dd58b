"""One-pass small-G GROUP BY — the TPC-H Q1 shape, as a CUDA kernel.

Replaces the Pallas kernel `group_aggregate_dense_pallas`
(tidb_tpu/ops/dense_pallas.py:223, pallas_call at :415). The kernel itself
is csrc/dense_agg.cu (CUDA C++ for sm_90a, bound with ctypes), one launch
per call; its design notes are there. This module keeps what surrounds it, as the JAX package
keeps it outside the pallas_call: the eligibility gate, the key folds
(_key_words), the two hashes, the combo lanes, and the epilogue that turns
the kernel's accumulators into a GroupAggResult laid out exactly as
dense_pallas.py:452-467 does.

Group identity is the engine's double-hash contract (ops/seg.py): rows
match on the primary hash hp (bit 63 clear on valid rows); a row whose independently salted
verify hash hv differs from its group's first row raises the overflow flag
(the retry driver then takes the sort path), as does a (G+1)-th key.

Bound on an H100 SXM (3.35 TB/s): memory. One pass reads hp, hv, the
row-valid byte and, per (value, null) combo, an int64 value and a null
byte: N * (17 + 9 * NC) bytes — ~0.22 GB and ~66 us for Q1 at 2^22 rows
(NC = 4). See csrc/dense_agg.cu for what the design does about it.

`dense_agg` launches the kernel for CUDA tensors and runs the plain torch
version `_dense_agg_plain` only for CPU tensors; on CUDA it launches or
raises. It is a custom op with a vmap rule: under torch.func.vmap (the
region-batched program) one launch serves every region, on a grid that
gains a region axis. `dense_agg.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import KernelError, StreamScratch, count_launch
from .keys import sort_key_arrays
from .seg import _lsr, group_hash, hash_words

SLOTS = 64            # hash-table slots per block and globally
MAX_G = 32            # largest small-G hint the kernel takes
MAX_COMBOS = 6        # distinct (value, null) argument combos
_ALLOWED = frozenset({"count", "sum", "avg"})


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _keys_eligible(group_bys) -> bool:
    """The cases in which _key_words returns None, decided from shapes and
    types alone (no folds computed): float sort words (NaN: bit equality is
    not SQL equality), no keys, or more than 32 keys (the null bitmask)."""
    if not group_bys or len(group_bys) > 32:
        return False
    return all(g.value.dim() == 2 or g.eval_type != "real" for g in group_bys)


def _key_words(group_bys):
    """TWO independent word lists for the match / verify hashes.

    Multi-word keys (strings pack to 5 words) are first reduced to one
    word per hash by a linear rotate-xor fold with two different rotation
    schedules, so a fold collision in one hash is independent of the
    other. Callers check _keys_eligible first."""
    wa, wb = [], []
    nf = None
    for k, g in enumerate(group_bys):
        if g.value.dim() == 2:
            words = g.value
            if g.ft.is_ci():
                from ..expr.compile import fold_words_ci

                words = fold_words_ci(words)
            words = torch.where(g.null[:, None], 0, words)
            W = words.shape[1]

            def fold(step: int):
                acc = None
                for j in range(W):
                    sh = (step * j) % 63 + (1 if j else 0)
                    w = words[:, j]
                    rot = w if sh == 0 else _rotl64(w, sh)
                    acc = rot if acc is None else acc ^ rot
                return acc

            fa, fb = fold(7), fold(13)
        else:
            vals = sort_key_arrays(g)[1:]
            fa, fb = vals[0], vals[0]
            for j, w in enumerate(vals[1:], start=1):
                fa = fa ^ _rotl64(w, (7 * j) % 63 + 1)
                fb = fb ^ _rotl64(w, (13 * j) % 63 + 1)
        wa.append(fa)
        wb.append(fb)
        b = g.null.to(torch.int64) << k
        nf = b if nf is None else nf | b
    return wa + [nf], wb + [nf]


def dense_agg_eligible(group_bys, aggs, merge: bool) -> bool:
    """Strict subset the one-pass kernel handles (dense_pallas_eligible
    without the TPU kernel's row-count gate, which was an int32 limb
    artifact). A performance router, never a semantics change."""
    if merge or not group_bys:
        return False
    if not _keys_eligible(group_bys):
        return False
    combos = set()
    for desc, avs in aggs:
        if desc.name not in _ALLOWED or desc.distinct:
            return False
        if desc.name == "count":
            if len(avs) > 1:
                return False
        elif len(avs) != 1:
            return False
        if avs:
            a = avs[0]
            if a.eval_type not in ("int", "decimal") or a.value.dim() != 1:
                return False
            if a.value.dtype != torch.int64:
                return False
            combos.add((id(a.value), id(a.null)))
    return len(combos) <= MAX_COMBOS


# ---------------------------------------------------------------------------
# the kernel's function: plain version and CUDA wrapper
# ---------------------------------------------------------------------------

def _dense_agg_plain(hp, hv, row_valid, vals, nulls, g_cap: int):
    """Plain torch version of the kernel's function.

    Returns (group_rep int32[G], n_groups int32[], overflow bool[],
    counts int64[G], sums int64[NC, G], nns int64[NC, G]): groups in
    first-encounter order, group_rep = first valid row of each group,
    count(*) / per-combo wrapping int64 sum / per-combo non-null count.
    overflow: more than G distinct hp among valid rows, or a valid row
    whose hv differs from its group's first row. Rows of groups ranked
    >= G are left out of every sum."""
    dev = hp.device
    n = hp.shape[0]
    G = int(g_cap)
    nc = len(vals)
    idx = torch.nonzero(row_valid).flatten()
    uniq, inv = torch.unique(hp[idx], return_inverse=True)
    nu = int(uniq.shape[0])
    rep = torch.full((nu,), n, dtype=torch.int64, device=dev)
    rep = rep.scatter_reduce(0, inv, idx, reduce="amin", include_self=True)
    order = torch.argsort(rep)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nu, dtype=torch.int64, device=dev)
    gid = rank[inv]
    overflow = torch.tensor(nu > G, device=dev) | torch.any(hv[idx] != hv[rep[inv]])
    keep = gid < G
    g, rows = gid[keep], idx[keep]
    counts = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, g, torch.ones_like(g))
    sums = torch.zeros((nc, G), dtype=torch.int64, device=dev)
    nns = torch.zeros((nc, G), dtype=torch.int64, device=dev)
    for c in range(nc):
        nn = ~nulls[c][rows]
        sums[c].index_add_(0, g, torch.where(nn, vals[c][rows], 0))
        nns[c].index_add_(0, g, nn.to(torch.int64))
    ng = min(nu, G)
    group_rep = torch.zeros(G, dtype=torch.int32, device=dev)
    group_rep[:ng] = rep[order][:ng].to(torch.int32)
    return group_rep, torch.tensor(ng, dtype=torch.int32, device=dev), overflow, counts, sums, nns


_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_vpp = ctypes.POINTER(ctypes.c_void_p)
# csrc/dense_agg.cu's entry points: (restype, argtypes)
_SIGNATURES = {
    "dense_agg_scratch_bytes": (_i64, []),
    "dense_agg_launch": (_i32, [_vp, _vp, _vp, _i64, _vpp, _vpp, _i32, _i32, _i32,
                                _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp]),
}


def _fn(name: str):
    """An entry point of the dense_agg library, with its ctypes signature."""
    from ..kernels import entry

    return entry("dense_agg", name, _SIGNATURES[name])


# the 64-slot table the blocks merge into, one record per region, per
# device and stream; each region's last block leaves its record zeroed
_k1_scratch = StreamScratch(lambda: _fn("dense_agg_scratch_bytes")())


def _dense_agg_cuda_batched(hp, hv, row_valid, vals, nulls, g_cap: int):
    """One launch of the kernel over B regions and no other device
    operation. Every input is [B, n], region-major and contiguous; the
    outputs gain the leading region axis. Valid rows' hp must have bit 63
    clear (as group_hash gives them). The kernel writes every output in
    full, so they are allocated empty."""
    from ..kernels import check

    B, n = hp.shape
    G = int(g_cap)
    nc = len(vals)
    if not 1 <= G <= MAX_G:
        raise ValueError(f"g_cap {G} outside 1..{MAX_G}")
    if nc > MAX_COMBOS or len(nulls) != nc:
        raise ValueError(f"{nc} value lanes / {len(nulls)} null lanes (max {MAX_COMBOS})")
    if n >= 1 << 31:
        raise ValueError("row index must fit int32 (group_rep)")
    if not 1 <= B < 1 << 16:
        raise ValueError(f"{B} regions outside 1..65535")
    byte = (torch.bool, torch.uint8)
    check(hp, (B, n), (torch.int64,), "hp")
    check(hv, (B, n), (torch.int64,), "hv")
    check(row_valid, (B, n), byte, "row_valid")
    for c in range(nc):
        check(vals[c], (B, n), (torch.int64,), f"vals[{c}]")
        check(nulls[c], (B, n), byte, f"nulls[{c}]")
    dev = hp.device
    # six allocations cost the host less than views of one buffer would
    i64, i32 = torch.int64, torch.int32
    group_rep = torch.empty((B, G), dtype=i32, device=dev)
    n_groups = torch.empty(B, dtype=i32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    counts = torch.empty((B, G), dtype=i64, device=dev)
    sums = torch.empty((B, nc, G), dtype=i64, device=dev)
    nns = torch.empty((B, nc, G), dtype=i64, device=dev)
    varr = (_vp * MAX_COMBOS)(*[v.data_ptr() for v in vals])
    narr = (_vp * MAX_COMBOS)(*[m.data_ptr() for m in nulls])
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        scratch = _k1_scratch.get(dev, st, B)
        err = _fn("dense_agg_launch")(hp.data_ptr(), hv.data_ptr(), row_valid.data_ptr(), n, varr, narr, nc, G, B,
                                      group_rep.data_ptr(), n_groups.data_ptr(), overflow.data_ptr(),
                                      counts.data_ptr(), sums.data_ptr(), nns.data_ptr(), scratch.data_ptr(), st)
    if err != 0:
        # a launch that failed may leave the table dirty: never reuse it
        _k1_scratch.drop(dev, st)
        raise KernelError(f"dense_agg kernel launch failed (CUDA error {err})")
    count_launch(dense_agg)
    return group_rep, n_groups, overflow, counts, sums, nns


_T = torch.Tensor


@torch.library.custom_op("tidb_tpu_torch::dense_agg", mutates_args=())
def _dense_agg_op(hp: _T, hv: _T, row_valid: _T, vals: list[_T], nulls: list[_T],
                  g_cap: int) -> tuple[_T, _T, _T, _T, _T, _T]:
    if hp.device.type == "cuda":  # the launch over one region
        outs = _dense_agg_cuda_batched(hp[None], hv[None], row_valid[None], [v[None] for v in vals],
                                       [m[None] for m in nulls], g_cap)
        return tuple(o[0] for o in outs)
    return _dense_agg_plain(hp, hv, row_valid, vals, nulls, g_cap)


@_dense_agg_op.register_fake
def _dense_agg_fake(hp, hv, row_valid, vals, nulls, g_cap):
    G, nc = int(g_cap), len(vals)
    i64, i32 = torch.int64, torch.int32
    return (hp.new_empty(G, dtype=i32), hp.new_empty((), dtype=i32), hp.new_empty((), dtype=torch.bool),
            hp.new_empty(G, dtype=i64), hp.new_empty((nc, G), dtype=i64), hp.new_empty((nc, G), dtype=i64))


def _dense_agg_vmap(info, in_dims, hp, hv, row_valid, vals, nulls, g_cap):
    """The region axis: one launch over every region on the card (the
    counterpart of the grid axis that pallas_call's batching rule adds),
    the plain version lane by lane on the CPU."""
    from ..kernels import lanewise, region_major

    B = info.batch_size
    if hp.device.type != "cuda":
        return lanewise(_dense_agg_op, B, in_dims, (hp, hv, row_valid, vals, nulls, g_cap))
    d_hp, d_hv, d_valid, d_vals, d_nulls, _ = in_dims
    outs = _dense_agg_cuda_batched(region_major(hp, d_hp, B), region_major(hv, d_hv, B),
                                   region_major(row_valid, d_valid, B),
                                   [region_major(v, d, B) for v, d in zip(vals, d_vals)],
                                   [region_major(m, d, B) for m, d in zip(nulls, d_nulls)], g_cap)
    return outs, (0,) * 6


torch.library.register_vmap(_dense_agg_op, _dense_agg_vmap)


def dense_agg(hp, hv, row_valid, vals, nulls, g_cap: int):
    """The kernel's function (see _dense_agg_plain for the contract): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors, as
    the custom op `tidb_tpu_torch::dense_agg`, so that torch.func.vmap
    over the region-batched program launches the kernel once over every
    region (_dense_agg_vmap)."""
    if hp.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dense_agg: unsupported device {hp.device}")
    return _dense_agg_op(hp, hv, row_valid, list(vals), list(nulls), int(g_cap))


dense_agg.launches = 0


# ---------------------------------------------------------------------------
# the aggregation around it
# ---------------------------------------------------------------------------

def dense_agg_lanes(group_bys, aggs, row_valid, g_cap: int):
    """The kernel's inputs, built with torch elementwise ops (the JAX
    package builds them outside its pallas_call too): the match and verify
    hashes, the row mask, and one (value, null) lane pair per distinct
    argument combo. Returns (hp, hv, row_valid, vals, nulls, combo_ix)."""
    G = int(g_cap)
    wa, wb = _key_words(group_bys)
    hp = group_hash(wa, row_valid, salt=G)        # match identity
    hv = hash_words(wb, G + 0x9E3779B9)           # verify identity
    combo_ix: dict = {}
    combo_vals: list = []
    for desc, avs in aggs:
        if desc.name == "count" and not avs:
            continue
        a = avs[0]
        k = (id(a.value), id(a.null))
        if k not in combo_ix:
            combo_ix[k] = len(combo_vals)
            combo_vals.append(a)
    vals = [a.value.contiguous() for a in combo_vals]
    nulls = [a.null.contiguous() for a in combo_vals]
    return hp.contiguous(), hv.contiguous(), row_valid.contiguous(), vals, nulls, combo_ix


def group_aggregate_dense(group_bys, aggs, row_valid, g_cap: int):
    """One-pass small-G aggregation; returns aggregate.GroupAggResult with
    the states laid out as dense_pallas.py:452-467 lays them out.

    aggs: [(AggDesc, [CompVal])] pre-checked by dense_agg_eligible.
    g_cap: slot count (the planner's NDV hint, <= 32)."""
    from .aggregate import GroupAggResult

    G = int(g_cap)
    hp, hv, valid, vals, nulls, combo_ix = dense_agg_lanes(group_bys, aggs, row_valid, G)
    group_rep, n_groups, overflow, counts_star, sums, nns = dense_agg(hp, hv, valid, vals, nulls, G)
    group_valid = torch.arange(G, device=hp.device) < n_groups
    zeros = torch.zeros(G, dtype=torch.bool, device=hp.device)
    states = []
    for desc, avs in aggs:
        if desc.name == "count":
            if not avs:
                states.append([(counts_star, zeros)])
            else:
                c = combo_ix[(id(avs[0].value), id(avs[0].null))]
                states.append([(nns[c], zeros)])
            continue
        c = combo_ix[(id(avs[0].value), id(avs[0].null))]
        empty = nns[c] == 0
        if desc.name == "sum":
            states.append([(sums[c], empty)])
        else:  # avg: [count, sum]
            states.append([(nns[c], zeros), (sums[c], empty)])
    return GroupAggResult(group_rep, group_valid, n_groups, overflow, states)
