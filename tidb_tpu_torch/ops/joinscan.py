"""Post-sort passes of the packed join+group chain (TPC-H Q3), as CUDA
kernels.

Replaces the Pallas kernels of tidb_tpu/ops/joinscan.py:
  * K2 `postsort_segscan` (:198, pallas_call at :231): one flagged
    segmented scan over the sorted packed keys pk = key << 1 | side (hay
    rows even, probe rows odd) that gives, per key run, the contributing
    probe-row count, the matched flag, exact sums per value lane and
    non-null counts per nullable lane, plus the overflow flag and the
    join-row total;
  * K3 `membership_segscan` (:344, pallas_call at :365): per element, an
    outer (odd) real row whose key run starts with a usable inner row, plus
    the overflow flag (duplicate usable inner keys, or any bad bit).
The kernels are csrc/joinscan.cu (CUDA C++ for sm_90a, bound with ctypes);
their design notes are there. The TPU kernel's 12/12/8-bit limbs, its
0x80000000 bias and its run-length cap (_RUN_CAP, a limb-carry bound) are
gone: Hopper adds int64 natively, so a run of any length stays on K2.

Output contract of K2, identical to the JAX function's: every output is
[n]-aligned; a run's results sit at the run's LAST element, where the run
has a contributing probe row and a match (gv), and 0 everywhere else. key32
is the run's last pk. Overflow: duplicate usable hay keys, or any set bit
of the (unsorted) bad lane. join_rows counts every real probe row.

`postsort_segscan` and `membership_segscan` launch the kernels for CUDA
tensors and run the plain torch versions only for CPU tensors; on CUDA
they launch or raise, and a call is that one launch and no other device
operation (each keeps a zeroed scratch per device and stream). Each is a
custom op with a vmap rule: under torch.func.vmap (the region-batched
program) one launch serves every region. `.launches` on each counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..kernels import KernelError, StreamScratch, count_launch

PIN = (1 << 31) - 4    # joinagg._PIN_HAY: pk >= PIN is an unusable row
_PREV0 = -(1 << 31)    # "previous pk" of element 0: below every real pk
MAX_LANES = 2


def _neighbours(spk: torch.Tensor):
    """(prev_pk, run_start): element 0's predecessor is INT32_MIN."""
    prev = torch.empty_like(spk)
    prev[0:1] = _PREV0
    prev[1:] = spk[:-1]
    keydiff = (spk | 1) != (prev | 1)
    return prev, keydiff


def _run_totals(run_id: torch.Tensor, n_runs: int, x: torch.Tensor) -> torch.Tensor:
    """Per-element total of x over the element's run (int64)."""
    tot = torch.zeros(n_runs, dtype=torch.int64, device=x.device)
    tot.index_add_(0, run_id, x.to(torch.int64))
    return tot[run_id]


# ---------------------------------------------------------------------------
# K2: postsort_segscan
# ---------------------------------------------------------------------------

def _postsort_segscan_plain(spk, lanes_s, bad_lane, nw_s=None, nn_bits=()):
    """Plain torch version of K2 (see the module docstring). Returns
    (gv bool, cnt int64, key32 int32, [sum int64 per lane], [nn int64 per
    lane], overflow bool, join_rows int64), all [n]-aligned."""
    n = spk.shape[0]
    dev = spk.device
    prev, keydiff = _neighbours(spk)
    is_hay = (spk & 1) == 0
    is_real = spk < PIN
    contrib = ~is_hay & is_real
    dup = is_hay & is_real & (spk == prev) & ((prev & 1) == 0)
    mb = contrib & ~keydiff & ((prev & 1) == 0) & (prev == spk - 1)
    start = keydiff.clone()
    start[0:1] = True
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    n_runs = int(run_id[-1]) + 1 if n else 0
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = start[1:]
    cnt_run = _run_totals(run_id, n_runs, contrib)
    gv = is_end & (cnt_run > 0) & (_run_totals(run_id, n_runs, mb) > 0)
    cnt = torch.where(gv, cnt_run, 0)
    key32 = torch.where(gv, spk, 0)
    sums, nns = [], []
    for c, lane in enumerate(lanes_s):
        s = _run_totals(run_id, n_runs, torch.where(contrib, lane.to(torch.int64), 0))
        sums.append(torch.where(gv, s, 0))
        b = nn_bits[c] if c < len(nn_bits) else -1
        if b < 0:
            nns.append(cnt)
        else:
            nn = contrib & (((nw_s.to(torch.int32) >> b) & 1) == 0)
            nns.append(torch.where(gv, _run_totals(run_id, n_runs, nn), 0))
    overflow = torch.any(dup) | torch.any(bad_lane != 0)
    join_rows = contrib.sum()
    return gv, cnt, key32, sums, nns, overflow, join_rows


_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/joinscan.cu's entry points: (restype, argtypes)
_SIGNATURES = {
    "postsort_segscan_tile": (_i32, []),
    "postsort_segscan_scratch_bytes": (_i64, [_i64, _i64]),
    "postsort_segscan_acc_bytes": (_i64, []),
    "postsort_segscan_launch": (_i32, [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i64, _i32, _vp, _vp, _vp,
                                       _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp]),
    "membership_segscan_tile": (_i32, []),
    "membership_segscan_scratch_bytes": (_i64, []),
    "membership_segscan_launch": (_i32, [_vp, _vp, _i64, _i32, _vp, _vp, _vp, _vp]),
}


def _fn(name: str):
    """An entry point of the joinscan library, with its ctypes signature."""
    from ..kernels import entry

    return entry("joinscan", name, _SIGNATURES[name])


K2_TILE = 2048  # csrc/joinscan.cu TILE: the rows of one look-back tile
# (device index, stream) -> zeroed scratch: K2 tags its tile status words
# with an epoch that the kernel keeps in the buffer, so it is never reset
_k2_scratch: dict = {}  # guarded_by: _k2_lock
_k2_lock = threading.Lock()
# each region's flag and join rows, one record per region, per device and
# stream; the kernel's last block leaves them zeroed
_k2_acc = StreamScratch(lambda: _fn("postsort_segscan_acc_bytes")())


def _k2_scratch_for(dev, n: int, regions: int = 1):
    """K2's scratch on dev's current stream, large enough for `regions`
    regions of n rows."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    need = _fn("postsort_segscan_scratch_bytes")(n, regions)
    with _k2_lock:  # dispatch threads share a stream: one buffer for it
        buf = _k2_scratch.get(key)
        if buf is None or buf.numel() < need:
            buf = _k2_scratch[key] = torch.zeros(need, dtype=torch.uint8, device=dev)
        return buf


def _postsort_segscan_cuda_batched(spk, lanes_s, bad_lane, nw_s, bits):
    """One launch over B regions: every input [B, n], region-major and
    contiguous; outputs [B, n], overflow and join_rows [B]. Returns (gv,
    cnt, key32, sums, nns of the lanes whose bit is >= 0, overflow,
    join_rows)."""
    from ..kernels import check, ptr, stream

    B, n = spk.shape
    nc = len(lanes_s)
    if nc > MAX_LANES:
        raise ValueError(f"{nc} value lanes (the kernel takes <= {MAX_LANES})")
    if not 1 <= n < (1 << 31):
        raise ValueError(f"row count {n} outside 1..2^31-1")
    if any(not -1 <= b < 8 for b in bits):
        raise ValueError(f"null bits {bits} outside -1..7")
    check(spk, (B, n), (torch.int32,), "spk")
    check(bad_lane, (B, n), (torch.bool, torch.uint8), "bad_lane")
    for c in range(nc):
        check(lanes_s[c], (B, n), (torch.int32,), f"lanes_s[{c}]")
    if any(b >= 0 for b in bits):
        check(nw_s, (B, n), (torch.uint8,), "nw_s")
    dev = spk.device
    i64 = torch.int64
    gv = torch.empty((B, n), dtype=torch.bool, device=dev)
    cnt = torch.empty((B, n), dtype=i64, device=dev)
    key32 = torch.empty((B, n), dtype=torch.int32, device=dev)
    sums = [torch.empty((B, n), dtype=i64, device=dev) for _ in range(nc)]
    nn_out = [torch.empty((B, n), dtype=i64, device=dev) if b >= 0 else None for b in bits]
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    join_rows = torch.empty(B, dtype=i64, device=dev)
    pad = [None] * (MAX_LANES - nc)
    lanes, sums_p, nns_p = list(lanes_s) + pad, sums + pad, nn_out + pad
    bits_p = list(bits) + [-1] * (MAX_LANES - nc)
    with torch.cuda.device(dev):
        scratch = _k2_scratch_for(dev, n, B)
        acc = _k2_acc.get(dev, torch.cuda.current_stream(dev).cuda_stream, B)
        err = _fn("postsort_segscan_launch")(
            ptr(spk), ptr(lanes[0]), ptr(lanes[1]), ptr(bad_lane), ptr(nw_s), nc, bits_p[0], bits_p[1], n, B,
            ptr(gv), ptr(cnt), ptr(key32), ptr(sums_p[0]), ptr(sums_p[1]), ptr(nns_p[0]), ptr(nns_p[1]),
            ptr(overflow), ptr(join_rows), ptr(scratch), ptr(acc), stream(dev))
    if err != 0:
        raise KernelError(f"postsort_segscan kernel launch failed (CUDA error {err})")
    count_launch(postsort_segscan)
    return gv, cnt, key32, sums, [nn for nn in nn_out if nn is not None], overflow, join_rows


_T = torch.Tensor


@torch.library.custom_op("tidb_tpu_torch::postsort_segscan", mutates_args=())
def _postsort_segscan_op(spk: _T, lanes_s: list[_T], bad_lane: _T, nw_s: _T | None,
                         bits: list[int]) -> tuple[_T, _T, _T, list[_T], list[_T], _T, _T]:
    """K2 as one op: the null counts come back only for the lanes whose
    bit is >= 0 (the others are the run count, which the caller reuses)."""
    if spk.device.type == "cuda":
        outs = _postsort_segscan_cuda_batched(spk[None], [x[None] for x in lanes_s], bad_lane[None],
                                              None if nw_s is None else nw_s[None], bits)
        return (outs[0][0], outs[1][0], outs[2][0], [x[0] for x in outs[3]], [x[0] for x in outs[4]],
                outs[5][0], outs[6][0])
    gv, cnt, key32, sums, nns, overflow, join_rows = _postsort_segscan_plain(spk, lanes_s, bad_lane, nw_s, bits)
    return gv, cnt, key32, sums, [nn for nn, b in zip(nns, bits) if b >= 0], overflow, join_rows


@_postsort_segscan_op.register_fake
def _postsort_segscan_fake(spk, lanes_s, bad_lane, nw_s, bits):
    n = spk.shape[0]
    i64 = torch.int64
    return (spk.new_empty(n, dtype=torch.bool), spk.new_empty(n, dtype=i64), spk.new_empty(n, dtype=torch.int32),
            [spk.new_empty(n, dtype=i64) for _ in lanes_s], [spk.new_empty(n, dtype=i64) for b in bits if b >= 0],
            spk.new_empty((), dtype=torch.bool), spk.new_empty((), dtype=i64))


def _postsort_segscan_vmap(info, in_dims, spk, lanes_s, bad_lane, nw_s, bits):
    """The region axis: one launch over every region on the card, the
    plain version lane by lane on the CPU."""
    from ..kernels import lanewise, region_major

    B = info.batch_size
    if spk.device.type != "cuda":
        return lanewise(_postsort_segscan_op, B, in_dims, (spk, lanes_s, bad_lane, nw_s, bits))
    d_spk, d_lanes, d_bad, d_nw, _ = in_dims
    outs = _postsort_segscan_cuda_batched(
        region_major(spk, d_spk, B), [region_major(x, d, B) for x, d in zip(lanes_s, d_lanes)],
        region_major(bad_lane, d_bad, B), None if nw_s is None else region_major(nw_s, d_nw, B), bits)
    return outs, (0, 0, 0, [0] * len(outs[3]), [0] * len(outs[4]), 0, 0)


torch.library.register_vmap(_postsort_segscan_op, _postsort_segscan_vmap)


def postsort_segscan(spk, lanes_s, bad_lane, nw_s=None, nn_bits=()):
    """K2 (see _postsort_segscan_plain for the contract): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors, as the custom op
    `tidb_tpu_torch::postsort_segscan` (under torch.func.vmap one launch
    serves every region).

    spk int32 [n] sorted packed keys; lanes_s: 0-2 int32 [n] value lanes
    in sorted order, pre-masked to 0 on null and hay rows; bad_lane bool
    [n] (unsorted pre-sort overflow bits); nw_s uint8 [n] sorted null-bit
    word, nn_bits[c] the bit of lane c (-1 = NOT NULL)."""
    if spk.device.type not in ("cuda", "cpu"):
        raise ValueError(f"postsort_segscan: unsupported device {spk.device}")
    bits = [int(nn_bits[c]) if c < len(nn_bits) else -1 for c in range(len(lanes_s))]
    gv, cnt, key32, sums, nn_real, overflow, join_rows = _postsort_segscan_op(
        spk, list(lanes_s), bad_lane, nw_s if any(b >= 0 for b in bits) else None, bits)
    it = iter(nn_real)
    nns = [cnt if b < 0 else next(it) for b in bits]
    return gv, cnt, key32, list(sums), nns, overflow, join_rows


postsort_segscan.launches = 0


# ---------------------------------------------------------------------------
# K3: membership_segscan
# ---------------------------------------------------------------------------

def _membership_segscan_plain(spk, bad_lane):
    """Plain torch version of K3: (ok_out bool [n], overflow bool). ok_out
    marks an outer (odd) real row whose key run's first element is a usable
    inner (even) row; overflow is a duplicate usable inner key or any bad
    bit."""
    n = spk.shape[0]
    prev, keydiff = _neighbours(spk)
    is_inner = (spk & 1) == 0
    is_real = spk < PIN
    dup = is_inner & is_real & (spk == prev) & ((prev & 1) == 0)
    head = is_inner & is_real & keydiff
    start = keydiff.clone()
    start[0:1] = True
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    n_runs = int(run_id[-1]) + 1 if n else 0
    ok_out = ~is_inner & is_real & (_run_totals(run_id, n_runs, head) > 0)
    return ok_out, torch.any(dup) | torch.any(bad_lane != 0)


K3_TILE = 2048  # csrc/joinscan.cu K3_TILE: the rows of one K3 CTA
# the CTA ticket (count and flag), one record per region, per device and
# stream; each region's last CTA leaves its record zeroed for the next call
_k3_scratch = StreamScratch(lambda: _fn("membership_segscan_scratch_bytes")())


def _membership_segscan_cuda_batched(spk, bad_lane):
    """One launch over B regions ([B, n] inputs, region-major and
    contiguous) and no other device operation: it writes ok_out [B, n] and
    the overflow flags [B] in full, so both are allocated empty."""
    from ..kernels import check

    B, n = spk.shape
    if not 1 <= n < (1 << 31):
        raise ValueError(f"row count {n} outside 1..2^31-1")
    if not 1 <= B < (1 << 16):
        raise ValueError(f"{B} regions outside 1..65535")
    check(spk, (B, n), (torch.int32,), "spk")
    check(bad_lane, (B, n), (torch.bool, torch.uint8), "bad_lane")
    dev = spk.device
    ok_out = torch.empty((B, n), dtype=torch.bool, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        scratch = _k3_scratch.get(dev, st, B)
        err = _fn("membership_segscan_launch")(spk.data_ptr(), bad_lane.data_ptr(), n, B, ok_out.data_ptr(),
                                               overflow.data_ptr(), scratch.data_ptr(), st)
    if err != 0:
        # a launch that failed may leave the scratch dirty: never reuse it
        _k3_scratch.drop(dev, st)
        raise KernelError(f"membership_segscan kernel launch failed (CUDA error {err})")
    count_launch(membership_segscan)
    return ok_out, overflow


@torch.library.custom_op("tidb_tpu_torch::membership_segscan", mutates_args=())
def _membership_segscan_op(spk: _T, bad_lane: _T) -> tuple[_T, _T]:
    if spk.device.type == "cuda":
        ok_out, overflow = _membership_segscan_cuda_batched(spk[None], bad_lane[None])
        return ok_out[0], overflow[0]
    return _membership_segscan_plain(spk, bad_lane)


@_membership_segscan_op.register_fake
def _membership_segscan_fake(spk, bad_lane):
    return spk.new_empty(spk.shape[0], dtype=torch.bool), spk.new_empty((), dtype=torch.bool)


def _membership_segscan_vmap(info, in_dims, spk, bad_lane):
    """The region axis: one launch over every region on the card, the
    plain version lane by lane on the CPU."""
    from ..kernels import lanewise, region_major

    B = info.batch_size
    if spk.device.type != "cuda":
        return lanewise(_membership_segscan_op, B, in_dims, (spk, bad_lane))
    outs = _membership_segscan_cuda_batched(region_major(spk, in_dims[0], B), region_major(bad_lane, in_dims[1], B))
    return outs, (0, 0)


torch.library.register_vmap(_membership_segscan_op, _membership_segscan_vmap)


def membership_segscan(spk, bad_lane):
    """K3 (see _membership_segscan_plain for the contract): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors, as the custom op
    `tidb_tpu_torch::membership_segscan` (under torch.func.vmap one launch
    serves every region). spk int32 [n] sorted, as membership_lanes gives
    it (the kernel finds the start of a run longer than 32 rows by a
    search that relies on the order); bad_lane bool [n]."""
    if spk.device.type not in ("cuda", "cpu"):
        raise ValueError(f"membership_segscan: unsupported device {spk.device}")
    return _membership_segscan_op(spk, bad_lane)


membership_segscan.launches = 0
