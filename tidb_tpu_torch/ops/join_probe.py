"""Per-partition probe of the radix-partitioned join, as a CUDA kernel.

Replaces the Pallas kernel `probe_tables_pallas`
(tidb_tpu/ops/join_pallas.py:103, pallas_call at :130). The kernel is
csrc/join_probe.cu (CUDA C++ for sm_90a, bound with ctypes); its design
notes are there. For each radix partition it computes the first matching
build slot of every usable probe slot (part_cap = no match, and for every
unusable probe slot) and the unique-build fan-out flag (some usable probe
slot matches more than one usable build slot). Keys compare as int64
directly: the TPU kernel's hi/lo int32 split (_split32) was a Mosaic
artifact, and unsigned keys are the same bit patterns.

probe_kernel_eligible keeps the TPU kernel's shape gate exactly
(join_pallas.py:56-61), so the kernel runs on the shapes where the TPU ran
its own; other shapes take the "search" probe (ops/radix_join.py).

`probe_tables` launches the kernel for CUDA tensors and runs the plain
torch version `_probe_tables_plain` only for CPU tensors; on CUDA it
launches or raises; a CUDA call is that one launch and no other device
operation. It is a custom op with a vmap rule: under torch.func.vmap (the
region-batched program) one launch serves every region. `probe_tables.launches` counts kernel launches.
`probe_tables_bytes` counts the bytes a probe of given tables must move
(the kernel's bound).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import KernelError, StreamScratch, count_launch

MAX_PART_CAP = 256     # build slots per partition (a 512-entry shared hash table)
MAX_ROWS = 1 << 26     # probe-slot bound of the TPU kernel's gate
_PLAIN_CHUNK = 1 << 24  # compare cells per step of the plain version


def probe_kernel_eligible(n_parts: int, part_cap: int, probe_cap: int) -> bool:
    """The TPU kernel's shape-only gate: decided from capacities, never
    from data."""
    return part_cap <= MAX_PART_CAP and probe_cap % 1024 == 0 and n_parts * probe_cap < MAX_ROWS


def _probe_tables_plain(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok):
    """Plain torch version of the kernel's function: (bpos int32 [P,
    probe_cap], dup bool). The broadcast compare runs over blocks of
    partitions so its [P, probe_cap, part_cap] mask stays bounded."""
    P, part_cap = b_key_tbl.shape
    probe_cap = p_key_tbl.shape[1]
    dev = b_key_tbl.device
    step = max(1, _PLAIN_CHUNK // max(1, probe_cap * part_cap))
    slots = torch.arange(part_cap, dtype=torch.int32, device=dev)
    bpos = torch.empty((P, probe_cap), dtype=torch.int32, device=dev)
    dup = torch.zeros((), dtype=torch.bool, device=dev)
    for p0 in range(0, P, step):
        sl = slice(p0, min(P, p0 + step))
        eq = (p_key_tbl[sl, :, None] == b_key_tbl[sl, None, :]) & b_slot_ok[sl, None, :] & p_slot_ok[sl, :, None]
        bpos[sl] = torch.where(eq, slots, part_cap).amin(dim=-1).to(torch.int32)
        dup = dup | torch.any(eq.sum(dim=-1) > 1)
    return bpos, dup


def probe_tables_bytes(b_slot_ok, p_slot_ok) -> tuple[int, int]:
    """(bytes in, bytes out) that a probe of these tables must move: every
    ok byte of both sides, 32 B for each key sector (4 int64 slots, from
    the table's start) that holds a usable slot, on both sides; out, bpos
    in full (4 B a slot) and the dup flag. The keys of unusable slots are
    don't-cares, so a probe never needs to read a sector without one."""

    def used_sectors(ok) -> int:
        flat = ok.reshape(-1).to(torch.bool)
        pad = -flat.numel() % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return int(flat.view(-1, 4).any(dim=1).sum())

    in_bytes = b_slot_ok.numel() + p_slot_ok.numel() + 32 * (used_sectors(b_slot_ok) + used_sectors(p_slot_ok))
    return in_bytes, 4 * p_slot_ok.numel() + 1


_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/join_probe.cu's entry points: (restype, argtypes)
_SIGNATURES = {
    "probe_tables_scratch_bytes": (_i64, []),
    "probe_tables_launch": (_i32, [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp]),
}


def _fn(name: str):
    """An entry point of the join_probe library, with its ctypes signature."""
    from ..kernels import entry

    return entry("join_probe", name, _SIGNATURES[name])


# the dup word and the CTA ticket, one record per region, per device and
# stream; each region's last CTA leaves its record zeroed for the next call
_k4_scratch = StreamScratch(lambda: _fn("probe_tables_scratch_bytes")())


def _probe_tables_cuda_batched(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok, batch: int):
    """One launch over `batch` regions and no other device operation. The
    probe tables are [B, P, probe_cap]; a build table is [B, P, part_cap],
    or [P, part_cap] when every region shares it (read in place, once per
    region). It writes bpos [B, P, probe_cap] and dup [B] in full, so both
    are allocated empty."""
    from ..kernels import check

    B = int(batch)
    P, part_cap = b_key_tbl.shape[-2:]
    probe_cap = p_key_tbl.shape[-1]
    if not 1 <= part_cap <= MAX_PART_CAP:
        raise ValueError(f"part_cap {part_cap} outside 1..{MAX_PART_CAP}")
    if not 1 <= P < (1 << 31) or probe_cap < 1 or P * probe_cap >= (1 << 31):
        raise ValueError(f"table shape {P} x {probe_cap} outside the kernel's range")
    if not 1 <= B < (1 << 16):
        raise ValueError(f"{B} regions outside 1..65535")
    byte = (torch.bool, torch.uint8)
    shared_key, shared_ok = b_key_tbl.dim() == 2, b_slot_ok.dim() == 2
    check(b_key_tbl, (P, part_cap) if shared_key else (B, P, part_cap), (torch.int64,), "b_key_tbl")
    check(b_slot_ok, (P, part_cap) if shared_ok else (B, P, part_cap), byte, "b_slot_ok")
    check(p_key_tbl, (B, P, probe_cap), (torch.int64,), "p_key_tbl")
    check(p_slot_ok, (B, P, probe_cap), byte, "p_slot_ok")
    dev = b_key_tbl.device
    bpos = torch.empty((B, P, probe_cap), dtype=torch.int32, device=dev)
    dup = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        scratch = _k4_scratch.get(dev, st, B)
        err = _fn("probe_tables_launch")(b_key_tbl.data_ptr(), b_slot_ok.data_ptr(), p_key_tbl.data_ptr(),
                                         p_slot_ok.data_ptr(), P, part_cap, probe_cap, B, int(shared_key),
                                         int(shared_ok), bpos.data_ptr(), dup.data_ptr(), scratch.data_ptr(), st)
    if err != 0:
        # a launch that failed may leave the scratch dirty: never reuse it
        _k4_scratch.drop(dev, st)
        raise KernelError(f"probe_tables kernel launch failed (CUDA error {err})")
    count_launch(probe_tables)
    return bpos, dup


_T = torch.Tensor


@torch.library.custom_op("tidb_tpu_torch::probe_tables", mutates_args=())
def _probe_tables_op(b_key_tbl: _T, b_slot_ok: _T, p_key_tbl: _T, p_slot_ok: _T) -> tuple[_T, _T]:
    if b_key_tbl.device.type == "cuda":
        bpos, dup = _probe_tables_cuda_batched(b_key_tbl, b_slot_ok, p_key_tbl[None], p_slot_ok[None], 1)
        return bpos[0], dup[0]
    return _probe_tables_plain(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok)


@_probe_tables_op.register_fake
def _probe_tables_fake(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok):
    return p_key_tbl.new_empty(p_key_tbl.shape, dtype=torch.int32), p_key_tbl.new_empty((), dtype=torch.bool)


def _probe_tables_vmap(info, in_dims, b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok):
    """The region axis: one launch over every region on the card, a build
    table with no region axis (the broadcast build side) shared in place;
    the plain version lane by lane on the CPU."""
    from ..kernels import lanewise, region_major

    B = info.batch_size
    if b_key_tbl.device.type != "cuda":
        return lanewise(_probe_tables_op, B, in_dims, (b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok))
    d_bk, d_bo, d_pk, d_po = in_dims
    bk = b_key_tbl.contiguous() if d_bk is None else region_major(b_key_tbl, d_bk, B)
    bo = b_slot_ok.contiguous() if d_bo is None else region_major(b_slot_ok, d_bo, B)
    outs = _probe_tables_cuda_batched(bk, bo, region_major(p_key_tbl, d_pk, B), region_major(p_slot_ok, d_po, B), B)
    return outs, (0, 0)


torch.library.register_vmap(_probe_tables_op, _probe_tables_vmap)


def probe_tables(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok):
    """The kernel's function (see _probe_tables_plain): int64 key tables
    [P, part_cap] / [P, probe_cap] with their bool slot masks -> (bpos
    int32 [P, probe_cap], dup bool). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, as the custom op
    `tidb_tpu_torch::probe_tables` (under torch.func.vmap one launch
    serves every region, and a build table without the region axis is
    shared)."""
    if b_key_tbl.device.type not in ("cuda", "cpu"):
        raise ValueError(f"probe_tables: unsupported device {b_key_tbl.device}")
    return _probe_tables_op(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok)


probe_tables.launches = 0
