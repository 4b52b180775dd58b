"""Frozen copies, so that no later change to their originals moves the
yardstick.

- HBM_BYTES_PER_S, SIMT_OPS_PER_S, bound(): chip_smoke.py at commit
  16a2cd99 (lines 410-411 and 573-578), unchanged.
- round_div(): chip_smoke.py at commit 16a2cd99 (lines 753-755), unchanged:
  MySQL's decimal division, rounded half away from zero.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SIMT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)


def bound(in_bytes: int, out_bytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the 32-bit rate."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def round_div(num: int, den: int) -> int:
    q = (2 * abs(num) + abs(den)) // (2 * abs(den))
    return -q if (num < 0) != (den < 0) else q


def probe_tables_work(b_slot_ok, p_slot_ok):
    """(bytes in, bytes out, operations) that K4's probe of these tables
    must do, as device tensors where they depend on the masks' values.
    Bytes: tidb_tpu_torch/ops/join_probe.py probe_tables_bytes at commit
    16a2cd99 (lines 64-79): every ok byte of both sides, 32 B for each key
    sector (4 int64 slots) that holds a usable slot, on both sides; out,
    4 B a probe slot and the dup flag. Operations: chip_smoke.py phase 5 at
    the same commit (line 5903): 2 per compare of a usable probe slot with a
    usable build slot of its partition."""
    import torch

    def used_sectors(ok):
        flat = ok.reshape(-1).to(torch.bool)
        pad = -flat.numel() % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(-1, 4).any(dim=1).sum()

    in_bytes = b_slot_ok.numel() + p_slot_ok.numel() + 32 * (used_sectors(b_slot_ok) + used_sectors(p_slot_ok))
    compares = (p_slot_ok.sum(dim=-1).to(torch.int64) * b_slot_ok.sum(dim=-1).to(torch.int64)).sum()
    return in_bytes, 4 * p_slot_ok.numel() + 1, 2 * compares
