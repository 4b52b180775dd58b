"""TopN and the full sort (port of tidb_tpu/ops/topn.py; ref: unistore/
cophandler/mpp_exec.go:526 topNExec, pkg/executor/sortexec/topn.go:38).

Keeping k = 100 rows of N by a full lexsort sorts N rows to keep 100, so
the fast path sorts only a sample:

  1. fold (row validity, first-key null flag) into one word s0; take S
     strided pairs (s0, w1) and sort just the sample;
  2. take the j-th sample pair as a threshold, j sized so the expected
     candidate count lands in [k, CAP];
  3. candidates = rows lexicographically <= the threshold on (s0, w1). If
     their count is >= min(k, n_valid), the candidates provably hold the
     true top k (any other row is beaten by >= k candidates); if it is also
     <= CAP the fast path is exact;
  4. compact the candidate positions (cumsum + searchsorted: CAP queries,
     no scatter, no sort), then a CAP-row stable lexsort over every key
     word breaks the remaining ties.

When the check fails (a tie-heavy first word, an adversarial distribution,
fewer valid rows than the sample can see) the overflow flag is set, and
drive_program_info (exec/executor.py) rebuilds the program with
full_sort=True: the exact stable full lexsort. k above FAST_K_LIMIT goes
straight to the full sort. The static arithmetic (stride, j, cap and the
gate) is the JAX package's, so both take the fast path on exactly the same
shapes. The flag stays a 0-d device tensor, read with the other flags.
"""

from __future__ import annotations

import torch

from .keys import lexsort, sort_key_arrays
from .seg import I64_MAX

FAST_K_LIMIT = 2048  # beyond this, the full sort is the right kernel
SAMPLE = 16384  # threshold sample size


def _pow2(x: int) -> int:
    c = 1
    while c < x:
        c *= 2
    return c


def topn(by: list, row_valid: torch.Tensor, k: int, full_sort: bool = False):
    """by: list of (CompVal, desc: bool). Returns (row_indices[k] int64,
    out_valid[k], overflow 0-d bool).

    Invalid rows sort last; out_valid marks slots < min(k, n_valid_rows).
    Ties keep input order (stable), like the reference's heap-pop order.
    On overflow the indices are unusable; the caller rebuilds with
    full_sort=True (exact, no overflow possible)."""
    keys, invalid_last = _order_keys(by, row_valid)
    dev = row_valid.device
    n = row_valid.shape[0]
    k = min(k, n)
    n_valid = row_valid.sum()
    out_valid = torch.arange(k, device=dev) < n_valid

    stride = max(1, n // SAMPLE)
    s_count = n // stride  # sampled pairs
    # expected candidates per sample rank is n / s_count; the margin past
    # the k-quantile scales with the Poisson deviation of the sample count,
    # so an underflow (a needless full-sort rebuild) stays a tail event
    base = (k * s_count) // n
    j = min(base + 4 + 2 * int(base ** 0.5), s_count - 1)
    # cap needs slack above the expected candidate count (~(j+1) sample
    # gaps), or benign uniform data would overflow into the full sort
    expected = (j + 1) * max(1, n // s_count)
    cap = _pow2(max(2 * k + 2 * expected, 256))
    if full_sort or k < 1 or k > FAST_K_LIMIT or cap >= n or len(keys) < 2:
        return _stable_sort_idx(keys, invalid_last)[:k], out_valid, torch.zeros((), dtype=torch.bool, device=dev)

    # s0: the first key's null-flag word with invalid rows pinned to +max;
    # it takes <= 3 values, so the real selection happens on w1
    s0 = torch.where(row_valid, keys[0], I64_MAX)
    w1 = keys[1]
    w1_top = float("inf") if w1.is_floating_point() else I64_MAX
    w1m = torch.where(row_valid, w1, w1_top)  # a scalar operand: no host-to-device copy

    s0_smp, w1_smp = s0[::stride][:s_count], w1m[::stride][:s_count]
    pick = lexsort([s0_smp, w1_smp])[j : j + 1]
    ts0, tw1 = s0_smp[pick], w1_smp[pick]  # one-element tensors: no host sync
    cand = row_valid & ((s0 < ts0) | ((s0 == ts0) & (w1m <= tw1)))
    cnt = cand.sum()
    overflow = (cnt < torch.clamp(n_valid, max=k)) | (cnt > cap)

    # compact the first `cap` candidate positions (ascending by
    # construction, so stability is kept)
    cpos = _first_set_positions(cand, cap)
    cvalid = torch.arange(cap, device=dev) < cnt
    cpos_c = torch.clamp(cpos, 0, n - 1)
    small_keys = [(~cvalid).to(torch.int64)] + [kk[cpos_c] for kk in keys]
    perm_s = lexsort(small_keys, extra_key=cpos_c)
    return cpos_c[perm_s[:k]], out_valid, overflow


def _first_set_positions(cand: torch.Tensor, cap: int, block: int = 256) -> torch.Tensor:
    """Positions (int64) of the first `cap` set bits of cand [N], ascending;
    a rank past the last set bit gets a position the caller masks.

    Two levels: per-block counts locate each rank's block (a search over
    N / block counts), then a [cap, block] row gather and an intra-block
    cumsum find the bit. N not a multiple of the block (or a single block)
    takes one flat cumsum + searchsorted."""
    n = cand.shape[0]
    dev = cand.device
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
    if n % block or n <= block:
        c = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32)
        return torch.searchsorted(c, ranks, side="left")
    nb = n // block
    blocks = cand.reshape(nb, block)
    cum_b = torch.cumsum(blocks.sum(dim=1, dtype=torch.int32), 0, dtype=torch.int32)
    blk = torch.clamp(torch.searchsorted(cum_b, ranks, side="left"), max=nb - 1)
    rows = blocks[blk]  # [cap, block] contiguous row gather
    prev = torch.where(blk > 0, cum_b[torch.clamp(blk - 1, min=0)], 0)
    need = ranks - prev
    ccum = torch.cumsum(rows.to(torch.int32), 1, dtype=torch.int32)
    # argmax takes no bool on CUDA; both return the first maximum
    intra = torch.argmax(((ccum >= need[:, None]) & rows).to(torch.uint8), dim=1)
    return blk * block + intra


def _order_keys(by: list, row_valid: torch.Tensor):
    """ORDER BY -> (normalized key words, invalid-last word): the one place
    the ordering and validity keys are built (topn and sort_all share it)."""
    keys = []
    for v, desc in by:
        keys.extend(sort_key_arrays(v, desc=desc))
    invalid_last = (~row_valid).to(torch.int64)
    return keys, invalid_last


def _stable_sort_idx(keys: list, invalid_last: torch.Tensor) -> torch.Tensor:
    """Stable full-sort permutation with invalid rows compacted to the tail
    (topn's exact path and the Sort executor both use it)."""
    return lexsort([invalid_last] + keys)


def sort_all(by: list, row_valid: torch.Tensor):
    """Full stable sort of the batch (the Sort executor): every valid row,
    in ORDER BY order, invalid rows compacted to the tail. Returns
    (row_indices[n] int64, out_valid[n])."""
    keys, invalid_last = _order_keys(by, row_valid)
    n = row_valid.shape[0]
    idx = _stable_sort_idx(keys, invalid_last)
    out_valid = torch.arange(n, device=row_valid.device) < row_valid.sum()
    return idx, out_valid

