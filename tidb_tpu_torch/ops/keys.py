"""Key normalization (port of tidb_tpu/ops/keys.py): every sortable /
groupable value becomes a list of int64 (or float64) key tensors with
lexicographic semantics:

  numeric int/decimal/time  [null_flag, value]
  real                      [null_flag, value with -0.0 canonicalized]
  string                    [null_flag, word0..wordW, length]

NULLs sort first ascending and form one group (MySQL GROUP BY semantics).
"""

from __future__ import annotations

import torch

from ..expr.compile import I64_MIN, CompVal


def _float_sortable(v: torch.Tensor) -> torch.Tensor:
    """Floats stay float keys once -0.0 is canonicalized."""
    v = v.to(torch.float64)
    return torch.where(v == 0.0, 0.0, v)


def sort_key_arrays(v: CompVal, desc: bool = False) -> list[torch.Tensor]:
    """CompVal -> key tensors, most significant first.

    Ascending lexicographic order on the result == SQL ORDER BY order of the
    value with NULLs first; `desc` bit-inverts every word (negates floats),
    which also puts NULLs last. NULL rows' value lanes are zeroed so all
    NULLs compare equal (one group)."""
    nf = 1 - v.null.to(torch.int64)  # null -> 0 (sorts first ascending)
    if v.value.dim() == 2:
        words = v.value
        if v.ft.is_ci():
            from ..expr.compile import fold_words_ci

            words = fold_words_ci(words)
        arrs = [nf] + [words[:, i] for i in range(words.shape[1])]
    elif v.eval_type == "real":
        arrs = [nf, _float_sortable(v.value)]
    elif v.ft.is_unsigned() and v.eval_type == "int":
        arrs = [nf, v.value ^ I64_MIN]
    else:
        arrs = [nf, v.value.to(torch.int64)]
    arrs = [arrs[0]] + [torch.where(v.null, torch.zeros((), dtype=a.dtype, device=a.device), a) for a in arrs[1:]]
    if desc:
        arrs = [-a if a.is_floating_point() else ~a for a in arrs]
    return arrs


def lexsort(keys: list[torch.Tensor], extra_key: torch.Tensor | None = None) -> torch.Tensor:
    """Stable lexicographic argsort (int64), most-significant key first;
    `extra_key` is least significant. One stable sort pass per key, least
    significant first, each carrying the permutation so far."""
    order = list(reversed(keys))
    if extra_key is not None:
        order = [extra_key] + order
    perm = None
    for k in order:
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def segments_from_sorted(sorted_keys: list[torch.Tensor], valid: torch.Tensor):
    """Given key tensors already in sorted row order plus a validity mask
    (invalid rows sorted to the end), return (segment_ids int32 [N],
    n_groups int32). Invalid rows get segment id == n_groups."""
    n = valid.shape[0]
    diff = torch.zeros(n, dtype=torch.bool, device=valid.device)
    for k in sorted_keys:
        # out of place (a vmapped batch's region axis rides through cat)
        d = torch.cat([torch.ones_like(k[:1], dtype=torch.bool), k[1:] != k[:-1]])
        diff = diff | d
    new_seg = diff & valid
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    n_groups = torch.max(torch.where(valid, seg, -1)) + 1
    seg = torch.where(valid, seg, n_groups)
    return seg.to(torch.int32), n_groups.to(torch.int32)
