"""Collectives over a list of shards, one process.

The JAX package runs a mesh program as one SPMD function under
`shard_map`, with `psum` / `pmin` / `pmax` / `all_gather` / `all_to_all`
in the middle of it. Here a mesh program is straight-line code over a
list with one entry per shard (`[f(x) for x in shards]`), and these
functions stand between its phases. Each takes the shards' tensors in
shard order and returns one tensor per shard, on that shard's device
(`devices[i]`); a tensor moves with `.to(device)`, which is a no-op on
the same device and a peer copy between cards.

  psum / pmin / pmax  reduce on the lead device (shard 0's), then hand
                      the result to every shard;
  all_gather          torch.cat in shard order (tiled) or stacked on a
                      new leading axis (untiled);
  all_to_all          tiled=False: shard e receives stack([x_d[e] for d]),
                      dim 0 indexing the destination going in and the
                      source coming out.
"""

from __future__ import annotations

import torch


def _lead(xs: list, devices: list):
    if len(xs) != len(devices):
        raise ValueError(f"{len(xs)} tensors for {len(devices)} shards")
    return devices[0]


def _reduce(xs: list, devices: list, op):
    lead = _lead(xs, devices)
    acc = xs[0].to(lead)
    for x in xs[1:]:
        acc = op(acc, x.to(lead))
    return [acc.to(d) for d in devices]


def psum(xs: list, devices: list) -> list:
    return _reduce(xs, devices, torch.add)


def pmin(xs: list, devices: list) -> list:
    return _reduce(xs, devices, torch.minimum)


def pmax(xs: list, devices: list) -> list:
    return _reduce(xs, devices, torch.maximum)


def all_gather(xs: list, devices: list, tiled: bool = False) -> list:
    """Every shard gets all shards' tensors in shard order: concatenated
    on dim 0 (tiled) or stacked on a new leading axis [D, ...]."""
    lead = _lead(xs, devices)
    parts = [x.to(lead) for x in xs]
    g = torch.cat(parts) if tiled else torch.stack(parts)
    return [g.to(d) for d in devices]


def all_to_all(xs: list, devices: list) -> list:
    """tiled=False all_to_all over dim 0: xs[d] is [D, ...] with dim 0
    indexing the destination shard; shard e receives a [D, ...] tensor
    whose dim 0 indexes the source shard (out[e][d] == xs[d][e])."""
    _lead(xs, devices)
    n = len(xs)
    for x in xs:
        if x.shape[0] != n:
            raise ValueError(f"all_to_all needs dim 0 == {n} shards, got {tuple(x.shape)}")
    return [torch.stack([xs[d][e].to(devices[e]) for d in range(n)]) for e in range(n)]
