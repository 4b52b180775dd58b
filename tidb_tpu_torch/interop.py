"""Carry a batch across packages as plain numpy arrays.

device_batch_from_numpy takes a DeviceBatch in its numpy form — per column
`data`, `null`, and `length` (varlen) or None — and returns this port's
DeviceBatch on `device`. Tests feed the JAX package and the port identical
batches this way.
"""

from __future__ import annotations

import numpy as np
import torch

from .chunk.device import DeviceBatch, DeviceColumn
from .runtime import resolve_device


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def device_batch_from_numpy(cols, row_valid, n_rows: int, fts, device="cuda") -> DeviceBatch:
    """cols: [(data, null, length | None)] numpy arrays, one per column;
    row_valid: bool [N]; fts: the port's FieldTypes, one per column."""
    dev = resolve_device(device)
    out = []
    for (data, null, length), ft in zip(cols, fts):
        out.append(DeviceColumn(
            _tensor(data, dev),
            _tensor(np.asarray(null, bool), dev),
            _tensor(np.asarray(length, np.int32), dev) if length is not None else None,
            ft,
        ))
    return DeviceBatch(out, _tensor(np.asarray(row_valid, bool), dev),
                       torch.tensor(int(n_rows), dtype=torch.int32, device=dev))
