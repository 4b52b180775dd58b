"""Carry a batch across packages as plain numpy arrays.

device_batch_from_numpy takes a DeviceBatch in its numpy form — per column
`data`, `null`, and `length` (varlen) or None — and returns this port's
DeviceBatch on `device`. Tests feed the JAX package and the port identical
batches this way.

A store's state crosses the same way, the role weights play in a model's
port: `store_state` reads the MVCC versions, the region table (ids, keys,
epochs, peers, leaders), the store count and the PD's per-region flow (the
interval's traffic not yet heartbeated, and the approximate size and key
count) out of a TPUStore as plain values; `load_store_state` writes such
values into a fresh TPUStore (of either package: it touches only what both
stores share), and `store_from_state` builds the port's store from them.
A store started this way has recorded the write flow and the replication
proposals of its keys, so two stores started from one state schedule and
replicate alike.
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


def store_state(store) -> dict:
    """The plain values of a store: `kv` [(key, value | None, ts)] (every
    MVCC version, by key then ts), `regions` [(region_id, start_key,
    end_key, epoch, peers, leader)] in key order, `n_stores`, and `flows`
    {region_id: (read_bytes, read_keys, write_bytes, write_keys,
    approximate size, approximate keys)}."""
    with store.kv.lock:
        kv = [(k, v, ts) for k in sorted(store.kv._data) for ts, v in store.kv._data[k]]
    flow = store.pd.flow
    with flow._mu:
        flows = {rid: (f.read_bytes, f.read_keys, f.write_bytes, f.write_keys, f.approx_size, f.approx_keys)
                 for rid, f in flow._flows.items()}
    return {"kv": kv, "regions": region_table(store.cluster), "n_stores": store.cluster.n_stores, "flows": flows}


def region_table(cluster) -> list:
    """A cluster's regions in key order as plain values: (region_id,
    start_key, end_key, epoch, peers, leader)."""
    return [(r.region_id, r.start_key, r.end_key, r.epoch, cluster.peers_of(r.region_id),
             cluster.leader_of(r.region_id)) for r in cluster.regions()]


def load_store_state(store, kv, regions, n_stores: int, flows: dict | None = None):
    """Write plain values into a fresh TPUStore (either package's): the
    region table first, then the versions in ascending ts, each ts's keys
    applied as one batch and recorded as the store's bulk appliers record
    them (write flow, one replication proposal a region), then, with
    `flows`, each region's flow set to the given one (the interval's
    traffic and the approximate totals). Returns the store, its TSO past
    every version."""
    c = store.cluster
    region_cls = type(c.regions()[0])
    table = sorted(regions, key=lambda r: r[1])
    if not table or table[0][1] != b"" or any(a[2] != b[1] for a, b in zip(table, table[1:])):
        raise ValueError("the regions must cover the key space from b'' without gaps")
    with c._mu:
        c.n_stores = max(int(n_stores), 1)
        c._regions = [region_cls(int(r[0]), bytes(r[1]), bytes(r[2]), int(r[3])) for r in table]
        c._next_id = max(int(r[0]) for r in table) + 1
        c._store_of = {int(r[0]): int(r[5]) for r in table}
        c._peers = {int(r[0]): [int(p) for p in r[4]] for r in table}
    by_ts: dict[int, list] = {}
    for k, v, ts in kv:
        by_ts.setdefault(int(ts), []).append((bytes(k), None if v is None else bytes(v)))
    for ts in sorted(by_ts):
        applied = [(k, v, store.kv.put(k, v, ts)) for k, v in by_ts[ts]]
        store.record_applied_writes(applied, ts)
    if flows is not None:
        flow = store.pd.flow
        with flow._mu:
            flow._flows.clear()
            for rid, vals in flows.items():
                f = flow._flow(int(rid))
                (f.read_bytes, f.read_keys, f.write_bytes, f.write_keys, f.approx_size,
                 f.approx_keys) = (int(x) for x in vals)
    if by_ts:
        store.advance_tso(max(by_ts))
    store._bump_write_ver()
    return store


def store_from_state(kv, regions, n_stores: int, flows: dict | None = None, device="cuda", mesh_devices=None):
    """The port's TPUStore on `device`, started from plain values (see
    load_store_state)."""
    from .store import TPUStore

    return load_store_state(TPUStore(device=device, mesh_devices=mesh_devices), kv, regions, n_stores, flows)
