"""prog-audit true positives, one per check: an integer program that
leaks float64, one that reads a scalar back to the host, one that makes a
tensor on another device, a region-batched program with an op torch.func
.vmap runs lane by lane, one whose batched outputs lose the region axis,
and a builder whose closure captures a changing Python scalar (two builds
give different outputs)."""

import itertools

import torch

_counter = itertools.count(1)
LANES = 3


def _args():
    return [torch.arange(8, dtype=torch.int64)]


def _batched_args():
    return [torch.arange(8, dtype=torch.int64).repeat(LANES, 1)]


def _f64_leak():
    def fn(x):
        # BAD: int64 input promoted to float64 inside the program
        return (x.to(torch.float64) * 1.5).sum()

    return fn, _args()


def _host_sync():
    def fn(x):
        # BAD: int() of a tensor reads it back to the host mid-program
        return x[: int(x.max()) // 2]

    return fn, _args()


def _device_leak():
    def fn(x):
        # BAD: a scratch tensor made on another device than the program's
        scratch = torch.zeros(2, device="meta")
        return x + scratch.numel()

    return fn, _args()


def _hist(x):
    return torch.histc(x.to(torch.float32), bins=4, min=0, max=8)


def _lanewise():
    return _hist, _args()


def _lanewise_batched():
    # BAD: aten::histc has no batching rule: vmap loops over the lanes
    return torch.func.vmap(_hist), _batched_args()


def _rowsum(x):
    return x.sum()


def _axis_drift():
    return _rowsum, _args()


def _axis_drift_batched():
    # BAD: sums over the lanes too, so the region axis is gone
    return _rowsum, _batched_args()


def _closure_scalar():
    salt = next(_counter)  # BAD: changes per build

    def fn(x):
        return x + salt

    return fn, _args()


PROG_AUDIT_CATALOG = [
    {"name": "f64-leak", "make": _f64_leak, "line": 24},
    {"name": "host-sync", "make": _host_sync, "line": 32},
    {"name": "device-leak", "make": _device_leak, "line": 40},
    {"name": "vmap-lanewise", "make": _lanewise, "make_batched": _lanewise_batched, "line": 57},
    {"name": "region-axis", "make": _axis_drift, "make_batched": _axis_drift_batched, "line": 70},
    {"name": "build-stability", "make": _closure_scalar, "line": 75},
]
