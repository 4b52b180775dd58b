"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for on a host without one (typed, so that
    no bare RuntimeError leaves a request path)."""


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises
    DeviceUnavailableError (the port never quietly drops to the CPU —
    callers ask for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def mesh_devices(device, mesh_devices=None) -> list[torch.device]:
    """The device list a store shards its mesh programs over (the port's
    counterpart of `jax.devices()`). None means every visible CUDA device
    for a `cuda` store and the store's own device for a `cpu` one. A list
    may repeat a device: ["cpu"] * 8 stands for eight virtual CPU devices,
    ["cuda:0"] * 4 for four shards on one card. A `cuda` entry without
    CUDA raises, as resolve_device does."""
    dev = resolve_device(device)
    if mesh_devices is None:
        if dev.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [dev]
    out = [resolve_device(d) for d in mesh_devices]
    if not out:
        raise ValueError("mesh_devices must name at least one device")
    return out
