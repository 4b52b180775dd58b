"""The work of each hand-kernel call in a traced window, for the kernels'
roofline metrics: the kernel's custom-op entry is wrapped for the window,
and each call's bytes and operations are taken from its inputs with the
frozen arithmetic of reference/frozen.py, on the device and without a
host sync (summed once after the window)."""

from __future__ import annotations

import importlib
import threading
import time

from ..reference import frozen

# kernel -> (module of the port, the custom-op entry its wrapper calls, the
# CUDA kernel's name in the profiler, the work of a call from its arguments)
KERNELS = {
    "k4": ("tidb_tpu_torch.ops.join_probe", "_probe_tables_op", "probe_kernel",
           lambda b_key, b_ok, p_key, p_ok: frozen.probe_tables_work(b_ok, p_ok)),
}


class CallWork:
    """Records (host ns, bytes in, bytes out, operations) of every call of
    the kernels while open. A call inside torch.func.vmap (one launch for
    many regions) is counted apart: its lanes' work is not recorded."""

    def __init__(self):
        self.calls = {k: [] for k in KERNELS}
        self.batched = dict.fromkeys(KERNELS, 0)
        self._lock = threading.Lock()
        self._real = {}

    def __enter__(self):
        import torch

        for k, (mod_name, attr, _cuda, work) in KERNELS.items():
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            self._real[k] = (mod, attr, real)

            def wrapped(*args, _k=k, _real=real, _work=work):
                if any(torch.is_tensor(a) and torch._C._functorch.is_batchedtensor(a) for a in args):
                    with self._lock:
                        self.batched[_k] += 1
                else:
                    w = _work(*args)
                    with self._lock:
                        self.calls[_k].append((time.perf_counter_ns(), *w))
                return _real(*args)

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self._real.values():
            setattr(mod, attr, real)
        return False

    def bound_ns(self, kernel: str, lo: int, hi: int) -> tuple:
        """(summed bound in ns, calls) of the kernel's calls issued in
        [lo, hi): each call's bound is the larger of its bytes over the
        memory rate and its operations over the 32-bit rate."""
        total, n = 0.0, 0
        for t, b_in, b_out, ops in self.calls[kernel]:
            if lo <= t < hi:
                ms, _by = frozen.bound(int(b_in), int(b_out), int(ops))
                total += ms * 1e6
                n += 1
        return total, n
