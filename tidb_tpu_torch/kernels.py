"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface under `<checkout>/build/kernels/`, named by a digest of
its source so an edited kernel is rebuilt, and loaded with ctypes. Builds
happen at first use (never at import) and all missing sources compile in
parallel, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel name -> source, relative to the package
SOURCES = {
    "dense_agg": "csrc/dense_agg.cu",
    "joinscan": "csrc/joinscan.cu",
    "join_probe": "csrc/join_probe.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch (typed, so that
    no bare RuntimeError leaves a request path)."""


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _lib_path(name: str) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile every missing kernel library; returns {name: seconds} for
    the ones compiled in this call (0.0 for those already built). Raises
    RuntimeError with nvcc's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs: dict[str, float] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failures.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return secs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the build."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry point (NULL for None)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(dev) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `dev`, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check(t: torch.Tensor, shape, dtypes, what: str):
    """Raise unless `t` is a contiguous CUDA tensor of `shape` whose dtype
    is one of `dtypes` — what a kernel takes through a raw pointer."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, want one of {dtypes}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {tuple(shape)}, got {tuple(t.shape)}")


class StreamScratch:
    """A kernel's zeroed scratch buffer, one per (device, stream), made
    with torch.zeros at the stream's first launch; the kernel leaves it
    zeroed for the next launch. A region-batched launch takes one record
    of `nbytes()` bytes (the kernel library's own entry point) per region:
    a call that needs more records than the buffer holds replaces it with
    a larger zeroed one. A launch that failed may leave it dirty, so its
    caller drops it.

    Several dispatch threads may launch on one stream: the lookup is
    locked, so a stream gets one buffer, and a caller holds the tensor it
    got until its launch is enqueued (a replaced buffer is freed only
    then, so no later allocation on the stream can alias it first)."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.bufs: dict = {}  # guarded_by: _lock
        self._lock = threading.Lock()

    def get(self, dev, stream: int, records: int = 1) -> torch.Tensor:
        need = records * self.nbytes()
        with self._lock:
            buf = self.bufs.get((dev.index, stream))
            if buf is None or buf.numel() < need:
                buf = self.bufs[(dev.index, stream)] = torch.zeros(need, dtype=torch.uint8, device=dev)
            return buf

    def drop(self, dev, stream: int):
        with self._lock:
            self.bufs.pop((dev.index, stream), None)


_launch_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one launch to a kernel wrapper's `fn.launches`. The dispatch
    pool launches from several threads, and `+= 1` on an attribute is a
    read and a write that another thread can come between, so it is
    done under a lock."""
    with _launch_lock:
        fn.launches += 1


def region_major(x: torch.Tensor, in_dim, batch: int) -> torch.Tensor:
    """An input of a vmapped kernel call as the region-batched launch takes
    it: the region axis first and the tensor contiguous; an input with no
    region axis (in_dim None) is repeated for every region."""
    if in_dim is None:
        return x.unsqueeze(0).expand(batch, *x.shape).contiguous()
    return x.movedim(in_dim, 0).contiguous()


def _select(x, d, b: int):
    """Lane b of an argument (a list argument: of each element)."""
    if d is None:
        return x
    if isinstance(x, (list, tuple)):
        return [_select(v, dd, b) for v, dd in zip(x, d)]
    return x.select(d, b)


def _stack(outs: list):
    """Per-lane outputs (tensors, or tuples / lists of them) stacked on a
    new leading axis: (values, out_dims) of the same structure."""
    first = outs[0]
    if isinstance(first, (list, tuple)):
        parts = [_stack([o[i] for o in outs]) for i in range(len(first))]
        vals, dims = [p[0] for p in parts], [p[1] for p in parts]
        return (tuple(vals), tuple(dims)) if isinstance(first, tuple) else (vals, dims)
    return torch.stack(outs), 0


def lanewise(op, batch: int, in_dims, args):
    """A vmap rule's plain path: `op` called once per region lane on that
    lane's slice of every batched argument (unbatched ones as they are),
    the outputs stacked on a new leading region axis. Returns (outputs,
    out_dims) as torch.library.register_vmap wants them."""
    outs = [op(*_select(list(args), list(in_dims), b)) for b in range(batch)]
    return _stack(outs)


_typed: dict = {}


def entry(lib_name: str, name: str, signature):
    """Entry point `name` of a kernel library, its ctypes (restype,
    argtypes) `signature` set once per loaded library."""
    lib = load(lib_name)
    got = _typed.get((lib_name, name))
    if got is None or got[0] is not lib:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = signature
        got = _typed[(lib_name, name)] = (lib, fn)
    return got[1]


def load(name: str) -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
