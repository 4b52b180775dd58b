"""Native (C++) runtime components with ctypes bindings.

The reference's scan-decode hot loop runs in native code (TiKV in Rust;
in-repo Go: rowcodec ChunkDecoder at cophandler/cop_handler.go:424-467).
This package builds the framework's C++ equivalent on first use with the
toolchain's g++, into `<checkout>/build/native/` (no pip/pybind
dependency — plain C ABI via ctypes) and
falls back to the pure-Python decoders when compilation or decoding fails,
so the native layer is a transparent accelerator, never a requirement.

Components:
  rowcodec.cpp  tt_decode_rows — rowcodec-v2 rows -> columnar buffers
                (compact ints, comparable floats, binary decimals to
                scaled int64, packed times, string pools, null masks)

Copy of `tidb_tpu/native/__init__.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "rowcodec.cpp")
# built beside the CUDA kernels, under the checkout's build/ (never into
# the package directory)
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_SO = os.path.join(_BUILD, "librowcodec.so")

_lock = threading.Lock()
_lib = None  # guarded_by: _lock
_lib_failed = False  # guarded_by: _lock

# column classes — must match rowcodec.cpp
CLS_INT, CLS_UINT, CLS_FLOAT, CLS_DECIMAL, CLS_STRING, CLS_HANDLE = 0, 1, 2, 3, 5, 7


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:  # noqa: BLE001 — any toolchain problem = fallback
        return False


def get_lib():
    """The loaded shared library, building it if needed; None = unavailable."""
    global _lib, _lib_failed
    # double-checked fast path: once built, the unlocked read is stable
    if _lib is not None or _lib_failed:  # vet: ignore[lock-discipline]
        return _lib  # vet: ignore[lock-discipline]
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            stale = (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
            if stale and not _build():
                _lib_failed = True
                return None
            lib = ctypes.CDLL(_SO)
            lib.tt_decode_rows.restype = ctypes.c_int
            lib.tt_decode_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            if lib.tt_version() != 2:
                _lib_failed = True
                return None
            _lib = lib
        except Exception:  # noqa: BLE001
            _lib_failed = True
    return _lib  # vet: ignore[lock-discipline] — set under the lock above


def available() -> bool:
    return get_lib() is not None


def _col_class(ft) -> tuple[int, int] | None:
    """FieldType -> (class, decimal scale) or None when unsupported."""
    from ..types import TypeCode

    if ft.is_int():
        return (CLS_UINT if ft.is_unsigned() else CLS_INT), 0
    if ft.tp == TypeCode.Double:
        return CLS_FLOAT, 0
    if ft.is_decimal():
        return CLS_DECIMAL, max(ft.decimal, 0)
    if ft.is_time():
        return CLS_UINT, 0
    if ft.is_duration():
        return CLS_INT, 0
    if ft.tp in (TypeCode.Enum, TypeCode.Set, TypeCode.Bit):
        return CLS_UINT, 0
    if ft.is_string() and ft.tp != TypeCode.JSON:
        return CLS_STRING, 0
    return None  # Float32, JSON: python fallback


def decode_rows_columnar(values: list, handles: list, columns) -> "list | None":
    """Decode rowcodec-v2 value blobs into host Columns (one per requested
    scan column). Returns None when the native path is unavailable or the
    schema/bytes are outside its coverage — caller falls back."""
    from ..chunk.column import Column, numpy_dtype_for

    lib = get_lib()
    if lib is None:
        return None
    classes = []
    for c in columns:
        if c.col_id == -1:
            classes.append((CLS_HANDLE, 0))
            continue
        cc = _col_class(c.ft)
        if cc is None:
            return None
        classes.append(cc)
    n_rows, n_cols = len(values), len(columns)
    if n_cols > 256:
        return None
    blob = b"".join(values)
    row_offs = np.zeros(n_rows + 1, np.int64)
    np.cumsum([len(v) for v in values], out=row_offs[1:])
    blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8)
    handles_arr = np.asarray(handles, np.int64) if handles else np.zeros(n_rows, np.int64)
    ids = np.array([c.col_id for c in columns], np.int64)
    cls_arr = np.array([c for c, _ in classes], np.uint8)
    scale_arr = np.array([s for _, s in classes], np.int32)
    out_fixed = np.zeros((n_cols, max(n_rows, 1)), np.int64)
    out_null = np.zeros((n_cols, max(n_rows, 1)), np.uint8)
    out_len = np.zeros((n_cols, max(n_rows, 1)), np.int64)
    # pool rows exist only for string columns (upper bound per column:
    # every value byte in the batch)
    pool_idx = np.full(n_cols, -1, np.int32)
    n_str = 0
    for i, (c, _) in enumerate(classes):
        if c == CLS_STRING:
            pool_idx[i] = n_str
            n_str += 1
    pool_stride = len(blob) if n_str else 0
    pool = np.zeros((max(n_str, 1), max(pool_stride, 1)), np.uint8)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.tt_decode_rows(
        p(blob_arr), p(row_offs), n_rows, p(handles_arr), p(ids), p(cls_arr),
        p(scale_arr), p(pool_idx), n_cols, p(out_fixed), p(out_null), p(out_len),
        p(pool), pool_stride if n_str else 1,
    )
    if rc != 0:
        from ..util import metrics

        metrics.NATIVE_DECODE_FALLBACKS.inc()
        return None
    cols = []
    for ci, c in enumerate(columns):
        null = out_null[ci, :n_rows].astype(bool)
        dt = numpy_dtype_for(c.ft)
        if dt is None:  # varlen
            lens = out_len[ci, :n_rows]
            offs = np.zeros(n_rows + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            pr = int(pool_idx[ci])
            blob_out = pool[pr, : int(offs[-1])].copy() if offs[-1] else np.zeros(0, np.uint8)
            cols.append(Column(c.ft, None, null, offs, blob_out))
            continue
        raw = out_fixed[ci, :n_rows]
        if dt == np.uint64:
            data = raw.view(np.uint64).copy()
        elif dt == np.float64:
            data = raw.view(np.float64).copy()
        else:
            data = raw.copy()
        cols.append(Column(c.ft, data, null))
    return cols
