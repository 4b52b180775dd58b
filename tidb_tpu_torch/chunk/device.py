"""Device-resident columnar batches (torch port of tidb_tpu/chunk/device.py).

Static shapes as in the JAX package: a region batch is padded to a fixed
capacity and carries a `row_valid` mask; NULLs are a separate per-column
mask.

Type mapping onto torch dtypes:

  int / uint       int64  (uint64 bit-cast; unsigned compare via sign-flip)
  double / float   float64 / float32
  decimal(p,s)     int64 scaled by 10^s
  datetime/date    int64  (order-preserving packed layout, types/mytime.py)
  duration         int64 nanoseconds
  string/bytes     uint8 [N, W] padded + int32 lengths; compare/sort/group
                   keys are big-endian packed int64 words (pack_string_words)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import resolve_device
from ..types import FieldType
from .chunk import Chunk
from .column import Column, numpy_dtype_for

# max packed words used for on-device string compare/group keys (8 bytes each)
STRING_WORDS = 4

I64_MIN = -0x8000000000000000


@dataclass
class DeviceColumn:
    """One column on device. `data` is [N] for fixed-width, [N, W] for varlen."""

    data: torch.Tensor
    null: torch.Tensor  # bool [N]; True = NULL
    length: torch.Tensor | None  # int32 [N] for varlen, else None
    ft: FieldType

    def is_varlen(self) -> bool:
        return self.data.dim() == 2

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


@dataclass
class DeviceBatch:
    """A capacity-padded batch of rows on device."""

    cols: list[DeviceColumn]
    row_valid: torch.Tensor  # bool [N]; False = padding
    n_rows: torch.Tensor  # int32 scalar (actual row count)

    @property
    def capacity(self) -> int:
        return self.row_valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_valid.device


def _pad(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    n = len(arr)
    if n == capacity:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, arr.dtype)
    out[:n] = arr
    return out


def host_column_arrays(col: Column, capacity: int, str_width: int | None = None):
    """Column -> (data, null, length|None) numpy arrays padded to capacity."""
    n = len(col)
    null = _pad(col.null.astype(bool), capacity, True)
    if not col.is_varlen():
        data = col.data
        if data.dtype == np.uint64:
            data = data.view(np.int64)
        return _pad(data, capacity), null, None
    lens = (col.offsets[1:] - col.offsets[:-1]).astype(np.int32)
    max_len = int(lens.max()) if n else 0
    w = int(str_width) if str_width else max(1, max_len)
    if max_len > w:
        raise ValueError(f"varlen column has a {max_len}-byte value but str_width={w}")
    # one gather for every row: byte j of row i is blob[offsets[i] + j]
    # below the row's length, else 0 (a loop per row costs ~4 us a row)
    data = np.zeros((capacity, w), np.uint8)
    if n and col.blob is not None and len(col.blob):
        pos = np.asarray(col.offsets[:-1], np.int64)[:, None] + np.arange(w, dtype=np.int64)[None, :]
        inside = np.arange(w)[None, :] < lens[:, None]
        data[:n] = np.where(inside, np.asarray(col.blob, np.uint8)[np.minimum(pos, len(col.blob) - 1)], 0)
    return data, null, _pad(lens, capacity)


def to_device_batch(chunk: Chunk, capacity: int | None = None,
                    str_widths: dict[int, int] | None = None,
                    device="cuda") -> DeviceBatch:
    dev = resolve_device(device)
    n = chunk.num_rows()
    cap = capacity or max(1, n)
    cols = []
    for ci, col in enumerate(chunk.columns):
        _check_ci_ascii(col)
        w = (str_widths or {}).get(ci)
        data, null, length = host_column_arrays(col, cap, w)
        cols.append(
            DeviceColumn(
                torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                torch.from_numpy(np.ascontiguousarray(null)).to(dev),
                torch.from_numpy(np.ascontiguousarray(length)).to(dev) if length is not None else None,
                col.ft,
            )
        )
    row_valid = np.zeros(cap, bool)
    row_valid[:n] = True
    return DeviceBatch(cols, torch.from_numpy(row_valid).to(dev),
                       torch.tensor(n, dtype=torch.int32, device=dev))


def shared_str_widths(chunks: list[Chunk]) -> dict[int, int]:
    """Per-column max byte width across a batch of same-schema chunks."""
    widths: dict[int, int] = {}
    for ch in chunks:
        for ci, col in enumerate(ch.columns):
            if not col.is_varlen():
                continue
            w = 1
            if len(col):
                w = max(int((col.offsets[1:] - col.offsets[:-1]).max()), 1)
            widths[ci] = max(widths.get(ci, 1), w)
    return widths


def _check_ci_ascii(col: Column) -> None:
    """The device CI kernels fold ASCII only; any non-ASCII byte in a
    case-insensitive column is refused (NotImplementedError) rather than
    compared wrongly."""
    if col.ft.is_string() and col.ft.is_ci() and col.is_varlen() and len(col):
        if col.blob is not None and col.blob.size and int(col.blob.max()) >= 0x80:
            raise NotImplementedError(
                "non-ASCII data under a CI collation is not compared on device"
            )


def to_stacked_device_batch(chunks: list[Chunk], capacity: int, device="cuda") -> DeviceBatch:
    """Stack same-schema chunks into ONE region-batched DeviceBatch whose
    every leaf carries a leading region axis: data [B, cap(, W)], null /
    row_valid [B, cap], n_rows [B] — the input of the region-batched
    program (exec/builder.py build_program(vmap_batch=B)), where
    torch.func.vmap maps each region lane back to the single-region
    program unchanged.

    All chunks must share a schema; varlen columns are padded to the
    batch-wide max width (shared_str_widths), and every lane is checked
    for non-ASCII bytes under a CI collation as to_device_batch checks
    it. Stacking happens on the host, so the batch ships to `device` in
    one copy per leaf of each column."""
    if not chunks:
        raise ValueError("cannot stack an empty region batch")
    dev = resolve_device(device)
    widths = shared_str_widths(chunks)
    cols: list[DeviceColumn] = []
    for ci in range(chunks[0].num_cols()):
        datas, nulls, lengths = [], [], []
        for ch in chunks:
            col = ch.columns[ci]
            _check_ci_ascii(col)
            data, null, length = host_column_arrays(col, capacity, widths.get(ci))
            datas.append(data)
            nulls.append(null)
            lengths.append(length)
        cols.append(
            DeviceColumn(
                torch.from_numpy(np.stack(datas)).to(dev),
                torch.from_numpy(np.stack(nulls)).to(dev),
                torch.from_numpy(np.stack(lengths)).to(dev) if lengths[0] is not None else None,
                chunks[0].columns[ci].ft,
            )
        )
    row_valid = np.zeros((len(chunks), capacity), bool)
    for b, ch in enumerate(chunks):
        row_valid[b, : ch.num_rows()] = True
    n_rows = np.array([ch.num_rows() for ch in chunks], np.int32)
    return DeviceBatch(cols, torch.from_numpy(row_valid).to(dev), torch.from_numpy(n_rows).to(dev))


def pack_string_words(data: torch.Tensor, length: torch.Tensor, n_words: int = STRING_WORDS) -> torch.Tensor:
    """[N, W] uint8 + lengths -> [N, n_words + 1] int64, big-endian packed.

    Bytes beyond each row's length are zeroed and the byte length is
    appended as a final tiebreaker word, so comparing rows as tuples of
    these words == bytes.Compare on the originals truncated to 8*n_words
    bytes. The words are built by OR-ing masked, shifted bytes in int64
    (torch has no usable uint64 arithmetic), then the sign bit is flipped
    so unsigned byte order == signed int64 order."""
    nbytes = n_words * 8
    n, w = data.shape
    w = min(w, nbytes)
    dev = data.device
    pos = torch.arange(w, dtype=torch.int32, device=dev)
    data = torch.where(pos[None, :] < length[:, None], data[:, :w], torch.zeros((), dtype=data.dtype, device=dev))
    # only the words that can hold a byte are built; the rest are zero.
    # Built out of place (zeros_like keeps a vmapped batch's region axis)
    words = []
    for k in range(n_words):
        word = torch.zeros_like(length, dtype=torch.int64)
        for j in range(8 * k, min(w, 8 * k + 8)):
            word = word | (data[:, j].to(torch.int64) << (56 - 8 * (j % 8)))
        words.append(word)
    packed = torch.stack(words, dim=1) ^ I64_MIN
    return torch.cat([packed, length[:, None].to(torch.int64)], dim=1)


def device_dtype_for(ft: FieldType) -> torch.dtype:
    dt = numpy_dtype_for(ft)
    if dt is None:
        return torch.uint8
    if dt == np.uint64:
        return torch.int64
    return {np.int64: torch.int64, np.float64: torch.float64, np.float32: torch.float32}[dt]
