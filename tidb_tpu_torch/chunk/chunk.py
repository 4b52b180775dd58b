"""Host columnar batch (ref: pkg/util/chunk/chunk.go:35)."""

from __future__ import annotations

import numpy as np

from ..types import Datum, FieldType
from .column import Column


class Chunk:
    # _device_token: lazily-assigned monotonic identity used by the store's
    # device-batch caches (id() is reused after GC; a token never is)
    __slots__ = ("columns", "_device_token")

    def __init__(self, columns: list[Column]):
        self.columns = columns

    @classmethod
    def empty(cls, fts: list[FieldType]) -> "Chunk":
        return cls([Column.empty(ft) for ft in fts])

    @classmethod
    def from_rows(cls, fts: list[FieldType], rows: list[list[Datum]]) -> "Chunk":
        cols = []
        for ci, ft in enumerate(fts):
            cols.append(Column.from_datums(ft, [r[ci] for r in rows]))
        return cls(cols)

    def nbytes(self) -> int:
        """Host bytes held by this chunk (memory-tracker accounting)."""
        total = 0
        for c in self.columns:
            for arr in (c.data, c.null, c.offsets, c.blob):
                if arr is not None and hasattr(arr, "nbytes"):
                    total += arr.nbytes
        return total

    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def num_cols(self) -> int:
        return len(self.columns)

    def field_types(self) -> list[FieldType]:
        return [c.ft for c in self.columns]

    def row(self, i: int) -> list[Datum]:
        return [c.get_datum(i) for c in self.columns]

    def rows(self) -> list[list[Datum]]:
        return [self.row(i) for i in range(self.num_rows())]

    def take(self, idx: np.ndarray) -> "Chunk":
        return Chunk([c.take(idx) for c in self.columns])

    def slice(self, start: int, stop: int) -> "Chunk":
        return self.take(np.arange(start, min(stop, self.num_rows())))

    @classmethod
    def concat(cls, chunks: list["Chunk"]) -> "Chunk":
        if not chunks:
            raise ValueError("concat of no chunks")
        return cls([Column.concat([ch.columns[i] for ch in chunks]) for i in range(chunks[0].num_cols())])

    def __repr__(self):
        return f"Chunk({self.num_rows()} rows × {self.num_cols()} cols)"
