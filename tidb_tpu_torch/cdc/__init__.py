"""Change data capture: the TiCDC-analog changefeed subsystem — puller
over the replication log, commit-ts sorter, resolved-ts frontier,
rowcodec mounter, pluggable sinks, schema-change entries riding the same
log (DDL through the feed), raw feeds for log backup, and atomic
file-sink segments.

Port of `tidb_tpu/cdc/` (imports rewritten; it imports nothing of
tidb_tpu). The whole subsystem runs on the host: it moves typed rows, and
the columnar replica (columnar/) is where they reach the device."""

from .events import RawKVEvent, RowEvent, SchemaEvent
from .hub import Changefeed, ChangefeedError, ChangefeedHub, WriteGuard
from .mounter import Mounter, SchemaDriftError
from .schema import SchemaJournal
from .sink import (
    FileSink, MemorySink, SegmentWriter, SessionReplaySink, Sink, SinkError,
    open_sink,
)

__all__ = [
    "RowEvent", "SchemaEvent", "RawKVEvent", "Changefeed", "ChangefeedError",
    "ChangefeedHub", "WriteGuard", "Mounter", "SchemaDriftError",
    "SchemaJournal", "FileSink", "MemorySink", "SegmentWriter",
    "SessionReplaySink", "Sink", "SinkError", "open_sink",
]
