"""HTAP columnar replica tier (ref: TiDB VLDB'20's TiFlash — a
log-replicated columnar replica serving analytics without disturbing
OLTP, layered delta/stable like DeltaTree). Fed by the changefeed
(cdc/), compacted by the `pd.columnar` tick phase, routed to by
`tidb_isolation_read_engines`.

Port of `tidb_tpu/columnar/` (imports rewritten; it imports nothing of
tidb_tpu): the stable batches live on the store's device."""

from .replica import ColumnarNotReady, ColumnarReplica, ColumnarTable
from .route import columnar_would_serve, try_columnar_select
from .sink import ColumnarSink

__all__ = [
    "ColumnarNotReady",
    "ColumnarReplica",
    "ColumnarSink",
    "ColumnarTable",
    "columnar_would_serve",
    "try_columnar_select",
]
