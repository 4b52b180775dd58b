"""The multi-device tier (port of tidb_tpu/parallel/): regions sharded over
a list of devices, partial states merged across the shards
(mesh.py), the hash exchange and grouped / join exchange programs
(grouped.py, joinmesh.py over mpp/exchange_op.py), the session's
whole-statement mesh select (sql.py), and the list collectives between
the phases (collectives.py)."""

from .exchange import exchange_group_aggregate, hash_partition_ids
from .grouped import run_sharded_grouped_agg
from .mesh import region_mesh, run_sharded_partial_agg, stack_region_batches

__all__ = [
    "region_mesh",
    "stack_region_batches",
    "run_sharded_partial_agg",
    "run_sharded_grouped_agg",
    "hash_partition_ids",
    "exchange_group_aggregate",
]
