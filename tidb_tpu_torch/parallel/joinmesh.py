"""Hash-shuffle (repartition) join over the mesh (port of
tidb_tpu/parallel/joinmesh.py): a thin wrapper over the exchange data
plane. The program — hash-partition BOTH join sides by the join key,
all_to_all them over the shards, join each owned partition locally,
aggregate above (ref: unistore/cophandler/mpp_exec.go:609-721 Hash mode
with joinExec:844 above the receivers) — lives in mpp/exchange_op.py
(`run_exchange_join_agg`), and the DAG splitter in mpp/fragment.py
(`split_join_dag`, re-exported here)."""

from __future__ import annotations

from ..mpp.fragment import split_join_dag  # noqa: F401 — re-export

__all__ = ["split_join_dag", "run_sharded_join_agg"]


def run_sharded_join_agg(dag, stacked_probe, stacked_builds: list, mesh, group_capacity: int = 1024,
                         scale: int = 1):
    """Execute scan [sel] (JOIN(scan [sel]) [sel])+ GROUP BY over the mesh;
    returns (chunk, overflow flag)."""
    from ..mpp.exchange_op import run_exchange_join_agg

    return run_exchange_join_agg(dag, stacked_probe, stacked_builds, mesh, group_capacity=group_capacity,
                                 scale=scale)
