"""Distributed SQL over the port's store (port of tidb_tpu/distsql/): so
far the root's planning half, root.py (split_dag and the Final-merge
plan)."""

from .root import RootPlan, split_dag

__all__ = ["RootPlan", "split_dag"]
