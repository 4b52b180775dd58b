"""Copy of `tidb_tpu/sql/__init__.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu)."""

from .catalog import Catalog, CatalogError, TableMeta, field_type_from_spec
from .planner import PlanError, PlannedQuery, plan_select
from .session import Result, Session, SQLError

__all__ = [
    "Catalog",
    "CatalogError",
    "TableMeta",
    "field_type_from_spec",
    "PlanError",
    "PlannedQuery",
    "plan_select",
    "Result",
    "Session",
    "SQLError",
]
from . import builtins_host  # noqa: E402,F401 — registers the host builtin batch
