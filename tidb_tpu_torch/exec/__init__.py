from .dag import (
    Aggregation,
    DAGRequest,
    Limit,
    Projection,
    Selection,
    Sort,
    TableScan,
    TopN,
    ColumnInfo,
    Join,
    collect_scans,
)
from .builder import build_program, ProgramCache, CompiledDAG
from .executor import (OverflowRetryError, drive_program_info, run_dag_on_chunk, run_dag_on_chunks,
                       run_dag_reference)

__all__ = [
    "Aggregation",
    "DAGRequest",
    "Limit",
    "Projection",
    "Selection",
    "Sort",
    "TableScan",
    "TopN",
    "ColumnInfo",
    "Join",
    "collect_scans",
    "build_program",
    "ProgramCache",
    "CompiledDAG",
    "drive_program_info",
    "run_dag_on_chunk",
    "run_dag_on_chunks",
    "run_dag_reference",
    "OverflowRetryError",
]
