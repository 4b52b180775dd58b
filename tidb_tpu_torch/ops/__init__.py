from .keys import sort_key_arrays, segments_from_sorted
from .selection import apply_selection
from .aggregate import GatherState, GroupAggResult, group_aggregate, scalar_aggregate
from .topn import sort_all, topn
from .window import window_cols

__all__ = [
    "sort_key_arrays",
    "segments_from_sorted",
    "apply_selection",
    "GatherState",
    "GroupAggResult",
    "group_aggregate",
    "scalar_aggregate",
    "sort_all",
    "topn",
    "window_cols",
]
