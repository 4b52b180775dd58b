from .keys import sort_key_arrays, segments_from_sorted
from .selection import apply_selection
from .aggregate import GatherState, GroupAggResult, group_aggregate, scalar_aggregate

__all__ = [
    "sort_key_arrays",
    "segments_from_sorted",
    "apply_selection",
    "GatherState",
    "GroupAggResult",
    "group_aggregate",
    "scalar_aggregate",
]
