"""The coprocessor store of the port: MemKV, regions, and the
single-request endpoint on the card (store.py)."""

from .kv import MemKV
from .region import Region, Cluster
from .store import TPUStore, CopRequest, CopResponse, ExecSummary, KeyRange
from .errors import (
    RegionError,
    NotLeader,
    DataIsNotReady,
    EpochNotMatch,
    RegionNotFound,
    QuorumLost,
    QuorumLostError,
    ServerIsBusy,
    StoreUnavailable,
    parse_region_error,
)

__all__ = [
    "MemKV", "Region", "Cluster", "TPUStore", "CopRequest", "CopResponse", "ExecSummary", "KeyRange",
    "RegionError", "NotLeader", "DataIsNotReady", "EpochNotMatch", "RegionNotFound",
    "QuorumLost", "QuorumLostError", "ServerIsBusy", "StoreUnavailable",
    "parse_region_error",
]
