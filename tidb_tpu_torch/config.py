"""Instance configuration (ref: pkg/config — TOML file + flags, bridged to
sysvars at boot; cmd/tidb-server/main.go:654 setGlobalVars).

Copy of `tidb_tpu/config.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

try:
    import tomllib  # 3.11+
except ModuleNotFoundError:  # gated: from_toml degrades, everything else works
    tomllib = None
from dataclasses import dataclass


@dataclass
class Config:
    # store / execution
    region_split_rows: int = 1 << 20  # rows per region before auto-split
    group_capacity: int = 4096  # initial group table capacity
    join_capacity: int | None = None  # default: probe batch capacity
    distsql_scan_concurrency: int = 4
    paging_size: int | None = None
    # memory
    mem_quota_query: int = 1 << 30
    mem_quota_session: int = 0  # 0 = unlimited; parents every query tracker
    # admission control (ref: the server-side token limits) —
    # bridged onto the store's AdmissionGate at boot; 0 = unlimited
    admission_max_inflight: int = 0
    admission_session_queue: int = 4
    admission_queue_wait_ms: float = 50.0
    admission_shed_backoff_ms: int = 5
    admission_max_dispatch: int = 0
    # measured-cost admission: weigh in-flight statements by
    # their Top SQL cost class — heavy digests saturate (and shed) at a
    # fraction of the budget while point-gets keep their full count
    admission_cost_classed: bool = False
    # cross-session fused execution — bridged onto session
    # sysvars at boot: coalesce concurrent point gets into one batched
    # launch and autocommit writes into group commits
    coalesce_enabled: bool = False
    coalesce_wait_us: int = 300
    coalesce_max_lanes: int = 64
    # observability
    enable_metrics: bool = True
    slow_query_threshold_ms: int = 300
    # placement driver (tidb_tpu/pd; ref: pd ScheduleConfig) — bridged
    # onto the store's PlacementDriver by the session at boot
    pd_tick_interval: float = 10.0
    pd_max_region_size: int = 1 << 22  # bytes; split-checker threshold
    pd_max_region_keys: int = 1 << 16  # keys; split-checker threshold

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        if tomllib is not None:
            with open(path, "rb") as f:
                data = tomllib.load(f)
        else:
            data = _parse_flat_toml(open(path, encoding="utf-8").read())
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        known = {f_ for f_ in cls.__dataclass_fields__}
        flat = {}
        for k, v in data.items():
            if isinstance(v, dict):  # one level of TOML tables
                for k2, v2 in v.items():
                    if k2 in known:
                        flat[k2] = v2
            elif k in known:
                flat[k] = v
        return cls(**flat)


def _strip_comment(raw: str) -> str:
    """Drop a trailing # comment, but not a # inside a quoted value."""
    quote = None
    for j, ch in enumerate(raw):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return raw[:j]
    return raw


def _parse_flat_toml(text: str) -> dict:
    """Pre-3.11 fallback: the [section] / key = scalar subset the config
    files actually use (ints, bools, quoted strings). Not a general parser."""
    data: dict = {}
    cur = data
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = data.setdefault(line[1:-1].strip(), {})
            continue
        if "=" not in line:
            continue
        k, _, v = line.partition("=")
        v = v.strip()
        if v.lower() in ("true", "false"):
            val: object = v.lower() == "true"
        elif (v.startswith('"') and v.endswith('"')) or (v.startswith("'") and v.endswith("'")):
            val = v[1:-1]
        else:
            try:
                val = int(v)
            except ValueError:
                try:
                    val = float(v)
                except ValueError:
                    val = v
        cur[k.strip()] = val
    return data


DEFAULT = Config()
