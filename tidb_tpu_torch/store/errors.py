"""Typed region errors — the classification layer the dispatch client
retries on (ref: kvproto errorpb.Error: NotLeader / EpochNotMatch /
ServerIsBusy / StoreNotMatch, and client-go's per-kind Backoffer budgets,
tikv/client-go retry/backoff.go + copr/coprocessor.go:1424 handleCopResponse).

The wire seam carries `CopResponse.region_error` as a string (exactly like
the reference carries errorpb inside the cop response proto), so every
typed error ENCODES to a stable `kind`-prefixed string and PARSES back on
the client side — region errors survive both the single-request bytes seam
and the batched frames without a codec change. `parse_region_error` is
total: an unrecognized string still classifies (as `region_miss`, the
catch-all retry kind) so an old peer can never wedge a new client.

Copy of `tidb_tpu/store/errors.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RegionError:
    """Base: a retryable region-level failure. `kind` selects the
    Backoffer budget; `message` is the wire string it round-trips to."""

    message: str
    kind: str = "region_miss"

    def __str__(self) -> str:
        return self.message


@dataclass(frozen=True)
class NotLeader(RegionError):
    """The peer asked is not the region's leader (ref: errorpb.NotLeader,
    whose `leader` field names the peer to go to instead; the client
    switches peers IMMEDIATELY on a usable hint and only burns the
    updateLeader backoff budget without one). store_id is the store that
    rejected the request; leader_store the hinted current leader (-1 =
    unknown/no hint — e.g. an election in flight)."""

    store_id: int = -1
    leader_store: int = -1
    kind: str = "not_leader"

    @staticmethod
    def make(region_id: int, store_id: int, leader_store: int = -1) -> "NotLeader":
        # leader_store rides the kind-prefixed wire string BEFORE the
        # rejecting store so `_int_after`'s rfind("store") still finds the
        # standalone trailing token (old hint-less strings parse as -1)
        return NotLeader(
            f"not_leader: region {region_id} leader_store={leader_store} "
            f"store {store_id}",
            store_id=store_id, leader_store=leader_store,
        )


@dataclass(frozen=True)
class EpochNotMatch(RegionError):
    """Stale region epoch after a split/merge — the client re-splits its
    ranges against the fresh region view (ref: errorpb.EpochNotMatch)."""

    kind: str = "epoch_not_match"


@dataclass(frozen=True)
class RegionNotFound(RegionError):
    """The region id no longer exists (absorbed by a merge) — re-split,
    same as a stale epoch (ref: errorpb.RegionNotFound)."""

    kind: str = "region_not_found"


@dataclass(frozen=True)
class ServerIsBusy(RegionError):
    """The store is overloaded and suggests how long to wait (ref:
    errorpb.ServerIsBusy.backoff_ms; client-go honors the suggestion as a
    floor on its serverBusy backoff)."""

    backoff_ms: int = 0
    kind: str = "server_busy"

    @staticmethod
    def make(store_id: int, backoff_ms: int = 0) -> "ServerIsBusy":
        return ServerIsBusy(
            f"server_is_busy: store {store_id} backoff_ms={backoff_ms}",
            backoff_ms=backoff_ms,
        )


@dataclass(frozen=True)
class DataIsNotReady(RegionError):
    """A replica read asked a follower whose applied watermark trails the
    request's snapshot (ref: errorpb.DataIsNotReady raised by TiKV's
    replica read when `safe_ts < start_ts`; client-go backs off on the
    maxDataNotReady budget and falls back to the leader)."""

    store_id: int = -1
    safe_ts: int = -1
    kind: str = "data_not_ready"

    @staticmethod
    def make(region_id: int, store_id: int, safe_ts: int) -> "DataIsNotReady":
        return DataIsNotReady(
            f"data_is_not_ready: region {region_id} safe_ts={safe_ts} "
            f"store {store_id}",
            store_id=store_id, safe_ts=safe_ts,
        )


@dataclass(frozen=True)
class StoreUnavailable(RegionError):
    """The placement store is down/unreachable — the breaker-counting
    kind: repeated hits open the store's circuit breaker and the task
    fails over through a PD re-placement (ref: client-go's store
    liveness/slow-score marking a store unreachable)."""

    store_id: int = -1
    kind: str = "store_unavailable"

    @staticmethod
    def make(store_id: int) -> "StoreUnavailable":
        return StoreUnavailable(f"store_unavailable: store {store_id}",
                                store_id=store_id)


@dataclass(frozen=True)
class QuorumLost(RegionError):
    """The region's write quorum is gone — a majority of peers cannot ack
    (ref: a raft group without a quorum accepts no proposals; TiKV answers
    Propose errors until a majority returns). Unlike the read-side errors
    above this one is raised on the WRITE path: the store refuses the
    write instead of letting it stay silently durable on the shared KV
    (ROADMAP PR-8 follow-on)."""

    store_id: int = -1
    kind: str = "quorum_lost"

    @staticmethod
    def make(region_id: int, acks: int, needed: int) -> "QuorumLost":
        return QuorumLost(
            f"quorum_lost: region {region_id} acks={acks} needed={needed}",
        )


class QuorumLostError(RuntimeError):
    """Exception shape of QuorumLost for the write path (the read path
    carries region errors as response values; writes raise). The session
    boundary maps it to MySQL 9005 ErrRegionUnavailable."""

    def __init__(self, region_id: int, acks: int, needed: int):
        super().__init__(str(QuorumLost.make(region_id, acks, needed)))
        self.region_id, self.acks, self.needed = region_id, acks, needed


def _int_after(s: str, token: str, default: int = -1) -> int:
    i = s.rfind(token)
    if i < 0:
        return default
    tail = s[i + len(token):].lstrip()
    digits = ""
    for c in tail:
        if c.isdigit() or (c == "-" and not digits):
            digits += c
        else:
            break
    try:
        return int(digits)
    except ValueError:
        return default


def parse_region_error(message: str | None) -> RegionError | None:
    """Classify a wire region-error string into its typed form. Total:
    anything unrecognized is a generic `region_miss` (retry + re-split,
    the safe default)."""
    if message is None:
        return None
    m = message.strip()
    low = m.lower()
    if "data_is_not_ready" in low or "data is not ready" in low:
        return DataIsNotReady(m, store_id=_int_after(low, "store"),
                              safe_ts=_int_after(low, "safe_ts="))
    if "not_leader" in low or "not leader" in low:
        return NotLeader(m, store_id=_int_after(low, "store"),
                         leader_store=_int_after(low, "leader_store="))
    if "server_is_busy" in low or "server is busy" in low:
        return ServerIsBusy(m, backoff_ms=max(_int_after(low, "backoff_ms="), 0))
    if "store_unavailable" in low or "store unavailable" in low:
        return StoreUnavailable(m, store_id=_int_after(low, "store"))
    if "quorum_lost" in low or "quorum lost" in low:
        return QuorumLost(m)
    if "epoch_not_match" in low or "epoch not match" in low:
        return EpochNotMatch(m)
    if "not found" in low:
        return RegionNotFound(m)
    return RegionError(m)
