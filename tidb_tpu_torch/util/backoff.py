"""Backoffer — per-error-kind exponential backoff with a per-task budget
(ref: tikv/client-go/v2 retry/backoff.go Backoffer + config.go's
BoRegionMiss/BoUpdateLeader/BoServerBusy/BoTiKVRPC configs; TiDB scales
every budget by the `tidb_backoff_weight` sysvar, sessionctx/variable
BackOffWeight -> store/copr's backoffer construction).

Each region-error KIND owns an exponential (base, cap) schedule with equal
jitter — attempt n sleeps uniform[raw/2, raw] where raw = min(base·2ⁿ, cap)
— while ONE shared budget bounds the task's total sleep: when the next
sleep would exceed `budget_ms × weight`, the Backoffer raises
`BackoffExhausted` and the dispatch layer surfaces a typed
RegionUnavailableError (MySQL 9005) instead of spinning forever.

Sleeps are engineered, not naive:

  * deadline-aware — never sleeps past the RunawayChecker's
    MAX_EXECUTION_TIME deadline (sleeping longer would only wake up to die);
  * interruptible — sleeps in small slices, consulting the checker between
    slices, so KILL QUERY aborts a statement MID-backoff rather than after;
  * attributed — every slept interval lands on the ambient trace span
    (`backoff_ms`) and the `tidb_tpu_backoff_seconds_total{kind=}` counter.

The schedule values are the reference's, scaled to this engine's
in-process latencies (a TiKV RPC is ~ms; a cop call here is ~µs).

This module is the ONLY sanctioned sleep on a request path: the
`dataflow-backoff` vet pass (tidb_tpu/analysis/dataflow.py) flags any
raw `time.sleep` reachable from dispatch, and any unbounded retry loop
that never consults a Backoffer budget.

A copy of the JAX package's tidb_tpu/util/backoff.py (stdlib only; the
vet pass above belongs to the JAX package)."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass


class BackoffExhausted(RuntimeError):
    """The task's total-sleep budget is spent; the error is no longer
    retryable at this layer (ref: Backoffer.Backoff returning
    ErrTimeout once totalSleep exceeds maxSleep)."""

    def __init__(self, message: str, kind: str = ""):
        super().__init__(message)
        self.kind = kind


@dataclass(frozen=True)
class BackoffConfig:
    """One error kind's schedule (ref: retry/config.go NewConfig)."""

    kind: str
    base_ms: float
    cap_ms: float


# client-go's budgets, scaled ~1/25 to in-process latencies
# (BoRegionMiss 2/500, BoUpdateLeader 1/10, BoServerBusy 2000/10000,
# BoTiKVRPC 100/2000)
CONFIGS = {
    "region_miss": BackoffConfig("region_miss", 2, 100),
    "epoch_not_match": BackoffConfig("epoch_not_match", 2, 100),
    "region_not_found": BackoffConfig("region_not_found", 2, 100),
    "not_leader": BackoffConfig("not_leader", 2, 100),
    "server_busy": BackoffConfig("server_busy", 10, 400),
    "store_unavailable": BackoffConfig("store_unavailable", 10, 400),
    # follower safe_ts behind start_ts (ref: BoMaxDataNotReady 2/2000);
    # one short wait, then the client falls back to the leader
    "data_not_ready": BackoffConfig("data_not_ready", 2, 80),
}

DEFAULT_BUDGET_MS = 200.0  # per-task; scaled by tidb_backoff_weight
_SLICE_MS = 10.0  # checker-consultation granularity inside one sleep


class Backoffer:
    """One per cop task (the reference allocates one per request chain).

    `weight` is the `tidb_backoff_weight` sysvar; `checker` the
    statement's RunawayChecker (deadline + KILL flag); `rng`, `sleep_fn`
    and `now_fn` are injectable for deterministic tests."""

    def __init__(self, budget_ms: float = DEFAULT_BUDGET_MS, weight: int = 2,
                 checker=None, rng: random.Random | None = None,
                 sleep_fn=time.sleep, now_fn=time.monotonic):
        self.limit_ms = float(budget_ms) * max(int(weight), 0)
        self.checker = checker
        self.total_ms = 0.0
        self.attempts: dict[str, int] = {}
        self._rng = rng or random.Random()
        self._sleep = sleep_fn
        self._now = now_fn

    def backoff(self, kind: str, err: str = "", suggested_ms: float = 0.0) -> float:
        """Sleep one step of `kind`'s schedule (the server's suggested
        wait — ServerIsBusy.backoff_ms — acts as a floor, like client-go
        honoring the errorpb suggestion). Returns ms actually slept;
        raises BackoffExhausted when the budget cannot cover the step."""
        cfg = CONFIGS.get(kind) or BackoffConfig(kind, 2, 100)
        n = self.attempts.get(kind, 0)
        self.attempts[kind] = n + 1
        raw = min(cfg.base_ms * (2.0 ** n), cfg.cap_ms)
        ms = raw / 2.0 + self._rng.uniform(0.0, raw / 2.0)  # equal jitter
        ms = max(ms, float(suggested_ms))
        if self.total_ms + ms > self.limit_ms:
            raise BackoffExhausted(
                f"backoff budget exhausted after {self.total_ms:.0f}ms "
                f"(limit {self.limit_ms:.0f}ms, kind {kind}): {err}",
                kind=kind,
            )
        return self.sleep(ms, kind)

    def sleep(self, ms: float, kind: str = "manual") -> float:
        """Deadline-clamped, checker-interruptible sleep. The checker is
        consulted BETWEEN slices so KILL QUERY lands mid-backoff (a
        statement must not finish a 400ms server-busy nap before noticing
        it was killed); the deadline clamp means a sleep never outlives
        MAX_EXECUTION_TIME."""
        from . import metrics, tracing

        if self.checker is not None:
            self.checker.before_cop_request()  # raises if killed/overdue
            dl = getattr(self.checker, "deadline", None)
            if dl is not None:
                ms = min(ms, max((dl - self._now()) * 1000.0, 0.0))
        slept = 0.0
        while slept < ms:
            step = min(_SLICE_MS, ms - slept)
            self._sleep(step / 1000.0)
            slept += step
            if self.checker is not None and slept < ms:
                self.checker.before_cop_request()
        self.total_ms += slept
        metrics.BACKOFF_SECONDS.labels(kind).inc(slept / 1000.0)
        sp = tracing.current_span()
        if sp is not None:
            sp.set("backoff_ms", round(sp.attrs.get("backoff_ms", 0.0) + slept, 2))
        from ..topsql import record_backoff

        record_backoff(slept)  # Top SQL: the statement owns its naps
        return slept
