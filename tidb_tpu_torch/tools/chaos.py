"""Seeded chaos harness — drive a mixed SQL workload while a deterministic
fault schedule arms and disarms store/PD failpoints, and assert the engine's
ONE inviolable contract: a query under faults either returns the oracle
result or a TYPED retryable error — never a wrong answer — and the cluster
converges back to all-breakers-closed once the storm passes (ref: the
failpoint-driven chaos suites around pingcap/failpoint, and chaos-mesh's
invariant checking over TiDB clusters).

Two modes share one workload generator:

  * `run_chaos(...)` (default schedule) — storm phases at fixed statement
    indices: a store outage mid-run (batched dispatch fails over through a
    PD re-placement), a server-busy storm, a PD heartbeat blackout, counted
    not-leader flaps, and an operator-timeout window; the PD ticks every
    `tick_every` statements, exactly like its background timer.
  * `run_chaos(..., fault_rate=0.1)` — bench mode: each statement rolls the
    seeded dice and runs under a one-shot fault with that probability.

Oracle answers are precomputed on a pristine single-region session BEFORE
any fault is armed, so the comparison itself can never be polluted by the
schedule. `storm` is the loop itself (schedule, statement, classification,
PD ticks, convergence tail, report) over any session, statements and
answer check, so a caller can run the same storm over its own tables.

Copy of the repo's `tools/chaos.py` for the PyTorch port (it imports
nothing of tidb_tpu). Every session a storm builds lives on `device`
("cuda" unless the caller asks for the CPU; it raises without CUDA), with
its store's mesh tier over `mesh_devices`. A storm's interleaving belongs
to its threads and backoffs, so a storm is held to its invariants, not to
another run's counts.

Usage: `python -m tidb_tpu_torch.tools.chaos [seed [statements]]`, with
CHAOS_PITR / CHAOS_MPP / CHAOS_HTAP / CHAOS_CDC set to run those storms.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import sys
import tempfile
import time

from ..br import LogGapError, ReplayInterrupted, log_backup_views, restore_until
from ..cdc import SessionReplaySink
from ..codec import tablecodec
from ..sql.session import Session, SQLError
from ..util import failpoint as fp
from ..util import metrics

TID_ROWS = 240
N_REGIONS = 8
N_STORES = 4

# the SQL error codes a storm counts as typed and retryable: 9005 region
# unavailable, 1105 unknown (a typed region error past its budget), 3024
# max execution time, 1317 query interrupted; run_chaos adds 9003, the
# admission gate's typed ServerIsBusy shed
TYPED_CODES = (9005, 1105, 3024, 1317)
ADMISSION_SHED = 9003

# every failpoint the schedule may arm — disarmed wholesale in the
# `finally` so a crashed run never leaks faults into the next test
FAULT_POINTS = (
    "server/admission-full",
    "store/unreachable",
    "store/not-leader",
    "store/server-busy",
    "store/transfer-leader-timeout",
    "pd/heartbeat-lost",
    "pd/operator-timeout",
    "replica/apply-lag",
    "replica/drop-ack",
    "cdc/puller-drop",
    "cdc/resolved-stuck",
    "cdc/sink-stall",
    "columnar/apply-stall",
    "columnar/compact-stall",
    "mpp/dispatch-lost",
    "mpp/exchange-stall",
    "cdc/segment-crash",
    "restore/replay-crash",
    "br/log-gap",
)


def _chaos_tables(s: Session) -> None:
    s.execute("CREATE TABLE chaos_t (id BIGINT PRIMARY KEY, v BIGINT, g BIGINT)")
    s.execute("CREATE TABLE chaos_d (g BIGINT PRIMARY KEY, name VARCHAR(16))")


def storm_settings(s: Session) -> None:
    """The sharded storm cluster's session settings: batched cop tasks,
    backoff weight 1, and reads that ride followers for the whole storm —
    every cop task routes through the replica selector and the safe_ts
    gate, and the oracle comparison is what proves the gate never lies."""
    s.execute("SET tidb_allow_batch_cop = ON")
    s.execute("SET tidb_backoff_weight = 1")
    s.execute("SET tidb_replica_read = 'follower'")


def _fill_session(split_regions: bool, device="cuda", mesh_devices=None) -> Session:
    """One schema+data instance; `split_regions` True builds the sharded
    chaos cluster, False the single-region oracle."""
    s = Session(device=device, mesh_devices=mesh_devices)
    _chaos_tables(s)
    s.execute("INSERT INTO chaos_t VALUES " + ",".join(
        f"({i},{(i * 37) % 101},{i % 6})" for i in range(TID_ROWS)))
    s.execute("INSERT INTO chaos_d VALUES " + ",".join(
        f"({g},'grp{g}')" for g in range(6)))
    if split_regions:
        tid = s.catalog.table("chaos_t").table_id
        for i in range(1, N_REGIONS):
            s.store.cluster.split(tablecodec.encode_row_key(tid, i * TID_ROWS // N_REGIONS))
        s.store.cluster.set_stores(N_STORES)
        s.store.cluster.scatter()
        storm_settings(s)
    return s


def build_workload(seed: int, n: int) -> list[str]:
    """Deterministic mixed workload: scans, range reads, aggregates,
    a broadcast join, TopN — every statement fully ordered so result
    comparison is positional."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        t = rng.randrange(6)
        if t == 0:
            out.append(f"SELECT count(*), sum(v) FROM chaos_t WHERE v < {rng.randrange(5, 95)}")
        elif t == 1:
            a = rng.randrange(0, TID_ROWS - 25)
            out.append(f"SELECT id, v FROM chaos_t WHERE id BETWEEN {a} AND {a + 20} ORDER BY id")
        elif t == 2:
            out.append("SELECT g, count(*), sum(v) FROM chaos_t GROUP BY g ORDER BY g")
        elif t == 3:
            p = rng.randrange(10, 90)
            out.append(
                "SELECT t.g, d.name, count(*) FROM chaos_t t JOIN chaos_d d ON t.g = d.g "
                f"WHERE t.v < {p} GROUP BY t.g, d.name ORDER BY t.g")
        elif t == 4:
            out.append("SELECT id, v FROM chaos_t ORDER BY v DESC, id LIMIT 10")
        else:
            out.append(f"SELECT max(v), min(v), count(*) FROM chaos_t WHERE id >= {rng.randrange(TID_ROWS)}")
    return out


def default_schedule(n: int) -> dict[int, list[tuple]]:
    """Statement-index -> fault actions. Phases scale with `n` so a short
    run still sees every storm and still gets a clean convergence tail."""
    def at(frac: float) -> int:
        return max(int(n * frac), 1)

    sched: dict[int, list[tuple]] = {}

    def add(i, *action):
        sched.setdefault(i, []).append(tuple(action))

    # phase 0: a follower's apply loop wedges (replica reads hit the
    # safe_ts gate -> DataIsNotReady -> leader fallback, zero wrong rows)
    add(at(0.06), "arm", "replica/apply-lag", {"stores": {3}})
    add(at(0.12), "disarm", "replica/apply-lag")
    # phase 1: store 1 — a LEADER KILL — drops off the network mid-run
    # (batched dispatch lanes fall out, breaker opens, failover is a
    # leader TRANSFER among the live peers; the first attempts eat a
    # counted transfer-leader timeout first)
    add(at(0.15), "arm", "store/transfer-leader-timeout", 2)
    add(at(0.15), "down", 1)
    # part of the outage runs with LEADER reads: follower routing would
    # otherwise mask a dead leader entirely (followers keep serving), and
    # the failover-is-a-transfer assertion needs leader-targeted traffic
    add(at(0.18), "set", "tidb_replica_read", "leader")
    add(at(0.24), "set", "tidb_replica_read", "follower")
    add(at(0.28), "up", 1)
    add(at(0.28), "disarm", "store/transfer-leader-timeout")
    # phase 2: server-busy storm on store 2 (suggested-backoff honored)
    add(at(0.35), "arm", "store/server-busy", {"stores": {2}, "backoff_ms": 3})
    add(at(0.45), "disarm", "store/server-busy")
    # phase 3: PD heartbeat blackout (ticks keep running, stats starve)
    add(at(0.50), "arm", "pd/heartbeat-lost", True)
    add(at(0.60), "disarm", "pd/heartbeat-lost")
    # phase 4: counted not-leader flaps (transient leadership wobble —
    # fires 3 times total, then leadership 'settles')
    add(at(0.63), "arm", "store/not-leader", 3)
    add(at(0.68), "disarm", "store/not-leader")
    # phase 5: operator-timeout window + a second, shorter outage
    add(at(0.72), "arm", "pd/operator-timeout", True)
    add(at(0.72), "down", 2)
    add(at(0.78), "up", 2)
    add(at(0.80), "disarm", "pd/operator-timeout")
    # everything past at(0.80) runs clean: the convergence tail
    return sched


def _apply(actions, sess, fp) -> None:
    for action in actions:
        if action[0] == "down":
            sess.store.set_down(action[1])
        elif action[0] == "up":
            sess.store.set_up(action[1])
        elif action[0] == "arm":
            fp.enable(action[1], action[2])
        elif action[0] == "disarm":
            fp.disable(action[1])
        elif action[0] == "set":
            sess.execute(f"SET {action[1]} = '{action[2]}'")


def storm(s: Session, workload: list[str], check, schedule: dict, seed: int = 7,
          fault_rate: float | None = None, tick_every: int = 10,
          admission_flicker: float = 0.0) -> dict:
    """Run `workload` on `s` under `schedule` (statement index -> actions);
    returns the invariant report. `check(i, result)` holds statement i's
    Result to its oracle: None when right, else a dict of what it got and
    wanted (a wrong result). Raises nothing on query failures — failures
    are CLASSIFIED: an SQLError whose code is in TYPED_CODES, or the
    admission gate's 9003 shed, is typed; anything else is untyped. With `fault_rate`, each statement rolls the seeded
    dice for a one-shot fault; `admission_flicker` one-shot-arms the
    server/admission-full failpoint before that fraction of statements.
    The PD ticks every `tick_every` statements; with every fault cleared,
    up to three more ticks close any breaker still tripped (the
    convergence tail is part of the run)."""
    store = s.store
    rng = random.Random(seed * 31 + 1)
    labeled_total = metrics.REGISTRY.labeled_samples

    def breaker_trips_total() -> float:
        """Sum of the labeled trip counters via the public sampling API."""
        return sum(labeled_total("tidb_tpu_store_breaker_trips_total").values())

    n = len(workload)
    ok = typed = 0
    wrong: list = []
    untyped: list = []
    by_code: dict[int, int] = {}
    lat_ms: list[float] = []
    failovers0 = metrics.PD_FAILOVERS.value
    transfers0 = metrics.PD_TRANSFER_LEADER.value
    replica0 = labeled_total("tidb_tpu_replica_read_total")
    opkinds0 = labeled_total("pd_operator_total")
    trips0 = breaker_trips_total()
    try:
        for i, sql in enumerate(workload):
            _apply(schedule.get(i, ()), s, fp)
            if admission_flicker and rng.random() < admission_flicker:
                fp.enable("server/admission-full", 1)  # fire once: this
                # statement sheds at the gate, the next runs normally
            one_shot = fault_rate is not None and rng.random() < fault_rate
            if one_shot:
                sid = rng.randrange(1, N_STORES)  # store 0 spared: the
                # oracle comparison stays possible even at rate 1.0
                if rng.random() < 0.7:
                    fp.enable("store/server-busy", {"stores": {sid}, "backoff_ms": 2})
                else:
                    fp.enable("store/not-leader", 1)  # one counted flap
            t0 = time.monotonic()
            try:
                res = s.execute(sql)
                lat_ms.append((time.monotonic() - t0) * 1000.0)
                bad = check(i, res)
                if bad is not None:
                    wrong.append({"stmt": i, "sql": sql, **bad})
                else:
                    ok += 1
            except SQLError as exc:
                lat_ms.append((time.monotonic() - t0) * 1000.0)
                code = getattr(exc, "code", 0)
                if code in TYPED_CODES or code == ADMISSION_SHED:
                    typed += 1
                    by_code[code] = by_code.get(code, 0) + 1
                else:
                    untyped.append({"stmt": i, "sql": sql, "error": str(exc)[:200]})
            except Exception as exc:  # noqa: BLE001 — the exact bug class we hunt
                lat_ms.append((time.monotonic() - t0) * 1000.0)
                untyped.append({"stmt": i, "sql": sql,
                                "error": f"{type(exc).__name__}: {str(exc)[:200]}"})
            finally:
                if one_shot:
                    fp.disable("store/server-busy")
                    fp.disable("store/not-leader")
            if (i + 1) % tick_every == 0:
                store.pd.tick()
    finally:
        for name in FAULT_POINTS:
            fp.disable(name)
        for sid in range(N_STORES):
            store.set_up(sid)
    # convergence tail: with every fault cleared, the PD's health probes
    # close any breaker still tripped (this IS part of the run — the
    # acceptance bar is all-breakers-closed before the harness returns)
    for _ in range(3):
        store.pd.tick()
        if store.breakers.all_closed():
            break

    lat_sorted = sorted(lat_ms)

    def pct(p: float) -> float:
        return round(lat_sorted[min(int(len(lat_sorted) * p), len(lat_sorted) - 1)], 2) if lat_sorted else 0.0

    return {
        "seed": seed,
        "statements": n,
        "ok": ok,
        "typed_errors": typed,
        "errors_by_code": by_code,
        "wrong_results": wrong,
        "untyped_errors": untyped,
        "failovers": int(metrics.PD_FAILOVERS.value - failovers0),
        "transfer_leaders": int(metrics.PD_TRANSFER_LEADER.value - transfers0),
        # placement moves during failover happen ONLY on quorum loss; the
        # default storm never loses quorum (4 stores, 3 replicas, one
        # down), so this is the acceptance bar's zero
        "failover_moves": int(labeled_total("pd_operator_total").get("failover", 0)
                              - opkinds0.get("failover", 0)),
        "replica_reads": {
            k: int(labeled_total("tidb_tpu_replica_read_total").get(k, 0)
                   - replica0.get(k, 0))
            for k in ("leader", "follower")
        },
        "breaker_trips": int(breaker_trips_total() - trips0),
        "breakers": {str(k): v for k, v in sorted(store.breakers.states().items())},
        "breakers_all_closed": store.breakers.all_closed(),
        "store_health": [d["state"] for d in store.pd.stores_view()],
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
    }


def run_chaos(seed: int = 7, statements: int = 200, fault_rate: float | None = None,
              tick_every: int = 10, admission_flicker: float = 0.0,
              cost_classed: bool = False, coalesce: bool = False, *,
              device="cuda", mesh_devices=None) -> dict:
    """Run the workload under the fault schedule; returns the invariant
    report (see `storm`). Typed errors are expected under faults, wrong
    answers and untyped errors are the bugs this harness exists to catch.
    `admission_flicker` one-shot-arms the server/admission-full failpoint
    before that fraction of statements: the shed must surface as typed
    9003, never corrupt a later answer. `cost_classed` runs the storm with
    Top SQL attribution ON and the admission gate in measured-cost mode:
    every statement classifies + admits through the per-class lanes while
    faults fly — any shed must still be typed 9003 and the answer oracle
    must stay clean. `coalesce` runs the storm with cross-session fused
    execution ON: plan-cache-hit point gets route through the coalescer
    window and autocommit writes through group commit — faulted lanes must
    fall out to the single path, never corrupt an answer. The oracle is a
    single-region session on `device`; the storm's session shards its
    mesh tier over `mesh_devices`."""
    workload = build_workload(seed, statements)
    oracle_sess = _fill_session(False, device)
    oracle = [oracle_sess.execute(sql).values() for sql in workload]

    s = _fill_session(True, device, mesh_devices)
    if coalesce:
        s.execute("SET tidb_tpu_enable_coalesce = ON")
    if cost_classed:
        # measured-cost admission under the storm: Top SQL tags every
        # statement, the EWMAs learn live, the gate weighs each admit by
        # its class — generous inflight so the faults (not the gate) are
        # what this run stresses; admission_flicker still forces sheds
        s.execute("SET tidb_enable_top_sql = ON")
        s.store.admission.configure(max_inflight=8, cost_classed=True)

    def check(i, res):
        got = res.values()
        if got == oracle[i]:
            return None
        return {"got": repr(got)[:200], "want": repr(oracle[i])[:200]}

    schedule = {} if fault_rate is not None else default_schedule(statements)
    return storm(s, workload, check, schedule, seed=seed, fault_rate=fault_rate,
                 tick_every=tick_every, admission_flicker=admission_flicker)


# ------------------------------------------------------- the CDC storm phase
# (a live changefeed replays into a second cluster while the storm throws
# splits, merges, leader transfers, an outage, apply-lag and the cdc/*
# failpoints at it; at the end the mirror must be scan-identical to the
# source, the resolved frontier monotone, and every key's events in commit
# order with no duplicates)


class CheckingSink:
    """Ordering oracle wrapped around the replay sink: per-key commit_ts
    strictly increasing, no (key, commit_ts) duplicates, every row above
    the last flushed resolved ts, the resolved marks themselves monotone
    — the changefeed consistency contract, checked at the sink seam."""

    def __init__(self, inner):
        self.inner = inner
        self.last_by_key: dict = {}
        self.resolved = 0
        self.events = 0
        self.violations: list = []

    def write(self, events):
        for ev in events:
            # schema events ride the stream handle-less: they share the
            # per-table ordering lane and the resolved gate
            k = (ev.table, getattr(ev, "handle", "<schema>"))
            if ev.commit_ts <= self.resolved:
                self.violations.append(
                    f"event {k} at {ev.commit_ts} at/below flushed resolved {self.resolved}")
            last = self.last_by_key.get(k, 0)
            if ev.commit_ts <= last:
                self.violations.append(
                    f"per-key order broken: {k} at {ev.commit_ts} after {last}")
            self.last_by_key[k] = ev.commit_ts
            self.events += 1
        self.inner.write(events)

    def flush(self, resolved_ts):
        if resolved_ts < self.resolved:
            self.violations.append(
                f"resolved regressed: {resolved_ts} < {self.resolved}")
        self.resolved = resolved_ts
        self.inner.flush(resolved_ts)

    def close(self):
        self.inner.close()

    def describe(self):
        return f"checking({self.inner.describe()})"


def build_cdc_workload(seed: int, n: int) -> list[str]:
    """Mixed DML + reads: the write mix the changefeed must capture, the
    read mix that keeps the fault machinery (replica reads, breakers,
    batched cop) busy underneath it."""
    rng = random.Random(seed * 7 + 3)
    reads = build_workload(seed, n)
    out = []
    next_id = TID_ROWS
    for i in range(n):
        t = rng.randrange(8)
        if t in (0, 1):
            out.append(f"INSERT INTO chaos_t VALUES ({next_id},{rng.randrange(100)},{next_id % 6})")
            next_id += 1
        elif t == 2:
            out.append(f"UPDATE chaos_t SET v = {rng.randrange(100)} WHERE id = {rng.randrange(next_id)}")
        elif t == 3:
            out.append(f"DELETE FROM chaos_t WHERE id = {rng.randrange(next_id)}")
        elif t == 4:
            out.append(f"UPDATE chaos_d SET name = 'g{rng.randrange(100)}' WHERE g = {rng.randrange(6)}")
        else:
            out.append(reads[i])
    return out


def cdc_schedule(n: int) -> dict[int, list[tuple]]:
    """The CDC storm: every topology change the repo can throw plus the
    three cdc/* failpoints, with a clean convergence tail."""
    def at(frac: float) -> int:
        return max(int(n * frac), 1)

    sched: dict[int, list[tuple]] = {}

    def add(i, *action):
        sched.setdefault(i, []).append(tuple(action))

    add(at(0.06), "split")  # region split mid-stream: sorter hand-off
    add(at(0.10), "arm", "replica/apply-lag", {"stores": {3}})
    add(at(0.18), "disarm", "replica/apply-lag")
    add(at(0.22), "transfer")  # leader transfers under live capture
    add(at(0.28), "arm", "cdc/sink-stall", True)
    add(at(0.34), "disarm", "cdc/sink-stall")
    add(at(0.38), "down", 1)  # store outage: reads fail over; writes and
    add(at(0.48), "up", 1)  # the shared-KV log keep flowing
    add(at(0.52), "arm", "cdc/resolved-stuck", True)
    add(at(0.60), "disarm", "cdc/resolved-stuck")
    add(at(0.64), "arm", "cdc/puller-drop", True)
    add(at(0.70), "disarm", "cdc/puller-drop")
    add(at(0.74), "merge")  # region merge: watermark min-fold
    add(at(0.78), "transfer")
    # past at(0.78): clean tail — the feed must drain and converge
    return sched


def _apply_cdc(actions, sess, fp, tid) -> None:
    for action in actions:
        if action[0] == "split":
            handles = [h for h, in
                       ((r[0],) for r in sess.execute(
                           "SELECT id FROM chaos_t ORDER BY id").values())]
            if handles:
                mid = handles[len(handles) // 2]
                sess.store.cluster.split(tablecodec.encode_row_key(tid, mid))
        elif action[0] == "merge":
            regions = sess.store.cluster.regions()
            if len(regions) > 2:
                sess.store.cluster.merge(regions[0].region_id)
        elif action[0] == "transfer":
            for r in sess.store.cluster.regions():
                folls = sess.store.cluster.followers_of(r.region_id)
                if folls:
                    sess.store.cluster.transfer_leader(r.region_id, folls[0])
        else:
            _apply([action], sess, fp)


def _mirror_session(device) -> Session:
    mirror = Session(device=device)
    _chaos_tables(mirror)
    return mirror


def run_cdc_storm(seed: int = 11, statements: int = 160,
                  tick_every: int = 6, *, device="cuda", mesh_devices=None) -> dict:
    """The changefeed chaos acceptance: a feed created BEFORE the storm
    replays chaos_t/chaos_d into a pristine mirror cluster via the
    session-replay sink while the schedule churns topology and arms the
    cdc/* failpoints. Returns the invariant report; `main` asserts mirror
    equality, frontier monotonicity, zero ordering violations and zero
    untyped errors."""
    sess = _fill_session(True, device, mesh_devices)
    mirror = _mirror_session(device)
    tid = sess.catalog.table("chaos_t").table_id
    did = sess.catalog.table("chaos_d").table_id
    sink = CheckingSink(SessionReplaySink(mirror))
    feed = sess.store.cdc.create("storm", sink, sess.catalog,
                                 table_ids={tid, did}, start_ts=0)

    workload = build_cdc_workload(seed, statements)
    schedule = cdc_schedule(statements)
    ok = typed = 0
    untyped: list = []
    frontier_samples: list = []
    recov0 = metrics.CDC_RECOVERY_SCANS.value
    try:
        for i, sql in enumerate(workload):
            _apply_cdc(schedule.get(i, ()), sess, fp, tid)
            try:
                sess.execute(sql)
                ok += 1
            except SQLError as exc:
                if getattr(exc, "code", 0) in TYPED_CODES:
                    typed += 1
                else:
                    untyped.append({"stmt": i, "sql": sql, "error": str(exc)[:200]})
            except Exception as exc:  # noqa: BLE001 — the bug class we hunt
                untyped.append({"stmt": i, "sql": sql,
                                "error": f"{type(exc).__name__}: {str(exc)[:200]}"})
            if (i + 1) % tick_every == 0:
                sess.store.pd.tick()
                frontier_samples.append((i, feed.view(sess.store)["checkpoint_ts"]))
    finally:
        for name in FAULT_POINTS:
            fp.disable(name)
        for sid in range(N_STORES):
            sess.store.set_up(sid)
    # drain: with every fault cleared the feed must converge (backlog
    # flushes, recovery scans settle, frontier passes the last commit)
    last_commit = sess.store.kv.max_committed()
    for _ in range(12):
        sess.store.pd.tick()
        frontier_samples.append((statements, feed.view(sess.store)["checkpoint_ts"]))
        v = feed.view(sess.store)
        if v["pending"] == 0 and v["checkpoint_ts"] >= last_commit:
            break

    def scan(s, table):
        return s.execute(f"SELECT * FROM {table} ORDER BY 1").values()

    frontiers = [f for _, f in frontier_samples]
    return {
        "seed": seed,
        "statements": statements,
        "ok": ok,
        "typed_errors": typed,
        "untyped_errors": untyped,
        "events_emitted": sink.events,
        "ordering_violations": sink.violations,
        "recovery_scans": int(metrics.CDC_RECOVERY_SCANS.value - recov0),
        "frontier_samples": frontiers,
        "frontier_monotone": all(a <= b for a, b in zip(frontiers, frontiers[1:])),
        "frontier_advanced": bool(frontiers) and frontiers[-1] > frontiers[0],
        "feed_state": feed.view(sess.store)["state"],
        "mirror_equal": {
            "chaos_t": scan(sess, "chaos_t") == scan(mirror, "chaos_t"),
            "chaos_d": scan(sess, "chaos_d") == scan(mirror, "chaos_d"),
        },
        "source_rows": len(scan(sess, "chaos_t")),
        "mirror_rows": len(scan(mirror, "chaos_t")),
    }


# --------------------------------------------------- the HTAP storm phase
# (OLTP DML churns a sharded cluster whose tables carry a live columnar
# replica while the schedule throws splits, merges, leader transfers, a
# store outage, and the cdc/* + columnar/* failpoints; every engine-routed
# analytical query must return results byte-identical to the row-store
# oracle at the same snapshot, the replica's resolved-ts lag must drain to
# 0 after the storm, and zero untyped errors escape)


def htap_schedule(n: int) -> dict[int, list[tuple]]:
    """Topology churn + the columnar failpoints, with a clean tail."""
    def at(frac: float) -> int:
        return max(int(n * frac), 1)

    sched: dict[int, list[tuple]] = {}

    def add(i, *action):
        sched.setdefault(i, []).append(tuple(action))

    add(at(0.06), "split")
    add(at(0.10), "arm", "columnar/compact-stall", True)  # delta grows,
    add(at(0.20), "disarm", "columnar/compact-stall")  # overlay serves
    add(at(0.24), "transfer")
    add(at(0.28), "arm", "columnar/apply-stall", True)  # feed parks in
    add(at(0.34), "disarm", "columnar/apply-stall")  # error; scans fall
    add(at(0.34), "resume_columnar")  # back, RESUME replays the backlog
    add(at(0.38), "down", 1)  # store outage: reads fail over, the shared
    add(at(0.46), "up", 1)  # log keeps feeding the replica
    add(at(0.50), "arm", "cdc/resolved-stuck", True)  # frontier pins ->
    add(at(0.58), "disarm", "cdc/resolved-stuck")  # staleness fallbacks
    add(at(0.62), "arm", "cdc/puller-drop", True)
    add(at(0.68), "disarm", "cdc/puller-drop")
    add(at(0.72), "merge")
    add(at(0.76), "arm", "cdc/sink-stall", True)
    add(at(0.80), "disarm", "cdc/sink-stall")
    add(at(0.82), "transfer")
    # past at(0.82): clean tail — the replica must drain to lag 0
    return sched


def run_htap_storm(seed: int = 13, statements: int = 200,
                   tick_every: int = 6, *, device="cuda", mesh_devices=None) -> dict:
    """The HTAP chaos acceptance: chaos_t/chaos_d carry a columnar replica
    (ALTER ... SET COLUMNAR REPLICA 1) while the mixed DML+read workload
    runs under the storm. Every read runs TWICE back to back —
    engine-routed (tpu,columnar) then row-store-forced (tpu) — and the
    single-threaded workload guarantees both see the same snapshot, so the
    pair must be byte-identical. The mirror-equality oracle is the
    consistency gate; `main` additionally asserts the replica served real
    scans, lag drained to 0, and the feeds ended `normal`."""
    sess = _fill_session(True, device, mesh_devices)
    sess.execute("ALTER TABLE chaos_t SET COLUMNAR REPLICA 1")
    sess.execute("ALTER TABLE chaos_d SET COLUMNAR REPLICA 1")
    sess.store.pd.tick()  # birth incremental scans backfill + first fold
    tid = sess.catalog.table("chaos_t").table_id

    workload = build_cdc_workload(seed, statements)
    schedule = htap_schedule(statements)
    ok = typed = 0
    wrong: list = []
    untyped: list = []
    scans0 = metrics.COLUMNAR_SCANS.value
    falls0 = metrics.COLUMNAR_FALLBACKS.value
    applied0 = metrics.COLUMNAR_APPLIED.value

    def run_one(sql: str):
        """-> (values | None, error | None); typed errors count, untyped
        errors are the bug class this harness hunts."""
        nonlocal typed
        try:
            return sess.execute(sql).values(), None
        except SQLError as exc:
            if getattr(exc, "code", 0) in TYPED_CODES:
                typed += 1
                return None, "typed"
            return None, f"SQLError: {exc}"
        except Exception as exc:  # noqa: BLE001 — the bug class we hunt
            return None, f"{type(exc).__name__}: {exc}"

    try:
        for i, sql in enumerate(workload):
            _apply_htap(schedule.get(i, ()), sess, fp, tid)
            if sql.lstrip().upper().startswith("SELECT"):
                # the mirror-equality oracle: routed vs row-store, same
                # snapshot (single-threaded — no write between the pair)
                sess.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
                got, err1 = run_one(sql)
                sess.execute("SET tidb_isolation_read_engines = 'tpu'")
                want, err2 = run_one(sql)
                for err in (err1, err2):
                    if err not in (None, "typed"):
                        untyped.append({"stmt": i, "sql": sql, "error": err[:200]})
                if got is not None and want is not None:
                    if got != want:
                        wrong.append({"stmt": i, "sql": sql,
                                      "got": repr(got)[:200],
                                      "want": repr(want)[:200]})
                    else:
                        ok += 1
            else:
                _, err = run_one(sql)
                if err is None:
                    ok += 1
                elif err != "typed":
                    untyped.append({"stmt": i, "sql": sql, "error": err[:200]})
            if (i + 1) % tick_every == 0:
                sess.store.pd.tick()
    finally:
        for name in FAULT_POINTS:
            fp.disable(name)
        for sid in range(N_STORES):
            sess.store.set_up(sid)
    # drain: with every fault cleared (and parked feeds resumed) the
    # replica must converge — delta folds, lag reaches 0, feeds normal
    sess.store.columnar.resume_all()
    views = []
    for _ in range(12):
        sess.store.pd.tick()
        views = sess.store.columnar.views()
        if all(v["state"] == "normal" and v["resolved_ts_lag"] == 0
               and v["delta_rows"] == 0 for v in views):
            break
    return {
        "seed": seed,
        "statements": statements,
        "ok": ok,
        "typed_errors": typed,
        "wrong_results": wrong,
        "untyped_errors": untyped,
        "columnar_scans": int(metrics.COLUMNAR_SCANS.value - scans0),
        "columnar_fallbacks": int(metrics.COLUMNAR_FALLBACKS.value - falls0),
        "applied_events": int(metrics.COLUMNAR_APPLIED.value - applied0),
        "tables": views,
        "lag_drained": all(v["resolved_ts_lag"] == 0 for v in views),
        "feeds_normal": all(v["state"] == "normal" for v in views),
        "delta_drained": all(v["delta_rows"] == 0 for v in views),
    }


def _apply_htap(actions, sess, fp, tid) -> None:
    for action in actions:
        if action[0] == "resume_columnar":
            sess.store.columnar.resume_all()
        else:
            _apply_cdc([action], sess, fp, tid)


def _fill_mpp_session(device="cuda", mesh_devices=None):
    """The sharded 3-table chain cluster (TPC-H Q3 shape): a wide fact
    table split over N_REGIONS regions and N_STORES stores, two dimension
    chains, and a columnar replica on the fact table so the mpp probe can
    source from it mid-storm."""
    s = Session(device=device, mesh_devices=mesh_devices)
    s.execute("CREATE TABLE mpp_c (c_id BIGINT PRIMARY KEY, seg VARCHAR(2))")
    s.execute("CREATE TABLE mpp_o (o_id BIGINT PRIMARY KEY, ckey BIGINT, odate BIGINT)")
    s.execute("CREATE TABLE mpp_i (i_id BIGINT PRIMARY KEY, oid BIGINT, v BIGINT)")
    s.execute("INSERT INTO mpp_c VALUES " + ",".join(
        f"({i},'{'AB'[i % 2]}')" for i in range(12)))
    s.execute("INSERT INTO mpp_o VALUES " + ",".join(
        f"({i},{i % 12},{1000 + i % 9})" for i in range(48)))
    s.execute("INSERT INTO mpp_i VALUES " + ",".join(
        f"({i},{(i * 3) % 52},{(i * 37) % 101})" for i in range(TID_ROWS)))
    tid = s.catalog.table("mpp_i").table_id
    for i in range(1, N_REGIONS):
        s.store.cluster.split(tablecodec.encode_row_key(tid, i * TID_ROWS // N_REGIONS))
    s.store.cluster.set_stores(N_STORES)
    s.store.cluster.scatter()
    s.execute("SET tidb_backoff_weight = 1")
    s.execute("ALTER TABLE mpp_i SET COLUMNAR REPLICA 1")
    s.store.pd.tick()
    return s, tid


def build_mpp_workload(seed: int, n: int) -> list[str]:
    """Exchange-eligible reads (no ORDER BY — Sort pins plans to root)
    plus seeded DML churn; results compare as sorted row sets."""
    rng = random.Random(seed)
    out = []
    for k in range(n):
        t = rng.randrange(6)
        if t == 0:
            out.append(
                "SELECT oid, count(*), sum(v) FROM mpp_i "
                "JOIN mpp_o ON oid = o_id JOIN mpp_c ON ckey = c_id "
                f"WHERE seg = '{'AB'[rng.randrange(2)]}' AND odate < {1002 + rng.randrange(7)} "
                "GROUP BY oid")
        elif t == 1:
            out.append(
                "SELECT ckey, count(*), sum(v) FROM mpp_i "
                "JOIN mpp_o ON oid = ckey GROUP BY ckey")  # non-unique build
        elif t == 2:
            out.append(
                f"SELECT oid, count(*) FROM mpp_i WHERE v < {rng.randrange(20, 90)} GROUP BY oid")
        elif t == 3:
            out.append(
                "SELECT oid, max(v), min(v) FROM mpp_i "
                "JOIN mpp_o ON oid = o_id GROUP BY oid")
        elif t == 4:
            i = rng.randrange(TID_ROWS)
            out.append(f"UPDATE mpp_i SET v = {rng.randrange(101)} WHERE i_id = {i}")
        else:
            out.append(f"SELECT count(*), sum(v) FROM mpp_i WHERE oid >= {rng.randrange(40)}")
    return out


def mpp_schedule(n: int) -> dict[int, list[tuple]]:
    """Store outage + leader transfer + columnar lag + the mpp/* points,
    all mid-exchange, with a clean convergence tail."""
    def at(frac: float) -> int:
        return max(int(n * frac), 1)

    sched: dict[int, list[tuple]] = {}

    def add(i, *action):
        sched.setdefault(i, []).append(tuple(action))

    add(at(0.05), "arm", "mpp/dispatch-lost", 3)  # lost dispatches: counted
    add(at(0.12), "disarm", "mpp/dispatch-lost")  # fallbacks, same rows
    add(at(0.16), "down", 1)  # store outage mid-exchange: probe scan fails
    add(at(0.26), "up", 1)  # over; mpp falls out typed or re-splits
    add(at(0.30), "arm", "mpp/exchange-stall", 3)
    add(at(0.38), "disarm", "mpp/exchange-stall")
    add(at(0.42), "transfer")  # leader churn under the probe scan
    add(at(0.48), "arm", "columnar/apply-stall", True)  # replica lags: the
    add(at(0.56), "disarm", "columnar/apply-stall")  # probe source falls
    add(at(0.56), "resume_columnar")  # back to the row store, counted
    add(at(0.60), "split")
    add(at(0.66), "arm", "columnar/compact-stall", True)
    add(at(0.74), "disarm", "columnar/compact-stall")
    add(at(0.78), "transfer")
    # past at(0.78): clean tail — mpp must serve again before the end
    return sched


def run_mpp_storm(seed: int = 17, statements: int = 160,
                  tick_every: int = 6, *, device="cuda", mesh_devices=None) -> dict:
    """The MPP chaos acceptance: exchange-eligible chain joins and grouped
    aggs run under store outages, leader transfers, columnar lag and the
    mpp/* failpoints. Every read runs TWICE back to back — routed
    (mesh+mpp on) then row-store-forced (mesh off) — and the
    single-threaded workload guarantees the same snapshot, so the sorted
    row sets must be byte-identical. Failures must be typed; declines must
    be counted fallbacks. The mesh is the store's `mesh_devices`."""
    sess, tid = _fill_mpp_session(device, mesh_devices)
    workload = build_mpp_workload(seed, statements)
    schedule = mpp_schedule(statements)
    ok = typed = 0
    wrong: list = []
    untyped: list = []
    mpp0 = metrics.MPP_SELECTS.value
    falls0 = metrics.MPP_FALLBACKS.value
    mesh0 = metrics.MESH_SELECTS.value

    def run_one(sql: str):
        nonlocal typed
        try:
            return sorted(map(repr, sess.execute(sql).values())), None
        except SQLError as exc:
            if getattr(exc, "code", 0) in TYPED_CODES:
                typed += 1
                return None, "typed"
            return None, f"SQLError: {exc}"
        except Exception as exc:  # noqa: BLE001 — the bug class we hunt
            return None, f"{type(exc).__name__}: {exc}"

    def apply_mpp(actions):
        for action in actions:
            if action[0] == "split":  # _apply_cdc's split names chaos_t
                handles = sorted(r[0] for r in sess.execute(
                    "SELECT i_id FROM mpp_i").values())
                if handles:
                    mid = handles[len(handles) // 2]
                    sess.store.cluster.split(tablecodec.encode_row_key(tid, mid))
            elif action[0] == "resume_columnar":
                sess.store.columnar.resume_all()
            else:
                _apply_cdc([action], sess, fp, tid)

    try:
        for i, sql in enumerate(workload):
            apply_mpp(schedule.get(i, ()))
            if sql.lstrip().upper().startswith("SELECT"):
                # mirror oracle: routed (mesh+mpp, replica probes allowed)
                # vs row-store-forced, same snapshot (single-threaded — no
                # write lands between the pair)
                sess.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
                got, err1 = run_one(sql)
                sess.execute("SET tidb_enable_tpu_mesh = OFF")
                sess.execute("SET tidb_isolation_read_engines = 'tpu'")
                want, err2 = run_one(sql)
                sess.execute("SET tidb_enable_tpu_mesh = ON")
                for err in (err1, err2):
                    if err not in (None, "typed"):
                        untyped.append({"stmt": i, "sql": sql, "error": err[:200]})
                if got is not None and want is not None:
                    if got != want:
                        wrong.append({"stmt": i, "sql": sql,
                                      "got": repr(got)[:200],
                                      "want": repr(want)[:200]})
                    else:
                        ok += 1
            else:
                _, err = run_one(sql)
                if err is None:
                    ok += 1
                elif err != "typed":
                    untyped.append({"stmt": i, "sql": sql, "error": err[:200]})
            if (i + 1) % tick_every == 0:
                sess.store.pd.tick()
    finally:
        for name in FAULT_POINTS:
            fp.disable(name)
        for sid in range(N_STORES):
            sess.store.set_up(sid)
    sess.store.columnar.resume_all()
    for _ in range(12):
        sess.store.pd.tick()
    return {
        "seed": seed,
        "statements": statements,
        "ok": ok,
        "typed_errors": typed,
        "wrong_results": wrong,
        "untyped_errors": untyped,
        "mpp_selects": int(metrics.MPP_SELECTS.value - mpp0),
        "mpp_fallbacks": int(metrics.MPP_FALLBACKS.value - falls0),
        "mesh_selects": int(metrics.MESH_SELECTS.value - mesh0),
    }


def mpp_storm_bad(report: dict):
    """The CHAOS_MPP gate: truthy iff a wrong or untyped answer escaped, or
    the storm never served from (or fell out of) the MPP tier."""
    return (report["wrong_results"] or report["untyped_errors"]
            or report["mpp_selects"] == 0 or report["mpp_fallbacks"] == 0)


# --------------------------------------------------- the PITR storm phase
# (a log backup and a mirror replay feed ride the same storm of DML +
# mid-feed DDL + splits/transfers/outage + cdc/* failpoints; three
# mid-storm restore points must come back byte-identical to live oracle
# snapshots, a kill-mid-flush must cost nothing, a mid-replay crash must
# resume idempotently, and a manifest gap must fail as the typed
# LogGapError — never a silently-short cluster)


def build_pitr_workload(seed: int, n: int) -> list[str]:
    """The CDC write mix with EXPLICIT column lists, so the mid-storm
    `ADD COLUMN` DDLs never invalidate a later INSERT's shape."""
    rng = random.Random(seed * 7 + 3)
    reads = build_workload(seed, n)
    out = []
    next_id = TID_ROWS
    for i in range(n):
        t = rng.randrange(8)
        if t in (0, 1):
            out.append("INSERT INTO chaos_t (id, v, g) VALUES "
                       f"({next_id},{rng.randrange(100)},{next_id % 6})")
            next_id += 1
        elif t == 2:
            out.append(f"UPDATE chaos_t SET v = {rng.randrange(100)} WHERE id = {rng.randrange(next_id)}")
        elif t == 3:
            out.append(f"DELETE FROM chaos_t WHERE id = {rng.randrange(next_id)}")
        elif t == 4:
            out.append(f"UPDATE chaos_d SET name = 'g{rng.randrange(100)}' WHERE g = {rng.randrange(6)}")
        else:
            out.append(reads[i])
    return out


def pitr_schedule(n: int) -> dict[int, list[tuple]]:
    """Topology churn + the cdc/* points + three mid-feed DDLs (the
    zero-parks acceptance) + one kill-mid-flush, with a clean tail."""
    def at(frac: float) -> int:
        return max(int(n * frac), 1)

    sched: dict[int, list[tuple]] = {}

    def add(i, *action):
        sched.setdefault(i, []).append(tuple(action))

    add(at(0.06), "split")
    add(at(0.10), "ddl", "ALTER TABLE chaos_t ADD COLUMN note BIGINT DEFAULT 7")
    add(at(0.14), "arm", "cdc/sink-stall", True)
    add(at(0.20), "disarm", "cdc/sink-stall")
    add(at(0.22), "transfer")
    add(at(0.28), "arm", "cdc/segment-crash", 1)  # one flush dies between
    add(at(0.32), "resume_log")  # write and rename; RESUME redelivers the
    add(at(0.36), "ddl",  # window — exactly one durable copy may land
        "ALTER TABLE chaos_d ADD COLUMN tag BIGINT DEFAULT 1")
    add(at(0.40), "down", 1)
    add(at(0.48), "up", 1)
    add(at(0.56), "arm", "cdc/resolved-stuck", True)
    add(at(0.62), "disarm", "cdc/resolved-stuck")
    add(at(0.66), "ddl", "ALTER TABLE chaos_d CHANGE COLUMN tag tag2 BIGINT")
    add(at(0.70), "merge")
    add(at(0.74), "transfer")
    # past at(0.74): clean tail — checkpoint must pass the last commit
    return sched


def run_pitr_storm(seed: int = 19, statements: int = 160,
                   tick_every: int = 6, *, device="cuda", mesh_devices=None) -> dict:
    """The PITR chaos acceptance. One full backup + a log backup attach
    before the storm; a mirror replay feed (CheckingSink ordering oracle)
    rides the same stream so the mid-feed DDLs prove zero parks. Three
    restore points are snapshotted mid-storm; after the drain each is
    restored into a fresh cluster on `device` and compared row-for-row
    (the middle one through a mid-replay crash + resume)."""
    root = tempfile.mkdtemp(prefix="pitr-storm-")
    sess = _fill_session(True, device, mesh_devices)
    mirror = _mirror_session(device)
    tid = sess.catalog.table("chaos_t").table_id
    did = sess.catalog.table("chaos_d").table_id
    sink = CheckingSink(SessionReplaySink(mirror))
    feed = sess.store.cdc.create("pitr-mirror", sink, sess.catalog,
                                 table_ids={tid, did}, start_ts=0)
    sess.execute(f"BACKUP DATABASE * TO '{os.path.join(root, 'full', 'b0')}'")
    sess.execute(f"BACKUP LOG TO 'file://{root}'")
    lb = next(iter(sess.store.log_backups.values()))

    workload = build_pitr_workload(seed, statements)
    schedule = pitr_schedule(statements)
    capture_at = {max(int(statements * f), 1) for f in (0.25, 0.52, 0.80)}
    restore_points: list = []  # [(ts, rows_t, rows_d)]
    ok = typed = ddls = 0
    untyped: list = []
    drift0 = metrics.CDC_SCHEMA_DRIFT_LEGACY.value
    schema0 = metrics.CDC_SCHEMA_EVENTS.value

    def snap(s):
        return (s.execute("SELECT * FROM chaos_t ORDER BY 1").values(),
                s.execute("SELECT * FROM chaos_d ORDER BY 1").values())

    def apply_pitr(actions):
        nonlocal ddls
        for action in actions:
            if action[0] == "ddl":
                sess.execute(action[1])
                ddls += 1
            elif action[0] == "resume_log":
                fp.disable("cdc/segment-crash")
                sess.store.cdc.resume(lb.feed_name)
            else:
                _apply_cdc([action], sess, fp, tid)

    try:
        for i, sql in enumerate(workload):
            apply_pitr(schedule.get(i, ()))
            try:
                sess.execute(sql)
                ok += 1
            except SQLError as exc:
                if getattr(exc, "code", 0) in TYPED_CODES:
                    typed += 1
                else:
                    untyped.append({"stmt": i, "sql": sql, "error": str(exc)[:200]})
            except Exception as exc:  # noqa: BLE001 — the bug class we hunt
                untyped.append({"stmt": i, "sql": sql,
                                "error": f"{type(exc).__name__}: {str(exc)[:200]}"})
            if (i + 1) % tick_every == 0:
                sess.store.pd.tick()
            if i in capture_at:
                # a restore point: the next fresh ts covers exactly the
                # commits so far (single-threaded, so this read IS the
                # snapshot the restored cluster must reproduce)
                ts = sess.store.next_ts()
                rows_t, rows_d = snap(sess)
                restore_points.append((ts, rows_t, rows_d))
    finally:
        for name in FAULT_POINTS:
            fp.disable(name)
        for sid in range(N_STORES):
            sess.store.set_up(sid)
    # drain: the log checkpoint must pass the last commit so every
    # restore point is provably covered; the mirror must converge too
    sess.store.cdc.resume(lb.feed_name)
    last_commit = sess.store.kv.max_committed()
    for _ in range(16):
        sess.store.pd.tick()
        if (lb.sink.checkpoint_ts >= last_commit
                and feed.view(sess.store)["pending"] == 0
                and feed.view(sess.store)["checkpoint_ts"] >= last_commit):
            break
    lb_view = log_backup_views(sess.store)[0]

    # no duplicate events may have survived the kill-mid-flush redelivery
    kv_seen: set = set()
    duplicate_log_events = 0
    for rec in lb.sink.writer.read_records():
        if rec.get("t") != "kv":
            continue
        rk = (rec["k"], rec["ts"])
        if rk in kv_seen:
            duplicate_log_events += 1
        kv_seen.add(rk)

    # the three restores: fresh cluster each, byte-identical to its
    # oracle snapshot; the middle one crashes mid-replay and resumes
    restores: list = []
    resumed_ok = False
    for idx, (ts, rows_t, rows_d) in enumerate(restore_points):
        r = Session(device=device)
        if idx == 1:
            fp.enable("restore/replay-crash", 1)
            crashed = False
            try:
                restore_until(r.store, r.catalog, root, ts)
            except ReplayInterrupted:
                crashed = True
            finally:
                fp.disable("restore/replay-crash")
            rep = restore_until(r.store, r.catalog, root, ts)
            resumed_ok = crashed and bool(rep["resumed"])
        else:
            r.execute(f"RESTORE DATABASE * FROM '{root}' UNTIL TS = {ts}")
        got_t, got_d = snap(r)
        restores.append({
            "until_ts": ts,
            "chaos_t_equal": got_t == rows_t,
            "chaos_d_equal": got_d == rows_d,
            "rows": len(got_t),
        })

    # the gap drill: drop a manifest link — the restore MUST fail typed
    gap_typed = False
    gap_sess = Session(device=device)
    fp.enable("br/log-gap", 1)
    try:
        restore_until(gap_sess.store, gap_sess.catalog, root, restore_points[-1][0])
    except LogGapError as exc:
        gap_typed = exc.covered_ts < exc.target_ts
    except Exception:  # noqa: BLE001 — anything else fails the gate
        gap_typed = False
    finally:
        fp.disable("br/log-gap")

    report = {
        "seed": seed,
        "statements": statements,
        "ok": ok,
        "typed_errors": typed,
        "untyped_errors": untyped,
        "ddls": ddls,
        "schema_events": int(metrics.CDC_SCHEMA_EVENTS.value - schema0),
        "drift_legacy_fallbacks": int(metrics.CDC_SCHEMA_DRIFT_LEGACY.value - drift0),
        "ordering_violations": sink.violations,
        "mirror_feed_state": feed.view(sess.store)["state"],
        "log_backup": lb_view,
        "duplicate_log_events": duplicate_log_events,
        "restores": restores,
        "replay_crash_resumed": resumed_ok,
        "log_gap_typed": gap_typed,
        "mirror_equal": {
            "chaos_t": snap(sess)[0] == snap(mirror)[0],
            "chaos_d": snap(sess)[1] == snap(mirror)[1],
        },
    }
    shutil.rmtree(root, ignore_errors=True)
    return report


def pitr_storm_bad(report: dict):
    """The CHAOS_PITR gate: truthy iff any acceptance invariant broke."""
    return (report["untyped_errors"] or report["ordering_violations"]
            or report["drift_legacy_fallbacks"]
            or report["mirror_feed_state"] != "normal"
            or report["log_backup"]["state"] != "normal"
            or report["duplicate_log_events"]
            or not all(r["chaos_t_equal"] and r["chaos_d_equal"]
                       for r in report["restores"])
            or len(report["restores"]) != 3
            or not report["replay_crash_resumed"]
            or not report["log_gap_typed"]
            or report["ddls"] < 3 or report["schema_events"] < 3
            or not all(report["mirror_equal"].values()))


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    if os.environ.get("CHAOS_PITR"):
        report = run_pitr_storm(seed if len(sys.argv) > 1 else 19, n)
        print(json.dumps(report, indent=2, default=str))
        sys.exit(1 if pitr_storm_bad(report) else 0)
    if os.environ.get("CHAOS_MPP"):
        report = run_mpp_storm(seed if len(sys.argv) > 1 else 17, n)
        print(json.dumps(report, indent=2, default=str))
        sys.exit(1 if mpp_storm_bad(report) else 0)
    if os.environ.get("CHAOS_HTAP"):
        report = run_htap_storm(seed if len(sys.argv) > 1 else 13, n)
        print(json.dumps(report, indent=2, default=str))
        bad = (report["wrong_results"] or report["untyped_errors"]
               or not report["lag_drained"] or not report["feeds_normal"]
               or report["columnar_scans"] == 0)
        sys.exit(1 if bad else 0)
    if os.environ.get("CHAOS_CDC"):
        report = run_cdc_storm(seed if len(sys.argv) > 1 else 11, n)
        print(json.dumps(report, indent=2, default=str))
        bad = (not all(report["mirror_equal"].values())
               or report["ordering_violations"] or report["untyped_errors"]
               or not report["frontier_monotone"]
               or not report["frontier_advanced"]
               or report["feed_state"] != "normal")
        sys.exit(1 if bad else 0)
    report = run_chaos(seed, n)
    print(json.dumps(report, indent=2, default=str))
    bad = report["wrong_results"] or report["untyped_errors"] or not report["breakers_all_closed"]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
