"""The port's seeded chaos storms (tidb_tpu_torch/tools/chaos.py) on the CPU.

- Parity with the reference harness (the repo's tools/chaos.py, whose
  module imports no jax; its functions import the JAX package only when
  run): every workload builder and fault schedule gives the reference's
  statements and actions at seeds 7, 11, 13, 17 and 19 and n of 30, 40,
  100 and 200 (exact); the oracle fills answer as the JAX package's over
  statements of every kind the workloads draw (Datums by kind and value,
  torch_sql_parity.same); the `# guarded_by:` annotations of every port
  module equal those of its counterpart in tidb_tpu/, but for the named
  extras of code only the port has (exact).
- The reference's storm tests over the port, on `device="cpu"`, with the
  reference's seeds, statement counts and assertions: tests/test_chaos.py's
  200-statement acceptance and short run, tests/test_cdc.py's mirror
  equality acceptance and its resume-after-stall case, tests/test_columnar.py's
  HTAP storm, tests/test_pitr.py's PITR storm (`pitr_storm_bad`),
  tests/test_topsql.py's storm with the cost-classed gate, and the MPP
  storm held to the CHAOS_MPP gate on an eight-device CPU mesh. A storm's
  interleaving is its backoffs' and threads', so a storm is held to its
  invariants, not to the JAX package's counts.
"""

import importlib.util
import os

import pytest
import torch

from tidb_tpu_torch.analysis import common, guards
from tidb_tpu_torch.tools import chaos

from torch_sql_parity import norm, same

REPO = common.REPO
SEEDS = (7, 11, 13, 17, 19)
SIZES = (30, 40, 100, 200)
BUILDERS = ("build_workload", "build_cdc_workload", "build_mpp_workload", "build_pitr_workload")
SCHEDULES = ("default_schedule", "cdc_schedule", "htap_schedule", "mpp_schedule", "pitr_schedule")


def reference_chaos():
    """The repo's tools/chaos.py, loaded by path under its own name."""
    spec = importlib.util.spec_from_file_location("reference_chaos", os.path.join(REPO, "tools", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = reference_chaos()


# ------------------------------------------------ parity with the reference

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", BUILDERS + SCHEDULES)
def test_workloads_and_schedules_equal_the_reference(name, n):
    """Each builder's statements at every seed, each schedule's actions:
    equal to tools/chaos.py's (exact); so are the shared constants."""
    assert (chaos.TID_ROWS, chaos.N_REGIONS, chaos.N_STORES, chaos.FAULT_POINTS) == \
        (REF.TID_ROWS, REF.N_REGIONS, REF.N_STORES, REF.FAULT_POINTS)
    port, ref = getattr(chaos, name), getattr(REF, name)
    if name in BUILDERS:
        for seed in SEEDS:
            assert port(seed, n) == ref(seed, n), (name, seed, n)
    else:
        assert port(n) == ref(n), (name, n)


def _kinds(workload, prefixes) -> list[str]:
    """The first statements of each kind (two of each) in a workload."""
    out, seen = [], {}
    for sql in workload:
        kind = next(k for k, p in enumerate(prefixes) if sql.startswith(p))
        if seen.get(kind, 0) < 2:
            seen[kind] = seen.get(kind, 0) + 1
            out.append(sql)
    assert len(seen) == len(prefixes), seen
    return out


CHAOS_KINDS = ("SELECT count(*), sum(v) FROM chaos_t WHERE v <", "SELECT id, v FROM chaos_t WHERE id BETWEEN",
               "SELECT g, count(*)", "SELECT t.g, d.name", "SELECT id, v FROM chaos_t ORDER BY",
               "SELECT max(v), min(v)")
MPP_READ_KINDS = ("SELECT oid, count(*), sum(v) FROM mpp_i JOIN", "SELECT ckey", "SELECT oid, count(*) FROM mpp_i WHERE",
                  "SELECT oid, max(v)", "SELECT count(*), sum(v) FROM mpp_i")


@pytest.mark.parametrize("fill", ["chaos", "mpp"])
def test_oracle_fills_answer_as_the_jax_package(fill):
    """The JAX package's `_fill_session(False)` and the port's (device
    "cpu") answer every statement kind of `build_workload` alike, in order;
    `_fill_mpp_session`'s tables (the port's on an eight-device CPU mesh,
    as the JAX package's tests see eight devices) answer every read kind of
    `build_mpp_workload` with the same sorted row sets. Datums compared by
    kind and value, exactly (a DOUBLE within torch_sql_parity.REL)."""
    if fill == "chaos":
        stmts = _kinds(chaos.build_workload(7, 200), CHAOS_KINDS)
        j, p = REF._fill_session(False), chaos._fill_session(False, "cpu")
        for sql in stmts:
            assert same(norm(j.execute(sql).rows), norm(p.execute(sql).rows)), sql
    else:
        reads = [s for s in chaos.build_mpp_workload(17, 200) if s.startswith("SELECT")]
        stmts = _kinds(reads, MPP_READ_KINDS)
        (j, _), (p, _) = REF._fill_mpp_session(), chaos._fill_mpp_session("cpu", ["cpu"] * 8)
        for sql in stmts:
            jr = sorted(map(repr, norm(j.execute(sql).rows)))
            pr = sorted(map(repr, norm(p.execute(sql).rows)))
            assert jr == pr, sql


# the annotations only the port has, each on code the JAX package lacks:
# TPUStore's stats() counters (the port's batch and mesh keys), the hand
# kernels' per-stream scratch table and K2's scratch
PORT_ONLY_GUARDS = {
    "store/store.py": {"classes": {"TPUStore": {"_stats": "_stats_lock"}}},
    "kernels.py": {"classes": {"StreamScratch": {"bufs": "_lock"}}},
    "ops/joinscan.py": {"globals_": {"_k2_scratch": "_k2_lock"}},
}


def test_guard_annotations_equal_the_reference():
    """`guards.collect` over every port module equals its result over the
    module of the same path in tidb_tpu/ (none where there is no such
    module), but for PORT_ONLY_GUARDS. Exact."""
    from tidb_tpu_torch.analysis.guards import ModuleGuards

    checked = 0
    for path in common.py_files("tidb_tpu_torch"):
        sf = common.SourceFile.load(path)
        rel = os.path.relpath(path, os.path.join(REPO, "tidb_tpu_torch")).replace(os.sep, "/")
        got = guards.collect(sf.tree, sf.lines)
        ref_path = os.path.join(REPO, "tidb_tpu", rel)
        want = ModuleGuards()
        if os.path.exists(ref_path):
            rsf = common.SourceFile.load(ref_path)
            want = guards.collect(rsf.tree, rsf.lines)
        for field, extra in PORT_ONLY_GUARDS.get(rel, {}).items():
            table = getattr(want, field)
            for k, v in extra.items():
                if isinstance(v, dict):
                    table[k] = {**table.get(k, {}), **v}
                else:
                    table[k] = v
        assert (got.classes, got.globals_, got.requires) == (want.classes, want.globals_, want.requires), rel
        checked += got.any()
    assert checked >= 10  # the annotated modules were read, not skipped


@pytest.mark.parametrize("storm", ["run_chaos", "run_cdc_storm", "run_htap_storm", "run_mpp_storm", "run_pitr_storm"])
def test_storms_default_to_cuda_and_raise_without_it(storm, monkeypatch):
    """Every storm builds its sessions on the card unless asked for the
    CPU, and without CUDA it raises rather than running on the CPU.
    Exact (the error's type and message)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(chaos, storm)(statements=30)


# ------------------------------------------- the reference's storm tests

def test_chaos_200_statements_zero_wrong_results():
    """The seeded storm schedule — leader kills, apply-lag, transfer
    timeouts — over a 200-statement mixed workload running with
    `tidb_replica_read='follower'`: zero wrong answers, every error typed,
    breakers all re-closed, the storm provably fired (failovers + trips >
    0), every failover was a LEADER TRANSFER (placement moves only on
    quorum loss, and this storm never loses quorum), and follower peers
    served cop tasks without ever violating the safe_ts gate (a violation
    would show up as a wrong result). Invariants only."""
    report = chaos.run_chaos(seed=7, statements=200, device="cpu")
    assert report["wrong_results"] == []
    assert report["untyped_errors"] == []
    assert report["breakers_all_closed"], report["breakers"]
    assert report["failovers"] >= 1  # the outage really dispatched
    assert report["breaker_trips"] >= 1
    assert report["transfer_leaders"] >= 1  # failover = leader transfer
    assert report["failover_moves"] == 0  # quorum never lost -> no moves
    assert report["replica_reads"]["follower"] > 0
    assert report["ok"] + report["typed_errors"] == 200


def test_chaos_short_run_smoke():
    """A second-seed storm pass at 1/5 scale: same invariants, different
    fault/workload interleaving. Invariants only."""
    report = chaos.run_chaos(seed=11, statements=40, device="cpu")
    assert report["wrong_results"] == []
    assert report["untyped_errors"] == []
    assert report["breakers_all_closed"], report["breakers"]
    assert report["failovers"] >= 1
    assert report["failover_moves"] == 0  # transfers, never moves
    assert report["replica_reads"]["follower"] > 0
    assert report["ok"] + report["typed_errors"] == 40


def test_cdc_chaos_mirror_equality_acceptance():
    """A seeded storm (split, merge, leader transfers, a store outage,
    replica/apply-lag, and all three cdc/* failpoints) runs with a live
    changefeed replaying into a second cluster. At the end the mirror's
    full scans equal the source, the resolved frontier advanced
    monotonically (and past the stuck window), and per-key event order
    matched commit order with no duplicates. Invariants only (the
    mirror's scans exactly)."""
    report = chaos.run_cdc_storm(seed=11, statements=100, device="cpu")
    assert report["untyped_errors"] == [], report["untyped_errors"]
    assert report["ordering_violations"] == [], report["ordering_violations"]
    assert all(report["mirror_equal"].values()), report
    assert report["frontier_monotone"], report["frontier_samples"]
    assert report["frontier_advanced"], report["frontier_samples"]
    assert report["feed_state"] == "normal"
    assert report["events_emitted"] > 0
    assert report["recovery_scans"] > 0  # puller-drop really recovered


def test_resume_after_stall_redelivers_exactly_once_in_order(tmp_path):
    """RESUME after a stall + a kill-mid-flush: the re-queued batch
    redelivers EXACTLY once — per-key commit order intact (CheckingSink
    oracle on the mirror feed), exactly one durable copy of every event in
    the log-backup manifest, and the crashed segment's tmp leftover
    invisible to readers. Exact."""
    from tidb_tpu_torch.br import start_log_backup
    from tidb_tpu_torch.cdc import SessionReplaySink
    from tidb_tpu_torch.sql.session import Session
    from tidb_tpu_torch.util import failpoint

    ddl = "CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))"
    src = Session(device="cpu")
    src.execute(ddl)
    mirror = Session(device="cpu")
    mirror.execute(ddl)
    chk = chaos.CheckingSink(SessionReplaySink(mirror))
    meta = src.catalog.table("t")
    feed = src.store.cdc.create("f", chk, src.catalog, table_ids={meta.table_id, *meta.physical_ids()},
                                start_ts=0)
    lb = start_log_backup(src.store, src.catalog, str(tmp_path / "bk"))
    src.execute("INSERT INTO t VALUES (1, 10, 'a')")
    src.store.cdc.tick()
    failpoint.enable("cdc/sink-stall", True)
    try:
        src.execute("INSERT INTO t VALUES (2, 20, 'b')")
        src.execute("UPDATE t SET v = 21 WHERE id = 2")
        src.store.cdc.tick()  # emission skipped: the sorter holds the backlog
        assert chk.events == 1
    finally:
        failpoint.disable("cdc/sink-stall")
    # the log feed's next flush dies between write and rename
    failpoint.enable("cdc/segment-crash", 1)
    try:
        src.store.cdc.tick()
    finally:
        failpoint.disable("cdc/segment-crash")
    logfeed = src.store.cdc.get(lb.feed_name)
    assert logfeed.view(src.store)["state"] == "error"
    assert "segment-crash" in logfeed.view(src.store)["error"]
    assert feed.view(src.store)["state"] == "normal"  # mirror feed unhurt
    leftovers = [f for f in os.listdir(lb.sink.directory) if f.endswith(".tmp")]
    assert leftovers  # the kill left a torn tmp behind...
    src.store.cdc.resume(lb.feed_name)
    src.store.cdc.tick()  # ...and RESUME redelivers the dropped window
    assert logfeed.view(src.store)["state"] == "normal"
    # exactly-once: one durable copy of each version, per-key ts order
    seen: set = set()
    last_by_key: dict = {}
    kv = [r for r in lb.sink.writer.read_records() if r.get("t") == "kv"]
    for rec in kv:
        rk = (rec["k"], rec["ts"])
        assert rk not in seen, f"duplicate event {rk} in the manifest"
        seen.add(rk)
        assert rec["ts"] > last_by_key.get(rec["k"], 0)
        last_by_key[rec["k"]] = rec["ts"]
    assert len(kv) == 3  # insert 1, insert 2, update 2 — nothing lost
    assert chk.violations == [] and chk.events == 3
    assert (mirror.execute("SELECT * FROM t ORDER BY id").values()
            == src.execute("SELECT * FROM t ORDER BY id").values())


def test_htap_chaos_storm_acceptance():
    """A live changefeed feeds the columnar replica under splits, merges,
    leader transfers, a store outage and the columnar/* + cdc/*
    failpoints; every engine-routed analytical query is byte-identical to
    the row-store oracle at the same snapshot, the replica's resolved-ts
    lag drains to 0 after the storm, and zero untyped errors escape.
    Invariants only (each routed answer exactly)."""
    report = chaos.run_htap_storm(seed=13, statements=100, device="cpu")
    assert report["wrong_results"] == [], report["wrong_results"]
    assert report["untyped_errors"] == [], report["untyped_errors"]
    assert report["columnar_scans"] > 0, report
    assert report["lag_drained"], report["tables"]
    assert report["feeds_normal"], report["tables"]
    assert report["delta_drained"], report["tables"]
    assert report["applied_events"] > 0


def test_pitr_chaos_storm_acceptance():
    """A log backup + a mirror replay feed ride a seeded DML+DDL storm
    under splits, transfers, an outage and the cdc/* failpoints; three
    mid-storm restore points come back byte-identical to the live oracle,
    the mid-feed ALTERs park nothing, a kill mid-flush costs nothing, a
    mid-replay crash resumes idempotently, and a manifest gap fails typed.
    Invariants only (each restore exactly)."""
    report = chaos.run_pitr_storm(seed=19, statements=100, device="cpu")
    assert report["untyped_errors"] == [], report["untyped_errors"]
    assert report["ordering_violations"] == [], report["ordering_violations"]
    assert all(r["chaos_t_equal"] and r["chaos_d_equal"]
               for r in report["restores"]), report["restores"]
    assert report["replay_crash_resumed"] and report["log_gap_typed"], report
    assert not chaos.pitr_storm_bad(report), report


def test_chaos_oracle_clean_with_cost_classed_gate():
    """The answer-correctness storm stays clean with Top SQL attribution on
    and the admission gate in measured-cost mode — classes learned live
    under faults, every shed typed 9003 (in the storm's retryable set),
    zero wrong results, zero untyped errors. Invariants only."""
    from tidb_tpu_torch import topsql

    topsql.COLLECTOR.reset()
    report = chaos.run_chaos(seed=13, statements=40, admission_flicker=0.1,
                             cost_classed=True, device="cpu")
    assert report["wrong_results"] == []
    assert report["untyped_errors"] == []
    assert report["breakers_all_closed"], report["breakers"]
    # the flicker-forced sheds surfaced typed, and the storm's statements
    # actually flowed through the collector (classes were live, not idle)
    assert report["errors_by_code"].get(9003, 0) >= 1
    assert topsql.COLLECTOR.totals["exec_count"] > 0


def test_mpp_storm_short():
    """The MPP storm at 40 statements over an eight-device CPU mesh, held
    to the CHAOS_MPP gate: no wrong or untyped answer (routed and
    row-store-forced sorted row sets equal), and the storm both served
    from the MPP tier and fell out of it. Invariants only."""
    report = chaos.run_mpp_storm(seed=17, statements=40, device="cpu", mesh_devices=["cpu"] * 8)
    assert report["wrong_results"] == [], report["wrong_results"]
    assert report["untyped_errors"] == [], report["untyped_errors"]
    assert report["mpp_selects"] > 0, report
    assert report["mpp_fallbacks"] > 0, report
    assert not chaos.mpp_storm_bad(report)
