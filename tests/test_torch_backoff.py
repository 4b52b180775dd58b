"""The port's Backoffer, runaway checker and circuit breakers against the
JAX package's.

Every case of tests/test_backoff.py runs through both packages' copies of
util/backoff.py with the same seeded random.Random and the same fake clock
(sleep advances now), and the two must sleep the same sequence of slices,
return the same slept milliseconds and leave the same attempt counts;
tests/test_runaway.py's fake-clock deadline case runs through both
distsql/runaway.py copies; and a CircuitBreaker walks closed -> open ->
half-open -> open -> half-open -> closed on a fake clock in both, with the
same answers and the same breaker gauge / trip counts in each package's
own metrics registry. Tolerance: exact (the float sleeps compared equal).
"""

import random

import pytest

from tidb_tpu.distsql import dispatch as j_dispatch
from tidb_tpu.distsql import runaway as j_runaway
from tidb_tpu.util import backoff as j_backoff
from tidb_tpu.util import metrics as j_metrics
from tidb_tpu.util import tracing as j_tracing

from tidb_tpu_torch.distsql import dispatch as t_dispatch
from tidb_tpu_torch.distsql import runaway as t_runaway
from tidb_tpu_torch.util import backoff as t_backoff
from tidb_tpu_torch.util import metrics as t_metrics
from tidb_tpu_torch.util import tracing as t_tracing

PKGS = {
    "jax": (j_backoff, j_runaway, j_metrics, j_tracing, j_dispatch),
    "torch": (t_backoff, t_runaway, t_metrics, t_tracing, t_dispatch),
}


class FakeClock:
    """Deterministic time: sleep() advances now()."""

    def __init__(self):
        self.t = 0.0
        self.sleeps: list[float] = []

    def now(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.t += s


def make(pkg, budget_ms=10_000, weight=1, checker=None, seed=1):
    B = PKGS[pkg][0]
    clk = FakeClock()
    b = B.Backoffer(budget_ms=budget_ms, weight=weight, checker=checker,
                    rng=random.Random(seed), sleep_fn=clk.sleep, now_fn=clk.now)
    return b, clk


def both(case):
    """Run `case(pkg)` in both packages; its results must be equal."""
    got = {pkg: case(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["jax"]


def test_the_schedules_are_the_jax_ones():
    assert {k: (c.base_ms, c.cap_ms) for k, c in t_backoff.CONFIGS.items()} == \
        {k: (c.base_ms, c.cap_ms) for k, c in j_backoff.CONFIGS.items()}
    assert t_backoff.DEFAULT_BUDGET_MS == j_backoff.DEFAULT_BUDGET_MS
    assert t_backoff._SLICE_MS == j_backoff._SLICE_MS


def test_exponential_growth_capped_with_equal_jitter():
    def case(pkg):
        b, clk = make(pkg)
        cfg = PKGS[pkg][0].CONFIGS["region_miss"]
        slept = []
        for attempt in range(12):
            ms = b.backoff("region_miss")
            raw = min(cfg.base_ms * 2 ** attempt, cfg.cap_ms)
            assert raw / 2 <= ms <= raw + 1e-9  # equal jitter: uniform[raw/2, raw]
            slept.append(ms)
        assert b.attempts["region_miss"] == 12
        return slept, clk.sleeps, b.total_ms

    both(case)


def test_budget_scales_with_backoff_weight_and_exhausts_per_task():
    def case(pkg):
        B = PKGS[pkg][0]
        b, clk = make(pkg, budget_ms=20, weight=2)  # 40ms effective
        total = 0.0
        with pytest.raises(B.BackoffExhausted) as ei:
            for _ in range(50):
                total += b.backoff("server_busy")
        assert ei.value.kind == "server_busy"
        assert total <= 40.0
        b0, _ = make(pkg, budget_ms=200, weight=0)  # no budget at all
        with pytest.raises(B.BackoffExhausted) as e0:
            b0.backoff("region_miss")
        return total, clk.sleeps, str(ei.value), str(e0.value)

    both(case)


def test_per_kind_budgets_are_independent_but_share_the_total():
    def case(pkg):
        b, clk = make(pkg)
        b.backoff("region_miss")
        b.backoff("server_busy")
        assert b.attempts == {"region_miss": 1, "server_busy": 1}
        assert b.total_ms > 0
        return b.attempts, b.total_ms, clk.sleeps

    both(case)


def test_server_suggested_backoff_is_a_floor():
    def case(pkg):
        b, clk = make(pkg, seed=3)
        slept = b.backoff("server_busy", suggested_ms=77)
        assert slept >= 77
        return slept, clk.sleeps

    both(case)


def test_sleep_never_passes_the_checker_deadline():
    def case(pkg):
        B, R = PKGS[pkg][:2]
        clk = FakeClock()
        checker = R.RunawayChecker(max_execution_ms=50, now_fn=clk.now)
        b = B.Backoffer(budget_ms=10_000, weight=1, checker=checker,
                        rng=random.Random(1), sleep_fn=clk.sleep, now_fn=clk.now)
        slept = b.sleep(500, "store_unavailable")
        assert slept <= 50.0 + 1e-9  # clamped to the deadline, not the ask
        assert clk.t <= 0.0501
        return slept, clk.sleeps

    both(case)


def test_kill_query_interrupts_mid_backoff():
    def case(pkg):
        B, R = PKGS[pkg][:2]
        clk = FakeClock()
        checker = R.RunawayChecker(max_execution_ms=0, now_fn=clk.now)
        kills_after = [3]

        def killing_sleep(s):
            clk.sleep(s)
            kills_after[0] -= 1
            if kills_after[0] == 0:
                checker.kill()

        b = B.Backoffer(budget_ms=10_000, weight=1, checker=checker,
                        rng=random.Random(1), sleep_fn=killing_sleep, now_fn=clk.now)
        with pytest.raises(R.QueryKilledError) as ei:
            b.sleep(500, "server_busy")
        assert not ei.value.timeout
        # died mid-sleep: only the slices before the kill actually ran
        assert sum(clk.sleeps) < 500 / 1000.0
        assert len(clk.sleeps) == 3
        return clk.sleeps, str(ei.value)

    both(case)


def test_backoff_metric_and_span_attribution():
    def case(pkg):
        _B, _R, M, TR, _D = PKGS[pkg]
        before = M.BACKOFF_SECONDS.labels("not_leader").value
        b, clk = make(pkg)
        with TR.trace("t") as root:
            with TR.span("distsql.cop_task") as sp:
                slept = b.backoff("not_leader")
            assert sp.attrs["backoff_ms"] == pytest.approx(slept, abs=0.02)
        assert root is not None and root.find("distsql.cop_task") == [sp]
        after = M.BACKOFF_SECONDS.labels("not_leader").value
        assert after - before == pytest.approx(slept / 1000.0, abs=1e-6)
        return slept, sp.attrs["backoff_ms"], clk.sleeps

    both(case)


def test_unknown_kind_gets_a_default_schedule():
    def case(pkg):
        b, clk = make(pkg)
        slept = b.backoff("mystery_kind")
        assert slept > 0  # no KeyError
        return slept, clk.sleeps

    both(case)


def test_checker_deadline_fake_clock():
    def case(pkg):
        R = PKGS[pkg][1]
        now = [0.0]
        c = R.RunawayChecker(50, now_fn=lambda: now[0])
        c.before_cop_request()  # within budget
        assert c.deadline == pytest.approx(0.05)
        now[0] = 0.051
        with pytest.raises(R.QueryKilledError, match="maximum statement execution time") as ei:
            c.before_cop_request()
        assert ei.value.timeout
        return str(ei.value)

    both(case)


def test_circuit_breaker_walk_on_a_fake_clock():
    """closed -> (threshold failures) open -> rejects inside its probe
    window -> half-open probe admitted once a window -> a failed probe
    re-opens -> the next probe's success closes. The board's views
    follow, and each package's own gauge and trip counter record it."""

    def case(pkg):
        _B, _R, M, _TR, D = PKGS[pkg]
        sid = 7
        now = [100.0]
        board = D.BreakerBoard(threshold=3, probe_after=0.05, now_fn=lambda: now[0])
        trips0 = M.BREAKER_TRIPS.labels(str(sid)).value
        walk = []

        def step(what, value):
            walk.append((what, value, board.states()[sid], M.BREAKER_STATE.labels(str(sid)).value))

        step("allow", board.allow_request(sid))
        step("fail 1 opened", board.record_failure(sid))
        step("fail 2 opened", board.record_failure(sid))
        step("fail 3 opened", board.record_failure(sid))
        assert board.open_stores() == {sid} and board.unroutable_stores() == {sid}
        now[0] += 0.01
        step("allow inside the window", board.allow_request(sid))
        step("probe ready", board.get(sid).probe_ready())
        now[0] += 0.05
        step("probe ready after the window", board.get(sid).probe_ready())
        step("allow the probe", board.allow_request(sid))
        step("allow a second probe", board.allow_request(sid))
        step("the probe fails", board.record_failure(sid))
        now[0] += 0.06
        step("allow the next probe", board.allow_request(sid))
        board.record_success(sid)
        step("closed", board.all_closed())
        step("allow", board.allow_request(sid))
        assert board.unroutable_stores() == set()
        return walk, M.BREAKER_TRIPS.labels(str(sid)).value - trips0

    walk, trips = both(case)
    assert [w[2] for w in walk] == ["closed", "closed", "closed", "open", "open", "open", "open", "half-open",
                                    "half-open", "open", "half-open", "closed", "closed"]
    assert [w[1] for w in walk] == [True, False, False, True, False, False, True, True, False, True, True, True,
                                    True]
    assert trips == 2
