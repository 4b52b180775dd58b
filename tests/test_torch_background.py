"""The port's background frameworks (tidb_tpu_torch/background/: Timer,
TTLWorker, DistTaskScheduler, AutoAnalyzer) against the JAX package's, on
the CPU: the timer, TTL, dist-task and auto-analyze cases of
tests/test_background_batchcop.py, each run on both packages (the TTL and
auto-analyze cases over a session of each) with what they return held
equal. Tolerance: exact.
"""

import time

import pytest

from torch_sql_parity import run_both


def test_timer_fires_and_survives_errors():
    """A timer's tick count is the clock's, so what is compared is that it
    fired at least three times and counted the one error."""
    def case(P):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("boom")

        t = P.background.Timer("t", 0.01, fn).start()
        time.sleep(0.15)
        t.stop()
        assert len(calls) >= 3 and t.error_count >= 1 and t.fire_count >= 1
        return t.name, t.error_count, t.last_error, t.fire_count == len(calls) - 1

    run_both(case)


def test_ttl_worker_deletes_expired():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE ev (id INT PRIMARY KEY, created DATETIME)")
        s.execute("INSERT INTO ev VALUES (1,'2024-01-01 00:00:00'),(2,'2024-06-01 00:00:00'),(3,'2024-12-01 00:00:00')")
        w = P.background.TTLWorker(s, now_fn=lambda: "2024-12-02 00:00:00")
        w.attach("ev", "created", expire_after_days=30.0)
        deleted = w.run_once()
        left = s.execute("SELECT id FROM ev").values()
        again = w.run_once()
        assert deleted == 2 and left == [[3]] and again == 0
        return deleted, left, again, w.deleted_total

    run_both(case)


def test_ttl_rejects_unknown_column():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE ev (id INT PRIMARY KEY)")
        with pytest.raises(Exception) as ei:
            P.background.TTLWorker(s).attach("ev", "nope", 1.0)
        return type(ei.value).__name__, str(ei.value)

    run_both(case)


def test_disttask_scheduler():
    def case(P):
        sched = P.background.DistTaskScheduler(n_workers=4)
        task = sched.run("square", list(range(20)), lambda p: p * p)
        results = sorted(st.result for st in task.subtasks)
        assert task.state == "succeed" and results == sorted(i * i for i in range(20))
        return task.state, results, sorted((st.subtask_id, st.state, st.attempts) for st in task.subtasks)

    run_both(case)


def test_disttask_retry_then_revert():
    def case(P):
        sched = P.background.DistTaskScheduler(n_workers=2, max_retries=1)

        def flaky(p):
            if p == 13:
                raise RuntimeError("always fails")
            return p

        task = sched.run("flaky", [1, 13, 2], flaky)
        failed = [st for st in task.subtasks if st.state == "failed"]
        assert task.state == "reverted" and failed and failed[0].payload == 13 and failed[0].attempts == 2
        return task.state, [(st.payload, st.attempts, st.error) for st in failed]

    run_both(case)


def test_auto_analyze_triggers_on_drift():
    def case(P):
        s = P.new_session()
        s.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
        s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i})" for i in range(1, 11)))
        a = P.background.AutoAnalyzer(s)
        runs = [a.run_once(), a.run_once()]
        s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i})" for i in range(11, 31)))
        runs.append(a.run_once())
        assert runs == [["t"], [], ["t"]]
        return runs, a.analyzed

    run_both(case)
