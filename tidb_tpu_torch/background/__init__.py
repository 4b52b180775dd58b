"""Background frameworks (ref: pkg/timer, pkg/ttl, pkg/disttask,
pkg/statistics/handle auto-analyze) — the domain's always-on workers,
collapsed to thread-based runtimes over the embedded engine:

  Timer        periodic callbacks with jittered ticks (pkg/timer runtime);
               also drives the placement driver's scheduling tick
               (pd/core.py PlacementDriver.timer) and GC below
  TTLWorker    scans TTL-attached tables and deletes expired rows in
               bounded batches (pkg/ttl/ttlworker scan+delete workers)
  DistTask     task -> subtask split, N executor workers pulling from a
               queue with states/retry (pkg/disttask/framework scheduler +
               taskexecutor; subtask states proto/subtask.go:102)
  AutoAnalyzer ANALYZE tables whose modify ratio exceeds the threshold
               (statistics/handle auto-analyze loop)
  GCWorker     MVCC garbage collection on a timer

Copy of `tidb_tpu/background/` for the PyTorch port, over the port's
Session and TPUStore (it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class Timer:
    """(ref: pkg/timer/runtime). Fires `fn` every `interval` seconds on a
    daemon thread until stop(); errors are caught and counted, never fatal
    (a background tick must not kill the process)."""

    def __init__(self, name: str, interval: float, fn):
        self.name = name
        self.interval = interval
        self.fn = fn
        self.fire_count = 0
        self.error_count = 0
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, name=f"timer-{self.name}", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.fn()
                self.fire_count += 1
            except Exception as exc:  # noqa: BLE001 — ticks survive errors
                self.error_count += 1
                self.last_error = str(exc)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def fire_once(self):
        """Synchronous tick (tests and manual triggers)."""
        self.fn()
        self.fire_count += 1


# ---------------------------------------------------------------- TTL

@dataclass
class TTLRule:
    table: str
    column: str  # DATETIME column
    expire_after_days: float


class TTLWorker:
    """(ref: pkg/ttl/ttlworker — scan tasks find expired rows, delete
    workers remove them in bounded batches). `now_fn` is injectable so
    tests control the clock."""

    def __init__(self, session, batch: int = 256, now_fn=None):
        self.session = session
        self.rules: list[TTLRule] = []
        self.batch = batch
        self.now_fn = now_fn or (lambda: time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()))
        self.deleted_total = 0

    def attach(self, table: str, column: str, expire_after_days: float):
        self.session.catalog.table(table).col(column)  # validates
        self.rules.append(TTLRule(table, column, expire_after_days))

    def run_once(self) -> int:
        """One TTL pass over every rule; returns rows deleted."""
        import datetime as dt

        deleted = 0
        now = dt.datetime.strptime(self.now_fn(), "%Y-%m-%d %H:%M:%S")
        for rule in self.rules:
            cutoff = now - dt.timedelta(days=rule.expire_after_days)
            cutoff_s = cutoff.strftime("%Y-%m-%d %H:%M:%S")
            while True:
                res = self.session.execute(
                    f"DELETE FROM {rule.table} WHERE {rule.column} < '{cutoff_s}' LIMIT {self.batch}"
                )
                deleted += res.affected
                if res.affected < self.batch:
                    break
        self.deleted_total += deleted
        return deleted

    def timer(self, interval: float) -> Timer:
        return Timer("ttl", interval, self.run_once)


# ---------------------------------------------------------------- disttask

@dataclass
class Subtask:
    """(ref: disttask/framework/proto/subtask.go:102 states)."""

    subtask_id: int
    payload: object
    state: str = "pending"  # pending -> running -> (succeed | failed)
    result: object = None
    error: str = ""
    attempts: int = 0


@dataclass
class Task:
    """(ref: disttask/framework/proto/task.go:147)."""

    task_id: int
    task_type: str
    state: str = "pending"  # pending -> running -> (succeed | reverted)
    subtasks: list = field(default_factory=list)


class DistTaskScheduler:
    """Split a task into subtasks, run them on N workers, collect results
    (ref: disttask framework scheduler + per-node taskexecutor; a failed
    subtask retries up to `max_retries`, then reverts the whole task —
    framework/scheduler/balancer.go's rebalance collapses to the shared
    queue: an idle worker simply pulls the next subtask)."""

    def __init__(self, n_workers: int = 4, max_retries: int = 2):
        self.n_workers = n_workers
        self.max_retries = max_retries
        self._next_id = 1
        self.history: list[Task] = []

    def run(self, task_type: str, payloads: list, execute_fn) -> Task:
        """execute_fn(payload) -> result; raises to fail the subtask."""
        task = Task(self._next_id, task_type)
        self._next_id += 1
        task.subtasks = [Subtask(i + 1, p) for i, p in enumerate(payloads)]
        self.history.append(task)
        task.state = "running"
        queue = list(task.subtasks)
        qlock = threading.Lock()
        failed = threading.Event()

        def worker():
            while not failed.is_set():
                with qlock:
                    if not queue:
                        return
                    st = queue.pop(0)
                st.state = "running"
                while True:
                    st.attempts += 1
                    try:
                        st.result = execute_fn(st.payload)
                        st.state = "succeed"
                        break
                    except Exception as exc:  # noqa: BLE001
                        st.error = str(exc)
                        if st.attempts > self.max_retries:
                            st.state = "failed"
                            failed.set()
                            return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        task.state = "reverted" if failed.is_set() else "succeed"
        return task


# ---------------------------------------------------------------- auto-analyze

class AutoAnalyzer:
    """(ref: statistics/handle autoAnalyze loop): tables whose modified-row
    ratio since the last ANALYZE exceeds `ratio` (default matches
    tidb_auto_analyze_ratio 0.5) get re-analyzed."""

    def __init__(self, session, ratio: float = 0.5):
        self.session = session
        self.ratio = ratio
        self.analyzed: list[str] = []

    def run_once(self) -> list:
        ran = []
        cat = self.session.catalog
        for name in cat.tables():
            meta = cat.table(name)
            st = cat.stats.get(meta.table_id)
            if st is None:
                if meta.row_count > 0:
                    self.session.execute(f"ANALYZE TABLE {name}")
                    ran.append(name)
                continue
            base = max(st.row_count, 1)
            drift = abs(meta.row_count - st.row_count) / base
            if drift > self.ratio:
                self.session.execute(f"ANALYZE TABLE {name}")
                ran.append(name)
        self.analyzed.extend(ran)
        return ran

    def timer(self, interval: float) -> Timer:
        return Timer("auto-analyze", interval, self.run_once)


class GCWorker:
    """Safepoint-driven MVCC garbage collection on a timer (ref:
    pkg/store/gcworker/gc_worker.go — leader-elected there, a plain
    periodic worker in one process). Each tick garbage-collects versions
    older than the current TSO, clamped below active transactions by
    TPUStore.run_gc."""

    def __init__(self, store, interval: float = 30.0):
        self.store = store
        self.removed_total = 0
        self.runs = 0

        def tick():
            self.removed_total += self.store.run_gc()
            self.runs += 1

        self.timer = Timer("gc", interval, tick)

    def start(self):
        self.timer.start()
        return self

    def stop(self):
        self.timer.stop()
