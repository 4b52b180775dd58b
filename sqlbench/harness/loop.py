"""The closed loop: C sessions in threads of this process over one store,
each sending its next statement when the last one has returned all its
rows, until the window closes."""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field

from .check import rows_of
from .traffic import Stream


@dataclass
class Record:
    stmt: object
    session: int
    start: float
    end: float
    rows: list = field(default_factory=list)
    error: str | None = None
    span: object = None  # the statement's span tree in a traced run


def sql_value(v: str) -> str:
    return v if v.lstrip("-").isdigit() else "'" + v.replace("'", "''") + "'"


def sessions(dep, cfg: dict, n: int, device: str) -> list:
    """n sessions over the deployment's store and catalog, each with the
    configuration's session variables."""
    from tidb_tpu_torch.sql import Session

    out = []
    for _ in range(n):
        s = Session(store=dep.store, catalog=dep.catalog, device=device)
        for var, v in cfg["session_variables"].items():
            s.execute(f"SET {var} = {sql_value(v['value'])}")
        out.append(s)
    return out


def execute(sess, store, stmt, idx: int, traced: bool) -> Record:
    """One statement, timed from its issue to its last row; the result
    cache is cleared before the clock starts."""
    from tidb_tpu_torch.util import tracing

    store.clear_result_cache()
    rec = Record(stmt, idx, 0.0, 0.0)
    t0 = time.perf_counter()
    try:
        if traced:
            with tracing.trace("sqlbench.statement", template=stmt.template) as root:
                res = sess.execute(stmt.sql)
            rec.span = root
        else:
            res = sess.execute(stmt.sql)
        rec.end = time.perf_counter()
        rec.rows = rows_of(res)
    except Exception:  # a failed statement is counted, and the session goes on
        rec.end = time.perf_counter()
        rec.error = traceback.format_exc(limit=4)
    rec.start = t0
    return rec


class Window:
    """Runs the sessions' streams for `seconds`; `records` holds every
    statement, those still running at the close included (they finish)."""

    def __init__(self, sess: list, store, mix: dict, seed: int, seconds: float, traced: bool):
        self.sess, self.store, self.mix = sess, store, mix
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.records: list = []
        self.start = self.deadline = 0.0

    def run(self) -> "Window":
        n = len(self.sess)
        streams = [Stream(self.mix, self.seed, i) for i in range(n)]
        per = [[] for _ in range(n)]
        go = threading.Barrier(n + 1)

        def worker(i: int):
            go.wait()
            while time.perf_counter() < self.deadline:
                per[i].append(execute(self.sess[i], self.store, streams[i].next(), i, self.traced))

        threads = [threading.Thread(target=worker, args=(i,), name=f"sqlbench-session-{i}") for i in range(n)]
        for t in threads:
            t.start()
        self.start = time.perf_counter()
        self.deadline = self.start + self.seconds
        go.wait()
        for t in threads:
            t.join()
        self.records = sorted((r for rs in per for r in rs), key=lambda r: r.start)
        return self

    def in_window(self) -> list:
        return [r for r in self.records if r.end <= self.deadline]
