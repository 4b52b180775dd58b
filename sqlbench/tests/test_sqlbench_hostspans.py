"""The readers of the port's host spans and fetch counter: each gives the
expected number on a hand-built span tree, nothing (None) on a tree or a
store without what it reads, and a CPU `--trace 1` run of the cell
reports all six."""

from dataclasses import dataclass, field

from sqlbench_testkit import tiny_run

from sqlbench.harness import layers, loop, spec

NEW = ("pool_queue_ms", "launch_ms", "wait_ms", "fetch_ms", "offcpu_ms", "fetches_per_stmt")
MS = 1_000_000


@dataclass
class Span:
    """The fields of a tidb_tpu_torch.util.tracing.Span the readers use."""

    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int | None = None
    children: list = field(default_factory=list)


def sp(name, start_ms, end_ms, cpu_ms=None, children=()):
    return Span(name, start_ms * MS, end_ms * MS, None if cpu_ms is None else cpu_ms * MS, list(children))


def statement():
    """Two pool tasks whose queue waits and phases overlap, and a root merge."""
    task1 = sp("distsql.cop_task", 3, 28, 20, [
        sp("cop.decode", 5, 10, 1),
        sp("cop.execute", 10, 27, 15, [sp("exec.program", 10, 10, 0), sp("exec.launch", 10, 20, 4),
                                       sp("exec.wait", 20, 25, 0), sp("exec.fetch", 25, 27, 2)])])
    task2 = sp("distsql.cop_task", 6, 41, 12, [
        sp("cop.execute", 15, 40, 12, [sp("exec.launch", 15, 30, 10), sp("exec.wait", 30, 40, 1)])])
    merge = sp("distsql.root_merge", 42, 50, 5, [sp("exec.launch", 42, 44, 2), sp("exec.wait", 44, 45, 0),
                                                  sp("exec.fetch", 45, 46, 1)])
    root_ = sp("distsql.execute_root", 0, 50, 10, [sp("distsql.cop_queue", 1, 3), sp("distsql.cop_queue", 1, 6),
                                                   task1, task2, merge])
    return sp("sqlbench.statement", 0, 60, 30, [root_])


def context(roots, before=None, after=None):
    records = [loop.Record(None, 0, 0.0, 1.0, span=r) for r in roots]
    before = {"host_fetches": 100} if before is None else before
    after = {"host_fetches": 100 + 27 * len(roots)} if after is None else after
    return layers.Context(window=None, completed=records, before=before, after=after, timeline=None)


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_each_reader_on_a_hand_built_tree():
    ctx = context([statement(), sp("sqlbench.statement", 0, 5, 5)])  # the second has none of the spans
    assert read("pool_queue_ms", ctx) == 5 / 2  # [1, 6]
    assert read("launch_ms", ctx) == (20 + 2) / 2  # [10, 30] and [42, 44]
    assert read("wait_ms", ctx) == (5 + 10 + 1) / 2  # [20, 25], [30, 40], [44, 45]
    assert read("fetch_ms", ctx) == (2 + 1) / 2
    # off a CPU: cop.decode 5 - 1, launches (10 - 4) + (15 - 10) + (2 - 2),
    # fetches (2 - 2) + (1 - 1); the waits and the queue are not summed
    assert read("offcpu_ms", ctx) == (4 + 6 + 5) / 2
    assert read("fetches_per_stmt", ctx) == 27


def test_nothing_to_read_gives_none():
    """A program that predates the spans, its counter or `cpu_ns`."""
    bare = sp("sqlbench.statement", 0, 60, None, [sp("distsql.execute_root", 0, 50, None, [
        sp("distsql.cop_task", 3, 28, None, [sp("cop.decode", 5, 10), sp("cop.execute", 10, 27)])])])
    ctx = context([bare], before={"chunk_decodes": 0}, after={"chunk_decodes": 0})
    for name in NEW:
        assert read(name, ctx) is None, name
    assert read("fetches_per_stmt", context([])) is None


def test_a_traced_cpu_run_reports_all_six():
    rc, res, err = tiny_run("tpch_sf05.agg", trace=1, seconds=2.0)
    assert rc == 0 and res["correct"], err[-3000:]
    for name in NEW:
        assert res["metrics"][name]["value"] > 0, name
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # the phases lie inside the store's and the root merge's spans
    assert m["launch_ms"] + m["wait_ms"] + m["fetch_ms"] <= m["cop_ms"] + m["dispatch_self_ms"]
