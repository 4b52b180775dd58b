"""The coprocessor's phase spans in the PyTorch port: each program run
opens `exec.launch`, `exec.wait` and `exec.fetch` under the span that is
current (`cop.execute`, `cop.batch_execute`, `distsql.root_merge`); each
pool or batch task opens `distsql.cop_queue` from its submit on the
session thread to its start on a worker; spans that open and close on one
thread carry their thread CPU (`cpu_ns`); the `drive_*_info` functions
count their device-to-host reads into `TPUStore.stats()["host_fetches"]`
whether or not a trace is open. On `device="cpu"`."""

import json

import pytest

from tidb_tpu_torch.chunk import Chunk, to_device_batch
from tidb_tpu_torch.codec import tablecodec
from tidb_tpu_torch.exec import Aggregation, ColumnInfo, DAGRequest, TableScan
from tidb_tpu_torch.exec.builder import ProgramCache
from tidb_tpu_torch.exec.executor import drive_program_info
from tidb_tpu_torch.expr import AggDesc, col
from tidb_tpu_torch.sql.session import Session
from tidb_tpu_torch.types import Datum, new_longlong
from tidb_tpu_torch.util import tracing

PHASES = ["exec.launch", "exec.wait", "exec.fetch"]
GROUP_BY = "SELECT v, count(*) FROM t GROUP BY v"
FT = new_longlong()


@pytest.fixture()
def sess():
    """60 rows in 3 regions, scan concurrency 4: the pool tier."""
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i % 5})" for i in range(1, 61)))
    tid = s.catalog.table("t").table_id
    for h in (20, 40):
        s.store.cluster.split(tablecodec.encode_row_key(tid, h))
    s.execute("SET tidb_distsql_scan_concurrency = 4")
    return s


def json_tree(sess, sql: str = GROUP_BY) -> dict:
    sess.store.clear_result_cache()
    return json.loads(sess.execute(f"TRACE FORMAT='json' {sql}").values()[0][0])


def span_tree(sess, sql: str = GROUP_BY) -> tracing.Span:
    """The statement's spans as objects (exact start and end times)."""
    sess.store.clear_result_cache()
    with tracing.trace("test.statement") as root:
        sess.execute(sql)
    return root


def nodes(node: dict) -> list:
    out = [node]
    for c in node.get("children", []):
        out.extend(nodes(c))
    return out


def find(node: dict, name: str) -> list:
    return [n for n in nodes(node) if n["name"] == name]


def phase_triples(children: list) -> list:
    """The phase spans among a parent's children, in order, cut in threes."""
    ph = [c for c in children if (c["name"] if isinstance(c, dict) else c.name) in PHASES]
    assert len(ph) % 3 == 0 and ph
    return [ph[i:i + 3] for i in range(0, len(ph), 3)]


def test_every_cop_execute_has_the_three_phases_in_order(sess):
    tree = json_tree(sess)
    execs = find(tree, "cop.execute")
    assert len(execs) == 3  # one a region
    for x in execs:
        for triple in phase_triples(x["children"]):
            assert [c["name"] for c in triple] == PHASES
            assert sum(c["duration_ns"] for c in triple) <= x["duration_ns"]
    (merge,) = find(tree, "distsql.root_merge")
    assert [c["name"] for c in merge["children"] if c["name"] in PHASES] == PHASES


def test_phases_lie_inside_their_parent_without_overlap(sess):
    root = span_tree(sess)
    execs = root.find("cop.execute")
    assert len(execs) == 3
    for x in execs + root.find("distsql.root_merge"):
        for launch, wait, fetch in phase_triples(x.children):
            assert x.start_ns <= launch.start_ns <= launch.end_ns <= wait.start_ns <= wait.end_ns \
                <= fetch.start_ns <= fetch.end_ns <= x.end_ns


def test_an_overflow_retry_gets_its_own_triple():
    """300 distinct keys at a group capacity of 8: the first run's group
    flag fires, and the retry on a larger rung runs with its own phases."""
    ch = Chunk.from_rows([FT], [[Datum.i64(i)] for i in range(300)])
    batch = to_device_batch(ch, capacity=512, device="cpu")
    dag = DAGRequest((TableScan(9, (ColumnInfo(1, FT),)),
                      Aggregation(group_by=(col(0, FT),), aggs=(AggDesc("count", ()),), partial=True)),
                     output_offsets=(0, 1))
    with tracing.trace("test.retry") as root:
        chunk, _counts, info = drive_program_info(ProgramCache(), dag, batch, group_capacity=8)
    assert chunk.num_rows() == 300
    assert [c.name for c in root.children] == ["exec.program"] + PHASES + ["exec.program"] + PHASES
    # the first run: three flags, then the two need hints; the second: the
    # flags, ex_rows, valid and two leaves of each of the two outputs
    assert info["fetches"] == 5 + 3 + 1 + 1 + 2 * 2


def test_the_queue_wait_ends_before_its_task_starts(sess):
    root = span_tree(sess)
    (er,) = root.find("distsql.execute_root")
    queues = {q.attrs["region_id"]: q for q in er.children if q.name == "distsql.cop_queue"}
    tasks = {t.attrs["region_id"]: t for t in er.children if t.name == "distsql.cop_task"}
    assert sorted(queues) == sorted(tasks) == [1, 2, 3]
    for rid, q in queues.items():
        assert er.start_ns <= q.start_ns <= q.end_ns <= tasks[rid].start_ns
        assert q.cpu_ns is None


def test_the_batch_tier_queues_each_store_batch(sess):
    sess.execute("SET tidb_allow_batch_cop = ON")
    tree = json_tree(sess, "SELECT sum(v) FROM t WHERE v > 1")
    (er,) = find(tree, "distsql.execute_root")
    names = [c["name"] for c in er["children"]]
    assert names.count("distsql.cop_queue") == names.count("distsql.batch_cop") >= 1
    for bx in find(tree, "cop.batch_execute"):
        assert [[c["name"] for c in t] for t in phase_triples(bx["children"])] == [PHASES]


def test_cpu_ns_on_single_thread_spans_only(sess):
    tree = json_tree(sess)
    queues = find(tree, "distsql.cop_queue")
    assert len(queues) == 3 and all("cpu_ns" not in q for q in queues)
    rest = [n for n in nodes(tree) if n["name"] != "distsql.cop_queue"]
    assert {n["name"] for n in rest} >= {"session", "cop.decode", "distsql.cop_task", *PHASES}
    for n in rest:
        assert 0 <= n["cpu_ns"] <= n["duration_ns"], n["name"]


def test_the_roots_carry_cpu_ns():
    with tracing.trace("root") as root:
        sum(i * i for i in range(20000))
    assert 0 < root.cpu_ns <= root.duration_ns


def test_no_span_is_built_with_tracing_off(sess, monkeypatch):
    built = []
    real = tracing.Span.__init__

    def counting(self, *a, **k):
        built.append(a[0] if a else None)
        real(self, *a, **k)

    sess.execute(GROUP_BY)  # programs built and cached
    monkeypatch.setattr(tracing.Span, "__init__", counting)
    sess.store.clear_result_cache()
    sess.execute(GROUP_BY)
    assert built == []


@pytest.mark.parametrize("concurrency", [1, 4], ids=["single", "pool"])
def test_host_fetches_repeat_exactly(sess, concurrency):
    sess.execute(f"SET tidb_distsql_scan_concurrency = {concurrency}")
    sess.execute(GROUP_BY)  # programs built and cached

    def one(traced: bool) -> int:
        before = sess.store.stats()["host_fetches"]
        if traced:
            json_tree(sess)
        else:
            sess.store.clear_result_cache()
            sess.execute(GROUP_BY)
        return sess.store.stats()["host_fetches"] - before

    got = [one(False), one(False), one(True)]
    # per region: three flags, ex_rows, valid, two leaves of each output
    assert got == [3 * (3 + 1 + 1 + 2 * 2)] * 3
