"""`correct`: the port's CPU Session answers every template as the numpy
reference does at a tiny size; and a run whose timed path is broken
underneath (half of each region's rows left out, an answer altered where
it is produced, a stale answer returned) comes out not correct. One chip:
no exchange between chips to leave out."""

import pytest
from sqlbench_testkit import tiny_run, with_kept

from sqlbench.harness import spec

ALL = [w["name"] for w in with_kept(spec.benchmark())["workloads"]]


@pytest.fixture(autouse=True)
def kept_cells(monkeypatch):
    real = spec.benchmark
    monkeypatch.setattr(spec, "benchmark", lambda: with_kept(real()))


def seconds(cell: str) -> float:
    """A window in which a tiny run completes a few statements on the CPU."""
    return 6.0 if cell.endswith(".join") else 2.0


@pytest.mark.parametrize("cell", ALL)
def test_reference_equals_session(cell):
    rc, res, err = tiny_run(cell, trace=0, seconds=seconds(cell))
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"], err[-3000:]
    assert res["checks"]["checked_statements"]["value"] >= len(spec.traffic(
        spec.workload(spec.benchmark(), cell)["traffic"])["templates"])
    assert res["failed"] == 0 and res["metrics"]["stmt_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", ALL)
def test_traced_run_reads_its_layers(cell):
    rc, res, err = tiny_run(cell, trace=1, seconds=seconds(cell))
    assert rc == 0 and res["correct"], err[-3000:]
    listed = {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell, "per_layer")}
    for name in listed & {"p95_ms.host", "session_ms", "dispatch_self_ms", "cop_ms", "launches_per_stmt"}:
        assert res["metrics"][name]["value"] > 0, name
    assert set(res["metrics"]) <= listed
    assert "device_idle_pct" not in res["metrics"]  # no device timeline off the card


def half_rows(monkeypatch):
    from tidb_tpu_torch.store.store import TPUStore

    real = TPUStore.region_chunk

    def region_chunk(self, *a, **k):
        ch = real(self, *a, **k)
        return ch.slice(0, ch.num_rows() // 2)

    monkeypatch.setattr(TPUStore, "region_chunk", region_chunk)


def altered_answer(monkeypatch):
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.types import Datum

    real = Session.execute

    def execute(self, sql, *a, **k):
        res = real(self, sql, *a, **k)
        if res.rows and sql.lstrip().upper().startswith("SELECT"):
            row = res.rows[-1]
            for j, d in enumerate(row):
                if d.kind.name == "Int64":
                    row[j] = Datum.i64(d.val + 1)
                    break
                if d.kind.name == "MysqlDecimal":
                    row[j] = Datum.dec(d.val + type(d.val)("0.01", 2))
                    break
        return res

    monkeypatch.setattr(Session, "execute", execute)


def stale_answer(monkeypatch):
    """Each template's first answer, returned again for every later one."""
    from tidb_tpu_torch.sql import Session

    real = Session.execute
    first = {}

    def execute(self, sql, *a, **k):
        res = real(self, sql, *a, **k)
        if not sql.lstrip().upper().startswith("SELECT"):
            return res
        return first.setdefault(sql.split(" WHERE ")[0], res)

    monkeypatch.setattr(Session, "execute", execute)


@pytest.mark.parametrize("fault", [half_rows, altered_answer, stale_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ALL)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    rc, res, err = tiny_run(cell, trace=0, seconds=seconds(cell))
    assert rc == 0 and res is not None, err[-3000:]
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0
