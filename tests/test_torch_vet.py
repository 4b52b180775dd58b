"""The port's vet suite (tidb_tpu_torch/analysis and
`python -m tidb_tpu_torch.tools.vet`): every pass flags its true-positive
fixture in tests/torch_vet_fixtures/, each static pass the two packages
share gives the JAX package's findings on the JAX package's own fixtures,
every dataflow root of the port's catalogs resolves in tidb_tpu_torch/, the
live tree is clean, suppression markers and KNOWN entries work (and rot is
flagged), the CLI contract holds, and the program auditor's live catalog
runs clean on the CPU while each of its six checks fires on its fixture."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tidb_tpu_torch import analysis
from tidb_tpu_torch.analysis import dataflow, progaudit, suppress_audit
from tidb_tpu_torch.analysis.common import Finding, SourceFile, filter_suppressed, load_files, py_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_vet_fixtures")
JAX_FIXTURES = os.path.join(REPO, "tests", "vet_fixtures")


def _fixture(name: str) -> SourceFile:
    return SourceFile.load(os.path.join(FIXTURES, name), repo=REPO)


def _messages(findings):
    return [f.render() for f in findings]


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    """Every run in this file caches under its own tmp_path, never in the
    checkout's .vet_cache_torch.json."""
    monkeypatch.setenv("TIDB_TPU_TORCH_VET_CACHE", str(tmp_path / "vet_cache.json"))


# ------------------------------------------------- fixtures: true positives

class TestFixtureCorpus:
    def test_torch_purity_flags_fixture(self):
        found = analysis.run_pass("torch-purity", [_fixture("torch_purity_bad.py")])
        msgs = " | ".join(_messages(found))
        assert len(found) == 4, msgs
        assert "BAD_CONST" in msgs and "BAD_DERIVED" in msgs
        assert "torch.set_default_dtype()" in msgs
        assert "torch.backends.cuda.matmul.allow_tf32" in msgs

    def test_torch_purity_leaves_functions_and_constants_alone(self, tmp_path):
        p = tmp_path / "ok.py"
        p.write_text("import numpy as np\nimport torch\n\n"
                     "I64_MAX = (1 << 63) - 1\nTABLE = np.arange(4)\nDEV = torch.device('cpu')\n"
                     "_T = torch.Tensor\n\n"
                     "def build(dev):\n    return torch.zeros(4, device=dev)\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        assert analysis.run_pass("torch-purity", [sf]) == []

    def test_lock_discipline_flags_fixture(self):
        found = analysis.run_pass("lock-discipline", [_fixture("lock_bad.py")])
        msgs = _messages(found)
        assert len(found) == 2, msgs
        assert any("written outside" in m for m in msgs)
        assert any("read outside" in m for m in msgs)

    def test_metrics_flags_fixture(self):
        found = analysis.run_pass("metrics", [_fixture("metrics_bad.py")])
        msgs = " | ".join(_messages(found))
        for expect in ("registered more than once", "must end `_total`", "invalid metric name",
                       "must not claim the counter suffix", "takes 1 label value(s)", "is a labeled family",
                       "has no .labels()", "not a registered instrument"):
            assert expect in msgs, f"missing {expect!r} in {msgs}"

    def test_wire_parity_flags_fixture(self):
        found = analysis.run_pass("wire-parity", [_fixture("bad_wire.py")])
        msgs = " | ".join(_messages(found))
        assert "encode_orphan has no matching decode_orphan" in msgs
        assert "field-kind mismatch" in msgs and "'f64'" in msgs
        # the fragment frames' sender sub-structure is held to its mirror
        assert "encode_fragment_plan/decode_fragment_plan sub-structure mismatch" in msgs
        assert "exchange_sender" in msgs

    def test_failpoints_flags_fixture(self):
        found = analysis.run_pass("failpoints", [_fixture("failpoint_bad.py")])
        assert len(found) == 1, _messages(found)
        assert "vetfix/undefined-name" in found[0].message
        assert "under tidb_tpu_torch/" in found[0].message

    def test_failpoints_live_run_skips_the_fixture_corpora(self):
        from tidb_tpu_torch.analysis import failpoints

        _findings, sites = failpoints.analyze()
        assert "vetfix/undefined-name" not in sites
        assert not any("vet_fixtures" in w for ws in sites.values() for w in ws)
        # every site is the port's own
        assert sites and all(w.startswith("tidb_tpu_torch/") for ws in sites.values() for w in ws)
        # the port's arming files: its tests, tools and chip_smoke.py, never
        # the JAX package's tests
        files = [os.path.relpath(p, REPO) for p in failpoints._use_files()]
        assert "chip_smoke.py" in files and "tests/torch_sql_parity.py" in files
        assert all(f.startswith(("tests/test_torch_", "tests/torch_sql_parity", "tidb_tpu_torch/tools/",
                                 "chip_smoke.py")) for f in files), files

    def test_every_port_site_has_a_description(self):
        from tidb_tpu_torch.analysis import failpoints

        _findings, sites = failpoints.analyze()
        assert set(sites) <= set(failpoints.DESCRIPTIONS), set(sites) - set(failpoints.DESCRIPTIONS)

    def test_dataflow_snapshot_flags_fixture(self):
        found = analysis.run_pass("dataflow-snapshot", [_fixture("dataflow_snapshot_bad.py")])
        msgs = _messages(found)
        assert len(found) == 4, msgs
        assert any("max_ts" in m and "NEWEST version" in m for m in msgs)
        assert any("latest-version ts (12345)" in m for m in msgs)
        assert any("does not flow" in m for m in msgs)
        assert not any(f.line in (30, 35, 38) for f in found)

    def test_dataflow_backoff_flags_fixture(self):
        found = analysis.run_pass("dataflow-backoff", [_fixture("dataflow_backoff_bad.py")])
        msgs = _messages(found)
        assert len(found) == 2, msgs
        assert any("never consults a Backoffer budget" in m for m in msgs)
        assert any("raw time.sleep" in m for m in msgs)

    def test_dataflow_escape_flags_fixture(self):
        found = analysis.run_pass("dataflow-error-escape", [_fixture("dataflow_escape_bad.py")])
        msgs = _messages(found)
        assert len(found) == 2, msgs
        assert any("bare `raise RuntimeError` escapes" in m for m in msgs)
        assert any("RegionTimeoutError" in m and "session boundary" in m for m in msgs)

    def test_dataflow_closure_findings_not_duplicated(self, tmp_path):
        p = tmp_path / "m.py"
        p.write_text("import time\n\n"
                     "def select(store, req):  # vet: request-path-root\n"
                     "    def worker():\n"
                     "        time.sleep(0.05)\n"
                     "    run(worker)\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        found = analysis.run_pass("dataflow-backoff", [sf])
        assert len(found) == 1 and found[0].line == 5, _messages(found)

    def test_escape_lexical_floor_covers_the_port_control_plane(self, tmp_path):
        """A bare raise in the port's dispatch/store/PD layers is a finding
        even outside the request cone."""
        (tmp_path / "tidb_tpu_torch" / "pd").mkdir(parents=True)
        root = tmp_path / "root.py"
        root.write_text("def select(store, req):  # vet: request-path-root\n"
                        "    return None\n")
        sched = tmp_path / "tidb_tpu_torch" / "pd" / "sched.py"
        sched.write_text("def tick():\n    raise RuntimeError('boom')\n")
        files = [SourceFile.load(str(root), repo=str(tmp_path)),
                 SourceFile.load(str(sched), repo=str(tmp_path))]
        found = analysis.run_pass("dataflow-error-escape", files)
        assert len(found) == 1, _messages(found)
        assert "dispatch/store/PD layer" in found[0].message

    def test_escape_family_is_the_port_not_a_prefix_of_it(self, tmp_path):
        """`tidb_tpu` is a prefix of `tidb_tpu_torch`: the lexical floor and
        the family must match the port's directories, never the JAX
        package's."""
        (tmp_path / "tidb_tpu" / "pd").mkdir(parents=True)
        root = tmp_path / "root.py"
        root.write_text("def select(store, req):  # vet: request-path-root\n    return None\n")
        sched = tmp_path / "tidb_tpu" / "pd" / "sched.py"
        sched.write_text("def tick():\n    raise RuntimeError('boom')\n")
        files = [SourceFile.load(str(root), repo=str(tmp_path)),
                 SourceFile.load(str(sched), repo=str(tmp_path))]
        assert analysis.run_pass("dataflow-error-escape", files) == []

    def test_prog_audit_fixture_flags_every_check(self):
        found = analysis.run_pass("prog-audit", [_fixture("progaudit_bad.py")])
        checks = {progaudit._FINDING.match(f.message).group("check") for f in found}
        assert checks == set(progaudit.CHECKS), _messages(found)


# ------------------------------------- parity with the JAX package's passes

def _jax_analysis():
    from tidb_tpu import analysis as jax_analysis

    return jax_analysis


def _jax_fixture(name: str):
    from tidb_tpu.analysis.common import SourceFile as JaxSourceFile

    return JaxSourceFile.load(os.path.join(JAX_FIXTURES, name), repo=REPO)


def _norm(findings) -> list:
    """(line, pass, message) with the package named one way."""
    return sorted((f.line, f.passname, f.message.replace("tidb_tpu_torch", "tidb_tpu")) for f in findings)


@pytest.mark.parametrize("passname,fixture", [
    ("lock-discipline", "lock_bad.py"),
    ("metrics", "metrics_bad.py"),
    ("wire-parity", "bad_wire.py"),
    ("failpoints", "failpoint_bad.py"),
    ("dataflow-snapshot", "dataflow_snapshot_bad.py"),
    ("dataflow-backoff", "dataflow_backoff_bad.py"),
    ("dataflow-error-escape", "dataflow_escape_bad.py"),
])
def test_static_pass_matches_the_jax_package(passname, fixture):
    want = _jax_analysis().run_pass(passname, [_jax_fixture(fixture)])
    got = analysis.run_pass(passname, [SourceFile.load(os.path.join(JAX_FIXTURES, fixture), repo=REPO)])
    assert want, f"the JAX package's {passname} found nothing in {fixture}"
    assert _norm(got) == _norm(want)


def test_suppressions_audit_matches_the_jax_package(tmp_path):
    from tidb_tpu.analysis import suppress_audit as jax_audit
    from tidb_tpu.analysis.common import SourceFile as JaxSourceFile

    p = tmp_path / "s.py"
    p.write_text("x = 1  # vet: ignore[metrics]\ny = 2  # vet: ignore[no-such-pass]\n")
    kw = dict(used_markers=set(), ran_passes={"metrics"}, known_passes={"metrics"})
    want = jax_audit.audit([JaxSourceFile.load(str(p), repo=str(tmp_path))], **kw)
    got = suppress_audit.audit([SourceFile.load(str(p), repo=str(tmp_path))], **kw)
    # the unknown-pass hint names each package's own CLI
    strip = [(f.line, f.message.split(" (see ")[0]) for f in want]
    assert [(f.line, f.message.split(" (see ")[0]) for f in got] == strip
    assert len(got) == 2


# ------------------------------------------------- live tree + suppression

class TestLiveTree:
    def test_every_pass_clean_on_the_tree(self):
        findings = analysis.run_all(device="cpu")
        assert findings == [], "\n".join(_messages(findings))

    def test_suppression_marker_drops_finding(self, tmp_path):
        p = tmp_path / "sup.py"
        p.write_text(
            "import threading\n\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._mu = threading.Lock()\n"
            "        self.v = 0  # guarded_by: _mu\n\n"
            "    def racy(self):\n"
            "        return self.v  # vet: ignore[lock-discipline]\n\n"
            "    def racy2(self):\n"
            "        return self.v\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        found = analysis.run_pass("lock-discipline", [sf])
        assert len(found) == 1 and found[0].line == 12

    def test_stale_suppression_flagged(self, tmp_path):
        p = tmp_path / "s.py"
        p.write_text("x = 1  # vet: ignore[torch-purity]\n"
                     "y = 2  # vet: ignore[no-such-pass]\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        out = suppress_audit.audit([sf], used_markers=set(), ran_passes={"torch-purity"},
                                   known_passes={"torch-purity"})
        msgs = [f.message for f in out]
        assert len(out) == 2, msgs
        assert any("stale suppression" in m for m in msgs)
        assert any("unknown pass 'no-such-pass'" in m and "tidb_tpu_torch.tools.vet" in m for m in msgs)

    def test_live_suppression_not_flagged(self, tmp_path):
        from tidb_tpu_torch.analysis import lock_discipline

        p = tmp_path / "s.py"
        p.write_text(
            "import threading\n\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._mu = threading.Lock()\n"
            "        self.v = 0  # guarded_by: _mu\n\n"
            "    def racy(self):\n"
            "        return self.v  # vet: ignore[lock-discipline]\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        used: set = set()
        kept = filter_suppressed(lock_discipline.run([sf]), {sf.rel: sf}, used)
        assert kept == [] and used
        assert suppress_audit.audit([sf], used_markers=used, ran_passes={"lock-discipline"},
                                    known_passes={"lock-discipline"}) == []

    def test_pass_not_run_gives_no_verdict(self, tmp_path):
        p = tmp_path / "s.py"
        p.write_text("x = 1  # vet: ignore[torch-purity]\n")
        sf = SourceFile.load(str(p), repo=str(tmp_path))
        assert suppress_audit.audit([sf], used_markers=set(), ran_passes=set(),
                                    known_passes={"torch-purity"}) == []

    def test_the_port_markers_all_earn_their_keep(self):
        """The port's `# vet: ignore[...]` markers each suppress a live
        finding (none is stale: the full run above would flag it)."""
        tree = load_files(py_files("tidb_tpu_torch"))
        markers = [(sf.rel, ln, names) for sf in tree for ln, names in sf.ignore_markers()
                   if not sf.rel.startswith("tidb_tpu_torch/analysis/")]
        assert markers
        assert all(set(names) <= set(analysis.ALL_PASS_NAMES) for _r, _l, names in markers)

    def test_guard_collection_reads_the_port_conventions(self):
        from tidb_tpu_torch.analysis import guards

        sf = SourceFile.load(os.path.join(REPO, "tidb_tpu_torch", "store", "store.py"))
        g = guards.collect(sf.tree, sf.lines)
        assert g.classes["TPUStore"]["_cop_cache"] == "_cop_lock"
        sf = SourceFile.load(os.path.join(REPO, "tidb_tpu_torch", "store", "kv.py"))
        g = guards.collect(sf.tree, sf.lines)
        assert g.classes["MemKV"]["_data"] == "lock"
        assert ("MemKV", "_ensure_sorted") in g.requires


# ------------------------------------------------- CLI contract

def _fixture_paths():
    return sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES) if f.endswith(".py"))


class TestVetCLI:
    def _run(self, *args, env=None):
        return subprocess.run(
            [sys.executable, "-m", "tidb_tpu_torch.tools.vet", *args],
            capture_output=True, text=True, timeout=600, cwd=REPO, env=env or dict(os.environ))

    def test_clean_tree_exits_zero_and_json_parses(self):
        r = self._run("--json", "--device", "cpu")
        assert r.returncode == 0, r.stdout + r.stderr
        assert json.loads(r.stdout) == []

    def test_fixture_corpus_exits_nonzero_with_every_port_pass(self):
        r = self._run("--json", "--files", *_fixture_paths())
        assert r.returncode == 1, r.stdout + r.stderr
        findings = json.loads(r.stdout)
        assert {f["pass"] for f in findings} >= {
            "torch-purity", "lock-discipline", "metrics", "wire-parity", "failpoints",
            "dataflow-snapshot", "dataflow-backoff", "dataflow-error-escape", "prog-audit"}
        assert all({"path", "line", "pass", "message"} <= set(f) for f in findings)

    def test_only_accepts_globs(self):
        r = self._run("--only", "dataflow-*")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "dataflow-snapshot" in r.stdout and "dataflow-error-escape" in r.stdout

    def test_only_suppressions_runs_the_full_suite(self):
        r = self._run("--only", "suppressions", "--device", "cpu")
        assert r.returncode == 0, r.stdout + r.stderr
        with pytest.raises(ValueError, match="run_all"):
            analysis.run_pass("suppressions")

    def test_unknown_pass_is_exit_2(self):
        r = self._run("--only", "no-such-pass")
        assert r.returncode == 2 and "unknown pass" in r.stderr

    def test_list_names_every_pass(self):
        r = self._run("--list")
        assert r.returncode == 0
        for name in analysis.ALL_PASS_NAMES:
            assert name in r.stdout

    def test_prog_audit_without_cuda_raises(self):
        """--device defaults to cuda: on a host without a card the auditor
        raises rather than quietly running on the CPU."""
        if torch.cuda.is_available():
            r = self._run("--only", "prog-audit", "--device", "cpu")
            assert r.returncode == 0, r.stdout + r.stderr
            return
        r = self._run("--only", "prog-audit")
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr and "DeviceUnavailableError" in r.stderr

    def test_diff_is_a_multiset(self):
        from tidb_tpu_torch.tools import vet

        a = {"path": "p.py", "line": 3, "pass": "x", "message": "m"}
        a2 = {"path": "p.py", "line": 9, "pass": "x", "message": "m"}
        new, fixed = vet._diff_sets([a], [a, a2])
        assert new == [a2] and fixed == []
        new, fixed = vet._diff_sets([a, a2], [a])
        assert new == [] and len(fixed) == 1

    def test_value_flags_are_not_input_files(self):
        from tidb_tpu_torch.tools import vet

        argv = ["--files", "a.py", "--baseline", "out.json", "b.py", "--device", "cpu"]
        assert vet._input_files(argv) == ["a.py", "b.py"]

    def test_diff_missing_baseline_is_exit_2(self, tmp_path):
        r = self._run("--files", os.path.join(FIXTURES, "lock_bad.py"), "--diff", str(tmp_path / "nope.json"))
        assert r.returncode == 2, r.stdout + r.stderr
        assert "unusable baseline" in r.stderr

    def test_baseline_diff_roundtrip(self, tmp_path):
        fixtures = _fixture_paths()
        base = tmp_path / "base.json"
        r = self._run("--files", *fixtures, "--baseline", str(base))
        assert r.returncode == 0, r.stdout + r.stderr
        recorded = json.loads(base.read_text())
        assert recorded and recorded == sorted(recorded, key=lambda d: (d["path"], d["line"], d["pass"]))
        r = self._run("--files", *fixtures, "--diff", str(base))
        assert r.returncode == 0, r.stdout + r.stderr
        assert json.loads(r.stdout) == {"new": [], "fixed": []}
        empty = tmp_path / "empty.json"
        empty.write_text("[]")
        r = self._run("--files", *fixtures, "--diff", str(empty))
        assert r.returncode == 1
        d = json.loads(r.stdout)
        assert d["fixed"] == [] and len(d["new"]) == len(recorded)


# ------------------------------------------- dataflow engine: unit seeds

class TestDataflowEngine:
    @pytest.fixture(scope="class")
    def graph(self):
        return dataflow.graph_for(load_files(py_files("tidb_tpu_torch")))

    def test_call_graph_resolves_dispatch_into_the_store(self, graph):
        fi = graph.funcs["tidb_tpu_torch/distsql/dispatch.py::_run_one_task"]
        callees = {c.qname for c, _ in fi.callees}
        assert "tidb_tpu_torch/store/store.py::TPUStore.coprocessor" in callees

    def test_request_path_cone_is_nontrivial(self, graph):
        reach = graph.reachable(graph.request_roots())
        assert "tidb_tpu_torch/store/store.py::TPUStore.region_chunk" in reach
        assert "tidb_tpu_torch/store/kv.py::MemKV.scan" in reach
        assert "tidb_tpu_torch/pd/core.py::PlacementDriver._split_key" not in reach

    def test_start_ts_fact_reaches_the_kv_seam(self, graph):
        dataflow.TaintAnalysis(graph)
        fi = graph.funcs["tidb_tpu_torch/store/store.py::TPUStore._scan_region_kvs"]
        assert dataflow.TS in fi.facts.get("start_ts", set())

    def test_escape_tracks_typed_errors_to_the_boundary(self, graph):
        dataflow.EscapeAnalysis(graph)
        b = graph.boundaries()[0]
        names = {t[1] for t in b.escapes if isinstance(t, tuple)}
        assert "RegionUnavailableError" in names or "CopInternalError" in names
        # the typed device and kernel errors replaced bare RuntimeErrors
        assert "RuntimeError" not in {t for t in b.escapes if isinstance(t, str)}

    @pytest.mark.parametrize("catalog", sorted(dataflow.ROOT_CATALOGS))
    def test_every_root_resolves_in_the_port(self, graph, catalog):
        for suffix, cls, name in dataflow.ROOT_CATALOGS[catalog]:
            hits = [fi for fi in graph.funcs.values()
                    if fi.rel.endswith(suffix) and fi.name == name and fi.cls == cls]
            assert len(hits) == 1, (catalog, suffix, cls, name)
            assert hits[0].rel.startswith("tidb_tpu_torch/")
        assert dataflow.unresolved_roots(graph, "x", {catalog: dataflow.ROOT_CATALOGS[catalog]}) == []

    def test_an_unresolved_root_is_a_finding(self, tmp_path):
        """A live tree whose seams moved must not pass with an empty cone."""
        pkg = tmp_path / "tidb_tpu_torch"
        (pkg / "distsql").mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "distsql" / "dispatch.py").write_text("def select_renamed(store, req):\n    return None\n")
        files = [SourceFile.load(str(p), repo=str(tmp_path)) for p in (pkg / "__init__.py", pkg / "distsql" / "dispatch.py")]
        found = dataflow.run_snapshot(files)
        msgs = _messages(found)
        assert len(found) == len(dataflow.REQUEST_ROOTS), msgs
        assert any("REQUEST_ROOTS root distsql/dispatch.py::select resolves to no function" in m for m in msgs)
        assert all(f.path.endswith("analysis/dataflow.py") and f.line > 1 for f in found)
        assert len(dataflow.run_escape(files)) >= sum(len(v) for v in dataflow.ROOT_CATALOGS.values())


# --------------------------------------------------- prog-audit

class TestProgAudit:
    @pytest.fixture(scope="class")
    def report(self):
        return progaudit.audit_live(device="cpu")

    def test_catalog_covers_every_builder_path(self):
        names = {n for n, _dag, _nb, _caps in progaudit.live_catalog()}
        assert names == {"selection", "hashagg", "streamagg", "topn", "hashjoin", "radix_join",
                         "partial_scalar_agg", "partial_hashagg", "columnar_scan"}

    def test_mesh_variants_audited(self, report):
        from tidb_tpu_torch.distsql.planner import mesh_merge_kind

        kinds = {n: mesh_merge_kind(dag) for n, dag, _nb, _caps in progaudit.live_catalog()}
        assert kinds["partial_scalar_agg"] == "scalar"
        assert kinds["partial_hashagg"] == "group"
        assert kinds["topn"] == "topn"
        assert kinds["radix_join"] == "group"
        assert kinds["hashagg"] is None
        names = {p.name for p in report.programs}
        assert {"partial_scalar_agg/mesh-scalar", "partial_hashagg/mesh-group", "topn/mesh-topn",
                "radix_join/mesh-group", "exchange_join/mesh"} <= names

    def test_live_catalog_is_clean(self, report):
        assert report.raw == [], "\n".join(f.message for f in report.raw)
        assert report.findings == [] and report.stale == []
        # single, vmap and mesh variants of the nine shapes, three kernel
        # programs and the dense route's, the exchange join
        assert len(report.programs) == 9 * 2 + 4 + 4 * 2 + 1
        assert all(p.ops > 0 for p in report.programs)

    def test_kernel_programs_dispatch_the_custom_ops_as_themselves(self, report):
        by = {p.name: p.kernels for p in report.programs}
        assert by["q1_small_g/single"] == {"tidb_tpu_torch::dense_agg": 1}
        assert by["q3_chain/single"] == {"tidb_tpu_torch::postsort_segscan": 1,
                                         "tidb_tpu_torch::membership_segscan": 1}
        assert by["radix_join_kernel/single"] == {"tidb_tpu_torch::probe_tables": 1}
        # on the CPU the vmap rule runs the plain version lane by lane
        assert by["q1_small_g/vmap"] == {"tidb_tpu_torch::dense_agg": 3}

    def test_the_k4_entry_passes_the_kernel_gate(self):
        from tidb_tpu_torch.exec.builder import build_program

        entry = [e for e in progaudit.kernel_entries("cpu") if e.name == "radix_join_kernel"][0]
        cd = build_program(entry.dag, tuple(b.capacity for b in entry.batches),
                           group_capacity=entry.group_capacity)
        cd.fn(*entry.batches)
        assert cd.radix_info["strategy"] == "kernel"

    @pytest.mark.parametrize("check", progaudit.CHECKS)
    def test_each_check_flags_its_fixture(self, check):
        found = progaudit.run([_fixture("progaudit_bad.py")])
        mine = [f for f in found if progaudit._FINDING.match(f.message).group("prog").split("/")[0] == check]
        assert mine, _messages(found)
        assert {progaudit._FINDING.match(f.message).group("check") for f in mine} == {check}, _messages(mine)

    def test_region_axis_checker_fires_on_drift(self):
        single = [torch.zeros(8, dtype=torch.int64)]
        good = [torch.zeros(progaudit._VMAP_BATCH, 8, dtype=torch.int64)]
        assert progaudit.check_region_axis("x", single, good, ("f", 1)) == []
        assert progaudit.check_region_axis("x", single, [torch.zeros(8, dtype=torch.int64)], ("f", 1))
        assert progaudit.check_region_axis("x", single, [torch.zeros(3, 8, dtype=torch.int32)], ("f", 1))

    def test_closure_tensors_found(self):
        big = torch.zeros(2048, dtype=torch.int64)
        small = torch.zeros(4)

        def make():
            def fn(x):
                return x + big[0] + small[0]
            return fn

        found = progaudit.closure_tensors(make())
        assert [n for _p, n in found] == [2048 * 8]

    def test_known_entries_excuse_and_rot(self, monkeypatch):
        f = Finding("tidb_tpu_torch/exec/builder.py", 1, progaudit.PASS,
                    "program 'q3_chain/single': host-sync `cuda-sync` — why")
        monkeypatch.setattr(progaudit, "KNOWN", (
            ("q3_*", "host-sync", "cuda-sync", "cuda", "a reason"),
            ("hashagg/*", "f64-leak", "aten::div.Tensor", "*", "another"),
        ))
        used: set = set()
        assert progaudit.apply_known([f], "cuda:0", used) == [] and used == {0}
        # a CUDA-only entry excuses nothing on the CPU, and is not stale there
        assert progaudit.apply_known([f], "cpu") == [f]
        stale = progaudit.stale_known(used, "cuda:0")
        assert len(stale) == 1 and "aten::div.Tensor" in stale[0].message
        assert stale[0].passname == "suppressions" and stale[0].path.endswith("progaudit.py")
        assert len(progaudit.stale_known(set(), "cpu")) == 1

    def test_audit_live_raises_without_cuda(self, monkeypatch):
        from tidb_tpu_torch.runtime import DeviceUnavailableError

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailableError, match="CUDA is not available"):
            progaudit.audit_live(device="cuda")
        with pytest.raises(DeviceUnavailableError):
            analysis.run_only(["prog-audit"])

    def test_vmap_fallbacks_reads_torchs_warning(self):
        def hist(x):
            return torch.histc(x.to(torch.float32), bins=4, min=0, max=8)

        out, ops = progaudit.vmap_fallbacks(lambda: torch.func.vmap(hist)(torch.arange(16).reshape(2, 8)))
        assert ops == ["aten::histc"] and out.shape == (2, 4)


# ------------------------------- the port faults the auditor found, pinned

class TestRepairedFaults:
    def test_stream_aggregation_batches_over_regions(self):
        """streamagg/vmap failed: an in-place update of an unbatched mask
        by batched keys. Each lane of the batched run equals its single
        run."""
        from tidb_tpu_torch.ops.aggregate import group_aggregate

        keys = torch.tensor([[1, 1, 2, 3, 3, 3], [5, 6, 6, 6, 7, 7], [0, 0, 0, 0, 0, 0]])
        vals = torch.arange(18, dtype=torch.int64).reshape(3, 6)
        valid = torch.ones(6, dtype=torch.bool)

        def one(k, v):
            from tidb_tpu_torch.expr.agg import AggDesc
            from tidb_tpu_torch.expr.compile import CompVal
            from tidb_tpu_torch.expr.ir import col
            from tidb_tpu_torch.types import new_longlong

            I = new_longlong()
            g = CompVal(k, torch.zeros_like(k, dtype=torch.bool), I)
            a = CompVal(v, torch.zeros_like(v, dtype=torch.bool), I)
            res = group_aggregate([g], [(AggDesc("sum", (col(1, I),)), [a])], valid, 8, stream=True)
            return res.group_rep, res.n_groups, res.states[0][0][0]

        batched = torch.func.vmap(one)(keys, vals)
        for b in range(3):
            for got, want in zip(batched, one(keys[b], vals[b])):
                assert torch.equal(got[b], want)

    def test_exchange_bucket_count_is_fixed_size(self):
        """exchange_join/mesh read a bincount's data-sized output; the
        bucket counts are now a fixed-size index_add_."""
        from tidb_tpu_torch.mpp.exchange_op import scatter_to_buckets

        part = torch.tensor([2, 0, 1, 2, 2, 0], dtype=torch.int32)
        valid = torch.tensor([True, True, True, True, False, True])
        col = torch.arange(6, dtype=torch.int64)
        (out,), ovalid, ovf = scatter_to_buckets([col], valid, part, 3, 4)
        _o, recs = progaudit.record(lambda: scatter_to_buckets([col], valid, part, 3, 4), [])
        assert not [r.name for r in recs if progaudit._is_sync(r)]
        assert out.tolist() == [[1, 5, 0, 0], [2, 0, 0, 0], [0, 3, 0, 0]]
        assert ovalid.sum().item() == 5 and not ovf.item()

    def test_string_literals_are_made_on_the_device(self):
        """q3_chain/single synchronised on the card: its string literal was
        a blocking host-to-device copy. It is now built from fills; no
        host tensor is made inside the program."""
        from tidb_tpu_torch.expr.compile import device_bytes

        for b in (b"", b"B", b"BUILDING", b"\xff\x00abc\x80 nine bytes+"):
            assert device_bytes(b, "cpu").tolist() == list(b)
        entry = [e for e in progaudit.kernel_entries("cpu") if e.name == "q3_chain"][0]
        fn, args = progaudit._make(entry, False)()
        _out, recs = progaudit.record(fn, args)
        assert not [r.name for r in recs if r.base in ("aten::lift_fresh", "aten::lift_fresh_copy")]

    def test_typed_device_and_kernel_errors(self):
        from tidb_tpu_torch.kernels import KernelError
        from tidb_tpu_torch.runtime import DeviceUnavailableError

        assert issubclass(DeviceUnavailableError, RuntimeError) and DeviceUnavailableError is not RuntimeError
        assert issubclass(KernelError, RuntimeError) and KernelError is not RuntimeError


# ----------------------------------------------------- result cache

class TestVetCache:
    def test_roundtrip_and_invalidation(self, tmp_path, monkeypatch):
        from tidb_tpu_torch.analysis.vetcache import VetCache

        monkeypatch.setenv("TIDB_TPU_TORCH_VET_CACHE", str(tmp_path / "c.json"))
        src = tmp_path / "m.py"
        src.write_text("x = 1\n")
        sf = SourceFile.load(str(src), repo=str(tmp_path))
        c = VetCache()
        key = VetCache.file_key("p", "sha1", sf)
        c.put(key, [Finding("m.py", 1, "p", "msg")])
        c.save()
        hit = VetCache().get(key)
        assert hit and hit[0].render() == "m.py:1: [p] msg"
        src.write_text("x = 2\n")
        sf2 = SourceFile.load(str(src), repo=str(tmp_path))
        assert VetCache.file_key("p", "sha1", sf2) != key
        assert VetCache().get(VetCache.file_key("p", "sha1", sf2)) is None

    def test_default_file_is_the_ports_own(self, monkeypatch):
        from tidb_tpu_torch.analysis import vetcache

        monkeypatch.delenv("TIDB_TPU_TORCH_VET_CACHE", raising=False)
        assert os.path.basename(vetcache._DEFAULT_PATH) == ".vet_cache_torch.json"
        assert vetcache.VetCache().path == vetcache._DEFAULT_PATH
        assert ".vet_cache_torch.json" in open(os.path.join(REPO, ".gitignore")).read().split()

    def test_run_all_cold_equals_warm(self):
        cold = analysis.run_all(device="cpu")
        warm = analysis.run_all(device="cpu")
        assert [f.render() for f in cold] == [f.render() for f in warm] == []
