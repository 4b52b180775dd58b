"""Nothing the benchmark runs imports JAX or the JAX package: an ast walk
of its sources, and the modules a run actually loads."""

import ast
import subprocess
import sys

from sqlbench_testkit import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tidb_tpu"}


def imported(path) -> list:
    """Top-level names of the modules a file imports (absolute imports)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module or "").split(".")[0])
    return out


def test_sources_import_no_jax():
    for path in (ROOT / "sqlbench").rglob("*.py"):
        bad = set(imported(path)) & FORBIDDEN
        assert not bad, f"{path}: imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "sqlbench" / "reference").rglob("*.py"):
        assert set(imported(path)) <= {"__future__", "decimal", "numpy", "torch"}, path


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'sqlbench/tests'); import sqlbench_testkit as k\n"
        "rc, res, err = k.tiny_run('tpch_sf05.agg', seconds=0.5)\n"
        "assert rc == 0 and res is not None, err\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'tidb_tpu'})\n"
        "print('FORBIDDEN', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_run_refuses_without_a_card():
    """On a machine with no card the command exits non-zero and prints no result."""
    code = (
        "import sys, torch; sys.path.insert(0, 'sqlbench/tests'); import sqlbench_testkit as k\n"
        "torch.cuda.is_available = lambda: False\n"
        "try:\n"
        "    k.run_module().main(['--workload', 'tpch_sf05.agg', '--seed', '1', '--seconds', '1', '--trace', '0'])\n"
        "except SystemExit as e:\n"
        "    sys.exit(e.code)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == "", out.stderr[-2000:]


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sqlbench", tmp_path / "sqlbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = (  # past the look for a card, to where the program is needed
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "sys.argv = ['sqlbench/run.py', '--workload', 'tpch_sf05.agg', '--seed', '1', '--seconds', '1', '--trace', '0']\n"
        "runpy.run_path('sqlbench/run.py', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stderr[-2000:]
    assert "tidb_tpu_torch" in out.stderr
