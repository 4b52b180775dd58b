"""The PyTorch port stands alone: no module of tidb_tpu_torch imports jax
or anything of the JAX package (tidb_tpu), importing it leaves jax
unloaded, and its entry points refuse a CUDA device that is not there
rather than quietly running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tidb_tpu_torch

PKG = Path(tidb_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "tidb_tpu")


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")))
def test_module_imports_no_jax_and_no_jax_package(path):
    bad = [m for m in _imported_modules(REPO / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    bad = [m for m in _imported_modules(REPO / "chip_smoke.py") if _forbidden(m)]
    assert not bad


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import tidb_tpu_torch, tidb_tpu_torch.exec, tidb_tpu_torch.ops.dense_agg\n"
        "import tidb_tpu_torch.interop, tidb_tpu_torch.workloads, tidb_tpu_torch.kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tidb_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch import workloads as W
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.chunk.device import to_device_batch
    from tidb_tpu_torch.exec import run_dag_on_chunk, run_dag_on_chunks
    import tidb_tpu_torch.exec as E
    import tidb_tpu_torch.expr as X
    from tidb_tpu_torch.interop import device_batch_from_numpy

    _no_cuda(monkeypatch)
    dag, fts = W.q6_dag(E, X, T)
    cols = W.q6_columns(W.make_tables(16))
    chunk = W.make_chunk(__import__("tidb_tpu_torch.chunk", fromlist=["Chunk"]), fts, cols)
    assert isinstance(chunk, Chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device_batch(chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_batch_from_numpy(cols, np.ones(16, bool), 16, fts)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dag_on_chunk(dag, chunk)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dag_on_chunks(dag, [chunk])
    # asked for explicitly, the CPU runs
    out = run_dag_on_chunk(dag, chunk, device="cpu")
    assert out.num_rows() == 1
    out = run_dag_on_chunks(dag, [chunk], device="cpu")
    assert out.num_rows() == 1
