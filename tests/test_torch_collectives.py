"""The list collectives of the port's mesh (tidb_tpu_torch/parallel/
collectives.py) against numpy, on 1, 2 and 8 shards of the CPU.

A mesh program of the port is straight-line code over a list with one
entry per shard; psum / pmin / pmax reduce on the lead device and hand the
result to every shard, all_gather concatenates (or stacks) in shard order,
and all_to_all(tiled=False) sends x_d[e] from shard d to shard e. Each
collective's output is held against the same reduction in numpy, exactly
(integer data; float sums in shard order, the order numpy adds them).
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.parallel import collectives as C

SHARDS = [1, 2, 8]


def _inputs(n, seed, shape=(5, 3), dtype=np.int64):
    rng = np.random.default_rng(seed)
    if dtype == np.float64:
        return [rng.standard_normal(shape) for _ in range(n)]
    return [rng.integers(-(1 << 40), 1 << 40, shape, dtype=dtype) for _ in range(n)]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("op", ["psum", "pmin", "pmax"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64], ids=["int64", "float64"])
def test_reductions_hand_every_shard_the_result(n, op, dtype):
    xs = _inputs(n, 1 + n, dtype=dtype)
    devices = [torch.device("cpu")] * n
    out = getattr(C, op)([torch.from_numpy(x) for x in xs], devices)
    want = xs[0].copy()
    for x in xs[1:]:
        want = {"psum": np.add, "pmin": np.minimum, "pmax": np.maximum}[op](want, x)
    assert len(out) == n
    for o in out:
        assert o.dtype == torch.from_numpy(xs[0]).dtype
        np.testing.assert_array_equal(o.numpy(), want)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_is_shard_order(n, tiled):
    xs = _inputs(n, 7, shape=(4,))
    out = C.all_gather([torch.from_numpy(x) for x in xs], [torch.device("cpu")] * n, tiled=tiled)
    want = np.concatenate(xs) if tiled else np.stack(xs)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), want)


@pytest.mark.parametrize("n", SHARDS)
def test_all_to_all_source_against_destination(n):
    """x_d[e] = 100 d + e: shard e must receive [100 d + e for d], so the
    output's dim 0 indexes the source and every value names its route."""
    xs = [np.array([[100 * d + e, -(100 * d + e)] for e in range(n)], np.int64) for d in range(n)]
    out = C.all_to_all([torch.from_numpy(x) for x in xs], [torch.device("cpu")] * n)
    for e, o in enumerate(out):
        want = np.stack([xs[d][e] for d in range(n)])
        np.testing.assert_array_equal(o.numpy(), want)
        assert o[:, 0].tolist() == [100 * d + e for d in range(n)]


def test_collectives_check_their_shard_count():
    two = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="shards"):
        C.psum([torch.zeros(3)], two)
    with pytest.raises(ValueError, match="dim 0"):
        C.all_to_all([torch.zeros(3, 2), torch.zeros(3, 2)], two)
