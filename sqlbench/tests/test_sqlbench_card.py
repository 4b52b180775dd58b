"""A tiny run of each cell on the card, through the command's own look for
one: correct, and a device timeline in the traced run."""

import pytest
from sqlbench_testkit import tiny_run

from sqlbench.harness import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_on_the_card(card, cell):
    rc, res, err = tiny_run(cell, trace=1, device=None)
    assert rc == 0 and res["correct"], err[-3000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["device_idle_pct"]["value"] < 100
