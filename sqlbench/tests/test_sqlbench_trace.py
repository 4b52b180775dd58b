"""The trace reduction's interval arithmetic, and the kernel-call recorder
against the port's own count of K4's bytes."""

import torch
from sqlbench_testkit import ROOT  # noqa: F401  (puts the checkout on the path)

from sqlbench.harness import kernels, trace


def test_intervals():
    assert trace.union([(5, 7), (1, 3), (2, 4)]) == [[1, 4], [5, 7]]
    assert trace.total([(1, 3), (2, 4), (10, 11)]) == 4
    assert trace.minus([(0, 10)], [(2, 3), (2, 4), (8, 12)]) == 6
    assert trace.clip([(0, 5), (8, 9)], 3, 8) == [(3, 5)]
    tl = trace.DeviceTimeline([("a", 0, 2), ("b", 1, 3), ("a", 6, 7)])
    assert tl.busy_ns(0, 10) == 4
    assert tl.gaps(0, 10) == [(3, 6), (7, 10)]
    assert tl.by_name(0, 10) == [("a", 3), ("b", 2)]


def test_k4_call_work_matches_the_port():
    from tidb_tpu_torch.ops import join_probe

    g = torch.Generator().manual_seed(3)
    b_key = torch.randint(0, 50, (4, 128), generator=g)
    p_key = torch.randint(0, 50, (4, 512), generator=g)
    b_ok = torch.rand(4, 128, generator=g) < 0.3
    p_ok = torch.rand(4, 512, generator=g) < 0.5
    with kernels.CallWork() as work:
        join_probe.probe_tables(b_key, b_ok, p_key, p_ok)
    assert join_probe._probe_tables_op is work._real["k4"][2]  # unwrapped again
    ((_t, b_in, b_out, ops),) = work.calls["k4"]
    assert (int(b_in), int(b_out)) == join_probe.probe_tables_bytes(b_ok, p_ok)
    assert int(ops) == 2 * int((p_ok.sum(1) * b_ok.sum(1)).sum())
