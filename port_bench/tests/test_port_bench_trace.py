"""The device's busy time is the union of its work's intervals, not
their sum: two overlapping kernels count once, an annotation row spanning
both counts not at all, a copy counts, and idle time at the window's
edge is idle."""

from __future__ import annotations

import pytest

from port_bench import trace


def test_union_not_sum():
    events = [("k1", "kernel", 10, 40), ("k2", "kernel", 30, 60),
              ("Optimizer.step", "annotation", 5, 70),
              ("Memcpy HtoD", "memcpy", 80, 90)]
    out = trace.reduce(events, 0, 100)
    assert out["busy_s"] == pytest.approx(60e-9)
    assert out["idle_share"] == pytest.approx(0.4)
    # the sum of the device rows would read 70 ns busy, with the
    # annotation 135 ns: more than the window
    assert sum(t for _, t in out["device_ops"]) == pytest.approx(70e-9)
    gaps = dict(out["idle_gaps"])
    assert gaps["idle at the window's edges"] == pytest.approx(20e-9)
    assert gaps["idle gaps under 0.1 ms"] == pytest.approx(20e-9)


def test_clipped_to_the_window():
    events = [("k", "kernel", -50, 20), ("k", "kernel", 90, 200)]
    out = trace.reduce(events, 0, 100)
    assert out["busy_s"] == pytest.approx(30e-9)
    assert out["kernel_ns"] == {"k": 30}


def test_gap_classes():
    events = [("a", "kernel", 0, 10), ("b", "kernel", 2_000_010, 2_000_020),
              ("c", "kernel", 2_500_020, 2_500_030)]
    out = trace.reduce(events, 0, 2_500_030)
    gaps = dict(out["idle_gaps"])
    assert gaps["idle gaps of 1 ms and over"] == pytest.approx(2e-3)
    assert gaps["idle gaps of 0.1-1 ms"] == pytest.approx(5e-4)
