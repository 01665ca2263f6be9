"""The traced run's arithmetic on hand-made intervals: busy time as the
union of device intervals clipped to the window, idle time put down to the
host span around it, and the breakdown's ten entries."""

import pytest

import _tiny  # noqa: F401  (puts the checkout on sys.path)
from portbench import trace


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(5, 15, "a"), (10, 20, "b"), (30, 40, "a"), (95, 120, "c"),
          (-10, 2, "d")]
    assert trace.union(iv, 0, 100) == [[0, 2], [5, 20], [30, 40], [95, 100]]


def test_idle_time_by_host_span():
    iv = [(10, 40, "k1"), (50, 90, "k2")]
    spans = [("issue", 0, 45), ("read", 45, 100)]
    tr = trace.read(iv, spans, 0, 100)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(70e-9)
    # idle: [0, 10) in issue, [40, 50) centred at 45 in read, [90, 100) read
    assert tr.idle_by_span == pytest.approx({"issue": 10e-9, "read": 20e-9})
    assert tr.op_seconds("k") == (pytest.approx(70e-9), 2)
    assert trace.label(spans, [0, 45], 200) == "outside"


def test_breakdown_keeps_the_ten_largest():
    iv = [(i * 10, i * 10 + i, f"op{i}") for i in range(1, 15)]
    b = trace.breakdown(trace.read(iv, [], 0, 200))
    assert len(b["device_ops"]) == 10 and b["device_ops"][0][0] == "op14"
    assert b["idle_gaps"] == [["outside", b["idle_gaps"][0][1]]]
