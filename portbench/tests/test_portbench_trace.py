"""The busy and idle arithmetic of the device trace on synthetic intervals."""

from __future__ import annotations

import pytest

from portbench.harness.trace import WINDOW_RANGE, gaps, summarize, union_length


def test_union_counts_overlap_once():
    assert union_length([(0.0, 1.0), (0.5, 1.5), (2.0, 3.0)]) == pytest.approx(2.5)
    assert union_length([(0.0, 4.0), (1.0, 2.0), (1.5, 3.0)]) == pytest.approx(4.0)
    assert union_length([]) == 0.0


def test_gaps():
    assert gaps([(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)], 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]


def test_concurrent_streams_never_read_busier_than_the_window():
    events = [(WINDOW_RANGE, False, 0.0, 10.0),
              ("k1", True, 0.0, 6.0), ("k2", True, 1.0, 7.0), ("k3", True, 2.0, 5.0),  # three streams
              ("k1", True, 9.0, 12.0),  # runs past the window: clipped
              ("host_op", False, 7.0, 9.0)]
    t = summarize(events)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(8.0)  # [0, 7) and [9, 10)
    assert t.idle_share == pytest.approx(0.2)
    assert t.idle_gaps == [["host_op", pytest.approx(2.0)]]
    assert t.device_ops[0][0] == "k1" and t.device_ops[0][1] == pytest.approx(7.0)


def test_no_window_no_summary():
    assert summarize([("k", True, 0.0, 1.0)]) is None
