"""The traced window's reduction: busy time, operations by name, idle gaps
named by the harness span the host was in."""

import pytest

from port_bench.trace import Timeline, breakdown


def test_busy_union_and_gaps():
    tl = Timeline([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 4.0, 5.0), ("a", 4.5, 4.6),
                   ("x", -1.0, 0.5), ("late", 7.0, 8.0)], 0.0, 6.0)
    assert tl.window_s == 6.0 and tl.busy_s() == pytest.approx(3.5)
    assert tl.by_name() == pytest.approx({"a": 1.1, "b": 1.5, "c": 1.0, "x": 0.5})
    gaps = tl.idle_gaps([("step", 0.4, 1.2), ("submit", 3.2, 3.8)])
    assert gaps == [("step", pytest.approx(0.5)), ("submit", pytest.approx(1.0)),
                    ("other", pytest.approx(1.0))]
    assert tl.calls("a") == [(1.0, 2.0), (4.5, 4.6)]
    out = breakdown(tl, [], top=2)
    assert out["device_ops"] == [["b", 1.5], ["a", pytest.approx(1.1)]]
    assert [n for n, _ in out["idle_gaps"]] == ["other", "other"]


def test_an_empty_trace_is_all_idle():
    tl = Timeline([], 0.0, 2.0)
    assert tl.busy_s() == 0.0 and tl.idle_gaps([]) == [("other", 2.0)]
