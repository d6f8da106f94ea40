"""The trace's arithmetic on intervals of known times: the card's busy
seconds are the union of its operations inside the window, and each idle
gap goes to the host layer whose interval holds its middle."""
import pytest

import devtrace


def test_busy_is_the_union_inside_the_window():
    device = [(0, 10, "k"), (5, 20, "k"), (30, 40, "f"), (95, 130, "k")]
    out = devtrace.summarize(device, [], (2, 100))
    assert out["busy_s"] == pytest.approx((18 + 10 + 5) * 1e-6)
    assert out["window_s"] == pytest.approx(98e-6)
    assert out["breakdown"]["device_ops"] == [
        ["k", pytest.approx(28e-6)], ["f", pytest.approx(10e-6)]]


def test_idle_gaps_go_to_the_host_layer_they_fall_in():
    device = [(0, 10, "k"), (20, 30, "k"), (60, 90, "k")]
    host = [(8, 25, "evaluator"), (31, 50, "searcher"), (52, 58, "evaluator")]
    out = devtrace.summarize(device, host, (0, 100))
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["breakdown"]["idle_gaps"] == [
        ["searcher: 1 gaps", pytest.approx(30e-6)],
        ["evaluator: 1 gaps", pytest.approx(10e-6)],
        ["harness: 1 gaps", pytest.approx(10e-6)],
        ["searcher: one gap", pytest.approx(30e-6)],
        ["evaluator: one gap", pytest.approx(10e-6)],
        ["harness: one gap", pytest.approx(10e-6)]]
