"""The window's arithmetic."""
import pytest

from snsbench import window


@pytest.mark.parametrize("elapsed,last,seconds,ok", [
    (0.0, 1.0, 10.0, True), (9.0, 1.0, 10.0, True), (9.5, 1.0, 10.0, False),
    (13.0, 13.0, 45.0, True), (39.0, 13.0, 45.0, False)])
def test_a_further_map_starts_only_if_it_ends_inside(elapsed, last, seconds,
                                                     ok):
    assert window.may_start(elapsed, last, seconds) is ok


def test_map_s_is_the_window_over_the_maps():
    assert window.map_s(45.0, 100) == 0.45


def test_percentile_interpolates_between_order_statistics():
    vals = [float(v) for v in range(1, 101)]
    assert window.percentile(vals, 90) == pytest.approx(90.1)
    assert window.percentile([2.0], 90) == 2.0
    assert window.percentile([1.0, 2.0], 50) == 1.5



def test_busy_time_is_the_union_and_gaps_are_labelled_by_the_host():
    from snsbench import trace
    dev = [(10.0, 20.0, "void k1<int>(float*)"), (15.0, 30.0, "k2"),
           (40.0, 50.0, "k1<int>(float*)")]
    host = [(0.0, 60.0, "sns:run", 1), (30.0, 45.0, "aten::item", 1),
            (31.0, 33.0, "cudaStreamSynchronize", 1), (0.0, 60.0, "x", 2)]
    t = trace.summarize_intervals(dev, host)
    assert t["busy_s"] == pytest.approx(30e-6)
    assert t["window_s"] == pytest.approx(60e-6)
    assert dict(t["idle_gaps"]) == pytest.approx(
        {"sns:run / aten::item": 10e-6, "sns:run / -": 20e-6})
    assert dict(t["device_ops"]) == pytest.approx({"k1": 20e-6, "k2": 15e-6})
    assert t["records"]["k2"] == 1
