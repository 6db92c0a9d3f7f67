import statistics

import pytest

from rtbench import window


def test_frame_ms_is_the_window_over_its_frames():
    assert window.frame_ms(2.5, 25) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        window.frame_ms(1.0, 0)


def test_p90_is_over_every_frame():
    ms = [10.0] * 90 + [20.0 + k for k in range(10)]
    p = window.frame_ms_p90(ms)
    assert p == statistics.quantiles(ms, n=10, method="inclusive")[8]
    assert 10.0 < p < 21.0
    assert window.tail_count(ms) == 10
    with pytest.raises(ValueError):
        window.frame_ms_p90([5.0])


def test_p90_of_unordered_frames():
    ms = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert window.frame_ms_p90(ms) == pytest.approx(4.6)
