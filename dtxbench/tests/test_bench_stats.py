"""The arithmetic of a window: a stall in the middle must lower the rate
and raise the tails, and a missing request counts as infinitely late."""

import math

import pytest

from dtxbench.harness import stats


def _window(stall: float):
    """A server of one slot: 40 requests due 0.25 s apart, each served in
    0.2 s, first come first served; during a stall from 5 s on it serves
    nothing. Returns the due times, the first-token times (a request's
    start) and the requests finished inside the 10 s window."""
    due = [0.25 * i for i in range(40)]
    first, end, done = [], 0.0, 0
    for d in due:
        start = max(d, end)
        if stall and 5.0 <= start < 5.0 + stall:
            start = 5.0 + stall
        end = start + 0.2
        first.append(start)
        done += end <= 10.0
    return due, first, done


def test_stall_moves_rate_and_tail():
    due, first, n = _window(0.0)
    due2, first2, n2 = _window(2.0)
    assert n2 / 10.0 < n / 10.0
    calm = stats.percentile(stats.ttft_ms(due, first), 95)
    stalled = stats.percentile(stats.ttft_ms(due2, first2), 95)
    assert calm == pytest.approx(0.0)
    assert stalled > 1000.0


def test_missing_request_is_infinitely_late():
    ttft = stats.ttft_ms([0.0, 1.0, 2.0], [0.1, None, 2.1])
    assert math.isinf(max(ttft))
    assert math.isinf(stats.percentile(ttft * 10, 95))


def test_percentile_interpolates():
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert stats.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_tpot():
    assert stats.tpot_ms([0.0, 0.0], [1.0, 0.0], [11, 1]) == [
        pytest.approx(100.0)]
    assert math.isinf(stats.tpot_ms([None], [None], [0])[0])
