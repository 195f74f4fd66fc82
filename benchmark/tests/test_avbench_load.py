"""The open loop's schedule and the tails."""

from __future__ import annotations

import math

import numpy as np

from avbench.load import open_gaps, percentile


def test_same_seed_same_schedule():
    assert np.array_equal(open_gaps(168.0, 512, 1, 7),
                          open_gaps(168.0, 512, 1, 7))


def test_every_seed_the_same_cycle_from_another_start():
    a, b = open_gaps(168.0, 512, 1, 7), open_gaps(168.0, 512, 1, 8)
    assert not np.array_equal(a, b)
    shift = int(np.flatnonzero(b == a[0])[0])
    assert np.array_equal(np.roll(b, -shift), a)
    assert abs(a.mean() - 1.0 / 168.0) < 0.01 / 168.0


def test_tail_is_over_all_requests_and_failures_count():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile(values + [math.inf] * 6, 95) == math.inf
    assert percentile([3.0], 95) == 3.0
