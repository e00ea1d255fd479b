"""The percentile, window-rate and chunk-pacing arithmetic, by hand."""

import pytest

from benchmark.common import pacing_gaps, percentile, window_rate


def test_percentile_linear():
    # numpy's linear rule: rank (n - 1) q / 100 between sorted values
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile([10, 0, 20], 100) == 20
    assert percentile(range(101), 99) == 99.0
    assert percentile([0, 10], 99) == pytest.approx(9.9)


def test_pacing_gaps_split_each_chunk_over_its_tokens():
    # chunks of 4, 4 and 2 tokens ending at 1.0, 1.4 and 2.4 after a wait
    # that began at 0.2
    gaps = pacing_gaps([0.2, 1.0, 1.4, 2.4], [4, 4, 2])
    assert gaps == pytest.approx([0.2] * 4 + [0.1] * 4 + [0.5] * 2)
    assert percentile(gaps, 99) == pytest.approx(0.5)


def test_window_rate_counts_every_stream_over_the_whole_window():
    # 3 chunks of 128 steps for 8 streams, the last ending 2.5 s after the
    # window's start at 10.0 (a reset between chunks counts too)
    assert window_rate(10.0, [11.0, 11.8, 12.5], [128, 128, 128], 8) == \
        pytest.approx(3 * 128 * 8 / 2.5)
