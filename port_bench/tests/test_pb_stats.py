"""Rates and tails over all samples of the window, on synthetic records."""

import math

from port_bench import stats
from port_bench.drive import Rec
from port_bench.traffic import Request


def rec(due, deliveries, failed=None):
    r = Rec(req=Request(0, "x", 1, {}, False, None, None), due=due)
    r.deliveries = list(deliveries)
    r.failed = failed
    return r


def stream(start, n, every, nbytes=4096):
    return rec(start, [(start + every * (k + 1), nbytes) for k in range(n)])


def test_percentile_takes_every_sample():
    assert stats.percentile(range(1, 101), 95) == 95.05
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1, 2, math.inf], 95) == math.inf
    assert stats.percentile([1] * 99 + [math.inf], 50) == 1


def test_gaps_and_rate_of_steady_streams():
    recs = [stream(0.0, 20, 0.5), stream(0.25, 20, 0.5)]
    gaps = stats.pcm_gaps_ms(recs, 1.0, 9.0)
    assert gaps and all(abs(g - 500.0) < 1e-9 for g in gaps)
    # deliveries in (1, 9]: 16 + 16 of 4096 bytes of int16 at 2048 Hz
    assert stats.audio_seconds(recs, 1.0, 9.0, 2048) == 32 * 4096 / 2 / 2048


def test_a_stall_moves_the_gap_tail_and_the_rate():
    steady = [stream(0.0, 40, 0.25) for _ in range(4)]
    stalled = [stream(0.0, 40, 0.25) for _ in range(4)]
    for r in stalled:  # 1 s stalls at 2.5, 5 and 7.5 s hold every stream back
        r.deliveries = [(t + sum(1.0 for s in (2.5, 5.0, 7.5) if t > s), n)
                        for t, n in r.deliveries]
    p_steady = stats.percentile(stats.pcm_gaps_ms(steady, 0.0, 10.0), 95)
    p_stalled = stats.percentile(stats.pcm_gaps_ms(stalled, 0.0, 10.0), 95)
    assert p_steady == 250.0 and p_stalled == 1250.0
    assert (stats.audio_seconds(stalled, 0.0, 10.0, 2048)
            < stats.audio_seconds(steady, 0.0, 10.0, 2048))
    # a median would not see the stall: the tail does
    assert stats.percentile(stats.pcm_gaps_ms(stalled, 0.0, 10.0), 50) == 250.0


def test_ttfa_counts_from_due_and_failures_as_missing():
    recs = [rec(1.0, [(1.2, 10)]), rec(2.0, [(2.5, 10)]), rec(3.0, [], failed="refused"),
            rec(12.0, [(12.1, 10)])]
    lat = stats.ttfa_ms(recs, 0.0, 10.0)
    assert len(lat) == 3 and math.isclose(lat[0], 200.0) and lat[2] == math.inf
    assert stats.percentile(lat, 95) == math.inf


def test_gap_counts_only_when_it_ends_in_the_window():
    r = rec(0.0, [(0.5, 1), (1.5, 1), (2.5, 1)])
    assert stats.pcm_gaps_ms([r], 1.0, 2.0) == [1000.0]
