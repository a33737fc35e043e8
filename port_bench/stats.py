"""Rates and tails over the window, from the harness's own records.

Every function takes all samples of the window: no median of pieces, no
best-of.  A request that never delivered counts as infinitely late.
"""

from __future__ import annotations

import math

import numpy as np

MISSING = math.inf


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics) of all
    ``values``; a missing value (inf) counts as the largest."""
    v = np.sort(np.asarray(list(values), dtype=np.float64))
    if v.size == 0:
        return math.nan
    pos = (v.size - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if v[hi] == MISSING:
        return MISSING
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def ttfa_ms(recs, t0: float, close: float) -> list[float]:
    """Due to first PCM, in ms, of every request due in [t0, close)."""
    return [((r.first - r.due) * 1e3 if r.first is not None and not r.failed else MISSING)
            for r in recs if t0 <= r.due < close]


def pcm_gaps_ms(recs, t0: float, t1: float) -> list[float]:
    """The time between consecutive PCM deliveries of one stream, in ms,
    for every gap that ends in (t0, t1]."""
    out = []
    for r in recs:
        times = [t for t, _ in r.deliveries]
        out += [(b - a) * 1e3 for a, b in zip(times, times[1:]) if t0 < b <= t1]
    return out


def audio_seconds(recs, t0: float, t1: float, sample_rate: int) -> float:
    """Seconds of int16 PCM delivered in (t0, t1]."""
    n = sum(nbytes for r in recs for t, nbytes in r.deliveries if t0 < t <= t1)
    return n / 2 / sample_rate

