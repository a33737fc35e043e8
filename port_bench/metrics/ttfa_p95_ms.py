"""The 95th percentile, over every request due in the window, of the time
from when it was due to its first PCM bytes; a request that failed counts
as infinitely late."""

from port_bench import stats


def read(run):
    lat = stats.ttfa_ms(run.recs, run.t0, run.close)
    return stats.percentile(lat, 95) if lat else None
