"""The 95th percentile of the time between consecutive PCM deliveries of
one stream, over every such gap of every stream that ends in the window."""

from port_bench import stats


def read(run):
    gaps = stats.pcm_gaps_ms(run.recs, run.t0, run.t1)
    return stats.percentile(gaps, 95) if gaps else None
