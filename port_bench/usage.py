"""What the metric readers share: the streams' cache rows over time, the
rooflines of the traced kernels, the device's idle share.

A stream's cache rows at time t are its prompt plus the frames the LM had
handed over by then, plus one chunk in flight (the pool launches a chunk
before it reads the last one back); a stream counts from one round before
its first frames to its last.
"""

from __future__ import annotations

import bisect

from port_bench import counts, stats
from port_bench.reference.prompt import prompt_length

WINDOW = 16  # the repetition-penalty window the fast decoder reads
CHUNK = 20  # frames per round


def _streams(run) -> list:
    """Per request: (prompt rows, tap times, frames handed over by each)."""
    cached = getattr(run, "_streams", None)
    if cached is not None:
        return cached
    taps: dict[int, list] = {}
    for t, rid, n in run.lm_frames:
        taps.setdefault(rid, []).append((t, n))
    out = []
    for rec in run.recs:
        got = taps.get(rec.rid)
        if not got:
            continue
        voices = [(len(text), codes.shape[1]) for text, codes in run.traffic.voice_refs(rec.req)]
        rows = prompt_length(len(rec.req.text), voices)
        times, cum, total = [], [], 0
        for t, n in sorted(got):
            total += n
            times.append(t)
            cum.append(total)
        out.append((rows, times, cum))
    run._streams = out
    return out


def cache_rows(run, t: float) -> int:
    """The cache rows the live streams hold at ``t``, summed."""
    total = 0
    for rows, times, cum in _streams(run):
        lead = times[1] - times[0] if len(times) > 1 else 0.0
        if not times[0] - lead <= t <= times[-1]:
            continue
        k = bisect.bisect_right(times, t)
        total += rows + (cum[k - 1] if k else 0) + CHUNK
    return total


def lm_frames_with_rows(run):
    """(time, frames, the stream's cache rows) of every handover."""
    for rows, times, cum in _streams(run):
        prev = 0
        for t, c in zip(times, cum):
            yield t, c - prev, rows + prev
            prev = c


def roofline(run, part: str, bound_at) -> float | None:
    """100 x the summed bound of the calls of the kernel named ``part``
    over their summed device time; a call while no stream is live (an
    all-done frame, which the kernel skips) has no bound to count."""
    tl = run.timeline
    if tl is None:
        return None
    calls = tl.calls(part)
    busy = sum(b - a for a, b in calls)
    if not calls or busy <= 0:
        return None
    bound = sum(bound_at(0.5 * (a + b)) for a, b in calls if cache_rows(run, 0.5 * (a + b)))
    return 100.0 * bound / busy if bound else None


def idle_pct(run) -> float | None:
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)


def audio_s_per_s(run) -> float:
    """Seconds of PCM delivered in the window over the window's seconds."""
    return stats.audio_seconds(run.recs, run.t0, run.t1, run.sample_rate) / run.window_s


def mfu_pct(run) -> float:
    """The whole step's share of the card's bf16 peak: the model FLOPs of
    the LM frames delivered in the window (at each stream's cache rows) and
    of the codec's decode of the audio frames delivered in it, over the
    window's seconds and 989 TFLOP/s."""
    m, v = run.config["model"], run.config["codec"]
    lm = sum(n * counts.lm_flops_per_frame(m, rows)
             for t, n, rows in lm_frames_with_rows(run) if run.t0 < t <= run.t1)
    audio_frames = (stats.audio_seconds(run.recs, run.t0, run.t1, run.sample_rate)
                    * run.sample_rate / v["frame_length"])
    flops = lm + audio_frames * counts.codec_flops_per_frame(v)
    return 100.0 * flops / run.window_s / counts.BF16_OPS_PER_S


def ops_per_frame(run) -> float | None:
    """Device operations in the traced window per LM frame delivered in it."""
    tl = run.timeline
    if tl is None:
        return None
    frames = sum(n for t, _, n in run.lm_frames if tl.t0 < t <= tl.t1)
    return len(tl.ops) / frames if frames and tl.ops else None
