"""What the program's own spans give the metric readers.

Two sources, both read before the program is freed:

- the registry's aggregates, ``FishTTS.get_metrics()["phases"]`` at the
  window's opening and close (``run.phases``): a span's seconds and count
  in the window, or before it;
- the ring of span records, ``fish_tts_tpu_torch.utils.profiling.spans``,
  over the traced window (``run.timeline``): the device's idle time split
  by what the host was doing.  A record is (seq, name, kind, start, end,
  parent seq, request id, thread), on the clock the timeline is lined up
  with.

A program without the span, or without the ring, gives None, never an
error.
"""

from __future__ import annotations

import numpy as np

CALL_KINDS = ("launch", "wait", "host")  # a request span takes no part in the split
PARTS = ("launch", "program", "outside")  # what the host was doing while the card idled


def delta(run, name: str) -> tuple[float, int] | None:
    """(seconds, count) of the span ``name`` in the window, or None when
    the program never recorded it."""
    before, after = run.phases
    if name not in after:
        return None
    b = before.get(name, {"total_s": 0.0, "count": 0})
    return after[name]["total_s"] - b["total_s"], after[name]["count"] - b["count"]


def per_round_ms(run, name: str) -> float | None:
    """Milliseconds of ``name`` in the window per ``serve.round`` in it."""
    d, rounds = delta(run, name), delta(run, "serve.round")
    if d is None or rounds is None or rounds[1] <= 0:
        return None
    return d[0] / rounds[1] * 1e3


def mean_ms(run, name: str) -> float | None:
    """Milliseconds per ``name`` span recorded in the window."""
    d = delta(run, name)
    return d[0] / d[1] * 1e3 if d is not None and d[1] > 0 else None


def before_window_s(run, name: str) -> float | None:
    """Seconds of ``name`` before the window opened."""
    st = run.phases[0].get(name)
    return None if st is None else st["total_s"]


def ring(t0: float, t1: float) -> list | None:
    """The program's span records overlapping [t0, t1], or None."""
    try:
        from fish_tts_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read(t0, t1)


def program_thread(records) -> int | None:
    """The thread that ran the program: the one with the most seconds of
    outermost call spans."""
    total: dict[int, float] = {}
    for r in records:
        if r[2] in CALL_KINDS and r[5] is None:
            total[r[7]] = total.get(r[7], 0.0) + r[4] - r[3]
    return max(total, key=total.get) if total else None


def innermost(records, thread: int, t0: float, t1: float) -> tuple[np.ndarray, list[str]]:
    """What the host was doing on ``thread`` over [t0, t1], piecewise:
    (the change points, from t0 on; the part from each one to the next),
    by the innermost open call span."""
    calls = sorted(((max(r[3], t0), min(r[4], t1), "launch" if r[2] == "launch" else "program")
                    for r in records if r[2] in CALL_KINDS and r[7] == thread
                    and r[4] >= t0 and r[3] <= t1),
                   key=lambda c: (c[0], -c[1]))
    times, parts = [t0], ["outside"]
    stack: list[tuple[float, str]] = []

    def change(t: float, part: str) -> None:
        t = max(t, times[-1])
        if t == times[-1]:
            parts[-1] = part
        else:
            times.append(t)
            parts.append(part)

    for start, end, part in calls:
        while stack and stack[-1][0] <= start:
            t = stack.pop()[0]
            change(t, stack[-1][1] if stack else "outside")
        change(start, part)
        stack.append((end, part))
    while stack:
        t = stack.pop()[0]
        change(t, stack[-1][1] if stack else "outside")
    return np.array(times, dtype=np.float64), parts


def idle_split(timeline, records) -> dict[str, float] | None:
    """The traced window's share (%) in which the card was idle while the
    program's thread was in a launch span, in another call span, or in
    none, time-weighted: each idle interval is cut where the innermost
    span changes.  The three add up to the window's idle share."""
    thread = program_thread(records)
    if thread is None or timeline.window_s <= 0:
        return None
    t0, t1 = timeline.t0, timeline.t1
    a, b = timeline.busy()
    lo = np.concatenate([[t0], b])
    hi = np.concatenate([a, [t1]])
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    cum = np.concatenate([[0.0], np.cumsum(hi - lo)])

    def idle_until(t: np.ndarray) -> np.ndarray:
        """Idle seconds in [t0, t]."""
        if not len(lo):
            return np.zeros_like(t)
        j = np.searchsorted(lo, t, side="right") - 1
        jj = np.maximum(j, 0)
        inside = np.clip(t - lo[jj], 0.0, hi[jj] - lo[jj])
        return np.where(j >= 0, cum[jj] + inside, 0.0)

    times, parts = innermost(records, thread, t0, t1)
    edges = np.append(times, t1)
    idle = idle_until(edges[1:]) - idle_until(edges[:-1])
    labels = np.array(parts)
    return {p: float(100.0 * idle[labels == p].sum() / timeline.window_s) for p in PARTS}


def idle_pct(run, part: str) -> float | None:
    """``idle_split``'s ``part`` for the run's traced window."""
    tl = run.timeline
    if tl is None:
        return None
    if not hasattr(run, "_idle_split"):
        records = ring(tl.t0, tl.t1)
        run._idle_split = idle_split(tl, records) if records else None
    return None if run._idle_split is None else run._idle_split[part]
