"""The traced run's device timeline, on the host's clock.

``torch.profiler`` records the device's operations (CUDA activity only: no
host operator events, so tracing costs the host little).  The trace starts
and stops on an idle device, each time with a marker kernel first, whose
device start is lined up with the host's clock at its launch: every
operation then carries host-clock times, comparable with the harness's
spans.  ``Timeline`` holds the operations inside [t0, t1] and derives the
device's busy time, the operations' time by name, and the idle gaps with
the harness span the host was in.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

MARKER_CYCLES = 20_000


def _events(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device event, on the profiler's clock."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() * 1e-9 if hasattr(e, "start_ns") else e.start_us() * 1e-6
            dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6
            out.append((e.name(), start, start + dur))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out


class Tracer:
    """Starts and stops the device trace; ``timeline`` after ``stop``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._make = lambda: profile(activities=[ProfilerActivity.CUDA])
        self.prof = None
        self.t0 = self.t1 = None
        self.timeline: Timeline | None = None

    def warm(self) -> None:
        """Load the tracing library in set-up, not in the window."""
        with self._make():
            self._marker()
            torch.cuda.synchronize()

    @staticmethod
    def _marker() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        return t

    def start(self) -> None:
        self.prof = self._make()
        self.prof.start()
        self._launch0 = self._marker()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        events = sorted(_events(self.prof), key=lambda e: e[1])
        self.prof = None
        if not events:
            self.timeline = Timeline([], self.t0, self.t1)
            return
        offset = self._launch0 - events[0][1]  # the marker ran first, on an idle device
        self.timeline = Timeline([(n, a + offset, b + offset) for n, a, b in events[1:]],
                                 self.t0, self.t1)


class Timeline:
    """Device operations (name, start, end) on the host's clock within
    [t0, t1]."""

    def __init__(self, ops, t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.ops = [(n, max(a, t0), min(b, t1)) for n, a, b in ops if b > t0 and a < t1]
        self._busy = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the operations' intervals: (starts, ends), sorted."""
        if self._busy is None:
            a = np.array([o[1] for o in self.ops], dtype=np.float64)
            b = np.array([o[2] for o in self.ops], dtype=np.float64)
            order = np.argsort(a, kind="stable")
            a, b = a[order], np.maximum.accumulate(b[order]) if len(b) else b
            new = np.ones(len(a), dtype=bool)
            new[1:] = a[1:] > b[:-1]  # a gap before this operation
            first = np.flatnonzero(new)
            last = np.append(first[1:] - 1, len(a) - 1) if len(a) else first
            self._busy = (a[first], b[last])
        return self._busy

    def busy_s(self) -> float:
        a, b = self.busy()
        return float((b - a).sum())

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for n, a, b in self.ops:
            out[n] += b - a
        return dict(out)

    def calls(self, part: str) -> list[tuple[float, float]]:
        """(start, end) of every operation whose name holds ``part``."""
        return [(a, b) for n, a, b in self.ops if part in n]

    def idle_gaps(self, spans) -> list[tuple[str, float]]:
        """Every idle interval, named by the harness span (name, start,
        end) the host was in at its middle ("other" outside any)."""
        a, b = self.busy()
        lo = np.concatenate([[self.t0], b])
        hi = np.concatenate([a, [self.t1]])
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        spans = sorted(spans, key=lambda sp: sp[1])
        starts = np.array([sp[1] for sp in spans], dtype=np.float64)
        ends = np.array([sp[2] for sp in spans], dtype=np.float64)
        mid = 0.5 * (lo + hi)
        k = np.searchsorted(starts, mid, side="right") - 1
        inside = (k >= 0) & (ends[np.maximum(k, 0)] >= mid) if len(spans) else k < -1
        return [(spans[kk][0] if ok else "other", float(g))
                for kk, ok, g in zip(k.tolist(), inside.tolist(), (hi - lo).tolist())]


def breakdown(timeline: Timeline, spans, top: int = 10) -> dict:
    ops = sorted(timeline.by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(timeline.idle_gaps(spans), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
