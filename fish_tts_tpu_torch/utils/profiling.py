"""Metrics and traces: per-phase timers, a ring of spans, throughput and RTF
counters.

The port's own copy of ``fish_tts_tpu/utils/profiling.py``, with the same
aggregates: ``GenerationEngine.metrics`` records the "prefill"/"decode"
spans and token counts of every generation, ``FishTTS`` adds "vocoder"
spans and exposes ``get_metrics()`` with the device memory in use.

Every span also lands in one process-wide ring of the last ``RING_SIZE``
records, read with :func:`spans`.  A record is a :class:`Span`: its name;
its kind (``"launch"``: the host enqueues device work; ``"wait"``: the host
blocks on a copy or an event; ``"host"``: anything else; ``"request"``: a
request's interval written by :meth:`Metrics.record`); its start and end
on :func:`now`; the call span open on the same thread when it began (its
parent); the request's id; the thread.  A span never synchronizes and never
reads a device tensor.  Every span and request timestamp of the port is
taken with :func:`now`: ``time.perf_counter``, the clock the benchmark's
device trace is lined up with.

``hbm_bytes_in_use`` reads ``torch.cuda.memory_allocated`` and
``device_trace`` is a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

# default S1-mini codec rate (44.1 kHz, 2048 samples a frame); a loaded
# vocoder config overrides it per instance via Metrics.audio_tokens_per_sec
AUDIO_TOKENS_PER_SEC = 44100 / 2048
# the phases the real-time factor sums: the LM's waits and the codec's
RTF_PHASES = ("prefill", "decode", "vocoder")
RING_SIZE = 65_536  # span records the ring keeps
KINDS = ("host", "launch", "wait")  # a call span's kinds


def now() -> float:
    """The clock of every span and request timestamp in the port."""
    return time.perf_counter()


class Span(NamedTuple):
    """One record of the ring."""

    seq: int
    name: str
    kind: str
    start: float
    end: float
    parent: int | None  # seq of the call span open on the thread at the start
    rid: int | None  # the request's id
    thread: int


_ring: deque[tuple] = deque(maxlen=RING_SIZE)
_lock = threading.Lock()  # the ring and every registry's aggregates
_seq = itertools.count()
_local = threading.local()


def _open_spans() -> list:
    """This thread's open call spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def spans(t0: float | None = None, t1: float | None = None) -> list[Span]:
    """The ring's records that overlap [t0, t1] (an end left None is
    open), in the order they ended."""
    with _lock:
        recs = list(_ring)
    return [Span._make(r) for r in recs
            if (t0 is None or r[4] >= t0) and (t1 is None or r[3] <= t1)]


@dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class _CallSpan:
    """The context :meth:`Metrics.span` returns; ``rid`` may be set inside
    the block."""

    __slots__ = ("_metrics", "_name", "_kind", "rid", "seq", "_parent", "_start")

    def __init__(self, metrics: "Metrics", name: str, kind: str, rid: int | None):
        self._metrics, self._name, self._kind, self.rid = metrics, name, kind, rid

    def __enter__(self) -> "_CallSpan":
        stack = _open_spans()
        self.seq = next(_seq)
        self._parent = stack[-1].seq if stack else None
        stack.append(self)
        self._start = now()
        return self

    def __exit__(self, *exc) -> None:
        end = now()
        _open_spans().pop()
        self._metrics._add(self.seq, self._name, self._kind, self._start, end, self._parent,
                           self.rid)


@dataclass
class Metrics:
    """Per-engine metrics registry.

    The engine dispatches chunk k+1 before it reads chunk k back, so the
    "prefill"/"decode" spans time the host-visible wait for that phase's
    outputs, the wall time the caller spent, not the device's compute of
    that chunk alone.  That is the numerator for throughput and RTF; for
    device time by kernel use ``device_trace`` or ``chip_smoke.py
    --profile``.
    """

    phases: dict[str, PhaseStats] = field(default_factory=lambda: defaultdict(PhaseStats))
    tokens_generated: int = 0
    audio_seconds: float = 0.0
    # frames/s of the codec in use: set from the loaded VocoderConfig
    audio_tokens_per_sec: float = AUDIO_TOKENS_PER_SEC

    def span(self, name: str, kind: str = "host", rid: int | None = None) -> _CallSpan:
        """Time a call on :func:`now`: ``with metrics.span(name, kind):``,
        ``kind`` one of ``KINDS``.  A span covers the device's work only if
        the caller reads the results back inside the block."""
        if kind not in KINDS:
            raise ValueError(f"span kind must be one of {KINDS}, not {kind!r}")
        return _CallSpan(self, name, kind, rid)

    def record(self, name: str, start: float, end: float, rid: int | None = None) -> None:
        """A request span [start, end] on :func:`now`: one that runs across
        rounds or yields, which no ``with`` block can cover."""
        stack = _open_spans()
        self._add(next(_seq), name, "request", start, end, stack[-1].seq if stack else None, rid)

    def _add(self, seq, name, kind, start, end, parent, rid) -> None:
        rec = (seq, name, kind, start, end, parent, rid, threading.get_ident())
        with _lock:
            st = self.phases[name]
            st.total_s += end - start
            st.count += 1
            _ring.append(rec)

    def record_tokens(self, n: int) -> None:
        self.tokens_generated += n
        self.audio_seconds += n / self.audio_tokens_per_sec

    @property
    def tokens_per_sec(self) -> float:
        """Generated tokens over the LM time that produced them (prefill,
        which also emits the first chunk, plus decode)."""
        lm_s = sum(self.phases[n].total_s for n in ("prefill", "decode") if n in self.phases)
        return self.tokens_generated / lm_s if lm_s else 0.0

    @property
    def rtf(self) -> float:
        """Real-time factor over the LM's and the codec's timed phases
        (``RTF_PHASES``; lower is better)."""
        total = sum(self.phases[n].total_s for n in RTF_PHASES if n in self.phases)
        return total / self.audio_seconds if self.audio_seconds else 0.0

    def summary(self) -> dict:
        with _lock:
            phases = {k: (v.total_s, v.count, v.mean_s) for k, v in self.phases.items()}
        return {
            "tokens": self.tokens_generated,
            "audio_s": round(self.audio_seconds, 2),
            "tokens_per_sec": round(self.tokens_per_sec, 1),
            "rtf": round(self.rtf, 4),
            "phases": {
                k: {"total_s": round(total, 3), "count": count, "mean_ms": round(mean * 1e3, 2)}
                for k, (total, count, mean) in phases.items()
            },
        }

    def reset(self) -> None:
        with _lock:
            self.phases.clear()
        self.tokens_generated = 0
        self.audio_seconds = 0.0


def hbm_bytes_in_use(device: torch.device | str | None = None) -> int:
    """Bytes PyTorch has allocated on ``device`` (the current CUDA device by
    default); 0 on the CPU or without a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated(dev))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host and, with a CUDA
    device, device activity), written to ``log_dir`` for TensorBoard or
    Perfetto.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
