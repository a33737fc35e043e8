"""Metrics and traces: per-phase timers, throughput and RTF counters.

The port's own copy of ``fish_tts_tpu/utils/profiling.py``, with the same
semantics: ``GenerationEngine.metrics`` records the "prefill"/"decode"
spans and token counts of every generation, ``FishTTS`` adds "vocoder"
spans and exposes ``get_metrics()`` with the device memory in use.
``hbm_bytes_in_use`` reads ``torch.cuda.memory_allocated`` and
``device_trace`` is a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

# default S1-mini codec rate (44.1 kHz, 2048 samples a frame); a loaded
# vocoder config overrides it per instance via Metrics.audio_tokens_per_sec
AUDIO_TOKENS_PER_SEC = 44100 / 2048


@dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


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

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a phase on the host's wall clock.  The caller reads the
        phase's results back inside the block, which waits for the device."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st = self.phases[name]
            st.total_s += time.perf_counter() - t0
            st.count += 1

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
        """Real-time factor over all timed phases (lower is better)."""
        total = sum(p.total_s for p in self.phases.values())
        return total / self.audio_seconds if self.audio_seconds else 0.0

    def summary(self) -> dict:
        return {
            "tokens": self.tokens_generated,
            "audio_s": round(self.audio_seconds, 2),
            "tokens_per_sec": round(self.tokens_per_sec, 1),
            "rtf": round(self.rtf, 4),
            "phases": {
                k: {"total_s": round(v.total_s, 3), "count": v.count,
                    "mean_ms": round(v.mean_s * 1e3, 2)}
                for k, v in self.phases.items()
            },
        }

    def reset(self) -> None:
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
