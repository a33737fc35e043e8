"""The port's metrics (``utils/profiling.py``) against the JAX package's, and
their wiring: prefill/decode/vocoder spans and token counts recorded by
``FishTTS`` on the CPU, as ``tests/test_metrics.py`` checks them there."""

import itertools
import time

import pytest
import torch

from fish_tts_tpu.utils import profiling as jprofiling
from fish_tts_tpu_torch import FishTTS
from fish_tts_tpu_torch.testing import make_tiny_bundle
from fish_tts_tpu_torch.utils import profiling as tprofiling

# (phase, clock ticks in it) and tokens recorded after it
SCRIPT = [("prefill", 3, 10), ("decode", 7, 20), ("decode", 2, 0), ("vocoder", 5, 0),
          ("decode", 11, 7)]


def _run(metrics, monkeypatch) -> dict:
    ticks = itertools.count()
    now = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    for name, dt, tokens in SCRIPT:
        with metrics.span(name):
            now["t"] += dt * 0.0137 + next(ticks) * 1e-6
        metrics.record_tokens(tokens)
    return metrics.summary()


@pytest.mark.parametrize("rate", [None, 44100 / 512])
def test_metrics_summary_matches_jax(monkeypatch, rate):
    """Under the same patched clock, spans and tokens, the port's
    ``Metrics.summary()`` equals the JAX package's (default and a loaded
    codec's frame rate); ``reset`` empties both alike."""
    ours, theirs = tprofiling.Metrics(), jprofiling.Metrics()
    assert tprofiling.AUDIO_TOKENS_PER_SEC == jprofiling.AUDIO_TOKENS_PER_SEC
    if rate is not None:
        ours.audio_tokens_per_sec = theirs.audio_tokens_per_sec = rate
    assert _run(ours, monkeypatch) == _run(theirs, monkeypatch)
    assert ours.phases["decode"].mean_s == pytest.approx(theirs.phases["decode"].mean_s)
    ours.reset()
    theirs.reset()
    assert ours.summary() == theirs.summary()


def test_hbm_bytes_and_trace_on_the_cpu(tmp_path):
    assert tprofiling.hbm_bytes_in_use("cpu") == 0
    with tprofiling.device_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(tmp_path.iterdir())


def test_synthesize_records_spans_and_tokens():
    tts = FishTTS(device="cpu", precision="int8", warmup=False,
                  _testing_bundle=make_tiny_bundle(0))
    assert tts.metrics is tts.engine.metrics
    vcfg = tts._vocoder_cfg
    assert tts.metrics.audio_tokens_per_sec == vcfg.sample_rate / vcfg.frame_length
    tts.metrics.reset()
    wav = tts.synthesize("measure me", max_tokens=24)
    assert wav[:4] == b"RIFF"
    s = tts.get_metrics()
    assert s["tokens"] > 0 and s["audio_s"] > 0
    assert s["phases"]["prefill"]["count"] == 1
    assert s["phases"]["decode"]["count"] >= 1
    assert s["phases"]["vocoder"]["count"] >= 1
    assert s["tokens_per_sec"] > 0 and s["rtf"] > 0
    assert "hbm_gb" not in s  # the CPU reports no device memory
    tts.metrics.reset()
    assert tts.get_metrics()["tokens"] == 0 and not tts.get_metrics()["phases"]
