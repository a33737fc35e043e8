"""The port's metrics (``utils/profiling.py``) against the JAX package's, and
their wiring: prefill/decode/vocoder spans and token counts recorded by
``FishTTS`` on the CPU, as ``tests/test_metrics.py`` checks them there; the
ring of span records (kind, parent, request id, thread) beside the
aggregates, and its bound."""

import itertools
import threading
import time
from collections import deque

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


def _mine(t0: float, t1: float) -> list:
    """The ring's records that began and ended inside [t0, t1]."""
    return [r for r in tprofiling.spans(t0, t1) if t0 <= r.start and r.end <= t1]


def test_span_and_record_write_the_aggregate_and_the_ring():
    """A call span and a request span each add to the registry's aggregate
    and to the ring, with kind, parent (the call span open on the thread),
    request id and thread; every timestamp lies inside a surrounding
    ``perf_counter()`` bracket; other threads' spans have no parent here."""
    m = tprofiling.Metrics()
    t0 = time.perf_counter()
    with m.span("outer", rid=7) as outer:
        with m.span("inner", kind="launch") as inner:
            inner.rid = 8
        m.record("req", t0, tprofiling.now(), rid=9)
        done = []
        th = threading.Thread(target=lambda: done.append(m.span("other", kind="wait")
                                                         .__enter__().__exit__()))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive() and done
    t1 = time.perf_counter()
    recs = {r.name: r for r in _mine(t0, t1)}
    assert set(recs) == {"outer", "inner", "req", "other"}
    me = threading.get_ident()
    assert recs["outer"] == (outer.seq, "outer", "host", recs["outer"].start,
                             recs["outer"].end, None, 7, me)
    assert (recs["inner"].kind, recs["inner"].parent, recs["inner"].rid,
            recs["inner"].thread) == ("launch", outer.seq, 8, me)
    assert (recs["req"].kind, recs["req"].parent, recs["req"].rid) == ("request", outer.seq, 9)
    assert recs["other"].parent is None and recs["other"].thread != me
    assert recs["other"].kind == "wait"
    for r in recs.values():
        assert t0 <= r.start <= r.end <= t1
    assert recs["outer"].start <= recs["inner"].start <= recs["inner"].end <= recs["outer"].end
    for name in recs:
        assert m.phases[name].count == 1
        assert m.phases[name].total_s == pytest.approx(recs[name].end - recs[name].start)
    assert m.summary()["phases"]["req"]["count"] == 1
    with pytest.raises(ValueError, match="kind"):
        m.span("bad", kind="device")


def test_the_ring_is_bounded(monkeypatch):
    """The ring keeps the last ``RING_SIZE`` records; the aggregate counts
    them all."""
    monkeypatch.setattr(tprofiling, "_ring", deque(maxlen=16))
    m = tprofiling.Metrics()
    for i in range(40):
        m.record("r", float(i), float(i) + 0.5, rid=i)
    assert tprofiling._ring.maxlen == 16 and [r.rid for r in tprofiling.spans()] == list(
        range(24, 40))
    assert [r.rid for r in tprofiling.spans(30.2, 31.0)] == [30, 31]
    assert m.phases["r"].count == 40
    assert tprofiling.RING_SIZE == 65_536


def test_rtf_sums_the_lm_and_codec_phases():
    """Spans that nest inside or beside the LM's and the codec's leave the
    real-time factor as the JAX package computes it."""
    m = tprofiling.Metrics()
    m.record_tokens(100)
    for name, s in (("prefill", 0.5), ("decode", 1.0), ("vocoder", 0.25),
                    ("engine.first_frames", 3.0), ("serve.round", 9.0)):
        m.record(name, 0.0, s)
    assert m.rtf == pytest.approx(1.75 / m.audio_seconds)
