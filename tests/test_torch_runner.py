"""The runner's decode dispatch (``decode.Runner.decode``) at tiny size on
the CPU, with the prefill tests' stand-in for the capture
(``test_torch_prefill_graph.eager_capture``: the graph's body replayed
eagerly, its ring, counters and key kept).

- ``decode.eager_because``: a mesh or a state off the card sends both a
  prefill and a decode chunk to the eager route; more than one row or a
  host noise source only a prefill.
- One ``DecodeGraph`` per (state, read rows, skip, route), captured at
  first use inside a ``graph.capture`` span with the owner's capacity,
  reused by the next call at that key.
- The graph route gives the eager loop's frames, emitted flags and state,
  across a chunk longer than the capacity.
- Where ``eager_because`` gives a reason (the CPU, a tp = 2 mesh of CPU
  handles) the runner calls ``decode.decode_chunk``, looked up when called,
  and captures nothing.
"""

from types import SimpleNamespace

import pytest
import torch
from test_torch_prefill_graph import (CACHE, SAMPLING, assert_same_state, bundle,  # noqa: F401
                                      eager_capture, fresh, prompt_of, refuse_capture,
                                      runner_of)
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.utils import profiling


def host_noise(slot, step, draws):
    return torch.zeros(draws.slow), torch.zeros(3, draws.fast)


# (batch, noise, device) -> the reason for a prefill, for a decode chunk
EAGER_CASES = {
    "graph": ((1, "gumbel", "cuda"), None, None),
    "batch": ((2, "gumbel", "cuda"), "batch", None),
    "host noise": ((1, "host", "cuda"), "host noise", None),
    "device": ((1, "gumbel", "cpu"), "device", "device"),
}


@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "decode"])
@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_because(bundle, case, prefill):
    """The one decision, on a state that only names its device."""
    (batch, noise, device), want_prefill, want_decode = EAGER_CASES[case]
    noise = decode.GumbelNoise(1, bundle["cfg"]) if noise == "gumbel" else host_noise
    state = {"frame": SimpleNamespace(device=torch.device(device))}
    got = decode.eager_because(bundle["int8"], state, batch, noise, prefill=prefill)
    assert got == (want_prefill if prefill else want_decode)


def test_one_decode_graph_per_key(bundle, monkeypatch):
    """A graph per (state, read rows, skip, route), each captured once inside
    a ``graph.capture`` span at the runner's capacity; at B > 1 the skip is
    always on, so ``skip_done`` adds no graph there."""
    cfg = bundle["cfg"]
    opened = []

    def capture(state, fn, pool=None):
        opened.append([s._name for s in profiling._open_spans()])
        return eager_capture(state, fn, pool)

    monkeypatch.setattr(decode, "_capture", capture)
    monkeypatch.setattr(decode, "eager_because", lambda *a, **k: None)
    runner = runner_of(bundle, bundle["int8"])
    one, two = runner.state(1, CACHE), runner.state(2, CACHE)
    noise = decode.GumbelNoise(5, cfg)
    calls = [(one, 32, False), (one, 32, False), (one, 64, False), (one, 32, True),
             (two, 32, False), (two, 32, True), (one, 64, False)]
    graphs, replays = [], decode.graph_replays
    for state, kv, skip in calls:
        frames, emitted = runner.decode(state, noise, SAMPLING, 3, kv_bucket=kv, skip_done=skip)
        assert frames.shape == (state["frame"].shape[0], 3, 1 + cfg.num_codebooks)
        graphs.append(len(runner._decodes))
    assert graphs == [1, 1, 2, 3, 4, 4, 4]
    assert decode.graph_replays == replays + 3 * len(calls)
    assert opened == [["graph.capture"]] * 4
    assert {g.ring.frames.shape[1] for g in runner._decodes.values()} == {runner.capacity}
    assert sorted(k[1:3] for k in runner._decodes) == [(32, False), (32, True), (32, True),
                                                       (64, False)]


@pytest.mark.parametrize("weights", ["int8", "plain"])
def test_graph_route_equals_eager(bundle, monkeypatch, weights):
    """12 frames through the runner's graph (capacity 8: two ring passes)
    against ``decode_chunk`` from a copy of one prefilled state: frames,
    emitted flags and the whole state equal."""
    cfg, params = bundle["cfg"], bundle[weights]
    noise = decode.GumbelNoise(77, cfg)
    want = fresh(params, cfg)
    decode.prefill(params, bundle["rope"], want, *prompt_of(20, 32, 3, cfg), noise, *SAMPLING,
                   cfg=cfg, ids=bundle["ids"], kv_bucket=0)
    got = fresh(params, cfg, want)
    _, frames_e, emitted_e = decode.decode_chunk(params, bundle["rope"], want, noise, *SAMPLING,
                                                 cfg=cfg, ids=bundle["ids"], num_frames=12,
                                                 kv_bucket=64)
    monkeypatch.setattr(decode, "_capture", eager_capture)
    monkeypatch.setattr(decode, "eager_because", lambda *a, **k: None)
    runner = runner_of(bundle, params)
    frames_g, emitted_g = runner.decode(got, noise, SAMPLING, 12, kv_bucket=64, skip_done=False)
    assert len(runner._decodes) == 1
    assert torch.equal(frames_g, frames_e) and torch.equal(emitted_g, emitted_e)
    assert_same_state(got, want)


@pytest.mark.parametrize("reason", ["device", "mesh"])
def test_runner_decodes_eager(bundle, monkeypatch, reason):
    """On the CPU and on a tp = 2 mesh the chunk runs ``decode.decode_chunk``
    (patched after the runner was made: it is looked up when called), with
    no capture."""
    cfg = bundle["cfg"]
    if reason == "mesh":
        engine = GenerationEngine(bundle["plain"], cfg, bundle["tok"],
                                  EngineConfig(tp_size=2, dp_size=1))
        runner = engine.runner.sibling(8)
    else:
        runner = runner_of(bundle, bundle["int8"])
    state = runner.state(1, CACHE)
    noise = decode.GumbelNoise(3, cfg)
    assert decode.eager_because(runner.params, state, 1, noise, prefill=False) == reason

    calls = []
    real = decode.decode_chunk

    def spy(*a, **k):
        calls.append((k["num_frames"], k["kv_bucket"], k["early_exit"]))
        return real(*a, **k)

    monkeypatch.setattr(decode, "decode_chunk", spy)
    monkeypatch.setattr(decode, "_capture", refuse_capture)
    eager = decode.eager_frames
    frames, emitted = runner.decode(state, noise, SAMPLING, 5, kv_bucket=32, skip_done=True)
    assert calls == [(5, 32, True)] and not runner._decodes
    assert frames.shape == (1, 5, 1 + cfg.num_codebooks) and emitted.shape == (1, 5)
    assert decode.eager_frames == eager + 5
