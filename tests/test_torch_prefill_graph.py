"""The B = 1 prefill graph (``decode.PrefillGraph`` through
``decode.Runner.prefill``) at tiny size on the CPU, where nothing can be
captured: a stand-in for the capture keeps everything else (the static
input buffers, their staging, the key, the counters) and replays the body
the graph holds, ``decode.prefill_body``, eagerly.

- The staged body against the eager ``decode.prefill``, bit for bit (frame,
  KV rows, position, done flag, the whole state) at two prompt buckets,
  from a fresh state and behind a forked prefix, on the int8 kernel route
  (the kernels' plain versions) and the plain route.
- A second, shorter prompt at the same key leaves no trace of the first.
- The runner runs the eager ``prefill`` for a state off the card, more
  than one row, parameters on a mesh and a host noise source, and builds
  no graph for them.

On the card ``chip_smoke.py``'s graph phase holds the captured prefill to
the eager one.
"""

import numpy as np
import pytest
import torch

from fish_tts_tpu_torch import testing
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.models.dual_ar import TokenIds, make_rope_tables
from fish_tts_tpu_torch.utils.profiling import Metrics
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

SAMPLING = (0.7, 0.8, 1.1)
CACHE = 128  # the tiny config's context
PREFIX = 21  # tokens of the forked prefix
KV_PRE = 32  # the prefix's read rows


@pytest.fixture(scope="module")
def bundle():
    cfg, params, tok, *_ = testing.make_tiny_bundle(0)
    ids = TokenIds(tok.semantic_begin_id, tok.semantic_end_id, tok.im_end_id)
    return {"cfg": cfg, "tok": tok, "ids": ids, "rope": make_rope_tables(cfg),
            "int8": quantize_lm_params(params), "plain": params}


class EagerReplay:
    """The stand-in for a captured graph: each replay runs the body on the
    static buffers and writes its frame into the graph's output (a decode
    frame returns (frame, emitted) and writes its own ring)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        out = self.fn()
        self.out.copy_(out[0] if isinstance(out, tuple) else out)

    def pool(self):
        return None


def eager_capture(state, fn, pool=None):
    out = torch.zeros_like(state["frame"])
    return EagerReplay(fn, out), out, [0] * len(decode._COUNTERS)


def refuse_capture(state, fn, pool=None):
    raise AssertionError("the dispatcher tried to capture a graph")


@pytest.fixture
def graph_route(monkeypatch):
    """The runner takes its graph route on the CPU, with the stand-in."""
    monkeypatch.setattr(decode, "_capture", eager_capture)
    monkeypatch.setattr(decode, "eager_because", lambda *a, **k: None)


def prompt_of(length: int, bucket: int, seed: int, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """A random (1, 1+K, bucket) prompt of ``length`` tokens, zero padded:
    text tokens in row 0, codes under them."""
    rng = np.random.default_rng(seed)
    p = np.zeros((1, 1 + cfg.num_codebooks, bucket), np.int32)
    p[0, 0, :length] = rng.integers(0, cfg.vocab_size, length)
    p[0, 1:, :length] = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, length))
    return torch.from_numpy(p), torch.tensor([length], dtype=torch.int32)


def fresh(params, cfg, prefix=None):
    """A one-row state of CACHE rows, or a copy of ``prefix`` (the engine's
    fork: every field, the KV rows included)."""
    state = decode.init_state(params, cfg, batch=1, max_seq_len=CACHE)
    if prefix is not None:
        for k in ("k", "v"):
            state["kv"][k].copy_(prefix["kv"][k])
        for k, v in prefix.items():
            if k != "kv":
                state[k].copy_(v)
    return state


def runner_of(b, params, **options) -> decode.Runner:
    return decode.Runner(params, b["cfg"], b["ids"], b["rope"], Metrics(), capacity=8,
                         **options)


def prefix_state(b, params):
    """A prefilled PREFIX-token prefix, as ``set_prefix`` leaves it."""
    cfg = b["cfg"]
    state = fresh(params, cfg)
    decode.prefill(params, b["rope"], state, *prompt_of(PREFIX, 32, 5, cfg),
                   decode.GumbelNoise(0, cfg), *SAMPLING, cfg=cfg, ids=b["ids"], kv_bucket=0)
    for k in ("done", "frame", "step"):
        state[k].zero_()
    return state


def assert_same_state(got, want):
    for k in ("k", "v"):
        assert torch.equal(got["kv"][k], want["kv"][k]), f"kv.{k}"
    for k in want:
        if k != "kv":
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("prefixed", [False, True], ids=["fresh", "behind-prefix"])
@pytest.mark.parametrize("bucket", [32, 64])
@pytest.mark.parametrize("weights", ["int8", "plain"])
def test_staged_body_equals_prefill(bundle, graph_route, weights, bucket, prefixed):
    cfg, params = bundle["cfg"], bundle[weights]
    pre = prefix_state(bundle, params) if prefixed else None
    kv = KV_PRE if prefixed else 0
    prompt, lengths = prompt_of(bucket - 5, bucket, 11, cfg)
    noise = decode.GumbelNoise(1234567890123, cfg)

    want = fresh(params, cfg, pre)
    _, frame_e = decode.prefill(params, bundle["rope"], want, prompt, lengths, noise, *SAMPLING,
                                cfg=cfg, ids=bundle["ids"], kv_bucket=kv)
    runner = runner_of(bundle, params)
    got = fresh(params, cfg, pre)
    replays = decode.prefill_replays
    _, frame_g = runner.prefill(got, prompt, lengths, noise, *SAMPLING, kv_bucket=kv)

    assert decode.prefill_replays == replays + 1 and len(runner._prefills) == 1
    assert torch.equal(frame_g, frame_e)
    assert int(got["pos"][0]) == (PREFIX if prefixed else 0) + bucket - 5
    assert_same_state(got, want)


def test_shorter_prompt_leaves_no_trace(bundle, graph_route):
    cfg, params = bundle["cfg"], bundle["int8"]
    runner = runner_of(bundle, params)
    state = fresh(params, cfg)
    long_p = prompt_of(60, 64, 21, cfg)
    short_p = prompt_of(9, 64, 22, cfg)
    noise = decode.GumbelNoise(7, cfg)
    runner.prefill(state, *long_p, noise, *SAMPLING, kv_bucket=0)
    decode.reset_state(state)
    _, frame_g = runner.prefill(state, *short_p, noise, *SAMPLING, kv_bucket=0)
    (graph,) = runner._prefills.values()
    assert torch.equal(graph.prompt, short_p[0])  # the padding rewritten too

    want = fresh(params, cfg)
    _, frame_e = decode.prefill(params, bundle["rope"], want, *short_p, noise, *SAMPLING,
                                cfg=cfg, ids=bundle["ids"], kv_bucket=0)
    assert torch.equal(frame_g, frame_e)
    assert_same_state(state, want)


def host_noise(slot, step, draws):
    return torch.zeros(draws.slow), torch.zeros(3, draws.fast)


@pytest.mark.parametrize("reason", ["device", "batch", "host noise", "mesh"])
def test_dispatcher_runs_eager(bundle, monkeypatch, reason):
    cfg, ids = bundle["cfg"], bundle["ids"]
    params, batch, noise = bundle["int8"], 1, decode.GumbelNoise(3, cfg)
    options = {}
    if reason == "batch":
        batch = 2
    elif reason == "host noise":
        noise = host_noise
    elif reason == "mesh":
        engine = GenerationEngine(bundle["plain"], cfg, bundle["tok"],
                                  EngineConfig(tp_size=2, dp_size=1))
        params, options = engine.params, engine.runner.options
    state = decode.init_state(params, cfg, batch=batch, max_seq_len=CACHE)
    prompt = torch.cat([prompt_of(20, 32, 30 + b, cfg)[0] for b in range(batch)])
    lengths = torch.full((batch,), 20, dtype=torch.int32)
    assert decode.eager_because(params, state, batch, noise, prefill=True) == reason

    calls = []
    real = decode.prefill

    def spy(*a, **k):
        calls.append(k["kv_bucket"])
        return real(*a, **k)

    monkeypatch.setattr(decode, "prefill", spy)
    monkeypatch.setattr(decode, "_capture", refuse_capture)
    runner = runner_of(bundle, params, **options)
    eager, replays = decode.prefill_eager, decode.prefill_replays
    _, frame = runner.prefill(state, prompt, lengths, noise, *SAMPLING, kv_bucket=0)
    assert calls == [0] and not runner._prefills and frame.shape == (batch, 1 + cfg.num_codebooks)
    assert decode.prefill_eager == eager + 1 and decode.prefill_replays == replays


def test_engine_prefills_through_its_graphs(bundle, monkeypatch):
    """``generate_long`` prefills through the engine's runner (on the CPU
    its eager prefill); the stand-in route, decode graphs included, gives
    the same codes."""
    cfg = bundle["cfg"]
    engine = GenerationEngine(bundle["int8"], cfg, bundle["tok"], EngineConfig())
    seen = []
    real = decode.Runner.prefill

    def spy(self, state, *a, **k):
        seen.append(self is engine.runner)
        return real(self, state, *a, **k)

    monkeypatch.setattr(decode.Runner, "prefill", spy)

    def codes():
        engine.reseed(9)
        return [r.codes for r in engine.generate_long("Hi there.", max_new_tokens=6)
                if r.codes is not None]

    eager = codes()
    monkeypatch.setattr(decode, "_capture", eager_capture)
    monkeypatch.setattr(decode, "eager_because", lambda *a, **k: None)
    graphed = codes()
    assert seen == [True, True] and len(engine.runner._prefills) == 1
    assert all(np.array_equal(a, b) for a, b in zip(eager, graphed)) and len(eager) == 1
