"""The plain reference against the port's plain path at tiny widths (a test
may import both; the reference imports nothing of the port)."""

import numpy as np
import pytest
import torch

from fish_tts_tpu_torch.config import DualARConfig, VocoderConfig, VocoderTransformerConfig
from fish_tts_tpu_torch.models import dual_ar as P
from fish_tts_tpu_torch.models import vocoder
from fish_tts_tpu_torch.models.prompt import build_prompt
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.utils.quantize import qgather, quantize_lm_params

from port_bench import weights
from port_bench.reference import prompt
from port_bench.reference.dac import DAC
from port_bench.reference import sampling as S
from port_bench.reference.dual_ar import DualAR, qdq, served_gaps
from port_bench.run import config_of

# the port's rotary tables are stored in bf16, the reference's in float32: at these
# few positions they differ by ~1e-5 of the largest value
TOL = 1e-4


def port_configs(cfg):
    m, v = cfg["model"], cfg["codec"]
    pc = DualARConfig(**{k: x for k, x in m.items() if k in DualARConfig.__dataclass_fields__})
    vc = VocoderConfig(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()
                          if k in VocoderConfig.__dataclass_fields__
                          and k not in ("quantizer_transformer", "latent_dim")},
                       quantizer_transformer=VocoderTransformerConfig(**v["quantizer_transformer"]))
    return pc, vc


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def setup(tiny_config):
    cfg = config_of(tiny_config)
    m = cfg["model"]
    ids = prompt.ids(m["codebook_size"])
    params = weights.lm(m, 5, ids.semantic_begin, "cpu", torch.float32)
    pc, vc = port_configs(cfg)
    tok = P.TokenIds(ids.semantic_begin, ids.semantic_end, ids.im_end)
    return cfg, ids, params, pc, vc, tok


def sequence(ids, K, cb, n, seed=0):
    g = np.random.default_rng(seed)
    inp = np.zeros((1 + K, n), np.int64)
    semantic = g.random(n) < 0.6
    inp[1:] = g.integers(0, cb, (K, n))
    inp[0] = np.where(semantic, ids.semantic_begin + inp[1], g.integers(0, 256, n))
    inp[1:, ~semantic] = 0
    return torch.from_numpy(inp)


def port_hidden(params, pc, tok, inp):
    rope = P.make_rope_tables(pc)
    n = inp.shape[1]
    kv = P.init_kv_cache(pc, 1, pc.max_seq_len, torch.float32)
    causal = torch.where(torch.arange(n)[None] <= torch.arange(n)[:, None], 0.0,
                         torch.finfo(torch.float32).min)[None, None]
    hidden = P.slow_forward(params, pc, tok, rope, inp[None].int(), torch.arange(n)[None], kv,
                            None, causal, read_len=0)
    return hidden[0], rope


def port_fast(params, pc, rope, h, codes):
    cache = P.new_fast_cache(params, pc, h.shape[0])
    P.fast_step(params, pc, rope, h[:, None], 0, cache)
    out = []
    for cb in range(1, pc.num_codebooks):
        emb = qgather(params["fast_embeddings"], codes[:, cb - 1], torch.float32)[:, None]
        out.append(P.fast_step(params, pc, rope, emb, cb, cache)[:, -1, :pc.residual_codebook_size])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_lm_matches_the_ports_plain_path(setup, mode):
    cfg, ids, params, pc, vc, tok = setup
    m = cfg["model"]
    port = quantize_lm_params(params) if mode == "int8" else params
    inp = sequence(ids, m["num_codebooks"], m["residual_codebook_size"], 40)
    h_port, rope = port_hidden(port, pc, tok, inp)
    ref = DualAR(params, m, ids, mode)
    h_ref = ref.hidden(inp)
    assert rel(h_port, h_ref) < TOL
    assert rel(P.lm_logits(port, pc, h_port[None])[0], ref.head(h_ref)) < TOL
    codes = inp[1:, :8].T.contiguous()
    assert rel(port_fast(port, pc, rope, h_ref[:8], codes), ref.fast_logits(h_ref[:8], codes)) < TOL


def test_int8_reference_rounds_as_the_port_quantizes(setup):
    _, _, params, *_ = setup
    q = quantize_lm_params(params)
    w = params["layers"]["w1"][0]
    assert torch.equal(qdq(w, "int8"), q["layers"]["w1"]["q"][0].float() * q["layers"]["w1"]["s"][0])
    e = params["embeddings"]
    assert torch.equal(qdq(e, "int8"), q["embeddings"]["q"].float() * q["embeddings"]["s"])


def test_served_gaps_are_zero_on_the_references_own_argmax(setup):
    cfg, ids, params, *_ = setup
    m = cfg["model"]
    ref = DualAR(params, m, ids, "fp32")
    p = torch.from_numpy(prompt.prompt_matrix("hello there", m["num_codebooks"],
                                              m["codebook_size"]))
    frames = []
    for _ in range(6):  # greedy decoding by the reference itself
        inp = torch.cat([p] + [f[:, None] for f in frames], dim=1)
        h = ref.hidden(inp)[-1:]
        tok = int(ref.head(h).argmax())
        a = min(max(tok - ids.semantic_begin, 0), m["codebook_size"] - 1)
        codes = [a]
        for _b in range(m["num_codebooks"] - 1):
            lg = ref.fast_logits(h, torch.tensor([codes + [0] * (m["num_codebooks"] - len(codes))]))
            codes.append(int(lg[0, len(codes) - 1].argmax()))
        frames.append(torch.tensor([tok] + codes))
    g = served_gaps(ref, p, torch.stack(frames))
    assert g["slow_gap"] == 0.0 and g["fast_gap"] == 0.0
    wrong = torch.stack(frames).clone()
    wrong[2, 3] = (wrong[2, 3] + 1) % m["residual_codebook_size"]
    assert served_gaps(ref, p, wrong)["fast_gap"] > 0.0


def test_dac_matches_the_ports_decode(tiny_config):
    cfg = config_of(tiny_config)
    v = cfg["codec"]
    _, vc = port_configs(cfg)
    params = weights.codec(v, 3, "cpu", torch.float32)
    g = np.random.default_rng(1)
    codes = np.concatenate([g.integers(0, v["semantic_codebook_size"], (1, 12)),
                            g.integers(0, v["residual_codebook_size"], (3, 12))])
    want = vocoder.dac_decode(params, vc, torch.from_numpy(codes)[None])[0, 0]
    got = DAC(params, v, "fp32")(torch.from_numpy(codes))
    assert got.shape == want.shape == (12 * v["frame_length"],)
    assert rel(got, want) < TOL


def test_prompt_matches_the_ports(tmp_path):
    vocab = tmp_path / "tokenizer.tiktoken"
    vocab.write_text(prompt.vocab_lines())
    tk = FishTokenizer(vocab, prompt.special_tokens(48))
    ids = prompt.ids(48)
    assert (tk.semantic_begin_id, tk.semantic_end_id, tk.im_end_id) == (
        ids.semantic_begin, ids.semantic_end, ids.im_end)
    codes = np.random.default_rng(0).integers(0, 24, (4, 7))
    voices = [("a voice, spoken.", codes), ("another one", codes[:, :3])]
    for vs in ([], voices):
        want = build_prompt(tk, "Text to say.", 4, [t for t, _ in vs], [c for _, c in vs]).values
        got = prompt.prompt_matrix("Text to say.", 4, 48, vs)
        assert np.array_equal(got, want)
        assert got.shape[1] == prompt.prompt_length(12, [(len(t), c.shape[1]) for t, c in vs])


def test_noise_is_the_ports_for_the_requests_seed():
    from fish_tts_tpu_torch.engine import decode

    seed = 2**33 + 12345
    s = int(np.random.default_rng(seed).integers(0, 2**63 - 1))
    key = decode.GumbelNoise(s, None).slot_keys([0])[0]
    assert S.request_key(seed) == key
    steps = torch.tensor([decode.PREFILL_STEP, 0, 1, 17])
    keys = torch.full((4,), key, dtype=torch.int64)
    g = decode.gumbel_draws(keys, steps.int(), 600).float()
    assert torch.equal(S.gumbel(key, steps, 0, 512), g[:, :512])
    assert torch.equal(S.gumbel(key, steps, 512 + 24, 24), g[:, 512 + 24:512 + 48])
    assert torch.equal(S.steps_of(0, 3, "cpu"), torch.tensor([decode.PREFILL_STEP, 0, 1]))


def test_rules_draw_what_the_ports_samplers_draw():
    from fish_tts_tpu_torch.engine import sampling
    from fish_tts_tpu_torch.ops import sampler_kernel

    g = torch.Generator().manual_seed(3)
    n, V, W = 64, 300, 16
    logits = torch.randn(n, V, generator=g) * 3
    ids = torch.randint(0, V, (n, W), generator=g)
    noise = S.gumbel(99, torch.arange(n), 0, V)
    pen = torch.full((n, 1), 1.1)
    rules = (torch.full((n, 1), 0.7), torch.full((n, 1), 0.8), pen)
    want = S.pick(S.penalise(logits, ids, pen), noise, 0.7, 0.8)
    slow = sampler_kernel.sample_slow_plain(logits, ids, noise, *rules)
    book = sampling.sample(noise, logits, *rules, prev_idx=ids, top_k=-1)
    assert torch.equal(slow.long(), want) and torch.equal(book.long(), want)
    assert float(S.gap(S.penalise(logits, ids, pen), noise, 0.7, 0.8, want).max()) == 0.0
    # a draw at the wrong temperature, or outside the nucleus, falls short
    hot = S.pick(S.penalise(logits, ids, pen), noise, 1.0, 0.8)
    wide = S.pick(S.penalise(logits, ids, pen), noise, 0.7, 1.0)
    for tok in (hot, wide):
        assert float(S.gap(S.penalise(logits, ids, pen), noise, 0.7, 0.8, tok).max()) > 0.05


def test_penalty_window_is_the_ports(setup):
    """The ids the window holds at each served frame, against the port's
    circular window and its slow-token column."""
    from fish_tts_tpu_torch.engine import decode

    K1, W = 5, S.WINDOW
    g = torch.Generator().manual_seed(4)
    frames = torch.randint(1, 40, (40, K1), generator=g)
    prev = torch.zeros((1, K1, W), dtype=torch.int64)
    for f in range(1, 40):
        step = torch.tensor([f - 1])
        col = decode.penalty_column(prev, step)
        assert torch.equal(col[0], S.slow_penalty_ids(frames, f, 1)[0])
        for b in range(1, K1 - 1):
            assert sorted(prev[0, 1 + b].tolist()) == sorted(
                S.book_penalty_ids(frames, b, f, 1)[0].tolist())
        prev[0, :, (f - 1) % W] = frames[f]


def test_w8a8_rounds_each_products_input(setup):
    cfg, ids, params, *_ = setup
    m = cfg["model"]
    ref, low = DualAR(params, m, ids, "int8"), DualAR(params, m, ids, "w8a8")
    assert torch.equal(ref.emb, low.emb)
    x = torch.randn(3, m["dim"])
    w = low.slow.layers[0]["w1"]
    assert torch.equal(low.slow.mm(x, w), qdq(x, "int8") @ w.T)
    assert not torch.equal(low.slow.mm(x, w), ref.slow.mm(x, w))
