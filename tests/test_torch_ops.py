"""Parity of the PyTorch port's host-side modules with the JAX package at
tiny size: quantization, norms/RoPE/attention/convs, the tokenizer, the
audio encoders and the codec decode.  Inputs come from numpy seeds and go
through both implementations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG, TINY_VOCODER_CONFIG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models import tokenizer as jtok
from fish_tts_tpu.models import vocoder as jvoc
from fish_tts_tpu.ops import attention as jattn
from fish_tts_tpu.ops import conv as jconv
from fish_tts_tpu.ops import norms as jnorms
from fish_tts_tpu.ops import rope as jrope
from fish_tts_tpu.utils import audio as jaudio
from fish_tts_tpu.utils import quantize as jquant
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_TINY_VOCODER_CONFIG
from fish_tts_tpu_torch.models import tokenizer as ttok
from fish_tts_tpu_torch.models import vocoder as tvoc
from fish_tts_tpu_torch.ops import attention as tattn
from fish_tts_tpu_torch.ops import conv as tconv
from fish_tts_tpu_torch.ops import norms as tnorms
from fish_tts_tpu_torch.ops import rope as trope
from fish_tts_tpu_torch.utils import audio as taudio
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from fish_tts_tpu_torch.utils import quantize as tquant

OPS_TOL = 1e-5  # f32 ops: same math, other summation order


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# --- quantization: bit-equal ------------------------------------------------


def test_quantize_weight_rounds_half_to_even_and_clips():
    # amax 127 gives scale 1, so w/scale lands exactly on .5 ties
    w = np.array([[127.0, 62.5, -62.5, 63.5, 0.5, -1.5, -127.0, 1.0]], np.float32).T
    jq = jquant.quantize_weight(jnp.asarray(w), axis=0)
    tq = tquant.quantize_weight(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))
    assert tq["q"].numpy()[:, 0].tolist() == [127, 62, -62, 64, 0, -2, -127, 1]


def test_quantize_lm_params_bit_equal():
    """The port quantizes its (out, in) layout over the same contraction
    axis: q and s equal the JAX package's after the layout bridge."""
    params = jdual.init_params(jax.random.PRNGKey(0), TINY_CONFIG, jnp.float32)
    want = tckpt.from_jax_params(_np_tree(jquant.quantize_lm_params(params)))
    got = tquant.quantize_lm_params(tckpt.from_jax_params(_np_tree(params)))
    n = 0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=str(path))
        n += 1
    assert n > 20


# --- ops: f32 within 1e-5 ---------------------------------------------------


def _norm_case(rng):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    a = (rng.random((1, 32, 1)) + 0.5).astype(np.float32)
    xc = rng.standard_normal((2, 32, 7)).astype(np.float32)
    pairs = [
        (jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)), tnorms.rms_norm(_t(x), _t(w))),
        (jnorms.vocoder_rms_norm(jnp.asarray(x), jnp.asarray(w)),
         tnorms.vocoder_rms_norm(_t(x), _t(w))),
        (jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
         tnorms.layer_norm(_t(x), _t(w), _t(b))),
        (jnorms.snake(jnp.asarray(xc), jnp.asarray(a)), tnorms.snake(_t(xc), _t(a))),
    ]
    return pairs


def _rope_case(rng):
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    jt = jrope.precompute_freqs_cis(40, 16)
    tt = trope.precompute_freqs_cis(40, 16)
    pos = rng.integers(0, 40, (2, 6))
    return [
        (jt.astype(jnp.float32), tt.float()),
        (jrope.apply_rotary_emb(jnp.asarray(x), jt[:6]), trope.apply_rotary_emb(_t(x), tt[:6])),
        (jrope.apply_rotary_emb(jnp.asarray(x), jt[pos]),
         trope.apply_rotary_emb(_t(x), tt[torch.from_numpy(pos)])),
    ]


def _attention_case(rng):
    B, Hq, Hkv, T, S, D = 2, 4, 2, 5, 9, 16
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    off = np.array([3, 7])
    cache_bias = np.where(np.arange(S)[None, None, None] < off[:, None, None, None], 0.0,
                          float(np.finfo(np.float32).min)).astype(np.float32)
    cache_bias = np.broadcast_to(cache_bias, (B, 1, T, S)).copy()
    tpos = np.arange(T)
    jb = jattn.causal_bias(jnp.asarray(tpos), jnp.asarray(tpos))
    tb = _t(jb)
    jw = jattn.window_causal_bias(jnp.asarray(tpos), jnp.asarray(tpos), 2)
    tw = tattn.window_causal_bias(torch.from_numpy(tpos), torch.from_numpy(tpos), 2)
    qd = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return [
        (jw, tw),
        (jattn.gqa_attention_two_part(*map(jnp.asarray, (q, kc, vc, cache_bias, kn, vn)), jb),
         tattn.gqa_attention_two_part(*map(_t, (q, kc, vc, cache_bias, kn, vn)), tb)),
        (jattn.gqa_attention(*map(jnp.asarray, (q, kn, vn)), jb),
         tattn.gqa_attention(*map(_t, (q, kn, vn)), tb)),
        (jattn.attention(*map(jnp.asarray, (qd, kn, vn)), jw),
         tattn.attention(*map(_t, (qd, kn, vn)), tw)),
    ]


def _conv_case(rng):
    x = rng.standard_normal((2, 6, 23)).astype(np.float32)
    w = rng.standard_normal((8, 6, 7)).astype(np.float32)
    wg = rng.standard_normal((6, 1, 7)).astype(np.float32)
    wt = rng.standard_normal((6, 4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    out = []
    for stride, dil in ((1, 1), (1, 3), (2, 1), (4, 1)):
        out.append((jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        stride=stride, dilation=dil),
                    tconv.causal_conv1d(_t(x), _t(w), _t(b), stride=stride, dilation=dil)))
    out.append((jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(wg), groups=6),
                tconv.causal_conv1d(_t(x), _t(wg), groups=6)))
    for stride in (2, 4):
        out.append((jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(wt), stride=stride),
                    tconv.causal_conv_transpose1d(_t(x), _t(wt), stride=stride)))
    return out


@pytest.mark.parametrize("case", [_norm_case, _rope_case, _attention_case, _conv_case],
                         ids=["norms", "rope", "attention", "conv"])
def test_ops_match_jax(case):
    rng = np.random.default_rng(0)
    for i, (want, got) in enumerate(case(rng)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=OPS_TOL, atol=OPS_TOL, err_msg=str(i))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_two_part_attention_is_independent_of_the_read_window(dtype):
    """One decode step of three streams whose cache lengths differ, read at
    windows of 1, 2 and 4 cache blocks: a stream's output has the same bits
    at every window that covers its length (a pool's window is set by its
    longest stream), and matches the JAX package's one softmax over the
    joined keys."""
    rng = np.random.default_rng(7)
    B, Hq, Hkv, D, S = 3, 4, 2, 16, 4 * tattn.CACHE_BLOCK
    lens = np.array([5, tattn.CACHE_BLOCK - 1, tattn.CACHE_BLOCK + 9])
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, 1, D), (B, Hkv, 1, D), (B, Hkv, 1, D)))
    kc, vc = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    block = np.zeros((1, 1, 1, 1), np.float32)

    def run(W):
        bias = np.where(np.arange(W)[None, None, None] < lens[:, None, None, None], 0.0,
                        tattn.NEG_INF).astype(np.float32)
        args = (q, kc[:, :, :W], vc[:, :, :W], bias, kn, vn)
        got = tattn.gqa_attention_two_part(*(_t(a).to(dtype) for a in args[:3]), _t(bias),
                                           *(_t(a).to(dtype) for a in args[4:]), _t(block))
        want = jattn.gqa_attention_two_part(*map(jnp.asarray, args), jnp.asarray(block))
        return got, np.asarray(want)

    outs = {W: run(W) for W in (tattn.CACHE_BLOCK, 2 * tattn.CACHE_BLOCK, S)}
    for W, (got, want) in outs.items():
        covered = lens <= W
        for b in np.flatnonzero(covered):
            assert torch.equal(got[b], outs[S][0][b]), (W, b)
        tol = OPS_TOL if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().numpy()[covered], want[covered], rtol=tol,
                                   atol=tol)


# --- tokenizer: identical ids ------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_vocab") / "tokenizer.tiktoken"
    jtok.write_tiny_vocab(path)
    return (jtok.FishTokenizer(path, jtok.ALL_SPECIAL_TOKENS),
            ttok.FishTokenizer(path, ttok.ALL_SPECIAL_TOKENS))


@pytest.mark.parametrize("text", [
    "Hello, world! It's 3:45pm -- isn't it?\n\n  Tabs\tand  spaces ",
    "你好，世界。日本語のテキスト、한국어",
    "emoji 😀👍🏽 and ZWJ 👨‍👩‍👧 flags 🇯🇵",
    "<|im_start|>user\n<|text|>hi<|im_end|><|semantic:0|><|semantic:4095|><|semantic:4096|>",
    "",
], ids=["ascii", "cjk", "emoji", "specials", "empty"])
def test_tokenizer_ids_match(tokenizers, text):
    jt, tt = tokenizers
    assert tt.encode(text) == jt.encode(text)
    assert tt.encode(text, allowed_special=set()) == jt.encode(text, allowed_special=set())
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    assert (tt.semantic_begin_id, tt.semantic_end_id, tt.im_end_id) == (
        jt.semantic_begin_id, jt.semantic_end_id, jt.im_end_id)


# --- audio bytes: identical ---------------------------------------------------


def test_audio_bytes_match():
    audio = np.random.default_rng(2).uniform(-1.3, 1.3, 3000).astype(np.float32)
    assert taudio.to_wav_bytes(audio, 22050) == jaudio.to_wav_bytes(audio, 22050)
    assert taudio.to_pcm_bytes(audio[:1000] * 0.9) == jaudio.to_pcm_bytes(audio[:1000] * 0.9)


# --- codec decode ------------------------------------------------------------


VOCODER_TOL = 1e-4


def test_dac_decode_matches():
    """One random codec tree (the port's initializer, every leaf jittered so
    no bias or scale is trivially 0 or 1) goes through both decoders."""
    cfg = TINY_VOCODER_CONFIG
    assert dataclasses.asdict(T_TINY_VOCODER_CONFIG) == dataclasses.asdict(cfg)
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(1)
    tp = jax.tree_util.tree_map(
        lambda t: t + 0.02 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)),
        tvoc.init_vocoder_params(gen, T_TINY_VOCODER_CONFIG))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    codes = np.concatenate([
        rng.integers(0, cfg.semantic_codebook_size, (1, 1, 12)),
        rng.integers(0, cfg.residual_codebook_size, (1, cfg.n_residual_codebooks, 12)),
    ], axis=1).astype(np.int32)
    codes[0, 1, 3] = 10_000  # out of range: both clamp
    want = np.asarray(jax.jit(lambda p, c: jvoc.dac_decode(p, cfg, c))(jp, jnp.asarray(codes)))
    got = tvoc.dac_decode(tp, T_TINY_VOCODER_CONFIG, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (1, 1, 12 * cfg.frame_length)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=VOCODER_TOL, atol=VOCODER_TOL)
