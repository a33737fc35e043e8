"""``fish_tts_tpu_torch.models``: the export surface and the object-style
handles against the JAX package's, at tiny size on the CPU, with the small
pieces around them (tokenizer sizes, ``param_count``, ``quantized_bytes``,
the audio loaders).

Tolerances: the LM handles in f32 within 1e-4 of the largest magnitude
(sums in another order); the codec's latents and audio as
``test_torch_encoder`` and ``test_torch_stream`` hold them (codes equal but
at a near tie of the port's own similarities, audio within
``AUDIO_TOL``/``PEAK_TOL``).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder import FL, audio
from test_torch_encoder import hold_codes as hold_vq_codes
from test_torch_stream import assert_audio_close, loud_vocoder, random_codes
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

import fish_tts_tpu.models as jmodels
from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.testing import write_tiny_model_dir
from fish_tts_tpu.utils import audio as jaudio
from fish_tts_tpu.utils.quantize import quantize_lm_params as jquantize
from fish_tts_tpu.utils.quantize import quantized_bytes as jquantized_bytes
import fish_tts_tpu_torch.models as tmodels
from fish_tts_tpu_torch import FishTTS
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.testing import make_tiny_bundle
from fish_tts_tpu_torch.utils import audio as taudio
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params, quantized_bytes

LM_TOL = 1e-4  # of the largest magnitude
TEXT = "The handles drive the engine."


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_tiny_model_dir(tmp_path_factory.mktemp("api_model"), seed=0)


def test_models_export_surface():
    assert set(tmodels.__all__) == set(jmodels.__all__)
    for name in tmodels.__all__:
        assert getattr(tmodels, name) is not None
    assert tmodels.GenerateResponse.__module__ == "fish_tts_tpu_torch.engine.generate"
    with pytest.raises(AttributeError):
        tmodels.NotAnExport  # noqa: B018


def assert_same(got, want) -> None:
    """Two trees of tensors: the same keys, dtypes and values."""
    got, want = tckpt.flatten_params(got), tckpt.flatten_params(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].float().numpy(), w.float().numpy(), err_msg=k)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("overrides", [{}, {"fast_dim": 32, "fast_n_head": 2,
                                            "fast_n_local_heads": 1,
                                            "fast_intermediate_size": 96}],
                         ids=["tiny", "fast_dim"])
def test_dual_ar_transformer_matches_jax(model_dir, overrides):
    """``forward_generate`` (a prompt, then one cached step),
    ``forward_generate_fast`` (with the ``fast_project_in`` bridge when
    ``fast_dim != dim``), ``lm_logits``, ``embed`` and ``setup_caches``
    against the JAX handle on the same f32 weights."""
    jcfg = dataclasses.replace(J_CFG, **overrides)
    tcfg = dataclasses.replace(T_CFG, **overrides)
    jp = jdual.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    jm = jmodels.DualARTransformer(jcfg, jp, JTokenizer.from_pretrained(model_dir))
    tm = tmodels.DualARTransformer(tcfg, tp, TTokenizer.from_pretrained(model_dir))
    assert dataclasses.astuple(tm.token_ids()) == dataclasses.astuple(jm.token_ids())

    rng = np.random.default_rng(3)
    T, S = 7, tcfg.max_seq_len
    inp = rng.integers(0, tcfg.codebook_size, (1, 1 + tcfg.num_codebooks, T)).astype(np.int32)
    inp[0, 0] = rng.integers(0, tcfg.vocab_size, T)
    inp[0, 0, 3] = jm.token_ids().semantic_begin + 2  # one semantic position
    np.testing.assert_allclose(tm.embed(torch.from_numpy(inp)).numpy(),
                               np.asarray(jm.embed(jnp.asarray(inp))), rtol=0, atol=1e-6)
    NEG = float(np.finfo(np.float32).min)
    t_idx = np.arange(T)
    block = np.where(t_idx[None, :] <= t_idx[:, None], 0.0, NEG)[None, None].astype(np.float32)
    cache_bias = np.full((1, 1, T, S), NEG, np.float32)
    pos = np.arange(T, dtype=np.int32)[None]
    outs = []
    for m, to in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        kv = m.setup_caches(batch=1)
        assert tuple(kv["k"].shape) == (tcfg.n_layer, 1, tcfg.n_local_heads, S, tcfg.head_dim)
        h, kv = m.forward_generate(to(inp), to(pos), kv, to(cache_bias), to(block))
        # one more token at position T, reading the cache the prompt wrote
        step_bias = np.where(np.arange(S) < T, 0.0, NEG)[None, None, None].astype(np.float32)
        h1, _ = m.forward_generate(to(inp[:, :, :1]), to(np.full((1, 1), T, np.int32)), kv,
                                   to(step_bias), to(np.zeros((1, 1, 1, 1), np.float32)))
        if m is tm:
            fast_cache, fast_pos = tdual.new_fast_cache(tp, tcfg, 1), 0
        else:
            fast_cache, fast_pos = jdual.new_fast_cache(jp, jcfg, 1), jnp.int32(0)
        fast, _ = m.forward_generate_fast(h[:, -1:], fast_pos, fast_cache)
        outs.append([np.asarray(x, np.float32) for x in (h, m.lm_logits(h), h1, fast)])
    for want, got in zip(*outs):
        assert got.shape == want.shape
        assert rel(got, want) <= LM_TOL


def test_dual_ar_from_pretrained_both_formats(model_dir, tmp_path):
    """``from_pretrained`` on the native directory and on a ``model.pth``
    one of the same weights: the JAX handle's parameters, transposed to
    ``(out, in)``; without weights it raises; ``device`` defaults to the
    card."""
    from fish_tts_tpu_torch import testing

    want = jmodels.DualARTransformer.from_pretrained(model_dir)
    native = tmodels.DualARTransformer.from_pretrained(model_dir, device="cpu")
    d = shutil.copytree(model_dir, tmp_path / "pth",
                        ignore=shutil.ignore_patterns("lm.safetensors"))
    torch.save(testing.to_reference_lm_state_dict(native.params, native.config,
                                                  dtype=torch.float32), d / "model.pth")
    pth = tmodels.DualARTransformer.from_pretrained(d, device="cpu")
    expect = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, want.params))
    for m in (native, pth):
        assert dataclasses.asdict(m.config) == dataclasses.asdict(want.config)
        assert m.tokenizer.total_vocab_size == want.tokenizer.total_vocab_size
        assert_same(m.params, expect)
    (d / "model.pth").unlink()
    with pytest.raises(FileNotFoundError, match="No LM weights"):
        tmodels.DualARTransformer.from_pretrained(d, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmodels.DualARTransformer.from_pretrained(model_dir)


@pytest.fixture(scope="module")
def dacs():
    tp, jp = loud_vocoder()
    return tmodels.DAC(T_VCFG, tp), jmodels.DAC(J_VCFG, jp)


def test_dac_encode_and_decode_match_jax(dacs):
    tdac, jdac = dacs
    assert (tdac.sample_rate, tdac.frame_length) == (jdac.sample_rate, jdac.frame_length)
    T = 3 * FL + 37
    x = audio(5, T)
    codes, lengths = tdac.encode(torch.from_numpy(x))
    jcodes, jlengths = jdac.encode(jnp.asarray(x))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    padded = np.pad(x, ((0, 0), (0, 0), (0, codes.shape[-1] * FL - T)))
    latent = tvoc_latent(tdac, padded)
    hold_vq_codes(codes, jcodes, tdac.params, latent)

    c = random_codes(4, seed=2, batch=2)
    wave, n = tdac.decode(torch.from_numpy(c))
    jwave, jn = jdac.decode(jnp.asarray(c))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert_audio_close(wave.numpy(), np.asarray(jwave))
    lat = tdac.quantizer.from_codes(torch.from_numpy(c))
    assert rel(lat.numpy(), np.asarray(jdac.quantizer.decode(jnp.asarray(c)))) <= LM_TOL
    assert tmodels.DAC().quantizer is None


def tvoc_latent(dac, padded):
    from fish_tts_tpu_torch.models import vocoder as tvoc

    return tvoc.encoder_forward(dac.params["encoder"], T_VCFG, torch.from_numpy(padded)).numpy()


def test_window_limited_transformer_matches_jax(dacs):
    tdac, jdac = dacs
    tcfg = T_VCFG.quantizer_transformer
    x = np.random.default_rng(1).standard_normal((1, T_VCFG.quantizer_input_dim, 12))
    x = x.astype(np.float32)
    got = tmodels.WindowLimitedTransformer(tcfg, tdac.params["quantizer"]["pre"], 4)(
        torch.from_numpy(x))
    want = jmodels.WindowLimitedTransformer(J_VCFG.quantizer_transformer,
                                            jdac.params["quantizer"]["pre"], 4)(jnp.asarray(x))
    assert rel(got.numpy(), want) <= LM_TOL


def test_dac_from_pretrained_both_formats(model_dir, tmp_path):
    from fish_tts_tpu_torch import testing

    native = tmodels.DAC.from_pretrained(model_dir, config=T_VCFG, device="cpu")
    d = tmp_path / "codec"
    d.mkdir()
    torch.save(testing.to_reference_codec_state_dict(native.params, T_VCFG, naming=None),
               d / "codec.pth")
    for handle in (tmodels.DAC.from_pretrained(d, config=T_VCFG, device="cpu"),
                   tmodels.DAC.from_pretrained(d / "codec.pth", config=T_VCFG, device="cpu")):
        assert_same(handle.params, native.params)


def codes_of(responses) -> np.ndarray:
    responses = list(responses)
    assert responses[-1].action == "next"
    return np.concatenate([r.codes for r in responses if r.action == "sample"], axis=1)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_init_model_and_generate_long(model_dir, precision):
    """``init_model`` builds the engine ``FishTTS`` builds (its parameters
    to the bit); the module-level ``generate_long`` gives the codes of the
    engine's own ``generate_long`` with the same seed."""
    engine, decode_fn = tmodels.init_model(model_dir, device="cpu", precision=precision)
    assert decode_fn == engine.generate_long
    tts = FishTTS(model_dir=model_dir, device="cpu", precision=precision, warmup=False)
    assert_same(engine.params, tts.engine.params)
    kw = dict(max_new_tokens=16, temperature=0.7, top_p=0.8, repetition_penalty=1.1)
    got = codes_of(tmodels.generate_long(model=engine, tokenizer=engine.tokenizer, text=TEXT,
                                         decode_one_token=None, **kw))
    want = codes_of(tts.engine.generate_long(TEXT, noise=tts.engine._seed_noise(0), **kw))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > 3


def test_init_model_refusals(model_dir):
    with pytest.raises(ValueError, match="precision"):
        tmodels.init_model(model_dir, device="cpu", precision="int4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmodels.init_model(model_dir)  # device="cuda" by default


def test_tokenizer_sizes_match_jax(model_dir):
    j, t = JTokenizer.from_pretrained(model_dir), TTokenizer.from_pretrained(model_dir)
    assert (t.num_special_tokens, t.total_vocab_size, t.vocab_size) == (
        j.num_special_tokens, j.total_vocab_size, j.vocab_size)
    assert t.total_vocab_size == t.vocab_size + t.num_special_tokens


def test_param_count_and_quantized_bytes_match_jax():
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, dtype=jnp.float32)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    assert tdual.param_count(tp) == jdual.param_count(jp)
    assert quantized_bytes(tp) == jquantized_bytes(jp)
    for cast_j, cast_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jq = jquantize(jdual.cast_params(jp, cast_j))
        tq = quantize_lm_params(tdual.cast_params(tp, cast_t))
        assert tdual.param_count(tq) == jdual.param_count(jq)
        assert quantized_bytes(tq) == jquantized_bytes(jq)
    _, bundle_params, *_ = make_tiny_bundle(0)
    assert tdual.param_count(bundle_params) == tdual.param_count(tp)


def test_load_audio_bytes(tmp_path, monkeypatch):
    """A ``.wav`` file's bytes as they are, equal to JAX's; any other file
    needs ffmpeg, and without it both packages raise the same
    RuntimeError."""
    wav = tmp_path / "a.wav"
    wav.write_bytes(taudio.to_wav_bytes(np.linspace(-0.5, 0.5, 441, dtype=np.float32)))
    assert taudio.load_audio_bytes(wav) == jaudio.load_audio_bytes(wav) == wav.read_bytes()
    other = tmp_path / "a.mp3"
    other.write_bytes(b"not audio")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as jerr:
        jaudio.load_audio_bytes(other)
    with pytest.raises(RuntimeError) as terr:
        taudio.load_audio_bytes(other)
    assert str(terr.value) == str(jerr.value) and "ffmpeg" in str(terr.value)
