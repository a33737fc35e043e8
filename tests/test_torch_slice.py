"""The port's whole slice against the JAX package's kernel path, at tiny
size with int8 f32 weights.

The JAX side runs ``decode.prefill_chunk`` + ``decode.decode_chunk`` with
``fast_kernel=True`` (Pallas in interpret mode, the slow head prepared as
the JAX engine does).  The port gets a noise source that replays the JAX
kernel path's Gumbel draws: per (slot, step) one ``gumbel(k_slow, (V,))``
and one ``gumbel(k_fast, (K-1, Vr))`` from ``fold_in(fold_in(key, slot),
step)``.  Frames must be equal; the codec's waveforms agree within 1e-4.

Equality holds while no sampling decision sits on its edge: the prefill
runs in XLA on one side and in PyTorch on the other, whose f32 sums differ
in the last bits, and the kernels round activations to bf16, which can turn
such a difference into a logit change of ~1e-4.  Base key 42 meets two
residual-book logits 5e-4 apart at the top-p boundary in frame 21 and keeps
one of them on each side; the key below meets no such tie in its frames.
"""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG, TINY_VOCODER_CONFIG
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models import vocoder as jvoc
from fish_tts_tpu.models.prompt import build_prompt as jbuild_prompt
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.ops import slow_stack as jslow
from fish_tts_tpu.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch import FishTTS
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.models import vocoder as tvoc
from fish_tts_tpu_torch.models.prompt import build_prompt as tbuild_prompt
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.testing import make_tiny_bundle
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

CFG = TINY_CONFIG
TEXT = "Hello world, this is a test."
SAMPLING = (0.7, 0.8, 1.1)
N0, N1 = 9, 16  # prefill frame + 9 + 16 = 26 frames
WAVE_TOL = 1e-4
BASE_KEY = jax.random.PRNGKey(0)


def replay_noise(key):
    """Noise source replaying the JAX kernel path's draws for base ``key``."""
    V, K, Vr = CFG.vocab_size, CFG.num_codebooks, CFG.residual_codebook_size

    @jax.jit
    def draw(slot, step):
        k = jax.random.fold_in(jax.random.fold_in(key, slot), step)
        ks, kf = jax.random.split(k)
        return (jax.random.gumbel(ks, (V,), jnp.float32),
                jax.random.gumbel(kf, (K - 1, Vr), jnp.float32))

    def noise(slot, step, draws):
        assert draws == tdecode.Draws(V, Vr, per_book=False)  # the kernel route's
        g_slow, g_fast = draw(jnp.uint32(slot), jnp.uint32(step))
        return torch.from_numpy(np.array(g_slow)), torch.from_numpy(np.array(g_fast))

    return noise


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice_vocab") / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    specials = tiny_special_tokens(CFG.codebook_size)
    jtok, ttok = JTokenizer(path, specials), TTokenizer(path, specials)
    ids = jdual.TokenIds(jtok.semantic_begin_id, jtok.semantic_end_id, jtok.im_end_id)
    jp = quantize_lm_params(jdual.init_params(jax.random.PRNGKey(0), CFG, jnp.float32))
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    enc = jbuild_prompt(jtok, TEXT, CFG.num_codebooks)
    np.testing.assert_array_equal(
        tbuild_prompt(ttok, TEXT, CFG.num_codebooks).values, enc.values)
    T = enc.values.shape[1]
    prompt = np.zeros((1, 1 + CFG.num_codebooks, 64), np.int32)
    prompt[0, :, :T] = enc.values

    # the JAX kernel path, as the JAX engine runs it
    jk = jslow.prepare_head(jp, CFG)
    rope = jdual.make_rope_tables(CFG)
    t, p, r = (jnp.float32(v) for v in SAMPLING)
    state = jdecode.init_state(jk, CFG, batch=1)
    state, f0, e0 = jdecode.prefill_chunk(
        jk, rope, state, jnp.asarray(prompt), jnp.asarray([T], jnp.int32), BASE_KEY,
        t, p, r, cfg=CFG, ids=ids, num_frames=N0, top_k=-1, kv_bucket_prefill=0,
        kv_bucket=128, fast_kernel=True)
    state, f1, e1 = jdecode.decode_chunk(
        jk, rope, state, BASE_KEY, t, p, r, cfg=CFG, ids=ids, num_frames=N1, top_k=-1,
        kv_bucket=128, fast_kernel=True, early_exit=True)
    frames = np.concatenate([np.asarray(f0), np.asarray(f1)], axis=1)[0]
    emitted = np.concatenate([np.asarray(e0), np.asarray(e1)], axis=1)[0]
    return dict(tp=tp, ttok=ttok, ids=ids, prompt=prompt, T=T, frames=frames,
                emitted=emitted)


def test_decode_frames_match_jax_kernel_path(setup):
    s = setup
    tp, ids = s["tp"], s["ids"]
    rope = tdual.make_rope_tables(T_CFG)
    noise = replay_noise(BASE_KEY)
    state = tdecode.init_state(tp, T_CFG, batch=1)
    state, f0, e0 = tdecode.prefill_chunk(
        tp, rope, state, torch.from_numpy(s["prompt"]), torch.tensor([s["T"]]), noise,
        *SAMPLING, cfg=T_CFG, ids=ids, num_frames=N0, kv_bucket_prefill=0, kv_bucket=128)
    state, f1, e1 = tdecode.decode_chunk(
        tp, rope, state, noise, *SAMPLING, cfg=T_CFG, ids=ids, num_frames=N1,
        kv_bucket=128, early_exit=True)
    frames = torch.cat([f0, f1], dim=1)[0].numpy()
    emitted = torch.cat([e0, e1], dim=1)[0].numpy()
    assert frames.shape[0] == 1 + N0 + N1 >= 20
    np.testing.assert_array_equal(emitted, s["emitted"])
    np.testing.assert_array_equal(frames[emitted], s["frames"][s["emitted"]])
    # the frames are not degenerate
    assert len(set(frames[:, 0].tolist())) > 3


def test_engine_codes_and_waveform_match(setup):
    """GenerationEngine.generate_long (its own chunking) yields the JAX
    frames' codes, final frame stripped; both codecs turn them into the same
    waveform."""
    s = setup
    max_new = 1 + N0 + N1 - 1
    engine = GenerationEngine(s["tp"], T_CFG, s["ttok"])
    out = list(engine.generate_long(TEXT, max_new_tokens=max_new, temperature=SAMPLING[0],
                                    top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                                    noise=replay_noise(BASE_KEY)))
    assert [o.action for o in out] == ["sample", "next"]
    frames = s["frames"][s["emitted"]][:max_new]
    eos = np.flatnonzero(frames[:, 0] == s["ids"].im_end)
    if eos.size:
        frames = frames[:eos[0] + 1]
    want = np.maximum(frames[:-1, 1:].T, 0)
    np.testing.assert_array_equal(out[0].codes, want)

    gen = torch.Generator().manual_seed(9)
    rng = np.random.default_rng(2)
    tvp = jax.tree_util.tree_map(
        lambda t: t + 0.02 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)),
        tvoc.init_vocoder_params(gen, T_VCFG))
    jvp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tvp)
    codes = out[0].codes[None].astype(np.int32)
    wave_j = np.asarray(jax.jit(lambda p, c: jvoc.dac_decode(p, TINY_VOCODER_CONFIG, c))(
        jvp, jnp.asarray(codes)))
    wave_t = tvoc.dac_decode(tvp, T_VCFG, torch.from_numpy(codes)).numpy()
    assert wave_t.shape == (1, 1, codes.shape[-1] * T_VCFG.frame_length)
    np.testing.assert_allclose(wave_t, wave_j, rtol=WAVE_TOL, atol=WAVE_TOL)


def test_synthesize_returns_valid_wav():
    tts = FishTTS(device="cpu", precision="int8", warmup=True,
                  _testing_bundle=make_tiny_bundle(0))
    wav = tts.synthesize("Hello world", max_tokens=12)
    with wave.open(io.BytesIO(wav)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 44100)
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16)
    fl = T_VCFG.frame_length
    assert 0 < n <= 11 * fl and n % fl == 0 and pcm.size == n


def test_unported_options_raise():
    """Every option constructs, multi-device sharding included (a mesh size
    below 1 raises); the default device is the card."""
    assert EngineConfig(tp_size=4, dp_size=2).tp_size == 4
    for field in ("tp_size", "dp_size"):
        with pytest.raises(ValueError):
            EngineConfig(**{field: 0})
    EngineConfig(sample_top_k=8, approx_top_k=True, fast_kernel=False)
    assert dataclasses.asdict(EngineConfig())["sample_top_k"] == -1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            FishTTS(_testing_bundle=make_tiny_bundle(0))  # device="cuda" by default


def test_default_noise_does_not_depend_on_chunking():
    """The default noise source draws per (slot, step), so the frames do not
    depend on how the decode is cut into chunks."""
    from fish_tts_tpu_torch.engine.decode import GumbelNoise
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = make_tiny_bundle(0)
    params = quantize_lm_params(params)
    codes = []
    for first, chunk, batch in ((10, 20, 100), (4, 4, 8)):
        engine = GenerationEngine(params, cfg, tok, EngineConfig(
            first_chunk=first, decode_chunk=chunk, batch_chunk=batch))
        out = engine.generate_long(TEXT, max_new_tokens=30, temperature=SAMPLING[0],
                                   top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                                   noise=GumbelNoise(7, cfg, "cpu"))
        codes.append(next(out).codes)
    assert codes[0].shape == (cfg.num_codebooks, 29)
    np.testing.assert_array_equal(codes[0], codes[1])
