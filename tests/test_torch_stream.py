"""Streaming synthesis in the port against the JAX package, at tiny size on
the CPU: the audio readers and headers, the stateful codec decode
(``models/vocoder_stream``) piece by piece and chunk by chunk, the port's
streamed decode against its own joint ``dac_decode``, and
``FishTTS.synthesize_stream`` (chunk framing, the EOS frame, both codec
modes, its errors), and the engine's streamed frames against the JAX
engine's ``generate_long(streaming=True)`` with the same noise.

Tolerances: the codec in fp32 holds the JAX tests' ``atol=1e-4, rtol=1e-3``
(``AUDIO_TOL``) and, so that near-silent audio cannot pass it by default,
1e-4 of the waveform's peak (``PEAK_TOL``); the conv pieces agree within
``OPS_TOL`` (f32 sums in another order); PCM within one int16 step; codes
are equal, a differing one excused only at a knife edge of the port's own
decision (``testing.sample_decision_margins``, logits that may each move by
``LOGIT_TOL`` of their largest magnitude).
"""

import dataclasses
import functools
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.engine.generate import GenerationEngine as JEngine
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models import vocoder_stream as jvs
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.utils import audio as jaudio
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine import sampling as tsampling
from fish_tts_tpu_torch.engine.generate import GenerationEngine as TEngine
from fish_tts_tpu_torch.models import vocoder as tvoc
from fish_tts_tpu_torch.models import vocoder_stream as tvs
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.ops import conv as tconv
from fish_tts_tpu_torch.utils import audio as taudio
from fish_tts_tpu_torch.utils import checkpoint as tckpt

AUDIO_TOL = dict(atol=1e-4, rtol=1e-3)
PEAK_TOL = 1e-4
OPS_TOL = 1e-5
LOGIT_TOL = 1e-5
SAMPLING = (0.7, 0.8, 1.1)
TEXT = "Stream this sentence, please."


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module that uses this fixture: its tiny
    shapes gain nothing from more, and the suite runs several workers on
    the same cores, where threads that outnumber the cores slow every small
    op several times over.  Test modules of the port import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loud_vocoder(seed: int = 1):
    """The tiny codec with every leaf jittered by 0.05 (the initializer's
    zero biases and small weights give near-silent audio): (port tree, the
    same values as a JAX tree)."""
    rng = np.random.default_rng(seed)
    tp = jax.tree_util.tree_map(
        lambda t: t + 0.05 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)),
        tvoc.init_vocoder_params(torch.Generator().manual_seed(seed), T_VCFG))
    return tp, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)


@pytest.fixture(scope="module")
def vparams():
    return loud_vocoder()


def random_codes(T: int, seed: int, batch: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, T_VCFG.semantic_codebook_size, (batch, 1, T)),
        rng.integers(0, T_VCFG.residual_codebook_size, (batch, T_VCFG.n_residual_codebooks, T)),
    ], axis=1).astype(np.int32)


def assert_audio_close(got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **AUDIO_TOL)
    peak = np.abs(want).max()
    assert peak > 1e-2, "the waveform is near silent"
    assert np.abs(got - want).max() <= PEAK_TOL * peak


def port_stream(params, cfg, codes: np.ndarray, splits) -> tuple[np.ndarray, dict]:
    """The port's stateful decode of ``codes`` cut into ``splits``: (the
    concatenated audio, the final state)."""
    st = tvs.init_decode_state(params, cfg, batch=codes.shape[0])
    out, t0 = [], 0
    for n in splits:
        st, audio = tvs.decode_chunk(params, cfg, st, torch.from_numpy(codes[:, :, t0:t0 + n]))
        out.append(audio.numpy())
        t0 += n
    assert t0 == codes.shape[-1]
    return np.concatenate(out, axis=-1), st


def leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict/list tree in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{path}/{i}")]
    return [(path, np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree))]


# --- audio readers and headers ---------------------------------------------


def _wav(audio: np.ndarray, rate: int, width: int, channels: int) -> bytes:
    scale = {1: 127, 2: 32767, 4: 2**31 - 1}[width]
    ints = np.round(np.repeat(audio[:, None], channels, axis=1) * scale)
    data = (ints + 128).astype(np.uint8) if width == 1 else ints.astype(f"<i{width}")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("rate,width,channels", [(22050, 2, 1), (44100, 1, 2), (16000, 4, 1),
                                                 (48000, 2, 2)])
def test_read_wav_matches_jax(rate, width, channels):
    """``read_wav`` at every sample width, mono and stereo, resampled or not,
    gives the JAX package's samples (its scipy path against the port's
    numpy Fourier resampling: float64 in both, within 1e-6)."""
    audio = np.sin(np.linspace(0, 60, 1999)) * np.random.default_rng(3).uniform(0.2, 0.9, 1999)
    wav = _wav(audio, rate, width, channels)
    got, want = taudio.read_wav(wav), jaudio.read_wav(wav)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wav_headers_match_jax():
    for rate in (44100, 24000):
        assert taudio.streaming_wav_header(rate) == jaudio.streaming_wav_header(rate)
        assert taudio.wav_header(rate, 4096) == jaudio.wav_header(rate, 4096)
    head = taudio.wav_header(44100, 8)
    with wave.open(io.BytesIO(head + b"\x01\x00" * 4)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == \
            (1, 2, 44100, 4)


# --- the stateful codec decode ------------------------------------------------


def test_init_decode_state_tree_matches_jax(vparams):
    """The fresh state has the JAX tree leaf for leaf: the same paths,
    shapes, dtypes and values (zeros, the window's positions -1)."""
    tp, jp = vparams
    got = leaves(tvs.init_decode_state(tp, T_VCFG, batch=2))
    want = leaves(jax.tree_util.tree_map(np.asarray, jvs.init_decode_state(jp, J_VCFG, batch=2)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# (op, kernel, stride or dilation): stride-1 convs at the residual units'
# dilations and a pointwise one; transposed convs with a spill (k = 2s, the
# decoder's) and without (k = s, the quantizer's upsampling).
CONV_CASES = [("conv", 7, 1), ("conv", 7, 3), ("conv", 7, 9), ("conv", 1, 1),
              ("tconv", 8, 4), ("tconv", 2, 2)]


@pytest.mark.parametrize("op,k,s", CONV_CASES)
def test_stream_conv_pieces_match_jax(op, k, s):
    """``stream_conv``/``stream_tconv`` over chunks of 5, 9 and 3 frames
    against the JAX functions on the same random inputs: each chunk's output
    and the carried tail or spill within OPS_TOL.  Together the chunks give
    the joint causal op; a transposed conv's spill carries no bias (the
    bias lands once, on emitted samples)."""
    rng = np.random.default_rng(k * 10 + s)
    C = 6
    x = rng.standard_normal((1, C, 17)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    w = rng.standard_normal((C, C, k)).astype(np.float32) * 0.3
    t = torch.from_numpy
    if op == "conv":
        tail = np.zeros((1, C, (k - 1) * s), np.float32)
        step_t = lambda st, xc, bias: tvs.stream_conv(st, t(xc), t(w), bias, dilation=s)  # noqa: E731
        step_j = lambda st, xc: jvs.stream_conv(st, jnp.asarray(xc), jnp.asarray(w),  # noqa: E731
                                                jnp.asarray(b), dilation=s)
        joint = tconv.causal_conv1d(t(x), t(w), t(b), dilation=s)
    else:
        tail = np.zeros((1, C, k - s), np.float32)
        step_t = lambda st, xc, bias: tvs.stream_tconv(st, t(xc), t(w), bias, stride=s)  # noqa: E731
        step_j = lambda st, xc: jvs.stream_tconv(st, jnp.asarray(xc), jnp.asarray(w),  # noqa: E731
                                                 jnp.asarray(b), stride=s)
        joint = tconv.causal_conv_transpose1d(t(x), t(w), t(b), stride=s)
    st_t, st_j, outs, t0 = t(tail), jnp.asarray(tail), [], 0
    for n in (5, 9, 3):
        xc = x[:, :, t0:t0 + n]
        st_unbiased, _ = step_t(st_t, xc, None)
        st_t, y_t = step_t(st_t, xc, t(b))
        st_j, y_j = step_j(st_j, xc)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=OPS_TOL, atol=OPS_TOL)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=OPS_TOL, atol=OPS_TOL)
        assert torch.equal(st_unbiased, st_t)  # the carried state does not see the bias
        outs.append(y_t)
        t0 += n
    np.testing.assert_allclose(torch.cat(outs, dim=-1).numpy(), joint.numpy(), rtol=OPS_TOL,
                               atol=OPS_TOL)


@pytest.mark.parametrize("splits", [[10, 20, 20, 7], [1, 1, 30, 25]])
def test_decode_chunk_matches_jax(vparams, splits):
    """The port's ``decode_chunk`` against JAX's, chunk by chunk from the
    same codes (fp32): each chunk's audio and the final state's every leaf
    within AUDIO_TOL."""
    tp, jp = vparams
    codes = random_codes(sum(splits), seed=2)
    st_t = tvs.init_decode_state(tp, T_VCFG)
    st_j = jvs.init_decode_state(jp, J_VCFG)
    dec_j = jax.jit(lambda p, s, c: jvs.decode_chunk(p, J_VCFG, s, c))
    t0 = 0
    for n in splits:
        chunk = codes[:, :, t0:t0 + n]
        st_t, a_t = tvs.decode_chunk(tp, T_VCFG, st_t, torch.from_numpy(chunk))
        st_j, a_j = dec_j(jp, st_j, jnp.asarray(chunk))
        assert a_t.shape == (1, 1, n * T_VCFG.frame_length)
        assert_audio_close(a_t.numpy(), np.asarray(a_j))
        t0 += n
    got, want = leaves(st_t), leaves(jax.tree_util.tree_map(np.asarray, st_j))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=path, **AUDIO_TOL)


def _small_block(cfg):
    return dataclasses.replace(cfg, quantizer_transformer=dataclasses.replace(
        cfg.quantizer_transformer, block_size=16))


STREAM_CASES = {
    # uneven chunks
    "chunks": (lambda cfg: cfg, 37, [10, 20, 7]),
    # early positions leave the 128-frame window
    "past the window": (lambda cfg: cfg, T_VCFG.quantizer_window + 13,
                        [16] * 8 + [13]),
    # positions past a 16-row rotary table: angles computed on the fly
    "past block_size": (_small_block, 45, [10, 20, 15]),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streamed_equals_joint(vparams, case):
    """The port's streamed decode, concatenated, against its own joint
    ``dac_decode`` of the whole sequence, within AUDIO_TOL."""
    make, T, splits = STREAM_CASES[case]
    cfg = make(T_VCFG)
    tp, _ = vparams
    codes = random_codes(T, seed=4)
    streamed, st = port_stream(tp, cfg, codes, splits)
    joint = tvoc.dac_decode(tp, cfg, torch.from_numpy(codes)).numpy()
    assert_audio_close(streamed, joint)
    assert int(st["post"]["off"][0]) == T
    W = T_VCFG.quantizer_window
    assert st["post"]["pos"][0].tolist() == [max(p, -1) for p in range(T - W, T)]


def test_stream_wlt_beyond_rope_table(vparams):
    """Positions past ``block_size``: the port's ``stream_wlt`` against
    JAX's (OPS_TOL), against the same positions inside an enlarged table
    and against a stream at position 0 (windowed attention does not see
    the offset), both within the JAX test's 2e-3 (angle rounding)."""
    tp, jp = vparams
    tcfg, window = T_VCFG.quantizer_transformer, T_VCFG.quantizer_window
    x = np.random.default_rng(7).standard_normal((1, T_VCFG.quantizer_input_dim, 8))
    x = x.astype(np.float32)

    def run(tc, delta):
        st = tvs.init_wlt_state(tp["quantizer"]["post"], tc, window, 1, torch.float32)
        st["off"] += delta
        return tvs.stream_wlt(st, tp["quantizer"]["post"], tc, window,
                              torch.from_numpy(x))[1].numpy()

    delta = tcfg.block_size + 37
    got = run(tcfg, delta)
    jst = jvs.init_wlt_state(jp["quantizer"]["post"], tcfg, window, 1, jnp.float32)
    jst["off"] = jst["off"] + delta
    want = np.asarray(jvs.stream_wlt(jst, jp["quantizer"]["post"], tcfg, window,
                                     jnp.asarray(x))[1])
    np.testing.assert_allclose(got, want, rtol=OPS_TOL, atol=OPS_TOL)
    oracle = run(dataclasses.replace(tcfg, block_size=8192), delta)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got, run(tcfg, 0), rtol=0, atol=2e-3)


# --- FishTTS.synthesize_stream ---------------------------------------------------


@pytest.fixture(scope="module")
def tts(vparams):
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(0)
    return FishTTS(device="cpu", precision="fp32", warmup=False,
                   _testing_bundle=(cfg, params, tok, vcfg, vparams[0]))


class Frames:
    """Records the full frames (slow token and codes) the engine computes,
    in order, from its prefill and its decode calls."""

    def __init__(self, tts, monkeypatch):
        self.frames: list[np.ndarray] = []
        engine = tts.engine
        prefill, decode = tdecode.prefill, engine._decode

        def rec_prefill(*a, **k):
            state, first = prefill(*a, **k)
            self.frames.append(first.numpy())
            return state, first

        def rec_decode(*a, **k):
            frames, emitted = decode(*a, **k)
            self.frames.extend(frames[0].numpy())
            return frames, emitted

        monkeypatch.setattr(tdecode, "prefill", rec_prefill)
        monkeypatch.setattr(engine, "_decode", rec_decode)

    def tokens(self) -> np.ndarray:
        return np.concatenate([np.atleast_2d(f) for f in self.frames])[:, 0]


def stream(tts, seed: int, max_tokens: int, **kw) -> tuple[list[bytes], np.ndarray]:
    """One ``synthesize_stream`` with the engine reseeded: (the PCM chunks,
    the codes the engine streamed (K, n))."""
    codes, gen_long = [], tts.engine.generate_long

    def spy(*a, **k):
        for r in gen_long(*a, **k):
            if r.action == "sample":
                codes.append(r.codes)
            yield r

    tts.engine.reseed(seed)
    tts.engine.generate_long = spy
    try:
        chunks = list(tts.synthesize_stream(TEXT, max_tokens=max_tokens, **kw))
    finally:
        del tts.engine.generate_long
    return chunks, np.concatenate(codes, axis=1)


def batch_codes(tts, seed: int, max_tokens: int) -> np.ndarray:
    tts.engine.reseed(seed)
    out = tts.engine.generate_long(TEXT, max_new_tokens=max_tokens, temperature=SAMPLING[0],
                                   top_p=SAMPLING[1], repetition_penalty=SAMPLING[2])
    return next(out).codes


def frames_of(chunks, tts) -> list[int]:
    fl = tts._vocoder_cfg.frame_length
    assert all(len(c) % (2 * fl) == 0 for c in chunks)
    return [len(c) // (2 * fl) for c in chunks]


def test_stream_chunk_framing(tts):
    """The first flush at 10 frames, then 20 each, then the rest; the
    streamed codes are the non-streamed call's with the same seed plus its
    stripped final frame."""
    chunks, codes = stream(tts, 5, 47)
    sizes = frames_of(chunks, tts)
    n = codes.shape[1]
    assert sum(sizes) == n and n > 30
    assert sizes == [10] + [20] * ((n - 10) // 20) + ([(n - 10) % 20] if (n - 10) % 20 else [])
    batch = batch_codes(tts, 5, 47)
    assert batch.shape[1] == n - 1
    np.testing.assert_array_equal(codes[:, :-1], batch)


def test_stream_yields_the_eos_frame(tts, monkeypatch):
    """With an EOS forced mid-stream (``ids.im_end`` set to a slow token the
    stream samples at frame ``stop``), the stream yields frames 0 .. stop,
    the EOS frame included, in chunks of 10 then 20; the non-streamed call
    strips it."""
    rec = Frames(tts, monkeypatch)
    stream(tts, 6, 60)
    tokens = rec.tokens()
    stop = next(k for k in range(12, 40)
                if tokens.tolist().index(tokens[k]) == k and tokens[k] != tokens[0])
    monkeypatch.setattr(tts.engine, "ids", dataclasses.replace(tts.engine.ids,
                                                               im_end=int(tokens[stop])))
    chunks, codes = stream(tts, 6, 60)
    sizes = frames_of(chunks, tts)
    assert codes.shape[1] == sum(sizes) == stop + 1
    assert sizes[0] == 10 and all(s == 20 for s in sizes[1:-1]) and 0 < sizes[-1] <= 20
    assert batch_codes(tts, 6, 60).shape[1] == stop


def test_stateful_pcm_equals_joint_decode(tts):
    """The stateful stream's PCM, concatenated, equals the joint decode of
    the streamed codes within one int16 step."""
    chunks, codes = stream(tts, 7, 47)
    got = np.frombuffer(b"".join(chunks), np.int16).astype(np.int32)
    want = np.frombuffer(tts._decode_to_pcm(codes), np.int16).astype(np.int32)
    assert got.shape == want.shape and np.abs(want).max() > 300
    assert np.abs(got - want).max() <= 1


def test_context_mode_keeps_the_framing(tts):
    """``vocoder_mode="context"`` gives the same total samples for
    ``context_frames`` 0 and 8, and the stateful mode's, from the same
    codes; with 0 frames of context its first chunk is the stateful one's."""
    ctx0, codes0 = stream(tts, 8, 36, vocoder_mode="context", context_frames=0)
    ctx8, codes8 = stream(tts, 8, 36, vocoder_mode="context", context_frames=8)
    stateful, codes = stream(tts, 8, 36)
    np.testing.assert_array_equal(codes0, codes)
    np.testing.assert_array_equal(codes8, codes)
    assert len(b"".join(ctx0)) == len(b"".join(ctx8)) == len(b"".join(stateful)) > 0
    assert frames_of(ctx8, tts) == frames_of(stateful, tts)
    first = np.frombuffer(ctx0[0], np.int16).astype(np.int32)
    assert np.abs(first - np.frombuffer(stateful[0], np.int16)).max() <= 1


def test_stream_rejects_unknown_kwargs(tts):
    with pytest.raises(TypeError):
        next(tts.synthesize_stream("x", max_new_tokens=8))
    with pytest.raises(TypeError):
        next(tts.synthesize_stream("x", pipeline=True))
    with pytest.raises(ValueError):
        next(tts.synthesize_stream("x", vocoder_mode="joint"))
    chunks = list(tts.synthesize_stream("explicit kwargs", max_tokens=12, temperature=0.7,
                                        top_p=0.8, repetition_penalty=1.1))
    assert chunks


@pytest.mark.parametrize("mode", ["stateful", "context"])
def test_vocoderless_stream_raises_clean_error(mode):
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(7)
    tts = FishTTS(device="cpu", precision="fp32", warmup=False,
                  _testing_bundle=(cfg, params, tok, vcfg, None))
    with pytest.raises(RuntimeError, match="Vocoder not loaded"):
        list(tts.synthesize_stream("hi", max_tokens=12, vocoder_mode=mode))


# --- the engine's streamed frames against the JAX engine's -----------------------


def replay_noise(key, cfg):
    """A host source replaying the JAX plain route's draws for base ``key``:
    one key per (slot, step) split into a slow and a fast key; the fast one
    split again per residual book."""
    K = cfg.num_codebooks

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def draw(slot, step, slow, fast):
        ks, kf = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, slot), step))
        return (jax.random.gumbel(ks, (slow,), jnp.float32),
                jax.vmap(lambda k: jax.random.gumbel(k, (fast,), jnp.float32))(
                    jax.random.split(kf, K - 1)))

    def noise(slot, step, d: tdecode.Draws):
        assert d.per_book
        g_slow, g_fast = draw(jnp.uint32(slot), jnp.uint32(step), d.slow, d.fast)
        return torch.from_numpy(np.array(g_slow)), torch.from_numpy(np.array(g_fast))

    return noise


class Decisions:
    """The port's sampling decisions on the plain route, K a frame (the slow
    token, then each residual book): (top_k, penalized logits, noise as
    read, temperature, top_p, picks)."""

    def __init__(self, monkeypatch):
        self.calls = []
        sample = tdecode.sample

        def rec(gumbel, logits, temperature, top_p, rep, prev_idx=None, top_k=0, approx=False):
            out = sample(gumbel, logits, temperature, top_p, rep, prev_idx, top_k=top_k,
                         approx=approx)
            pen = logits.float()
            if prev_idx is not None:
                pen = tsampling.apply_repetition_penalty(pen, prev_idx, rep)
            self.calls.append((top_k, pen, gumbel, temperature, top_p, out))
            return out

        monkeypatch.setattr(tdecode, "sample", rec)

    def frames(self, K: int, semantic_begin: int, codebook: int) -> np.ndarray:
        """The frames (n, 1+K) these decisions made."""
        picks = np.array([int(c[5][0]) for c in self.calls]).reshape(-1, K)
        a = np.clip(picks[:, :1] - semantic_begin, 0, codebook - 1)
        return np.concatenate([picks[:, :1], a, picks[:, 1:]], axis=1)

    def hold(self, got: np.ndarray, want: np.ndarray, K: int) -> int | None:
        """Frames (n, 1+K) of the port against JAX's: equal, or the first
        differing code on a knife edge of the port's own decision.  Returns
        the first differing frame, None when all are equal."""
        n = min(len(got), len(want))
        diff = np.argwhere(got[:n] != want[:n])
        if not len(diff):
            return None
        f, j = (int(v) for v in diff[0])
        assert j != 1, "the first code follows the slow token"
        top_k, logits, gumbel, temperature, top_p, picks = self.calls[f * K + max(j - 1, 0)]
        assert int(picks[0]) == got[f, j]
        m = testing.sample_decision_margins(
            torch.tensor([int(want[f, j])]), picks[:1], logits[:1], gumbel[:1],
            temperature[:1], top_p[:1], top_k, LOGIT_TOL * float(logits[0].abs().max()))
        assert not m["failures"], (f, j, m["failures"])
        return f


class JaxFrames:
    """Records the emitted frames of the JAX engine's prefill and decode
    calls, in order."""

    def __init__(self, monkeypatch):
        self.frames: list[np.ndarray] = []
        for name in ("prefill_chunk", "decode_chunk"):
            monkeypatch.setattr(jdecode, name, self._wrap(getattr(jdecode, name)))

    def _wrap(self, fn):
        def run(*a, **k):
            state, frames, emitted = fn(*a, **k)
            if not isinstance(frames, jax.core.Tracer):  # prefill_chunk's own call
                self.frames.extend(np.asarray(frames)[0][np.asarray(emitted)[0]])
            return state, frames, emitted
        return run


def make_engines():
    """(JAX engine, port engine on the plain route the JAX engine takes on
    the CPU) on the same tiny fp32 weights and vocabulary."""
    import tempfile
    from pathlib import Path

    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    specials = tiny_special_tokens(T_CFG.codebook_size)
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return (JEngine(jp, J_CFG, JTokenizer(path, specials), seed=3),
            TEngine(tp, T_CFG, TTokenizer(path, specials), EngineConfig(fast_kernel=False)))


def generate_both(monkeypatch, pair, text: str, max_tokens: int, streaming: bool):
    """The JAX engine's ``generate_long`` and the port's (``pair`` from
    :func:`make_engines`) with noise replaying the JAX call's: (JAX codes
    chunks, port codes chunks, JAX frames, port frames, the port's
    decisions)."""
    jeng, teng = pair
    jframes = JaxFrames(monkeypatch)
    _, base = jax.random.split(jeng._key)  # the key the JAX call draws
    kw = dict(max_new_tokens=max_tokens, temperature=SAMPLING[0], top_p=SAMPLING[1],
              repetition_penalty=SAMPLING[2], streaming=streaming)
    want = [r.codes for r in jeng.generate_long(text, **kw) if r.action == "sample"]
    seen = Decisions(monkeypatch)
    got = [r.codes for r in teng.generate_long(text, noise=replay_noise(base, T_CFG), **kw)
           if r.action == "sample"]
    K = T_CFG.num_codebooks
    tframes = seen.frames(K, teng.ids.semantic_begin, T_CFG.codebook_size)
    return want, got, np.stack(jframes.frames), tframes, seen


def hold_codes(want, got, jframes, tframes, seen) -> None:
    """The port's codes against JAX's: equal chunk by chunk, or equal up to
    a first differing frame that ``Decisions.hold`` excuses."""
    f = seen.hold(tframes, jframes, T_CFG.num_codebooks)
    w, g = np.concatenate(want, axis=1), np.concatenate(got, axis=1)
    if f is None:
        assert [c.shape for c in got] == [c.shape for c in want]
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(g[:, :f], w[:, :f])


def test_streamed_frames_match_jax_engine(monkeypatch):
    """``generate_long(streaming=True)`` in both engines: the same chunks (10
    frames, then 20) and codes, the full frames equal but at a knife edge."""
    want, got, jframes, tframes, seen = generate_both(monkeypatch, make_engines(), TEXT, 47,
                                                      streaming=True)
    assert [c.shape[1] for c in want][:2] == [10, 20]
    hold_codes(want, got, jframes, tframes, seen)
