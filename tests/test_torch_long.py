"""Long text in the port against the JAX package, at tiny size on the CPU:
``FishTTS.synthesize_long`` and ``synthesize_long_stream`` on the same
weights, each of the port's chunk calls replaying the noise of the JAX
call it stands for (``test_torch_stream.replay_noise``), with the cases of
the JAX package's ``tests/test_long_text.py``: a multi-chunk WAV, PCM
yielded across chunks, ``carry_frames=0``, and explicit against stored
references.

Tolerances: the prompts of every chunk call equal; codes equal, a first
differing frame excused only at a knife edge of the port's own decision
(``test_torch_stream.Decisions``), and nothing compared after it; with equal
codes, the same PCM chunks, each within ``PCM_TOL`` int16 steps (the fp32
codecs sum in other orders).
"""

import io
import tempfile
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import Decisions, JaxFrames, hold_codes, loud_vocoder, replay_noise
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.synthesizer import FishTTS as JFishTTS
from fish_tts_tpu.synthesizer import VoiceProfile as JVoiceProfile
from fish_tts_tpu_torch import FishTTS, VoiceProfile
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.utils import checkpoint as tckpt

PCM_TOL = 1
LONG_TEXT = "One two. Three four! Five six? Seven."
K = T_CFG.num_codebooks


@pytest.fixture(scope="module")
def pair():
    """(JAX FishTTS, port FishTTS) on the same tiny fp32 LM, vocabulary and
    audible codec; the port on the plain route the JAX instance takes on
    the CPU."""
    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    specials = tiny_special_tokens(T_CFG.codebook_size)
    tv, jv = loud_vocoder()
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    jtts = JFishTTS(device="cpu", precision="fp32", warmup=False,
                    _testing_bundle=(J_CFG, jp, JTokenizer(path, specials), J_VCFG, jv))
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    ttts = FishTTS(device="cpu", precision="fp32", warmup=False,
                   engine_config=EngineConfig(fast_kernel=False),
                   _testing_bundle=(T_CFG, tp, TTokenizer(path, specials), T_VCFG, tv))
    return jtts, ttts


def ref_codes(seed: int, frames: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, T_CFG.codebook_size // 2, (K, frames)).astype(np.int64)


class Calls:
    """Records each chunk call of an engine's ``generate_long``: (text,
    prompt texts, prompt codes, prefix flag, codes yielded).  On the JAX
    engine it also records the base key the call draws; on the port's it
    passes the noise replaying the JAX call of the same index."""

    def __init__(self, monkeypatch, engine, keys=None):
        self.calls, self.keys = [], [] if keys is None else keys
        real, replay = engine.generate_long, keys is not None

        def spy(text, **kw):
            codes = []
            self.calls.append((text, list(kw["prompt_text"]),
                               [np.asarray(c) for c in kw["prompt_tokens"]],
                               kw["use_prefix_cache"], codes))
            if replay:
                kw["noise"] = replay_noise(self.keys[len(self.calls) - 1], T_CFG)
            else:
                self.keys.append(jax.random.split(engine._key)[1])  # the key the call draws
            for r in real(text, **kw):
                if r.action == "sample":
                    codes.append(r.codes)
                yield r

        monkeypatch.setattr(engine, "generate_long", spy)

    def codes(self) -> list[np.ndarray]:
        return [c for call in self.calls for c in call[4]]


def run_both(pair, monkeypatch, method: str, references=None, **kw):
    """``method`` on both instances, the JAX one first: (JAX output, port
    output, JAX calls, port calls).  Holds the codes of all chunk calls
    together: equal, or equal up to a first differing frame at a knife edge
    of the port's decision; returns whether they were all equal."""
    jtts, ttts = pair
    jrefs = None if references is None else [JVoiceProfile(codes=r.codes, text=r.text)
                                             for r in references]
    jframes = JaxFrames(monkeypatch)
    jcalls = Calls(monkeypatch, jtts._engine)
    want = getattr(jtts, method)(LONG_TEXT, references=jrefs, **kw)
    want = list(want) if method.endswith("stream") else want
    seen = Decisions(monkeypatch)
    tcalls = Calls(monkeypatch, ttts.engine, keys=jcalls.keys)
    got = getattr(ttts, method)(LONG_TEXT, references=references, **kw)
    got = list(got) if method.endswith("stream") else got
    assert len(tcalls.calls) == len(jcalls.calls) >= 2
    tframes = seen.frames(K, ttts.engine.ids.semantic_begin, T_CFG.codebook_size)
    first = seen.hold(tframes, np.stack(jframes.frames), K)
    hold_codes(jcalls.codes(), tcalls.codes(), np.stack(jframes.frames), tframes, seen)
    if first is None:
        for (jt, jpt, jpc, jpre, _), (tt, tpt, tpc, tpre, _) in zip(jcalls.calls, tcalls.calls):
            assert (tt, tpt, tpre) == (jt, jpt, jpre)
            assert len(tpc) == len(jpc) and all(np.array_equal(a, b) for a, b in zip(tpc, jpc))
    return want, got, jcalls.calls, tcalls.calls, first is None


def int16(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.int16).astype(np.int32)


def wav_samples(wav: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(wav)) as w:
        assert (w.getnchannels(), w.getsampwidth()) == (1, 2)
        return int16(w.readframes(w.getnframes()))


def test_multi_chunk_wav_matches_jax(pair, monkeypatch):
    """Several chunks, one WAV of whole frames; with equal codes the same
    samples within PCM_TOL."""
    want, got, jcalls, _, equal = run_both(pair, monkeypatch, "synthesize_long", max_chars=12,
                                           carry_frames=4, max_tokens_per_chunk=8)
    assert got[:4] == b"RIFF" and len(jcalls) >= 3
    fl = T_VCFG.frame_length
    g = wav_samples(got)
    assert len(g) > 0 and len(g) % fl == 0
    if equal:
        w = wav_samples(want)
        assert g.shape == w.shape and np.abs(g - w).max() <= PCM_TOL


def test_stream_yields_across_chunks_as_jax(pair, monkeypatch):
    """The same PCM chunks across every text chunk: the first as soon as the
    engine's first response holds ``min_first_chunk`` frames, then a flush
    per ``chunk_tokens``; every frame of every chunk call comes out."""
    kw = dict(max_chars=12, carry_frames=4, max_tokens_per_chunk=8, min_first_chunk=2,
              chunk_tokens=4)
    want, got, _, tcalls, equal = run_both(pair, monkeypatch, "synthesize_long_stream", **kw)
    fl = T_VCFG.frame_length
    assert len(got) >= 2 and all(isinstance(c, bytes) and c and len(c) % (2 * fl) == 0
                                 for c in got)
    assert len(got[0]) == 2 * fl * tcalls[0][4][0].shape[1]  # the first response, at once
    assert sum(len(c) for c in got) == 2 * fl * sum(
        sum(x.shape[1] for x in call[4]) for call in tcalls)
    if equal:
        assert [len(c) for c in got] == [len(c) for c in want]
        assert all(np.abs(int16(a) - int16(b)).max() <= PCM_TOL for a, b in zip(got, want))


def test_carry_frames_zero_carries_nothing(pair, monkeypatch):
    _, _, jcalls, tcalls, _ = run_both(pair, monkeypatch, "synthesize_long", max_chars=12,
                                       carry_frames=0, max_tokens_per_chunk=8)
    assert all(call[1] == [] and call[2] == [] for call in tcalls)
    assert all(call[1] == [] and call[2] == [] for call in jcalls)


def test_carry_holds_the_last_frames_of_the_chunk_before(pair, monkeypatch):
    """Chunk i > 0 is prompted with chunk i - 1's text and its last
    ``carry_frames`` codes without the EOS frame, int64."""
    _, _, _, tcalls, _ = run_both(pair, monkeypatch, "synthesize_long", max_chars=12,
                                  carry_frames=4, max_tokens_per_chunk=8)
    for before, call in zip(tcalls, tcalls[1:]):
        codes = np.concatenate(before[4], axis=1)
        codes = codes[:, :-1] if codes.shape[1] > 1 else codes
        assert call[1] == [before[0]]
        assert call[2][0].dtype == np.int64
        np.testing.assert_array_equal(call[2][0], codes[:, -4:])


@pytest.mark.parametrize("stored", [False, True], ids=["explicit", "stored"])
def test_references_as_jax(pair, monkeypatch, stored):
    """A reference is the base of every chunk's prompt, the carry after it.
    Given explicitly, every chunk prefills it; stored (``references=None``),
    only the first chunk uses the prefix and the later ones prefill the
    stored profile with the carry."""
    jtts, ttts = pair
    ref = VoiceProfile(codes=ref_codes(3), text="r")
    if stored:
        jtts.set_references([JVoiceProfile(codes=ref.codes, text="r")])
        ttts.set_references([ref])
    try:
        _, wav, jcalls, tcalls, _ = run_both(
            pair, monkeypatch, "synthesize_long", references=None if stored else [ref],
            max_chars=8, carry_frames=2, max_tokens_per_chunk=6)
    finally:
        jtts.clear_references()
        ttts.clear_references()
    assert wav[:4] == b"RIFF"
    for calls in (jcalls, tcalls):
        if stored:
            assert calls[0][1:4] == ([], [], True)
        else:
            assert calls[0][1] == ["r"] and not calls[0][3]
        for call in calls[1:]:
            assert call[1][0] == "r" and len(call[1]) == 2 and not call[3]
            np.testing.assert_array_equal(call[2][0], ref.codes)


def test_empty_text_raises(pair):
    _, ttts = pair
    with pytest.raises(RuntimeError, match="No audio generated"):
        ttts.synthesize_long("   ")
    assert list(ttts.synthesize_long_stream("")) == []
    assert torch.get_num_threads() == 1
