"""Batched synthesis in the port against the JAX package, at tiny size on
the CPU: ``GenerationEngine.generate_batch`` and ``generate_batch_stream``
(prompts in two buckets, per-stream sampling parameters, per-stream
budgets, the forked prefix) against the JAX engine's with the same noise,
the streamed frames against the batch frames, ``FishTTS.synthesize_batch``
and ``synthesize_batch_stream``, and the slot-pool codec
(``vocoder_stream.decode_chunk_pool``) against JAX's.

Tolerances: codes are equal, a first differing code of a stream excused
only at a knife edge of the port's own decision
(``testing.sample_decision_margins``, logits that may each move by
``LOGIT_TOL`` of their largest magnitude); the codec in fp32 within the
JAX tests' ``AUDIO_TOL`` and 1e-4 of the waveform's peak; PCM within one
int16 step of the joint decode; the pool's int16 PCM bit-equal to the host
conversion.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import (AUDIO_TOL, LOGIT_TOL, Decisions, assert_audio_close, leaves,
                               loud_vocoder, port_stream, random_codes)
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.config import EngineConfig as JEngineConfig
from fish_tts_tpu.engine.generate import GenerationEngine as JEngine
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models import vocoder_stream as jvs
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine.generate import GenerationEngine as TEngine
from fish_tts_tpu_torch.models import vocoder_stream as tvs
from fish_tts_tpu_torch.models.prompt import build_prompt
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from fish_tts_tpu_torch.utils.audio import to_pcm_bytes

K = T_CFG.num_codebooks
# three streams in two prompt buckets: "hi" alone in 16, the others in 32
TEXTS = ["hello there", "hi", "ok go"]
# small chunks, and large ones for generate_batch; one read window
ENGINE = dict(prompt_buckets=(16, 32, 64), decode_chunk=8, first_chunk=8, batch_chunk=16,
              kv_bucket_step=128)
PER_STREAM = dict(temperature=[0.5, 1.2, 0.8], top_p=[0.6, 0.95, 0.8],
                  repetition_penalty=[1.0, 1.3, 1.1])
UNIFORM = dict(temperature=0.7, top_p=0.8, repetition_penalty=1.1)


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine on the plain route the JAX engine takes on
    the CPU) on the same tiny fp32 weights and vocabulary, both with the
    ENGINE buckets and chunks."""
    import tempfile
    from pathlib import Path

    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    specials = tiny_special_tokens(T_CFG.codebook_size)
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return (JEngine(jp, J_CFG, JTokenizer(path, specials), JEngineConfig(**ENGINE), seed=3),
            TEngine(tp, T_CFG, TTokenizer(path, specials),
                    EngineConfig(**ENGINE, fast_kernel=False)))


def replay_batch_noise(key):
    """A host source replaying the JAX batch call's draws for ``key``: the
    prefill frame from ``fold_in(key, slot)`` (slots local to the group),
    a decode frame from ``fold_in(fold_in(key, slot), step)``; each split
    into a slow key and a fast one, the fast one split per residual book."""

    @jax.jit
    def keys(slot, step, prefill):
        k = jax.random.fold_in(key, slot)
        return jax.random.split(jnp.where(prefill, k, jax.random.fold_in(k, step)))

    draw_slow = jax.jit(lambda k, n: jax.random.gumbel(k, (n,), jnp.float32),
                        static_argnums=1)
    draw_fast = jax.jit(lambda k, n: jax.vmap(lambda kk: jax.random.gumbel(
        kk, (n,), jnp.float32))(jax.random.split(k, K - 1)), static_argnums=1)

    def noise(slot, step, d: tdecode.Draws):
        assert d.per_book
        ks, kf = keys(jnp.uint32(slot), jnp.uint32(step % 2**32), step == tdecode.PREFILL_STEP)
        return (torch.from_numpy(np.array(draw_slow(ks, d.slow))),
                torch.from_numpy(np.array(draw_fast(kf, d.fast))))

    return noise


def record_chunks(engine, monkeypatch) -> list:
    """Records every (frames, emitted) chunk the engine's ``_batch_chunks``
    yields, rows in caller order."""
    seen = []
    real = engine._batch_chunks

    def spy(*a, **k):
        for f, e in real(*a, **k):
            seen.append((f.copy(), e.copy()))
            yield f, e

    monkeypatch.setattr(engine, "_batch_chunks", spy)
    return seen


def stream_frames(chunks, B: int) -> list[np.ndarray]:
    """Each stream's emitted full frames (n_b, 1+K) from recorded chunks."""
    frames = np.concatenate([f for f, _ in chunks], axis=1)
    emitted = np.concatenate([e for _, e in chunks], axis=1)
    return [frames[b][emitted[b]] for b in range(B)]


class Run:
    """One call of a batch entry point in both engines with the port's noise
    replaying the JAX call's draws; keeps both results, each stream's full
    frames, the port's sampling decisions, its prefill calls (rows, storage
    of the state's KV) and the KV storage of the state its decode ran on."""

    def __init__(self, pair, monkeypatch, method: str, texts, **kw):
        jeng, teng = pair
        jchunks, tchunks = record_chunks(jeng, monkeypatch), record_chunks(teng, monkeypatch)
        key, subs = jeng._key, []
        for _ in range(len(texts) + 1):  # at most one key per group, then the decode's
            key, sub = jax.random.split(key)
            subs.append(replay_batch_noise(sub))
        monkeypatch.setattr(teng, "next_noise", lambda: subs.pop(0))
        self.prefills, self.decoded, self.groups = [], set(), []
        prefill, decode, bucket_groups = tdecode.prefill, teng.runner.decode, teng._bucket_groups

        def spy_prefill(params, rope, state, *a, **k):
            self.prefills.append((state["frame"].shape[0],
                                  state["kv"]["k"].untyped_storage().data_ptr()))
            return prefill(params, rope, state, *a, **k)

        def spy_decode(state, *a, **k):
            self.decoded.add(state["kv"]["k"].data_ptr())
            return decode(state, *a, **k)

        def spy_groups(lengths):
            self.groups = bucket_groups(lengths)
            return self.groups

        monkeypatch.setattr(tdecode, "prefill", spy_prefill)
        monkeypatch.setattr(teng.runner, "decode", spy_decode)
        monkeypatch.setattr(teng, "_bucket_groups", spy_groups)
        self.want = self._collect(getattr(jeng, method)(texts, **kw))
        self.seen = Decisions(monkeypatch)
        self.got = self._collect(getattr(teng, method)(texts, **kw))
        B = len(texts)
        self.jframes, self.tframes = stream_frames(jchunks, B), stream_frames(tchunks, B)

    @staticmethod
    def _collect(out):
        return list(out) if not isinstance(out, list) else out

    def first_differences(self) -> dict[int, int]:
        """Per stream, the first frame where the port's full frames differ
        from JAX's, each on a knife edge of the port's own decision."""
        order = [i for _, idxs in self.groups for i in idxs]
        G = len(self.groups)
        out = {}
        for b, (got, want) in enumerate(zip(self.tframes, self.jframes)):
            n = min(len(got), len(want))
            diff = np.argwhere(got[:n] != want[:n])
            if not len(diff):
                assert len(got) == len(want), b
                continue
            f, j = (int(v) for v in diff[0])
            assert j != 1, "the first code follows the slow token"
            g = next(i for i, (_, idxs) in enumerate(self.groups) if b in idxs)
            if f == 0:  # the group's prefill frame, slots local to the group
                call, row = g * K, self.groups[g][1].index(b)
            else:  # decode frame f - 1, rows in grouped order
                call, row = (G + f - 1) * K, order.index(b)
            top_k, logits, gumbel, temperature, top_p, picks = \
                self.seen.calls[call + max(j - 1, 0)]
            r = slice(row, row + 1)
            assert int(picks[row]) == got[f, j]
            m = testing.sample_decision_margins(
                torch.tensor([int(want[f, j])]), picks[r], logits[r], gumbel[r],
                temperature[r], top_p[r], top_k, LOGIT_TOL * float(logits[row].abs().max()))
            assert not m["failures"], (b, f, j, m["failures"])
            out[b] = f
        return out


def hold_batch(run: Run) -> dict[int, int]:
    """``generate_batch``'s codes per stream equal JAX's, or equal up to a
    first differing frame that ``Run.first_differences`` excuses."""
    edges = run.first_differences()
    assert len(run.got) == len(run.want)
    for b, (g, w) in enumerate(zip(run.got, run.want)):
        if b in edges:
            np.testing.assert_array_equal(g[:, :edges[b]], w[:, :edges[b]])
        else:
            np.testing.assert_array_equal(g, w)
    return edges


BATCH_CASES = {"two buckets": (TEXTS, dict(max_new_tokens=20, **UNIFORM)),
               "per-stream sampling": (TEXTS, dict(max_new_tokens=20, **PER_STREAM)),
               # budgets from each prompt's own headroom (max_seq_len - prompt)
               "budgets": (["a much longer text here", "hi"], dict(max_new_tokens=0, **UNIFORM))}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_generate_batch_matches_jax(pair, monkeypatch, case):
    """``generate_batch`` in both engines with the same noise: equal codes
    per stream in caller order (tests/test_engine.py:424, :449, :587).
    The groups prefill into rows of the one persistent (B, alloc) state,
    one prefill per bucket, and the decode runs on that state."""
    texts, kw = BATCH_CASES[case]
    run = Run(pair, monkeypatch, "generate_batch", texts, **kw)
    edges = hold_batch(run)
    teng = pair[1]
    (B, alloc, scratch), = [k for k, s in teng.runner._states.items()
                            if s["kv"]["k"].data_ptr() in run.decoded]
    state = teng.runner._states[(B, alloc, scratch)]
    assert B == len(texts) and run.decoded == {state["kv"]["k"].data_ptr()}
    assert [n for n, _ in run.prefills] == [len(idxs) for _, idxs in run.groups]
    assert len(run.groups) == 2
    assert {p for _, p in run.prefills} == {state["kv"]["k"].untyped_storage().data_ptr()}
    if case == "budgets":
        # no EOS with these weights: each stream emits its own budget (the
        # final frame stripped); the longest budget set the decode's length
        budgets = [T_CFG.max_seq_len - build_prompt(teng.tokenizer, t, K).values.shape[1]
                   for t in texts]
        assert not edges and not any((f[:, 0] == teng.ids.im_end).any() for f in run.tframes)
        assert [len(f) for f in run.tframes] == budgets and budgets[0] < budgets[1]
        assert [c.shape[1] for c in run.got] == [n - 1 for n in budgets]


@pytest.mark.parametrize("case", ["two buckets", "per-stream sampling"])
def test_generate_batch_stream_matches_jax(pair, monkeypatch, case):
    """``generate_batch_stream`` in both engines: the same chunks, ``None``
    where a stream emitted nothing, and equal codes (tests/test_api.py:157's
    variant against the JAX engine)."""
    texts, kw = BATCH_CASES[case]
    run = Run(pair, monkeypatch, "generate_batch_stream", texts, **kw)
    edges = run.first_differences()
    assert len(run.got) == len(run.want) > 1
    if not edges:
        for g, w in zip(run.got, run.want):
            assert [x is None for x in g] == [x is None for x in w]
            for a, b in zip(g, w):
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    for b in range(len(texts)):
        g = np.concatenate([c[b] for c in run.got if c[b] is not None], axis=1)
        w = np.concatenate([c[b] for c in run.want if c[b] is not None], axis=1)
        n = edges.get(b, w.shape[1])
        np.testing.assert_array_equal(g[:, :n], w[:, :n])


def test_generate_batch_forks_prefix_matches_jax(pair, monkeypatch):
    """Through a stored prefix (tests/test_engine.py:386): one prefill per
    bucket group, of the texts alone, at the prefix's offset, into rows of
    the persistent state the prefix was forked into; codes equal JAX's."""
    jeng, teng = pair
    ref_codes = np.random.RandomState(0).randint(0, T_CFG.residual_codebook_size, (K, 8))
    jeng.set_prefix(["ref"], [ref_codes])
    teng.set_prefix(["ref"], [ref_codes])
    try:
        n_prefix = int(teng._prefix_state["pos"][0])
        assert n_prefix == int(np.asarray(jeng._prefix_state["pos"])[0]) > 8
        offsets = []
        real = tdecode.prefill

        def spy(params, rope, state, *a, **k):
            offsets.append(state["pos"].tolist())
            return real(params, rope, state, *a, **k)

        monkeypatch.setattr(tdecode, "prefill", spy)
        run = Run(pair, monkeypatch, "generate_batch", TEXTS, max_new_tokens=12, **PER_STREAM)
        hold_batch(run)
        assert [len(o) for o in offsets] == [1, 2]
        assert all(p == n_prefix for o in offsets for p in o)
    finally:
        jeng.clear_prefix()
        teng.clear_prefix()


def test_batch_params_are_checked(pair):
    teng = pair[1]
    with pytest.raises(ValueError, match="one value per text"):
        teng.generate_batch(TEXTS, temperature=[0.7, 0.8])
    with pytest.raises(ValueError, match="top_p out of range"):
        teng.generate_batch(TEXTS, top_p=[0.5, 1.5, 0.5])
    assert teng.generate_batch([]) == []


def test_past_the_kernels_batch_limit_runs_plain(caplog):
    """B = 17 is past the kernels' limit: the reference's gates put every
    part of the int8 frame on plain PyTorch, the engine says so once, and
    the batch runs."""
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = testing.make_tiny_bundle(0)
    engine = TEngine(quantize_lm_params(params), cfg, tok)
    assert tdecode.route(cfg, engine.params, 16, 16).slow_stack
    assert not any(tdecode.route(cfg, engine.params, 17, 16).__dict__[k]
                   for k in ("slow_stack", "sampler", "fast"))
    with caplog.at_level(logging.INFO, logger="fish_tts_tpu_torch.engine.generate"):
        for _ in range(2):
            out = engine.generate_batch(["x"] * 17, max_new_tokens=3)
            assert len(out) == 17 and all(c.shape == (cfg.num_codebooks, 2) for c in out)
    assert sum("B=17 is past the batch limit" in r.message for r in caplog.records) == 1


# --- FishTTS.synthesize_batch and synthesize_batch_stream -------------------------


@pytest.fixture(scope="module")
def vparams():
    return loud_vocoder()


@pytest.fixture(scope="module")
def tts(vparams):
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(0)
    return FishTTS(device="cpu", precision="fp32", warmup=False,
                   _testing_bundle=(cfg, params, tok, vcfg, vparams[0]))


def test_streamed_frames_equal_batch_frames(tts):
    """``generate_batch_stream`` with the same seed yields the frames
    ``generate_batch`` collects plus each stream's final frame, though one
    decodes 20-frame chunks and the other 100-frame ones."""
    eng = tts.engine
    eng.reseed(77)
    batch = eng.generate_batch(TEXTS, max_new_tokens=50, **PER_STREAM)
    eng.reseed(77)
    acc = [[] for _ in TEXTS]
    for chunk in eng.generate_batch_stream(TEXTS, max_new_tokens=50, **PER_STREAM):
        for b, codes in enumerate(chunk):
            if codes is not None:
                acc[b].append(codes)
    for b, parts in enumerate(acc):
        streamed = np.concatenate(parts, axis=1)
        assert streamed.shape[1] == batch[b].shape[1] + 1 == 50
        np.testing.assert_array_equal(streamed[:, :-1], batch[b])


def test_synthesize_batch_tolerates_empty_stream(tts, monkeypatch):
    """A stream with no codes gets a header-only WAV and the others keep
    their audio; all streams empty raises (tests/test_api.py:114)."""
    real = tts.engine.generate_batch

    def one_empty(texts, **kw):
        out = real(texts, **kw)
        out[0] = out[0][:, :0]
        return out

    monkeypatch.setattr(tts.engine, "generate_batch", one_empty)
    wavs = tts.synthesize_batch(["gone", "kept"], max_tokens=8)
    assert wavs[0][:4] == b"RIFF" and len(wavs[0]) == 44
    fl = T_VCFG.frame_length
    assert wavs[1][:4] == b"RIFF" and len(wavs[1]) == 44 + 2 * 7 * fl
    monkeypatch.setattr(tts.engine, "generate_batch",
                        lambda texts, **kw: [c[:, :0] for c in real(texts, **kw)])
    with pytest.raises(RuntimeError, match="No audio"):
        tts.synthesize_batch(["a", "b"], max_tokens=8)


def batch_stream(tts, mode: str, monkeypatch, max_tokens: int = 35):
    """One ``synthesize_batch_stream`` of TEXTS with the engine reseeded:
    (the rounds of PCM chunks, each stream's streamed codes (K, n_b))."""
    codes = [[] for _ in TEXTS]
    real = tts.engine.generate_batch_stream

    def spy(*a, **k):
        for chunk in real(*a, **k):
            for b, c in enumerate(chunk):
                if c is not None:
                    codes[b].append(c)
            yield chunk

    monkeypatch.setattr(tts.engine, "generate_batch_stream", spy)
    tts.engine.reseed(11)
    rounds = list(tts.synthesize_batch_stream(TEXTS, max_tokens=max_tokens,
                                              vocoder_mode=mode, context_frames=8, **PER_STREAM))
    return rounds, [np.concatenate(c, axis=1) for c in codes]


@pytest.mark.parametrize("mode", ["stateful", "context"])
def test_batch_stream_pcm(tts, monkeypatch, mode):
    """Every round is a list of B chunks of whole frames or None; each
    stream's first flush has at least 10 frames and the others 20 but for
    its last; the stateful pool's PCM, concatenated per stream, equals the
    joint decode of that stream's codes within one int16 step; the context
    mode gives the same samples per stream."""
    rounds, codes = batch_stream(tts, mode, monkeypatch)
    fl = T_VCFG.frame_length
    for b, c in enumerate(codes):
        chunks = [r[b] for r in rounds if r[b] is not None]
        assert all(len(r) == len(TEXTS) for r in rounds)
        sizes = [len(x) // (2 * fl) for x in chunks]
        assert all(len(x) % (2 * fl) == 0 for x in chunks) and sum(sizes) == c.shape[1] == 35
        assert sizes[0] >= 10 and all(s >= 20 for s in sizes[1:-1])
        got = np.frombuffer(b"".join(chunks), np.int16).astype(np.int32)
        want = np.frombuffer(tts._decode_to_pcm(c), np.int16).astype(np.int32)
        assert got.shape == want.shape and np.abs(want).max() > 300
        if mode == "stateful":
            assert np.abs(got - want).max() <= 1, b


def pool_schedule():
    """Streams joining, idling, ending on a ragged tail and replaced in a
    3-row pool of 8-frame rounds (tests/test_vocoder.py:321): per round, per
    row, (codes or None, reset), and the stream of each row."""
    A, B, C, D = (random_codes(n, seed=s) for s, n in enumerate((32, 13, 8, 8)))
    rounds = [[(A[:, :, 0:8], True), (None, False), (C, True)],
              [(A[:, :, 8:16], False), (B[:, :, 0:8], True), (None, False)],
              [(A[:, :, 16:24], False), (B[:, :, 8:13], False), (None, False)],
              [(A[:, :, 24:32], False), (None, False), (D, True)]]
    names = [["A"] * 4, [None, "B", "B", None], ["C", None, None, "D"]]
    return rounds, names, dict(A=A, B=B, C=C, D=D)


def test_decode_chunk_pool_matches_jax(vparams):
    """``decode_chunk_pool`` round by round against JAX's on the same codes
    and masks: every active row's audio, and the state's every leaf, within
    AUDIO_TOL; each stream's audio, concatenated, against its solo stream
    (tests/test_vocoder.py:289, :321)."""
    tp, jp = vparams
    rounds, names, streams = pool_schedule()
    fl = T_VCFG.frame_length
    st_t, st_j = tvs.init_decode_state(tp, T_VCFG, batch=3), jvs.init_decode_state(jp, J_VCFG, 3)
    pool_j = jax.jit(lambda s, c, a, r: jvs.decode_chunk_pool(jp, J_VCFG, s, c, a, r))
    got: dict[str, list[np.ndarray]] = {}
    for r, row in enumerate(rounds):
        codes = np.zeros((3, K, 8), np.int32)
        active, reset, m = np.zeros(3, bool), np.zeros(3, bool), [0] * 3
        for s, (chunk, rs) in enumerate(row):
            if chunk is not None:
                m[s] = chunk.shape[-1]
                codes[s, :, :m[s]] = chunk[0]
                active[s], reset[s] = True, rs
        st_t, a_t = tvs.decode_chunk_pool(tp, T_VCFG, st_t, torch.from_numpy(codes),
                                          torch.from_numpy(active), torch.from_numpy(reset))
        st_j, a_j = pool_j(st_j, jnp.asarray(codes), jnp.asarray(active), jnp.asarray(reset))
        for s in range(3):
            if active[s]:
                assert_audio_close(a_t[s].numpy(), np.asarray(a_j)[s])
                got.setdefault(names[s][r], []).append(a_t[s, 0, :m[s] * fl].numpy())
        got_st, want_st = leaves(st_t), leaves(jax.tree_util.tree_map(np.asarray, st_j))
        assert [p for p, _ in got_st] == [p for p, _ in want_st]
        for (path, g), (_, w) in zip(got_st, want_st):
            np.testing.assert_allclose(g, w, err_msg=path, **AUDIO_TOL)
    for name, parts in got.items():
        T = streams[name].shape[-1]
        solo, _ = port_stream(tp, T_VCFG, streams[name], [min(8, T - t) for t in range(0, T, 8)])
        assert_audio_close(np.concatenate(parts), solo[0, 0])


def test_pool_pcm_matches_host_path(tts):
    """The pool's decode gives int16 PCM made on the device, bit-equal to
    ``to_pcm_bytes`` of the same round's float audio
    (tests/test_serve.py::test_pool_pcm_matches_host_path)."""
    init, dec = tts._pool_vocoder_fns(3)
    vp = tts._vocoder_params
    codes = torch.from_numpy(random_codes(6, seed=9, batch=3))
    active, reset = torch.tensor([True, True, False]), torch.zeros(3, dtype=torch.bool)
    _, pcm = dec(vp, init(vp), codes, active, reset)
    assert pcm.dtype == torch.int16 and pcm.shape == (3, 1, 6 * T_VCFG.frame_length)
    _, audio = tvs.decode_chunk_pool(vp, T_VCFG, tvs.init_decode_state(vp, T_VCFG, 3), codes,
                                     active, reset)
    assert pcm.numpy().tobytes() == to_pcm_bytes(audio.numpy())
    assert np.abs(pcm.numpy()[:2]).max() > 300
