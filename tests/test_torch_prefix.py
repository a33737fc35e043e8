"""The stored reference voice and the engine's KV prefix in the port against
the JAX package, at tiny size on the CPU: the prompt matrices
(``set_prefix``'s and ``_encode_suffix``'s), the prefix state, a split
prefill against a joint one, the codes of ``generate_long`` with the prefix
against the JAX engine's with the same noise, the fork into the call's own
state (never aliased, in place, sliced or padded to its allocation), a
prefix changed while a call is in flight, the reference store of
``FishTTS`` (``references=None`` consults it, ``[]`` does not) and
``reseed``.

Tolerances: integer state and prompts bit-equal; the KV cache in fp32
within ``KV_TOL`` of its largest magnitude (XLA and PyTorch sum in other
orders); codes equal, a differing one excused only at a knife edge of the
port's own decision (``testing.sample_decision_margins``, through
``test_torch_stream.Decisions``).
"""

import numpy as np
import pytest
import torch

from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu_torch import FishTTS, VoiceProfile, testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.models.prompt import build_prompt
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params
from test_torch_stream import SAMPLING, generate_both, hold_codes, make_engines
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

KV_TOL = 1e-5
TEXT = "Cloned voice."
K = T_CFG.num_codebooks


def profile(seed: int, frames: int = 12, text: str = "Ref words.") -> VoiceProfile:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, T_CFG.residual_codebook_size, (K, frames))
    codes[0] = rng.integers(0, T_CFG.codebook_size, frames)
    return VoiceProfile(codes=codes, text=text, name=f"p{seed}")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def snapshot(state) -> dict:
    out = {k: v.clone() for k, v in state.items() if k != "kv"}
    out.update({f"kv_{k}": v.clone() for k, v in state["kv"].items()})
    return out


def unchanged(state, snap) -> bool:
    return all(torch.equal(state["kv"][k[3:]] if k.startswith("kv_") else state[k], v)
               for k, v in snap.items())


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine on the JAX engine's CPU route), both with
    the prefix of one reference set."""
    jeng, teng = make_engines()
    ref = profile(1)
    jeng.set_prefix([ref.text], [ref.codes])
    teng.set_prefix([ref.text], [ref.codes])
    return jeng, teng


def capture_prompts(monkeypatch, module, name="prefill"):
    """Record the padded prompt and lengths of every ``module.prefill`` call."""
    seen, real = [], getattr(module, name)

    def spy(params, rope, state, prompt, lengths, *a, **k):
        seen.append((np.asarray(prompt), int(np.asarray(lengths)[0]), int(np.asarray(
            state["pos"])[0])))
        return real(params, rope, state, prompt, lengths, *a, **k)

    monkeypatch.setattr(module, name, spy)
    return seen


def test_prompt_matrices_match_jax(monkeypatch):
    """``set_prefix``'s padded prompt and ``_encode_suffix``'s matrix are the
    JAX package's, bit for bit, and together they are ``build_prompt`` of the
    reference and the text."""
    jeng, teng = make_engines()
    ref = profile(2)
    jseen, tseen = capture_prompts(monkeypatch, jdecode), capture_prompts(monkeypatch, tdecode)
    jeng.set_prefix([ref.text], [ref.codes])
    teng.set_prefix([ref.text], [ref.codes])
    (jp, jT, _), (tp, tT, _) = jseen[-1], tseen[-1]
    np.testing.assert_array_equal(tp, jp)
    assert tT == jT
    suffix = teng._encode_suffix(TEXT).values
    np.testing.assert_array_equal(suffix, jeng._encode_suffix(TEXT).values)
    full = build_prompt(teng.tokenizer, TEXT, K, prompt_texts=[ref.text],
                        prompt_codes=[ref.codes]).values
    np.testing.assert_array_equal(np.concatenate([tp[0, :, :tT], suffix], axis=1), full)


def test_prefix_state_matches_jax(pair):
    """The prefix state: ``pos`` at the prefix's length as in JAX, the
    per-call fields reset, the KV rows below the prefix within KV_TOL of
    JAX's and of the rows a full-prompt prefill of the same reference
    writes."""
    jeng, teng = pair
    js, ts = jeng._prefix_state, teng._prefix_state
    n = int(ts["pos"][0])
    assert n == int(js["pos"][0]) > 0
    for k in ("frame", "step", "done"):
        assert not ts[k].any(), k
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    for k in ("k", "v"):
        assert rel(ts["kv"][k][:, :, :, :n].numpy(), np.asarray(js["kv"][k])[:, :, :, :n]) \
            <= KV_TOL, k
    # the same rows of a prefill of the whole prompt
    ref = profile(1)
    full = build_prompt(teng.tokenizer, TEXT, K, prompt_texts=[ref.text], prompt_codes=[ref.codes])
    padded, T = teng._pad_prompt(full.values)
    state = tdecode.init_state(teng.params, T_CFG, batch=1)
    tdecode.prefill(teng.params, teng.rope, state, torch.from_numpy(padded),
                    torch.tensor([T]), tdecode.GumbelNoise(0, T_CFG), *SAMPLING, cfg=T_CFG,
                    ids=teng.ids, kv_bucket=0, fast_kernel=False)
    for k in ("k", "v"):
        assert rel(ts["kv"][k][:, :, :, :n], state["kv"][k][:, :, :, :n]) <= KV_TOL, k


@pytest.mark.parametrize("kv_bucket", [None, 48])
def test_split_prefill_matches_joint(pair, kv_bucket):
    """Prefilling the prefix, then the text at its offset (reading the whole
    cache, or a window of ``kv_bucket`` rows over the prefix), gives the
    joint prefill's first frame and position, and its KV rows within
    KV_TOL."""
    _, teng = pair
    ref = profile(3)
    prefix = build_prompt(teng.tokenizer, "", K, prompt_texts=[ref.text], prompt_codes=[ref.codes])
    suffix = teng._encode_suffix(TEXT).values
    n_pre = prefix.values.shape[1] - teng._encode_suffix("").values.shape[1]
    joint = np.concatenate([prefix.values[:, :n_pre], suffix], axis=1)
    noise = tdecode.GumbelNoise(21, T_CFG)

    def prefill(state, values, kv):
        padded, T = teng._pad_prompt(values)
        return tdecode.prefill(teng.params, teng.rope, state, torch.from_numpy(padded),
                               torch.tensor([T]), noise, *SAMPLING, cfg=T_CFG, ids=teng.ids,
                               kv_bucket=kv, fast_kernel=False)

    s_joint = tdecode.init_state(teng.params, T_CFG, batch=1)
    _, f_joint = prefill(s_joint, joint, 0)
    s_split = tdecode.init_state(teng.params, T_CFG, batch=1)
    prefill(s_split, prefix.values[:, :n_pre], 0)
    assert n_pre <= 48
    _, f_split = prefill(s_split, suffix, kv_bucket)
    assert torch.equal(f_split, f_joint)
    n = joint.shape[1]
    assert int(s_split["pos"][0]) == int(s_joint["pos"][0]) == n
    for k in ("k", "v"):
        assert rel(s_split["kv"][k][:, :, :, :n], s_joint["kv"][k][:, :, :, :n]) <= KV_TOL, k


@pytest.mark.parametrize("streaming", [False, True])
def test_prefix_codes_match_jax(pair, monkeypatch, streaming):
    """``generate_long`` with the prefix (no references given) in both
    engines, the port's noise replaying the JAX call's: the prefill starts
    at the prefix's offset with the text alone, and the codes are JAX's (a
    first differing frame only at a knife edge)."""
    _, teng = pair
    seen = capture_prompts(monkeypatch, tdecode)
    want, got, jframes, tframes, decisions = generate_both(monkeypatch, pair, TEXT, 30,
                                                           streaming=streaming)
    prompt, T, offset = seen[-1]
    assert offset == int(teng._prefix_state["pos"][0])
    assert T == teng._encode_suffix(TEXT).values.shape[1]
    assert [c.shape[1] for c in want] == ([10, 20] if streaming else [29])
    hold_codes(want, got, jframes, tframes, decisions)


@pytest.fixture
def int8_engine():
    """A port engine on its default (kernel) route, int8 over f32, with the
    prefix of one reference."""
    cfg, params, tok, *_ = testing.make_tiny_bundle(0)
    engine = GenerationEngine(quantize_lm_params(params), cfg, tok)
    ref = profile(4)
    engine.set_prefix([ref.text], [ref.codes])
    return engine


def codes_of(engine, text, seed, **kw):
    out = engine.generate_long(text, max_new_tokens=24, temperature=SAMPLING[0],
                               top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                               noise=tdecode.GumbelNoise(seed, T_CFG), **kw)
    return np.concatenate([r.codes for r in out if r.action == "sample"], axis=1)


def test_prefix_survives_calls(int8_engine):
    """Two prefix calls with equal noise give equal codes, with calls on
    other text in between (one without the prefix, one streamed with it);
    after them the prefix state is unchanged bit for bit, and every call ran
    on the engine's persistent state, not on the prefix."""
    engine = int8_engine
    prefix = engine._prefix_state
    snap = snapshot(prefix)
    first = codes_of(engine, TEXT, 5)
    codes_of(engine, "Other text.", 6, use_prefix_cache=False)
    codes_of(engine, "Streamed.", 7, streaming=True)
    again = codes_of(engine, TEXT, 5)
    np.testing.assert_array_equal(again, first)
    assert unchanged(prefix, snap)
    assert engine._prefix_state is prefix
    assert all(s["kv"]["k"].data_ptr() != prefix["kv"]["k"].data_ptr()
               for s in engine._states.values())
    # the prefix changes the call: without it the same noise gives other codes
    assert not np.array_equal(codes_of(engine, TEXT, 5, use_prefix_cache=False), first)


@pytest.mark.parametrize("alloc", [64, 256])
def test_fork_into_smaller_and_larger_allocation(int8_engine, alloc):
    """The fork copies the prefix into the persistent state of (1, alloc) in
    place (a second fork keeps its tensors): KV rows below min(S, alloc)
    equal the prefix's, the rest zero; every other field equal."""
    engine = int8_engine
    prefix = engine._prefix_state
    state = engine._fork_prefix(prefix, alloc)
    ptrs = [t.data_ptr() for t in (state["kv"]["k"], state["kv"]["v"], state["pos"])]
    state["kv"]["k"].fill_(3.0)  # a dirty state from an earlier call
    state = engine._fork_prefix(prefix, alloc)
    assert [t.data_ptr() for t in (state["kv"]["k"], state["kv"]["v"], state["pos"])] == ptrs
    S = prefix["kv"]["k"].shape[3]
    n = min(S, alloc)
    for k in ("k", "v"):
        assert state["kv"][k].shape[3] == alloc
        assert torch.equal(state["kv"][k][:, :, :, :n], prefix["kv"][k][:, :, :, :n])
        assert not state["kv"][k][:, :, :, n:].any()
    for k in prefix:
        if k != "kv":
            assert torch.equal(state[k], prefix[k]), k


@pytest.mark.parametrize("change", ["clear", "replace"])
def test_prefix_change_mid_flight(int8_engine, change):
    """A call in flight keeps the prefix it started with when the prefix is
    cleared or replaced between its chunks: its codes equal an
    uninterrupted call's with the same noise."""
    engine = int8_engine
    want = codes_of(engine, TEXT, 8, streaming=True)
    gen = engine.generate_long(TEXT, max_new_tokens=24, temperature=SAMPLING[0],
                               top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                               noise=tdecode.GumbelNoise(8, T_CFG), streaming=True)
    chunks = [next(gen).codes]
    if change == "clear":
        engine.clear_prefix()
        assert not engine.has_prefix
    else:
        other = profile(9, frames=5, text="Another voice.")
        engine.set_prefix([other.text], [other.codes])
    chunks += [r.codes for r in gen if r.action == "sample"]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), want)


@pytest.fixture
def tts():
    return FishTTS(device="cpu", precision="int8", warmup=False,
                   _testing_bundle=testing.make_tiny_bundle(0))


def test_reference_store(tts):
    """``set/add/clear/get_references`` and ``num_references``; each change
    re-prefills the engine's prefix (a new allocation, a longer prefix for
    two references)."""
    assert tts.num_references == 0 and not tts.engine.has_prefix
    p1, p2 = profile(1), profile(2, text="Second.")
    tts.set_references([p1])
    assert tts.num_references == 1 and tts.engine.has_prefix
    first = tts.engine._prefix_state
    n1 = int(first["pos"][0])
    tts.add_reference(p2)
    assert tts.num_references == 2
    assert [p.name for p in tts.get_references()] == ["p1", "p2"]
    assert tts.engine._prefix_state is not first
    assert int(tts.engine._prefix_state["pos"][0]) > n1
    tts.get_references().clear()  # a copy
    assert tts.num_references == 2
    tts.clear_references()
    assert tts.num_references == 0 and not tts.engine.has_prefix
    tts.set_references([])
    assert not tts.engine.has_prefix


@pytest.mark.parametrize("entry", ["synthesize", "synthesize_stream"])
def test_references_none_uses_the_store(tts, monkeypatch, entry):
    """With stored references, ``references=None`` prefills the text alone
    at the prefix's offset; ``references=[]`` prefills the bare text prompt
    from position 0; an explicit list prefills its own full prompt."""
    ref = profile(1)
    tts.set_references([ref])
    n = int(tts.engine._prefix_state["pos"][0])
    seen = capture_prompts(monkeypatch, tdecode)

    def run(references):
        out = getattr(tts, entry)(TEXT, references=references, max_tokens=12)
        if entry == "synthesize_stream":
            out = b"".join(out)
        assert len(out) > 0
        return seen[-1]

    prompt, T, offset = run(None)
    assert (offset, T) == (n, tts.engine._encode_suffix(TEXT).values.shape[1])
    prompt, T, offset = run([])
    bare = build_prompt(tts._tokenizer, TEXT, K).values
    assert offset == 0
    np.testing.assert_array_equal(prompt[0, :, :T], bare)
    prompt, T, offset = run([profile(2)])
    p2 = profile(2)
    full = build_prompt(tts._tokenizer, TEXT, K, prompt_texts=[p2.text], prompt_codes=[p2.codes])
    assert offset == 0
    np.testing.assert_array_equal(prompt[0, :, :T], full.values)


def test_prefix_too_long_raises(tts):
    """The reserve check counts the prefix: a prefix plus text beyond
    ``max_seq_len - reserve`` raises."""
    tts.set_references([profile(5, frames=60)])
    with pytest.raises(ValueError, match="Prompt is too long"):
        tts.synthesize(TEXT, max_tokens=4)


def test_reseed_reproduces_a_call(tts):
    """``reseed`` restarts the per-call noise: the same seed gives the same
    codes; ``set_prefix`` does not draw from the sequence."""
    def codes():
        out = tts.engine.generate_long(TEXT, max_new_tokens=16, use_prefix_cache=False)
        return next(out).codes

    tts.engine.reseed(9)
    first = codes()
    assert not np.array_equal(codes(), first)
    tts.engine.reseed(9)
    tts.set_references([profile(1)])
    np.testing.assert_array_equal(codes(), first)


def test_set_prefix_noise_is_thrown_away(monkeypatch):
    """``set_prefix``'s discarded frame takes a noise source of its own, not
    one of the engine's per-call sources."""
    cfg, params, tok, *_ = testing.make_tiny_bundle(0)
    engine = GenerationEngine(params, cfg, tok, seed=3)
    calls = []
    real = engine._next_noise
    monkeypatch.setattr(engine, "_next_noise", lambda: calls.append(1) or real())
    ref = profile(1)
    engine.set_prefix([ref.text], [ref.codes])
    assert engine.has_prefix and not calls
