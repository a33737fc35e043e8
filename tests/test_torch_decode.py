"""The port's decode chunk against the JAX package's, at tiny size with
int8 f32 weights: the reference's per-frame all-done skip (early exit), the
device-resident state and default noise, and one frame that reads nothing
back to the host (the CPU's stand-in for "a CUDA graph can capture it").

The JAX side runs ``decode.prefill_chunk`` + ``decode.decode_chunk`` with
``fast_kernel=True`` and ``early_exit=True`` (Pallas in interpret mode), the
port gets a noise source replaying the same Gumbel draws.  An EOS is forced
by setting ``ids.im_end`` in both packages to a slow token the stream samples
mid-chunk.  Frames, emitted flags and the integer state must be bit-equal;
the KV caches agree within ``KV_TOL`` (the prefill runs in XLA on one side
and in PyTorch on the other, whose f32 sums differ in the last bits).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.prompt import build_prompt as jbuild_prompt
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.ops import slow_stack as jslow
from fish_tts_tpu.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

CFG = TINY_CONFIG
TEXTS = ("Hello world, this is a test.", "A second, shorter one.")
SAMPLING = (0.7, 0.8, 1.1)
N = 24  # decode frames after the prefill frame
KV_BUCKET = 128
KV_TOL = 1e-4
BASE_KEY = jax.random.PRNGKey(0)
EULER_GAMMA = 0.5772156649015329


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
    path = tmp_path_factory.mktemp("decode_vocab") / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    tok = JTokenizer(path, tiny_special_tokens(CFG.codebook_size))
    ids = jdual.TokenIds(tok.semantic_begin_id, tok.semantic_end_id, tok.im_end_id)
    jp = quantize_lm_params(jdual.init_params(jax.random.PRNGKey(0), CFG, jnp.float32))
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    encs = [jbuild_prompt(tok, t, CFG.num_codebooks).values for t in TEXTS]
    prompt = np.zeros((len(TEXTS), 1 + CFG.num_codebooks, 64), np.int32)
    for b, enc in enumerate(encs):
        prompt[b, :, :enc.shape[1]] = enc
    lengths = np.array([enc.shape[1] for enc in encs], np.int32)
    return dict(jk=jslow.prepare_head(jp, CFG), tp=tp, ids=ids, prompt=prompt,
                lengths=lengths, noise=replay_noise(BASE_KEY))


def port_prefill(s, B, ids, noise):
    state = tdecode.init_state(s["tp"], T_CFG, batch=B)
    state, first = tdecode.prefill(
        s["tp"], tdual.make_rope_tables(T_CFG), state, torch.from_numpy(s["prompt"][:B]),
        torch.from_numpy(s["lengths"][:B]), noise, *SAMPLING, cfg=T_CFG, ids=ids,
        kv_bucket=0)
    return state, first


def port_decode(s, state, ids, noise, n):
    return tdecode.decode_chunk(s["tp"], tdual.make_rope_tables(T_CFG), state, noise,
                                *SAMPLING, cfg=T_CFG, ids=ids, num_frames=n,
                                kv_bucket=KV_BUCKET, early_exit=True)


def first_at(tokens: np.ndarray, t: int) -> int:
    hits = np.flatnonzero(tokens == t)
    return int(hits[0]) if hits.size else -1


def forced_eos(s, B) -> tuple[int, list[int]]:
    """A slow token to serve as EOS and the decode frame at which each
    stream first samples it (-1: never).  Every stream that samples it does
    so mid-chunk, at B = 2 one earlier than the other; preferred: every
    stream stops, so the chunk ends with skipped frames."""
    state, first = port_prefill(s, B, s["ids"], s["noise"])
    _, frames, _ = port_decode(s, state, s["ids"], s["noise"], N)
    tokens = frames[:, :, 0].numpy()
    best = None
    for t in np.unique(tokens):
        if (first[:, 0].numpy() == t).any():
            continue  # the prefill frame must not stop a stream
        stops = [first_at(tokens[b], t) for b in range(B)]
        hits = [k for k in stops if k >= 0]
        if min(hits) < 2 or max(hits) > N - 4 or len(set(stops)) < B:
            continue
        score = (len(hits), -max(hits))
        if best is None or score > best[0]:
            best = (score, int(t), stops)
    assert best is not None, "no token stops a stream mid-chunk"
    return best[1], best[2]


@pytest.mark.parametrize("B", [1, 2])
def test_early_exit_matches_jax(setup, B):
    """``decode_chunk(early_exit=True)`` with a forced EOS equals the JAX
    package's: frames, emitted, step, pos, prev, frame and done bit-equal,
    the KV cache within KV_TOL; the frames after the last stop are skipped
    and leave the whole state, the cache included, as it was."""
    s = setup
    eos, stops = forced_eos(s, B)
    ids = dataclasses.replace(s["ids"], im_end=eos)

    rope = jdual.make_rope_tables(CFG)
    t, p, r = (jnp.float32(v) for v in SAMPLING)
    jstate = jdecode.init_state(s["jk"], CFG, batch=B)
    jstate, jf0, je0 = jdecode.prefill_chunk(
        s["jk"], rope, jstate, jnp.asarray(s["prompt"][:B]), jnp.asarray(s["lengths"][:B]),
        BASE_KEY, t, p, r, cfg=CFG, ids=ids, num_frames=0, top_k=-1, kv_bucket_prefill=0,
        kv_bucket=KV_BUCKET, fast_kernel=True)
    jstate, jf1, je1 = jdecode.decode_chunk(
        s["jk"], rope, jstate, BASE_KEY, t, p, r, cfg=CFG, ids=ids, num_frames=N, top_k=-1,
        kv_bucket=KV_BUCKET, fast_kernel=True, early_exit=True)

    # the port, cut into two chunks at the last stop
    last = max(stops)
    cut = last + 1 if last >= 0 else N // 2
    state, first = port_prefill(s, B, ids, s["noise"])
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf0)[:, 0])
    state, f1, e1 = port_decode(s, state, ids, s["noise"], cut)
    after_stop = {k: v.clone() for k, v in state.items() if k != "kv"}
    after_stop.update({f"kv_{k}": v.clone() for k, v in state["kv"].items()})
    state, f2, e2 = port_decode(s, state, ids, s["noise"], N - cut)
    frames = torch.cat([f1, f2], dim=1).numpy()
    emitted = torch.cat([e1, e2], dim=1).numpy()

    np.testing.assert_array_equal(emitted, np.asarray(je1))
    np.testing.assert_array_equal(frames, np.asarray(jf1))
    for k in ("step", "pos", "prev", "frame", "done"):
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]), err_msg=k)
    for k in ("k", "v"):
        np.testing.assert_allclose(state["kv"][k].numpy(), np.asarray(jstate["kv"][k]),
                                   rtol=KV_TOL, atol=KV_TOL, err_msg=k)
    for b, k in enumerate(stops):
        if k >= 0:
            assert frames[b, k, 0] == eos and emitted[b, k] and not emitted[b, k + 1:].any()
    if all(k >= 0 for k in stops):
        # every stream stopped: the rest of the chunk was skipped
        assert state["done"].all() and not e2.any()
        assert (f2 == state["frame"][:, None]).all()
        for k, v in after_stop.items():
            now = state["kv"][k[3:]] if k.startswith("kv_") else state[k]
            assert torch.equal(now, v), k
    assert stops[0] != stops[-1] or B == 1  # one stream stops before the other


def draw(seed, slots, steps):
    """The default source's draws of ``slots`` at ``steps``."""
    keys = torch.tensor(tdecode.GumbelNoise(seed, T_CFG).slot_keys(slots), dtype=torch.int64)
    return tdecode.default_draws(T_CFG, keys, steps)


def test_default_noise_keys_by_seed_slot_and_step():
    """Draws depend on (seed, slot, step) alone: equal for equal keys
    whatever the batch they are drawn in, different across slots, steps
    and seeds."""
    steps = torch.tensor([5, 9, 5, tdecode.PREFILL_STEP], dtype=torch.int32)
    g_slow, g_fast = draw(7, range(4), steps)
    assert g_slow.shape == (4, T_CFG.vocab_size) and g_slow.dtype == torch.float32
    assert g_fast.shape == (4, T_CFG.num_codebooks - 1, T_CFG.residual_codebook_size)
    for slot in range(4):
        one_slow, one_fast = draw(7, [slot], steps[slot:slot + 1])
        assert torch.equal(one_slow[0], g_slow[slot]) and torch.equal(one_fast[0], g_fast[slot])
    other_seed = draw(8, [0], steps[:1])[0][0]
    next_step = draw(7, [0], steps[:1] + 1)[0][0]
    for a, b in ((g_slow[0], g_slow[2]), (g_slow[0], next_step), (g_slow[0], other_seed),
                 (g_fast[0], g_fast[1])):
        assert (a != b).float().mean() > 0.99


def test_default_noise_is_standard_gumbel():
    """The mean of the draws is the Euler-Mascheroni constant and their
    variance pi^2 / 6, each within 5 standard errors."""
    g_slow, g_fast = draw(3, [0] * 64, torch.arange(64, dtype=torch.int32))
    g = torch.cat([g_slow.flatten(), g_fast.flatten()]).double()
    n = g.numel()
    var = math.pi ** 2 / 6
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - EULER_GAMMA) < 5 * math.sqrt(var / n)
    # the variance of a Gumbel sample variance: (mu4 - var^2) / n, mu4 = 27/5 var^2
    assert abs(g.var().item() - var) < 5 * math.sqrt((27 / 5 - 1) * var ** 2 / n)


# The routes a frame can take: int8 on the three kernels, bf16 (plain slow
# stack and residual books, the sampler kernel) and top_k > 0 (the plain
# samplers' sort).
ROUTES = {"int8": ({}, dict(top_k=-1)), "bf16": (dict(precision="bf16"), dict(top_k=-1)),
          "top_k=8": ({}, dict(top_k=8))}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("skip_done", [False, True])
def test_one_frame_reads_nothing_back(setup, monkeypatch, skip_done, route):
    """The frame the graph captures, with the default noise, at B = 2: no
    tensor is turned into a host value (a CUDA graph could not hold such a
    read).  Its state and ring stay tensors on the state's device."""
    s = dict(setup)
    make, opts = ROUTES[route]
    if make.get("precision") == "bf16":
        s["tp"] = tdual.cast_params(tckpt.from_jax_params(jax.tree_util.tree_map(
            np.asarray, jdual.init_params(jax.random.PRNGKey(0), CFG, jnp.float32))),
            torch.bfloat16)
    rt = tdecode.route(T_CFG, s["tp"], 2, tdecode.WINDOW, **opts)
    assert (rt.slow_stack, rt.sampler, rt.fast) == {
        "int8": (True, True, True), "bf16": (False, True, False),
        "top_k=8": (True, False, False)}[route]
    state, _ = port_prefill(s, 2, s["ids"], tdecode.GumbelNoise(5, T_CFG))
    ring = tdecode._Ring(2, 3, 1 + T_CFG.num_codebooks, state["frame"].device)
    rope = tdual.make_rope_tables(T_CFG)

    def refuse(*_a, **_k):
        raise AssertionError("a decode frame read a tensor back to the host")

    for name in ("__bool__", "item", "cpu", "tolist", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.no_grad():
        for _ in range(2):
            tdecode.decode_frame(s["tp"], T_CFG, s["ids"], rope, state, None,
                                 kv_bucket=KV_BUCKET, skip_done=skip_done, ring=ring, **opts)
    monkeypatch.undo()
    assert ring.t.tolist() == [2]
    assert state["step"].tolist() == [2, 2] and state["step"].dtype == torch.int32


def _tiny_kernel_inputs(gen):
    """Seeded inputs of the three kernels' plain versions at the tiny config."""
    cfg = T_CFG
    params = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, quantize_lm_params(
        jdual.init_params(jax.random.PRNGKey(1), CFG, jnp.float32))))
    rope = tdual.make_rope_tables(cfg)
    B, V, K, Vr = 2, cfg.vocab_size, cfg.num_codebooks, cfg.residual_codebook_size
    cols = [torch.full((B, 1), v) for v in SAMPLING]
    kv = {k: torch.randn((cfg.n_layer, B, cfg.n_local_heads, 32, cfg.head_dim), generator=gen)
          for k in ("k", "v")}
    return {
        "sampler": lambda skip: sampler_kernel.sample_slow(
            torch.randn((B, V), generator=gen), torch.randint(0, V, (B, 1 + K), generator=gen,
                                                              dtype=torch.int32),
            torch.rand((B, V), generator=gen), *cols, skip),
        "slow stack": lambda skip: slow_stack.slow_stack_step(
            params, cfg, rope["slow"], torch.randn((B, cfg.dim), generator=gen), kv,
            torch.tensor([3, 20], dtype=torch.int32), read_len=16, skip=skip),
        "fast decoder": lambda skip: fast_decoder.fast_decode_frame(
            params, cfg, rope["fast"], torch.randn((B, cfg.fast_dim), generator=gen),
            torch.tensor([1, 7], dtype=torch.int32),
            torch.randint(0, Vr, (B, K - 1, 16), generator=gen, dtype=torch.int32),
            torch.rand((B, K - 1, Vr), generator=gen), *cols, window=16, skip=skip),
    }


@pytest.mark.parametrize("kernel", ["sampler", "slow stack", "fast decoder"])
def test_plain_versions_take_the_skip_flag(kernel):
    """With the flag clear a plain version gives what it gives without one;
    with it set, zeros of the same shapes (what the kernel's wrapper returns
    when the kernel skips)."""
    outs = {}
    for skip in (None, torch.tensor(False), torch.tensor(True)):
        gen = torch.Generator().manual_seed(4)
        out = _tiny_kernel_inputs(gen)[kernel](skip)
        outs[None if skip is None else bool(skip)] = out if isinstance(out, tuple) else (out,)
    for a, b, z in zip(outs[None], outs[False], outs[True]):
        assert torch.equal(a, b) and a.abs().sum() > 0
        assert z.shape == a.shape and z.dtype == a.dtype and not z.any()


def test_engine_reuses_its_state_and_resets_it():
    """The engine keeps one decode state per (batch, cache size) and resets
    it in place: after another generation dirtied it, the same text and
    noise give the same codes again."""
    from fish_tts_tpu_torch.config import EngineConfig
    from fish_tts_tpu_torch.engine.generate import GenerationEngine
    from fish_tts_tpu_torch.testing import make_tiny_bundle
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = make_tiny_bundle(0)
    engine = GenerationEngine(quantize_lm_params(params), cfg, tok,
                              EngineConfig(first_chunk=4, decode_chunk=4, batch_chunk=8))

    def codes(text, seed):
        out = engine.generate_long(text, max_new_tokens=14, temperature=SAMPLING[0],
                                   top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                                   noise=tdecode.GumbelNoise(seed, cfg))
        return next(out).codes

    first = codes(TEXTS[0], 7)
    codes(TEXTS[1], 8)
    assert len(engine._states) == 1
    np.testing.assert_array_equal(codes(TEXTS[0], 7), first)
